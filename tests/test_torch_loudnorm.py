"""audioloudnorm of the PyTorch port against the JAX package, on the CPU.

Mirrors tests/test_audioloudnorm.py (the reference's scenarios,
audio/audiofx/tests/audioloudnorm.rs) at 3-5 s of 192 kHz F64: each signal
goes through both packages' `appsrc ! audioloudnorm ! appsink`.  The port's
output must meet the reference's own bar (integrated loudness within +-1 LU
of -24 LUFS, sample peak <= -2 dBFS, the exact sample count, PTS continuous
within 1 ns) and match the JAX element sample by sample within 1e-9 (f64;
the two analysers sum in other orders, ~1e-16 relative) with the same PTS.

The limiter's plain version (ops/loudnorm_limiter.py) is held against the
JAX package's `_limiter_scan` bit for bit, in f64 and f32, on windows that
drive the FSM through all four states (checked on the reference's own state
trajectory), including restarts and steepened attacks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core import Buffer as JBuffer, Caps as JCaps
from gst_plugins_rs_tpu.ops import loudnorm as JL
from gst_plugins_rs_tpu_torch.core import SECOND, Buffer as TBuffer, Caps as TCaps, Harness
from gst_plugins_rs_tpu_torch.ops import loudnorm as TLN
from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as TL
from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128
from torch_parity_helpers import port_on_cpu

RATE = 192_000
N_LONG = 500 * 1920  # 5 s
SAMPLE_TOL = 1e-9


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _run(pkg, buffer_cls, caps_cls, signal, spb, fmt="F64"):
    p = pkg.parse_launch("appsrc name=src ! audioloudnorm ! appsink name=sink")
    src = p.by_name("src")
    src.set_property("caps", caps_cls.builder("audio/x-raw", format=fmt, rate=RATE,
                                              channels=signal.shape[1], layout="interleaved"))
    for i in range(0, signal.shape[0], spb):
        chunk = signal[i:i + spb]
        if buffer_cls is TBuffer:
            chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        src.push_buffer(buffer_cls(chunk, pts=i * SECOND // RATE, offset=i,
                                   duration=chunk.shape[0] * SECOND // RATE))
    src.end_of_stream()
    p.play_until_eos()
    return [(np.asarray(s.buffer.data), s.buffer.pts) for s in p.by_name("sink").samples]


def _check_reference_bar(out, channels, expected_samples, expected_loudness):
    r128 = EbuR128(channels, RATE)
    expected_ts, n = 0, 0
    for data, pts in out:
        assert pts is not None and abs(pts - expected_ts) <= 1, (pts, expected_ts)
        r128.add_frames(torch.from_numpy(data))
        n += data.shape[0]
        expected_ts += data.shape[0] * SECOND // RATE
    assert n == expected_samples
    loudness = r128.loudness_global()
    if expected_loudness == -np.inf:
        assert loudness < -100, loudness
    else:
        assert abs(loudness - expected_loudness) < 1.0, loudness
    for c in range(channels):
        sp = r128.sample_peak(c)
        assert (20 * np.log10(sp) if sp > 0 else -np.inf) <= -2.0 + 1e-6


def _sine(amp, n, ch, freq=440.0):
    t = np.arange(n) / RATE
    return np.repeat((amp * np.sin(2 * np.pi * freq * t))[:, None], ch, axis=1)


def _white(amp, n, ch, seed=0):
    return np.repeat(np.random.RandomState(seed).uniform(-amp, amp, n)[:, None], ch, axis=1)


def _ticks(amp, n, ch, periods_per_tick, tick_interval_s=4.0, freq=440.0):
    t = np.arange(n) / RATE
    pos = np.mod(np.arange(n), tick_interval_s * RATE)
    sig = np.where(pos < periods_per_tick * RATE / freq, amp * np.sin(2 * np.pi * freq * t), 0.0)
    return np.repeat(sig[:, None], ch, axis=1)


# (name, signal, channels, samples per buffer, expected loudness): the
# scenarios of tests/test_audioloudnorm.py
SCENARIOS = {
    "basic": (lambda: _sine(0.8, N_LONG, 1), 1920, -24.0),
    "basic_white_noise": (lambda: _white(0.8, N_LONG, 1), 1920, -24.0),
    "remaining_at_eos": (lambda: _sine(0.8, 500 * 1024, 1), 1024, -24.0),
    # past 3 s: the drain with a partial frame left (30 drain steps)
    "remaining_at_eos_inner": (lambda: _sine(0.8, 600 * 1024, 1), 1024, -24.0),
    "short_input": (lambda: _sine(0.8, 100 * 1024, 1), 1024, -24.0),
    "basic_two_channels": (lambda: _sine(0.8, N_LONG, 2), 1920, -24.0),
    "silence": (lambda: np.zeros((500 * 1024, 1)), 1024, -np.inf),
    "quiet": (lambda: _sine(0.5, N_LONG, 1), 1920, -24.0),
    "very_quiet": (lambda: _sine(0.1, N_LONG, 1), 1920, -24.0),
    "very_very_quiet": (lambda: _sine(0.01, N_LONG, 1), 1920, -24.0),
    "below_threshold": (lambda: _sine(0.00045, N_LONG, 1), 1920, -np.inf),
    "limiter": (lambda: _sine(0.05, N_LONG, 1) + _ticks(0.8, N_LONG, 1, 1), 1024, -24.0),
    "limiter_on_first_frame": (lambda: _sine(0.05, N_LONG, 1) + _ticks(0.8, N_LONG, 1, 10),
                               1024, -24.0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax_and_reference_bar(name):
    make, spb, loudness = SCENARIOS[name]
    sig = make()
    got = _run(tfx, TBuffer, TCaps, sig, spb)
    _check_reference_bar(got, sig.shape[1], sig.shape[0], loudness)
    ref = _run(jfx, JBuffer, JCaps, sig, spb)
    assert [p for _, p in got] == [p for _, p in ref]
    a = np.concatenate([d for d, _ in ref])
    b = np.concatenate([d for d, _ in got])
    assert a.shape == b.shape and b.dtype == np.float64
    assert float(np.abs(a - b).max()) <= SAMPLE_TOL


# F32 streams: at 192 kHz the K-weighting high-pass (a pole near 1) costs
# f32 ~1e-3 of the filtered signal in the JAX package's block loop (the
# port's closed form, whose block states run in a rotation basis, ~1e-7),
# so the subblock energies carry ~1e-4 relative error and the gain ~1e-4
# (PERF.md section 3); the JAX run measured 1.9e-5 off the F64 run of the
# same samples
F32_TOL = 1e-4


def test_f32_stream_runs_in_f32():
    sig = (_sine(0.05, N_LONG, 2) + _ticks(0.8, N_LONG, 2, 10)).astype(np.float32)
    got = _run(tfx, TBuffer, TCaps, sig, 4800, fmt="F32")
    assert all(d.dtype == np.float32 for d, _ in got)
    _check_reference_bar([(d.astype(np.float64), p) for d, p in got], 2, sig.shape[0], -24.0)
    b = np.concatenate([d for d, _ in got])
    ref = np.concatenate([d for d, _ in _run(jfx, JBuffer, JCaps, sig, 4800, fmt="F32")])
    f64 = np.concatenate([d for d, _ in _run(tfx, TBuffer, TCaps, sig.astype(np.float64),
                                               4800)])
    assert float(np.abs(ref - b).max()) <= F32_TOL
    assert float(np.abs(f64 - b).max()) <= F32_TOL


def test_latency_query():
    h = Harness(tfx.element_factory_make("audioloudnorm"))
    assert h.query_latency().result["min_latency"] == 3 * SECOND


def test_time_shard_is_not_ported_yet():
    """time-shard=true is ported (tests/test_torch_timeshard.py holds both
    modes against JAX): on a 0.1 s buffer over 2 shards, both modes give the
    default path's samples (a stream under 3 s takes the linear gain)."""
    tfx.set_virtual_devices(2)
    try:
        outs = {}
        for props in ("", "time-shard=true", "time-shard=true time-shard-mode=linear"):
            p = tfx.parse_launch("audiotestsrc num-buffers=1 ! audio/x-raw,format=F64,rate=192000 "
                                 f"! audioloudnorm {props} ! appsink name=sink")
            p.play_until_eos()
            outs[props] = p.by_name("sink").concat_audio()
    finally:
        tfx.set_virtual_devices(None)
    ref = outs[""]
    assert ref.shape[0] > 0 and np.isfinite(ref).all()
    for props, out in outs.items():
        assert out.shape == ref.shape and float(np.abs(out - ref).max()) <= SAMPLE_TOL, props


def test_drain_launches_one_limiter_step_per_output_frame(monkeypatch):
    """A 4 s stream: the first frame, 10 inner frames, then 29 drain steps
    (the 30th frame would be cut away whole): one limiter run per 100 ms
    output frame."""
    calls = []
    real = TLN.limiter_frame

    def counting(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(TLN, "limiter_frame", counting)
    sig = _sine(0.3, 4 * RATE, 1)
    out = _run(tfx, TBuffer, TCaps, sig, 19200)
    n = sum(d.shape[0] for d, _ in out)
    assert n == sig.shape[0] and len(calls) == n // TL.FRAME == 40


# ---------------------------------------------------------------------------
# The limiter's plain version against the JAX scan
# ---------------------------------------------------------------------------
W = JL.FRAME + JL.TAIL


def _window(seed):
    """Quiet noise with 12 bursts of 1-40 samples at 0.7-1.5 full scale: peaks
    close together (restarts), and gaps long enough to sustain, release and
    fall back to Out.  Seed 3 adds pairs of single-sample peaks 1,500-1,800
    samples apart, the second a little higher: the attack steepens."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.3, 0.3, (W, 2))
    if seed == 3:
        for p, gap, a, b in ((3000, 1700, 0.95, 1.0), (9000, 1500, 0.9, 0.95),
                             (15000, 1800, 0.85, 0.9)):
            x[p, 0], x[p + gap, 1] = a, b
        return x
    for _ in range(12):
        p = rng.randint(0, W - 50)
        x[p:p + rng.randint(1, 40), rng.randint(0, 2)] *= rng.uniform(0.7, 1.5) / 0.3
    return x


CARRIES = [(0, 0, -1, 0.0, 0.0), (1, 500, -1, 0.9, 0.6), (2, 0, 100, 0.7, 0.5),
           (3, 3000, -1, 0.5, 1.0)]


@jax.jit
def _jax_states(x, carry, tp):
    """The JAX scan's per-sample (state, env)."""
    pk, pv, fut = JL._precompute_peaks(x, tp)
    step = JL._make_limiter_step(tp, x.dtype)

    def traced(c, inp):
        c, _ = step(c, inp)
        return c, (c[0], c[1])

    return jax.lax.scan(traced, carry, (x[:JL.FRAME], pk, pv, fut))[1]


# under jit, as every call site of the JAX element runs it (its frame steps
# are jitted): XLA then turns env / (len - 1) into a product with the
# reciprocal (an eager, unjitted scan divides)
_jax_limiter_scan = jax.jit(JL._limiter_scan)


def _jax_trace(x, carry, tp, npdt):
    """The JAX scan's output, final carry and per-sample (state, env)."""
    xj, tpj = jnp.asarray(x), jnp.asarray(tp, npdt)
    jc = tuple(jnp.asarray(v, jnp.int32) for v in carry[:3]) + \
        tuple(jnp.asarray(v, npdt) for v in carry[3:])
    states, envs = _jax_states(xj, jc, tpj)
    out, new = _jax_limiter_scan(xj, jc, tpj)
    return np.asarray(out), new, np.asarray(states), np.asarray(envs)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_limiter_plain_equals_jax_scan(dtype):
    npdt, tdt = (np.float64, torch.float64) if dtype == "f64" else (np.float32, torch.float32)
    tp = float(npdt(10 ** (-2 / 20)))
    visited, jumps = set(), 0
    for seed in range(4):
        x = _window(seed).astype(npdt)
        w = torch.from_numpy(x)
        pk, pv, fut = TL.precompute_peaks(w, tp)
        jpk, jpv, jfut = JL._precompute_peaks(jnp.asarray(x), jnp.asarray(tp, npdt))
        assert np.array_equal(np.asarray(jpk), pk.numpy())
        assert np.array_equal(np.asarray(jpv), pv.numpy())
        assert np.array_equal(np.asarray(jfut), fut.numpy())
        for carry in CARRIES:
            ref, ref_carry, states, envs = _jax_trace(x, carry, tp, npdt)
            out, ci, cf = TL.limiter_frame_plain(
                w, torch.tensor(carry[:3], dtype=torch.int32),
                torch.tensor(carry[3:], dtype=tdt), tp, pk, pv, fut)
            diff = np.flatnonzero((ref != out.numpy()).any(1))
            assert diff.size == 0, f"seed {seed}, carry {carry}: first differing sample {diff[:5]}"
            assert ci.tolist() == [int(v) for v in ref_carry[:3]]
            assert np.array_equal(cf.numpy(), np.asarray([ref_carry[3], ref_carry[4]], npdt))
            visited |= set(states.tolist())
            # an attack steepened mid-way restarts its envelope at neither 0
            # nor the next count
            att = (states[1:] == TL.ST_ATTACK) & (states[:-1] == TL.ST_ATTACK)
            jumps += int((att & (envs[1:] != envs[:-1] + 1) & (envs[1:] > 1)).sum())
    assert visited == {TL.ST_OUT, TL.ST_ATTACK, TL.ST_SUSTAIN, TL.ST_RELEASE}
    assert jumps > 0


def test_limiter_idle_frame_passes_input_through():
    x = np.random.RandomState(5).uniform(-0.5, 0.5, (W, 2))
    w = torch.from_numpy(x)
    pk, pv, fut = TL.precompute_peaks(w, 0.79)
    assert not bool(pk.any())
    ci, cf = torch.tensor([TL.ST_OUT, 0, -1], dtype=torch.int32), torch.zeros(2, dtype=torch.float64)
    out, ci2, cf2 = TL.limiter_frame(w, ci, cf, 0.79)
    assert torch.equal(out, w[:TL.FRAME]) and torch.equal(ci2, ci) and torch.equal(cf2, cf)


def test_fma_helpers_round_once():
    from fractions import Fraction

    from gst_plugins_rs_tpu_torch.ops.loudnorm_limiter import _fma32, _fma64

    rng = np.random.RandomState(3)
    for a, b, c in rng.uniform(-2, 2, (500, 3)):
        assert _fma64(a, b, c) == float(Fraction(a) * Fraction(b) + Fraction(c))
        a32, b32, c32 = np.float32(a), np.float32(b), np.float32(c)
        exact = Fraction(float(a32)) * Fraction(float(b32)) + Fraction(float(c32))
        got = _fma32(a32, b32, c32)
        # nearest f32: no f32 neighbour is closer
        for nb in (np.nextafter(got, np.float32(-np.inf)), np.nextafter(got, np.float32(np.inf))):
            assert abs(Fraction(float(got)) - exact) <= abs(Fraction(float(nb)) - exact)
