"""The port's stream banks (parallel/streams.py), loudnormbank and the bank
benchmark against the JAX package and the port's single-stream path, on the
CPU.

Mirrors of the non-mesh tests of tests/test_parallel.py and
tests/test_loudnormbank.py, and gates of the port's own:

- the echo bank: within ECHO_TOL = 1e-7 of JAX's echo_apply_flat, stream by
  stream (the same f32 products and sums);
- the loudnorm bank against the port's single-stream F32 path (the same
  operations on a leading stream axis): within BANK_TOL = 1e-6 a sample;
- the bank against the JAX bank, F32 at 2 streams over 3.4 s (the first
  frame and 4 inner frames): within JAX_BANK_TOL = 1e-6 a sample, the
  differing samples named;
- loudnormbank against the JAX element over 34 and 37 buffers, the drain
  included: within JAX_F32_TOL = 1e-4 a sample, the differing samples
  named.  That is tests/test_torch_loudnorm.py's F32_TOL for the
  single-stream element, and for its reason: at 192 kHz the K-weighting
  high-pass (a pole near 1) costs f32 ~1e-3 of the filtered signal in the
  JAX package's block loop (~1e-7 in the port's rotation basis), so on
  this test's 0.8 and 0.1
  sines the gains differ by ~1e-5 from the first frame on (both tests
  print the largest difference); the JAX package holds its own bank to its
  sequential path only within 2e-4 (tests/test_parallel.py);
- merged and per-stream integrated loudness against JAX: within
  LUFS_TOL = 1e-4 LU (f32 histograms, the bin energies summed in another
  order);
- the loudness oracle of the reference's tests: +-1 LU of -24 LUFS.
`shard=true`, `mesh=` and `--mesh` run over parallel/mesh.py's mesh (held
in tests/test_torch_mesh.py); here they raise ValueError, as the JAX bank
does, where the mesh does not divide the streams.  Torch runs on one
intra-op thread.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import loudnorm as JLN
from gst_plugins_rs_tpu.parallel import streams as jstreams
from gst_plugins_rs_tpu_torch.ops import loudnorm as LN
from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim
from gst_plugins_rs_tpu_torch.parallel import benchmark as tbench
from gst_plugins_rs_tpu_torch.parallel import streams as tstreams
from torch_parity_helpers import port_on_cpu

ECHO_TOL = 1e-7
BANK_TOL = 1e-6
JAX_BANK_TOL = 1e-6
JAX_F32_TOL = 1e-4
LUFS_TOL = 1e-4


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    d = np.abs(got - ref)
    bad = np.argwhere(d > tol)
    assert bad.size == 0, (f"{what}: {len(bad)} samples differ by more than {tol}, the first "
                           f"{[tuple(i) for i in bad[:5]]}: max |d| {d.max():.3e}")
    return float(d.max()) if d.size else 0.0


# ---------------------------------------------------------------------------
# tests/test_parallel.py (non-mesh)
# ---------------------------------------------------------------------------
def test_stream_bank_matches_individual():
    from gst_plugins_rs_tpu.ops.echo import echo_apply_flat, echo_lag_samples, echo_ring_size

    xs = np.random.RandomState(0).uniform(-1, 1, (4, 9600)).astype(np.float32)
    out = tstreams.echo_bank(4, rate=48000, channels=2).process(_t(xs)).numpy()
    S = echo_ring_size(1_000_000_000, 48000, 2)
    lag = echo_lag_samples(250_000_000, 1_000_000_000, 48000, 2)
    for i in range(4):
        ref, _ = echo_apply_flat(jnp.asarray(xs[i]), jnp.zeros((S,), jnp.float32),
                                 jnp.float32(0.5), jnp.float32(0.4), lag=lag)
        _close(out[i], ref, ECHO_TOL, f"echo stream {i}")


def test_stream_bank_state_advances():
    bank = tstreams.echo_bank(2, rate=8000, channels=1, delay_ns=100_000_000)
    x = torch.zeros(2, 800)
    x[:, 0] = 1.0
    bank.process(x)
    out2 = bank.process(torch.zeros(2, 800))
    assert float(out2[0, 0]) == pytest.approx(0.5)


def test_echo_bank_matches_jax_bank_over_ticks():
    xs = np.random.RandomState(4).uniform(-1, 1, (3, 5, 4800)).astype(np.float32)
    jb = jstreams.echo_bank(3)
    tb = tstreams.echo_bank(3)
    for k in range(5):
        _close(tb.process(_t(xs[:, k])).numpy(), jb.process(jnp.asarray(xs[:, k])),
               ECHO_TOL, f"tick {k}")


def _sines(amps, seconds, rate=LN.RATE):
    t = np.arange(int(seconds * rate)) / rate
    return np.stack([np.repeat((a * np.sin(2 * np.pi * 440 * t))[:, None], 2, axis=1)
                     for a in amps]).astype(np.float32)


def test_loudnorm_bank_normalizes_all_streams():
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    sigs = _sines([0.8, 0.2, 0.05], 8)
    bank = tstreams.loudnorm_bank(3, channels=2)
    outs = [bank.first_frame(_t(sigs[:, :3 * LN.RATE]))]
    pos = 3 * LN.RATE
    while pos + LN.FRAME <= sigs.shape[1]:
        outs.append(bank.process(_t(sigs[:, pos:pos + LN.FRAME])))
        pos += LN.FRAME
    full = torch.cat(outs, 1)
    for i in range(3):
        r = EbuR128(2, LN.RATE, dtype=torch.float32, device="cpu")
        r.add_frames(full[i, 2 * LN.RATE:])
        assert abs(r.loudness_global() + 24.0) < 2.0, f"stream {i}: {r.loudness_global()}"


def _first_and_frames(seed, N, K, hot=None):
    rng = np.random.RandomState(seed)
    first3 = rng.uniform(-0.3, 0.3, (N, LN.GAIN_LOOKAHEAD, 2)).astype(np.float32)
    frames = rng.uniform(-0.3, 0.3, (N, K, LN.FRAME, 2)).astype(np.float32)
    if hot is not None:
        # a hot stream with isolated spikes above -2 dBTP after the gain, in
        # the first frame's window and in the backlog that the next K frames
        # scale: the limiter walks its FSM there while the other streams idle
        first3[hot] *= 2.5
        frames[hot] *= 2.5
        for k in range(K + 1):
            first3[hot, 3000 + LN.FRAME * k + 900 * k] = 16.0
    return first3, frames


def _states_equal(a, b):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple):
            _states_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f
        else:
            assert x == y, f


def test_process_many_matches_sequential():
    first3, frames = _first_and_frames(7, 4, 5)
    a = tstreams.loudnorm_bank(4, channels=2)
    a.first_frame(_t(first3))
    seq = [a.process(_t(frames[:, k])) for k in range(5)]
    b = tstreams.loudnorm_bank(4, channels=2)
    b.first_frame(_t(first3))
    many = b.process_many(_t(frames))
    for k in range(5):
        assert torch.equal(many[:, k], seq[k]), k
    _states_equal(a.states, b.states)


def test_loudnorm_bank_matches_single_stream_path():
    """Each stream of the bank against the port's single-stream F32 steps,
    with one hot stream whose limiter runs while the others idle; the drain
    too."""
    N, K = 3, 4
    first3, frames = _first_and_frames(21, N, K, hot=1)
    bank = tstreams.loudnorm_bank(N, channels=2)
    firsts = bank.first_frame(_t(first3))
    many = bank.process_many(_t(frames))
    tail = np.zeros((N, LN.FRAME, 2), np.float32)
    tail[:, :5000] = frames[:, -1, :5000]
    drained = bank.drain(_t(tail))
    params = LN.loudnorm_params(-24.0, 7.0, -2.0, 2, torch.float32, "cpu")
    states = {}
    for i in range(N):
        st = LN.loudnorm_init(params, 2, 0.0)
        st, o = LN.first_frame_step(st, params, _t(first3[i]))
        _close(firsts[i], o, BANK_TOL, f"stream {i} first frame")
        seen = [int(st.lim_i[0])]
        for k in range(K):
            st, o = LN.inner_frame_step(st, params, _t(frames[i, k]))
            seen.append(int(st.lim_i[0]))
            _close(many[i, k], o, BANK_TOL, f"stream {i} frame {k}")
        st, o = LN.drain(st, params, _t(tail[i]))
        _close(drained[i], o, BANK_TOL, f"stream {i} drain")
        states[i] = seen
    assert any(s != lim.ST_OUT for s in states[1]), "the hot stream never left state Out"
    assert all(s == lim.ST_OUT for i in (0, 2) for s in states[i])


def test_loudnorm_bank_matches_jax_bank():
    """The bank against the JAX package's bank, F32, 2 streams over 3.4 s
    (the 3 s first frame and 4 inner frames), one of them hot."""
    first3, frames = _first_and_frames(5, 2, 4, hot=0)
    jb = jstreams.loudnorm_bank(2, channels=2, dtype=jnp.float32)
    tb = tstreams.loudnorm_bank(2, channels=2)
    d = _close(tb.first_frame(_t(first3)), jb.first_frame(jnp.asarray(first3)), JAX_BANK_TOL,
               "first frame")
    for k in range(4):
        d = max(d, _close(tb.process(_t(frames[:, k])), jb.process(jnp.asarray(frames[:, k])),
                          JAX_BANK_TOL, f"frame {k}"))
    print(f"bank vs JAX bank, 2 streams x 3.4 s F32: max |d| {d:.3e} (gate {JAX_BANK_TOL})")
    np.testing.assert_array_equal(tb.states.lim_i[:, 0].numpy(), np.asarray(jb.states.lim_state))


def test_precompute_peaks_batched_equals_single():
    w = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (3, 40320, 2))
                         .astype(np.float32))
    batched = lim.precompute_peaks(w, 0.9)
    for n in range(3):
        for got, ref in zip(batched, lim.precompute_peaks(w[n], 0.9)):
            assert torch.equal(got[n], ref)


def test_limiter_frames_plain_equals_per_stream():
    w = torch.from_numpy(np.random.RandomState(6).uniform(-1.2, 1.2, (2, 40320, 2)))
    tp = 10 ** (-2 / 20)
    ci = torch.tensor([[0, 0, -1], [2, 0, 100]], dtype=torch.int32)
    cf = torch.tensor([[0.0, 0.0], [0.7, 0.5]], dtype=torch.float64)
    out, ni, nf = lim.limiter_frames(w, ci, cf, tp)
    for n in range(2):
        o, i, f = lim.limiter_frame(w[n], ci[n], cf[n], tp)
        assert torch.equal(out[n], o) and torch.equal(ni[n], i) and torch.equal(nf[n], f)


# ---------------------------------------------------------------------------
# r128_bank and merged loudness
# ---------------------------------------------------------------------------
def test_r128_bank_merged_and_per_stream_match_jax():
    rng = np.random.RandomState(9)
    x = (rng.uniform(-1, 1, (3, 24 * 4800, 2)) * np.array([0.5, 0.1, 0.02])[:, None, None]) \
        .astype(np.float32)
    jb = jstreams.r128_bank(3, channels=2, rate=48000, dtype=jnp.float32)
    tb = tstreams.r128_bank(3, channels=2, rate=48000)
    for k in range(4):  # 4 ticks of 6 subblocks
        chunk = np.ascontiguousarray(x[:, k * 6 * 4800:(k + 1) * 6 * 4800])
        jb.add_frames(jnp.asarray(chunk))
        tb.add_frames(_t(chunk))
    assert abs(tb.merged_loudness() - jb.merged_loudness()) < LUFS_TOL
    np.testing.assert_allclose(tb.per_stream_loudness(), jb.per_stream_loudness(), rtol=0,
                               atol=LUFS_TOL)
    # the merged histogram is the sum of the streams': louder than the quietest
    assert tb.per_stream_loudness().min() < tb.merged_loudness()


def test_r128_bank_per_stream_equals_single_analyser():
    from gst_plugins_rs_tpu_torch.ops.ebur128 import (
        loudness_global, r128_add_full_subblocks, r128_init, r128_params)
    from gst_plugins_rs_tpu_torch.core.audio import default_channel_positions

    x = np.random.RandomState(3).uniform(-0.4, 0.4, (2, 12 * 4800, 2)).astype(np.float32)
    tb = tstreams.r128_bank(2, channels=2, rate=48000)
    tb.add_frames(_t(x))
    params = r128_params(48000, default_channel_positions(2), torch.float32, "cpu")
    for i in range(2):
        st = r128_add_full_subblocks(r128_init(params, 2), params, _t(x[i]))
        assert abs(float(loudness_global(st, params)) - tb.per_stream_loudness()[i]) < LUFS_TOL
        assert torch.allclose(tb.states.true_peak[i], st.true_peak, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_loudnormbank.py (non-mesh) and the element against JAX's
# ---------------------------------------------------------------------------
def run_bank(fx, n_streams, volumes, nbuf=34, shard=False):
    p = fx.Pipeline()
    bank = fx.element_factory_make("loudnormbank")
    bank.set_property("shard", shard)
    p.add(bank)
    sinks = []
    for i in range(n_streams):
        src = fx.element_factory_make("audiotestsrc")
        src.set_property("wave", "sine")
        src.set_property("freq", 440.0 + 100 * i)
        src.set_property("volume", volumes[i])
        src.set_property("samplesperbuffer", LN.RATE // 10)
        src.set_property("num-buffers", nbuf)
        sink = fx.element_factory_make("appsink")
        cf = fx.element_factory_make("capsfilter")
        cf.set_property("caps", fx.parse_caps(f"audio/x-raw,format=F32,rate={LN.RATE},channels=1"))
        for e in (src, sink, cf):
            p.add(e)
        src.link(cf)
        cf.pad("src").link(bank.request_sink_pad())
        bank.pad(f"src_{i}").link(sink.pad("sink"))
        sinks.append(sink)
    p.play_until_eos()
    return p, sinks


def measured_lufs(samples) -> float:
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    r = EbuR128(1, LN.RATE, dtype=torch.float32, device="cpu")
    r.add_frames(torch.as_tensor(np.asarray(samples)).reshape(-1, 1))
    return r.loudness_global()


def test_pipeline_normalizes_all_streams():
    vols = [0.8, 0.25, 0.5, 0.1]
    _, sinks = run_bank(tfx, 4, vols)
    for i, s in enumerate(sinks):
        out = s.concat_audio()
        assert out.shape[0] >= 3 * LN.RATE, f"stream {i} too short"
        lufs = measured_lufs(out)
        assert abs(lufs + 24.0) < 1.0, f"stream {i} (vol {vols[i]}): {lufs:.2f} LUFS"


def test_sample_count_and_pts():
    p, sinks = run_bank(tfx, 2, [0.7, 0.2])
    frame_ns = LN.FRAME * 10**9 // LN.RATE
    for s in sinks:
        assert s.concat_audio().shape[0] == 34 * (LN.RATE // 10)
        pts = [x.buffer.pts for x in s.samples]
        assert pts == [k * frame_ns for k in range(len(pts))]
    msgs = [m.structure for m in p.bus.messages() if m.structure is not None
            and m.structure.name == "r128-bank-level"]
    assert len(msgs) == 1 and msgs[0]["streams"] == 2


@pytest.mark.parametrize("nbuf", [34, 37])
def test_element_matches_jax_element(nbuf):
    """Both elements on the same two streams: the same samples within
    JAX_F32_TOL (the drain of 29 frames, and of 30 with a partial frame left
    when the streams end mid-frame), the same PTS and buffer sizes."""
    vols = [0.8, 0.1]
    _, jsinks = run_bank(jfx, 2, vols, nbuf)
    _, tsinks = run_bank(tfx, 2, vols, nbuf)
    for i, (js, ts) in enumerate(zip(jsinks, tsinks)):
        assert [x.buffer.pts for x in ts.samples] == [x.buffer.pts for x in js.samples]
        d = _close(ts.concat_audio(), js.concat_audio(), JAX_F32_TOL, f"stream {i}")
        print(f"loudnormbank vs the JAX element, {nbuf} buffers, stream {i}: max |d| {d:.3e} "
              f"(gate {JAX_F32_TOL})")


def test_partial_frame_drain():
    """Streams that end mid-frame: every sample in comes out."""
    p, sinks = run_bank(tfx, 2, [0.7, 0.2], nbuf=37)
    for s in sinks:
        assert s.concat_audio().shape[0] == 37 * (LN.RATE // 10)


def test_shard_raises():
    """shard=true shards the streams over a mesh of every visible device
    (tests/test_torch_mesh.py holds it against shard=false and JAX); like
    the JAX element, it raises ValueError when the mesh does not divide the
    stream count: 2 streams on 4 shards."""
    tfx.set_virtual_devices(4)
    try:
        with pytest.raises(ValueError, match="divisible by 4"):
            run_bank(tfx, 2, [0.5, 0.5], shard=True)
        with pytest.raises(ValueError, match="divisible by 8"):
            run_bank(jfx, 2, [0.5, 0.5], shard=True)  # the JAX bank on its 8 devices
        _, sinks = run_bank(tfx, 4, [0.5, 0.4, 0.3, 0.2], nbuf=31, shard=True)
        assert all(s.concat_audio().shape == (31 * LN.RATE // 10, 1) for s in sinks)
    finally:
        tfx.set_virtual_devices(None)


def test_mesh_arguments_raise():
    """mesh= shards a bank's streams; a mesh that does not divide the
    stream count raises ValueError, as device_put does in the JAX bank."""
    tfx.set_virtual_devices(4)
    try:
        mesh = tstreams.make_stream_mesh()
        assert mesh.shape == {"stream": 4}
        for make in (tstreams.loudnorm_bank, tstreams.r128_bank, tstreams.echo_bank):
            with pytest.raises(ValueError, match="divisible by 4"):
                make(2, mesh=mesh)
            assert len(make(4, mesh=mesh).states) == 4
        rows = tbench.run(4, "echo", 0.1, 0.05, use_mesh=True, emit=None)
        assert rows and all(r["buffers"] > 0 for r in rows)
    finally:
        tfx.set_virtual_devices(None)


@pytest.mark.parametrize("chain", ["echo", "echo,loudnorm"])
def test_benchmark_reports_windows(chain):
    lines = []
    rows = tbench.run(2, chain, seconds=0.2, window=0.1, use_mesh=False, emit=lines.append)
    assert rows and all(r["buffers"] > 0 and r["realtime_x"] > 0 for r in rows)
    assert lines[0].startswith("# streams=2") and "device=cpu" in lines[0]
    assert all("buffers/sec" in line for line in lines[1:])
