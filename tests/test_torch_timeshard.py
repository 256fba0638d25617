"""One long stream's time axis sharded over a mesh (parallel/timeshard.py)
and `audioloudnorm time-shard=true` in both modes, on 8 CPU shards
(`set_virtual_devices(8)`) against the JAX package on its 8 virtual CPU
devices (tests/conftest.py).

Mirrors tests/test_timeshard.py (6) and tests/test_timeshard_streaming.py
(8) with their gates, each held by the port against its own unsharded path
and against the JAX package:

- sharded_fir: atol 1e-4 of np.convolve, the tap-1 case exactly;
- block loudness: rtol 1e-5;
- sharded_loudnorm_linear, 4.6 s F64: gain, loudness and samples within
  rtol 1e-12 of the unsharded linear computation;
- the sharded analysis: energies rtol 1e-9, peaks exact, the exit filter
  state rtol 1e-9 / atol 1e-18 of the sequential analyser;
- the streaming mode: rtol 1e-9 / atol 1e-12 of time-shard=false, and the
  linear mode's pinned divergence and WARNING;
- port against JAX: SAMPLE_TOL = 1e-9 a sample in F64 and 1e-9 of the
  energies (tests/test_torch_loudnorm.py's gate: the two analysers sum in
  other orders, ~1e-16 relative), 1e-6 of the FIR (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core import Buffer as JBuffer, Caps as JCaps
from gst_plugins_rs_tpu.ops import loudnorm as JLN
from gst_plugins_rs_tpu.ops.ebur128 import r128_add_full_subblocks as j_add
from gst_plugins_rs_tpu.parallel import timeshard as jts
from gst_plugins_rs_tpu_torch.core import SECOND, Buffer as TBuffer, Caps as TCaps, MessageType
from gst_plugins_rs_tpu_torch.ops import loudnorm as LN
from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128, loudness_global, r128_add_full_subblocks
from gst_plugins_rs_tpu_torch.parallel import timeshard as ts
from gst_plugins_rs_tpu_torch.parallel.mesh import gather
from gst_plugins_rs_tpu_torch.parallel.streams import make_stream_mesh
from torch_parity_helpers import port_on_cpu

RATE = 192_000
SAMPLE_TOL = 1e-9


@pytest.fixture(autouse=True)
def _eight_shards():
    with port_on_cpu():
        tfx.set_virtual_devices(8)
        try:
            yield
        finally:
            tfx.set_virtual_devices(None)


@pytest.fixture()
def mesh():
    return make_stream_mesh(8, axis="time")


@pytest.fixture()
def jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("time",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jput(x, jmesh):
    return jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("time")))


# ---------------------------------------------------------------------------
# tests/test_timeshard.py
# ---------------------------------------------------------------------------
def test_sharded_fir_matches_unsharded(mesh, jmesh):
    rng = np.random.RandomState(0)
    N, T = 8 * 1024, 33
    x = rng.uniform(-1, 1, N).astype(np.float32)
    h = rng.uniform(-1, 1, T).astype(np.float32)
    parts = ts.sharded_fir(_t(x), _t(h), mesh)
    assert len(parts) == 8 and all(p.shape == (1024,) for p in parts)
    y = gather(parts).numpy()
    np.testing.assert_allclose(y, np.convolve(x, h, mode="full")[:N], atol=1e-4)
    with jmesh:
        ref = np.asarray(jts.sharded_fir(_jput(x, jmesh), jnp.asarray(h), jmesh))
    np.testing.assert_allclose(y, ref, atol=1e-6)


def test_sharded_fir_tap1(mesh):
    x = np.arange(8 * 16, dtype=np.float32)
    y = gather(ts.sharded_fir(_t(x), _t(np.asarray([2.0], np.float32)), mesh)).numpy()
    np.testing.assert_allclose(y, 2.0 * x)


def test_sharded_block_loudness(mesh, jmesh):
    rng = np.random.RandomState(1)
    n100 = 64
    x = rng.uniform(-1, 1, 8 * n100 * 4).astype(np.float32)
    e = gather(ts.sharded_block_loudness(_t(x), mesh, n100)).numpy()
    np.testing.assert_allclose(e, np.sum(x.reshape(-1, n100) ** 2, axis=1), rtol=1e-5)
    with jmesh:
        ref = np.asarray(jts.sharded_block_loudness(_jput(x, jmesh), jmesh, n100))
    np.testing.assert_allclose(e, ref, rtol=1e-6)
    with pytest.raises(ValueError):
        ts.sharded_block_loudness(_t(x[:8 * 100]), mesh, n100)


def _signal(seconds, ch=2, seed=7, tail=0, amp=0.1):
    rng = np.random.RandomState(seed)
    n = int(seconds * RATE) + tail
    x = (rng.standard_normal((n, ch)) * amp).astype(np.float64)
    x[:, 0] *= np.sin(np.linspace(0.0, 40.0, n))
    return x


def _run(pkg, sig, time_shard, mode="streaming", messages=None):
    """appsrc ! audioloudnorm ! appsink over 100 ms F64 buffers; returns the
    output samples."""
    buffer_cls, caps_cls = (TBuffer, TCaps) if pkg is tfx else (JBuffer, JCaps)
    p = pkg.parse_launch("appsrc name=src ! audioloudnorm name=ln ! appsink name=sink")
    if time_shard:
        p.by_name("ln").set_property("time-shard", True)
        p.by_name("ln").set_property("time-shard-mode", mode)
    src = p.by_name("src")
    src.set_property("caps", caps_cls.builder("audio/x-raw", format="F64", rate=RATE,
                                              channels=sig.shape[1], layout="interleaved"))
    if messages is not None:
        p.bus.add_watch(messages.append)
    for i in range(0, sig.shape[0], 19200):
        chunk = sig[i:i + 19200]
        data = _t(chunk) if pkg is tfx else chunk
        src.push_buffer(buffer_cls(data, pts=i * SECOND // RATE, offset=i,
                                   duration=chunk.shape[0] * SECOND // RATE))
    src.end_of_stream()
    p.play_until_eos()
    return np.concatenate([np.asarray(s.buffer.data) for s in p.by_name("sink").samples], axis=0)


class TestShardedLoudnormLinear:
    def test_ops_parity_long_stream(self, mesh, jmesh):
        """4.6 s over 8 shards: gain, output samples and integrated loudness
        equal the unsharded linear computation, and the JAX package's."""
        ch = 2
        n100 = RATE // 10
        x = _signal(4.6, ch, tail=321)
        n = x.shape[0]
        nfull = (n // n100) * n100
        params = LN.loudnorm_params(-24.0, 7.0, -2.0, ch, torch.float64, "cpu")
        st = LN.loudnorm_init(params, ch, 0.0)
        st = st._replace(r128_in=r128_add_full_subblocks(st.r128_in, params.r128, _t(x[:nfull])))
        gain_ref = float(LN.linear_gain_from_global(st, params))
        gl_ref = float(loudness_global(st.r128_in, params.r128))
        stride = 8 * n100
        xp = np.zeros((-(-n // stride) * stride, ch))
        xp[:n] = x
        parts, gain, gl = ts.sharded_loudnorm_linear(_t(xp), params, mesh,
                                                     n_valid_sb=nfull // n100)
        assert len(parts) == 8
        np.testing.assert_allclose(float(gain), gain_ref, rtol=1e-12)
        np.testing.assert_allclose(float(gl), gl_ref, rtol=1e-12)
        y = gather(parts).numpy()
        np.testing.assert_allclose(y[:n], x * gain_ref, rtol=1e-12, atol=0)
        jparams = JLN.loudnorm_params(-24.0, 7.0, -2.0, ch, jnp.float64)
        with jmesh:
            jy, jgain, jgl = jts.sharded_loudnorm_linear(jnp.asarray(xp), jparams, jmesh,
                                                        n_valid_sb=nfull // n100)
        np.testing.assert_allclose(float(gain), float(jgain), rtol=1e-12)
        np.testing.assert_allclose(float(gl), float(jgl), rtol=1e-12)
        assert float(np.abs(y - np.asarray(jy)).max()) <= SAMPLE_TOL

    def test_element_parity_sub3s(self):
        """A stream under 3 s: the default element takes the linear path, so
        time-shard=true reproduces it sample for sample."""
        sig = _signal(0.53, ch=2, tail=321)
        ref = _run(tfx, sig, time_shard=False)
        sharded = _run(tfx, sig, time_shard=True, mode="linear")
        assert ref.shape == sharded.shape == sig.shape
        np.testing.assert_allclose(sharded, ref, rtol=1e-12, atol=0)
        jsharded = _run(jfx, sig, time_shard=True, mode="linear")
        assert float(np.abs(sharded - jsharded).max()) <= SAMPLE_TOL

    def test_element_long_stream_hits_target(self):
        """A 4.6 s mono stream through linear mode: the re-measured integrated
        loudness lands on the target."""
        sig = _signal(4.6, ch=1, seed=3, tail=321)
        out = _run(tfx, sig, time_shard=True, mode="linear")
        assert out.shape == sig.shape
        r128 = EbuR128(1, RATE, device="cpu")
        r128.add_frames(_t(out))
        assert abs(r128.loudness_global() + 24.0) < 1.0


# ---------------------------------------------------------------------------
# tests/test_timeshard_streaming.py
# ---------------------------------------------------------------------------
class TestShardedAnalysis:
    def test_energies_and_peaks_match(self, mesh, jmesh):
        ch, m = 2, 16
        params = LN.loudnorm_params(-24.0, 7.0, -2.0, ch, torch.float64, "cpu")
        x = _signal(m / 10.0, ch, seed=3)
        st = LN.loudnorm_init(params, ch, 0.0).r128_in
        seq = []
        for i in range(m):
            st = r128_add_full_subblocks(st, params.r128, _t(x[i * LN.FRAME:(i + 1) * LN.FRAME]))
            seq.append(float(st.subblocks[-1]))
        z0 = LN.loudnorm_init(params, ch, 0.0).r128_in.filt_z
        e, sp, fz = ts.sharded_kweight_frame_analysis(_t(x), z0, params, mesh, m)
        e, sp = gather(e).numpy(), gather(sp).numpy()
        np.testing.assert_allclose(e, seq, rtol=1e-9)
        np.testing.assert_allclose(sp, np.abs(x).reshape(m, LN.FRAME, ch).max(1), rtol=0, atol=0)
        np.testing.assert_allclose(fz.numpy(), st.filt_z.numpy(), rtol=1e-9, atol=1e-18)
        jparams = JLN.loudnorm_params(-24.0, 7.0, -2.0, ch, jnp.float64)
        jz0 = JLN.loudnorm_init(jparams, ch, 0.0, jnp.float64).r128_in.filt_z
        with jmesh:
            je, jsp, jfz = jts.sharded_kweight_frame_analysis(_jput(x, jmesh), jz0, jparams,
                                                              jmesh, m)
        np.testing.assert_allclose(e, np.asarray(je), rtol=SAMPLE_TOL)
        np.testing.assert_array_equal(sp, np.asarray(jsp))
        np.testing.assert_allclose(fz.numpy(), np.asarray(jfz), rtol=1e-9, atol=1e-18)

    def test_carried_entry_state(self, mesh):
        """Chunk 2's analysis continues chunk 1's filter state exactly (the
        A^(L*k) entry propagation)."""
        ch, m = 1, 8
        params = LN.loudnorm_params(-24.0, 7.0, -2.0, ch, torch.float64, "cpu")
        x = _signal(2 * m / 10.0, ch, seed=5)
        st0 = LN.loudnorm_init(params, ch, 0.0).r128_in
        st = r128_add_full_subblocks(st0, params.r128, _t(x))
        e1, _, fz1 = ts.sharded_kweight_frame_analysis(_t(x[:m * LN.FRAME]), st0.filt_z,
                                                       params, mesh, m)
        e2, _, fz2 = ts.sharded_kweight_frame_analysis(_t(x[m * LN.FRAME:]), fz1, params,
                                                       mesh, m)
        got = np.concatenate([gather(e1).numpy(), gather(e2).numpy()])
        np.testing.assert_allclose(got, st.subblocks[-16:].numpy(), rtol=1e-9)
        np.testing.assert_allclose(fz2.numpy(), st.filt_z.numpy(), rtol=1e-9, atol=1e-18)
        with pytest.raises(ValueError, match="not shardable"):
            ts.sharded_kweight_frame_analysis(_t(x[:12 * LN.FRAME]), st0.filt_z, params, mesh,
                                              12)


class TestStreamingShardElement:
    def test_sample_parity_6s(self):
        """6.5 s: the first frame, one full chunk, the leftover frames and
        the drain equal the default path, and the JAX element's."""
        sig = _signal(6.5, ch=2, seed=11)
        ref = _run(tfx, sig, time_shard=False)
        got = _run(tfx, sig, time_shard=True)
        assert ref.shape == got.shape == sig.shape
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        jgot = _run(jfx, sig, time_shard=True)
        assert float(np.abs(got - jgot).max()) <= SAMPLE_TOL

    def test_sample_parity_with_limiter_peaks(self, monkeypatch):
        """Loud ticks drive the limiter through attack, sustain and release;
        the sharded mode still equals the default path, one limiter step a
        frame (inner_frames_scan_pre runs L1 once a frame)."""
        sig = _signal(6.5, ch=2, seed=13, amp=0.05)
        for pos in range(RATE // 2, sig.shape[0] - 8, RATE):
            sig[pos:pos + 4] = 0.6
        ref = _run(tfx, sig, time_shard=False)
        calls = []
        real = LN.limiter_frame
        monkeypatch.setattr(LN, "limiter_frame", lambda *a: calls.append(1) or real(*a))
        got = _run(tfx, sig, time_shard=True)
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
        # the first frame, 35 inner frames (one chunk of 32 and 3 left) and
        # 29 drain steps (no partial frame): one limiter run a frame
        assert len(calls) == 1 + 35 + 29

    def test_bounded_memory_incremental_output(self):
        """Streaming mode emits output before EOS and never holds a first
        frame or a chunk in the adapter."""
        from gst_plugins_rs_tpu_torch.core import State

        p = tfx.parse_launch("appsrc name=src ! audioloudnorm name=ln ! appsink name=sink")
        ln = p.by_name("ln")
        ln.set_property("time-shard", True)
        ln.set_property("time-shard-mode", "streaming")
        src = p.by_name("src")
        sig = _signal(6.5, ch=1, seed=2)
        src.set_property("caps", TCaps.builder("audio/x-raw", format="F64", rate=RATE,
                                               channels=1, layout="interleaved"))
        sink = p.by_name("sink")
        max_adapter = 0
        p.set_state(State.PLAYING)
        for i in range(0, sig.shape[0], 19200):
            c = sig[i:i + 19200]
            src.push_buffer(TBuffer(_t(c), pts=i * SECOND // RATE, offset=i,
                                    duration=c.shape[0] * SECOND // RATE))
            p.run(max_iterations=4)
            if ln._state is not None:
                max_adapter = max(max_adapter, ln._state.adapter.available())
        assert len(sink.samples) > 0, "no output before EOS"
        src.end_of_stream()
        p.play_until_eos()
        assert 0 < max_adapter < max(3 * RATE, 8 * ln._TS_FRAMES_PER_DEV * LN.FRAME)

    def test_linear_mode_divergence_pinned(self):
        """time-shard-mode=linear on a 6.5 s stream differs from the
        streaming algorithm (one whole-stream gain): the documented
        divergence, pinned; the JAX element's linear output is the same."""
        sig = _signal(6.5, ch=1, seed=4)
        ref = _run(tfx, sig, time_shard=False)
        lin = _run(tfx, sig, time_shard=True, mode="linear")
        assert ref.shape == lin.shape
        assert float(np.abs(ref - lin).max()) > 1e-6
        jlin = _run(jfx, sig, time_shard=True, mode="linear")
        assert float(np.abs(lin - jlin).max()) <= SAMPLE_TOL

    def test_linear_mode_warns_past_3s(self):
        messages = []
        _run(tfx, _signal(3.5, ch=1, seed=6), time_shard=True, mode="linear",
             messages=messages)
        warns = [m for m in messages if m.type == MessageType.WARNING and m.structure is not None
                 and m.structure.name == "audioloudnorm-time-shard-linear"]
        assert len(warns) == 1

    def test_streaming_mode_no_warning(self):
        messages = []
        _run(tfx, _signal(3.5, ch=1, seed=6), time_shard=True, messages=messages)
        assert not [m for m in messages if m.type == MessageType.WARNING]


def test_jax_sequential_analysis_is_the_port_s():
    """The sequential analyser both packages' sharded analysis is held to
    agrees across the packages (the energies of 8 frames)."""
    ch = 2
    x = _signal(0.8, ch, seed=9)
    params = LN.loudnorm_params(-24.0, 7.0, -2.0, ch, torch.float64, "cpu")
    jparams = JLN.loudnorm_params(-24.0, 7.0, -2.0, ch, jnp.float64)
    st = r128_add_full_subblocks(LN.loudnorm_init(params, ch, 0.0).r128_in, params.r128, _t(x))
    jst = j_add(JLN.loudnorm_init(jparams, ch, 0.0, jnp.float64).r128_in, jparams.r128,
                jnp.asarray(x))
    np.testing.assert_allclose(st.subblocks[-8:].numpy(), np.asarray(jst.subblocks[-8:]),
                               rtol=SAMPLE_TOL)
