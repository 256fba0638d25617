"""The port's single-process device mesh (parallel/mesh.py), the sharded
stream banks, the merged loudness and `loudnormbank shard=true`, on 8 CPU
shards (`set_virtual_devices(8)`) against the JAX package on its 8 virtual
CPU devices (tests/conftest.py).

Mirrors tests/test_parallel.py::test_mesh_sharded_bank, the three tests of
tests/test_merged_loudness.py and tests/test_loudnormbank.py::
test_sharded_mesh_matches_unsharded, and runs the seven serving stages of
`__graft_entry__.dryrun_multichip` through the port.  Gates:

- the sharded echo bank: bit-equal to the unsharded port bank (the same f32
  operations on each stream's slice), within ECHO_TOL = 1e-7 of the JAX
  sharded bank (tests/test_torch_parallel.py's echo gate);
- the sharded loudnorm bank against the unsharded one: within 1e-6 a
  sample, the JAX test's own atol (the K-filter products of a shard's
  columns summed in another order than the whole bank's);
- merged and per-stream loudness: the JAX tests' bounds, and within
  LUFS_TOL = 1e-4 LU of the JAX package (tests/test_torch_parallel.py);
- loudnormbank shard=true against the JAX element shard=true: within
  JAX_F32_TOL = 1e-4 a sample, the F32 element gate of
  tests/test_torch_parallel.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.parallel import streams as jstreams
from gst_plugins_rs_tpu_torch.ops import loudnorm as LN
from gst_plugins_rs_tpu_torch.parallel import benchmark as tbench
from gst_plugins_rs_tpu_torch.parallel import mesh as M
from gst_plugins_rs_tpu_torch.parallel import streams as tstreams
from torch_parity_helpers import port_on_cpu

ECHO_TOL = 1e-7
SHARD_TOL = 1e-6
LUFS_TOL = 1e-4
JAX_F32_TOL = 1e-4
RATE = 48000


@pytest.fixture(autouse=True)
def _eight_shards():
    with port_on_cpu():
        tfx.set_virtual_devices(8)
        try:
            yield
        finally:
            tfx.set_virtual_devices(None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------
def test_visible_devices_cycle_over_the_real_ones():
    devs = tfx.visible_devices()
    assert devs == [torch.device("cpu")] * 8
    tfx.set_virtual_devices(None)
    assert tfx.visible_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        tfx.set_virtual_devices(0)
    mesh = tstreams.make_stream_mesh()
    assert mesh.shape == {"stream": 1} and mesh.axis_names == ("stream",)


def test_collectives():
    mesh = tstreams.make_stream_mesh(4, axis="x")
    assert mesh.shape == {"x": 4} and M.axis_index(mesh) == [0, 1, 2, 3]
    x = torch.arange(8.0).reshape(4, 2)
    parts = M.shard(x, mesh)
    assert [p.tolist() for p in parts] == [[[0.0, 1.0]], [[2.0, 3.0]], [[4.0, 5.0]], [[6.0, 7.0]]]
    assert torch.equal(M.gather(parts), x)
    with pytest.raises(ValueError, match="divisible by 4"):
        M.shard(torch.zeros(6), mesh)
    # a ring to the next shard, and a partial permutation: zeros where no
    # shard sends
    ring = M.ppermute(parts, [(i, (i + 1) % 4) for i in range(4)])
    assert [float(p[0, 0]) for p in ring] == [6.0, 0.0, 2.0, 4.0]
    half = M.ppermute(parts, [(0, 1)])
    assert [float(p.abs().sum()) for p in half] == [0.0, 1.0, 0.0, 0.0]
    gathered = M.all_gather(parts)
    assert all(torch.equal(g[:, 0], x) for g in gathered)
    assert all(torch.equal(s, x.sum(0, keepdim=True)) for s in M.psum(parts))
    assert all(torch.equal(m, x.amax(0, keepdim=True)) for m in M.pmax(parts))
    # shards on one device share the replicated result (the aliasing rule)
    assert gathered[0] is gathered[3]
    assert all(torch.equal(r, x) for r in M.replicate(x, mesh))


# ---------------------------------------------------------------------------
# tests/test_parallel.py::test_mesh_sharded_bank
# ---------------------------------------------------------------------------
def test_mesh_sharded_bank():
    mesh = tstreams.make_stream_mesh(8)
    bank = tstreams.echo_bank(16, mesh=mesh)
    xs = np.random.RandomState(1).uniform(-1, 1, (16, 9600)).astype(np.float32)
    out = bank.process(bank.shard(_t(xs)))
    assert out.shape == (16, 9600)
    # the states live sharded over the mesh: 2 streams a shard
    assert len(bank.states) == 8 and all(s.shape[0] == 2 for s in bank.states)
    plain = tstreams.echo_bank(16).process(_t(xs))
    assert torch.equal(out, plain)
    jmesh = jstreams.make_stream_mesh(8)
    jbank = jstreams.echo_bank(16, mesh=jmesh)
    ref = np.asarray(jbank.process(jbank.shard(jnp.asarray(xs))))
    assert float(np.abs(out.numpy() - ref).max()) <= ECHO_TOL
    out2 = bank.process(_t(xs))  # the state advances shard by shard
    ref2 = np.asarray(jbank.process(jbank.shard(jnp.asarray(xs))))
    assert float(np.abs(out2.numpy() - ref2).max()) <= ECHO_TOL


@pytest.mark.parametrize("streams", [5, 12])
def test_bank_streams_must_divide_the_mesh(streams):
    """The JAX bank raises ValueError when the mesh does not divide the
    stream count (device_put of the states); so does the port's."""
    with pytest.raises(ValueError, match="divisible by 8"):
        jstreams.echo_bank(streams, mesh=jstreams.make_stream_mesh(8))
    for make in (tstreams.echo_bank, tstreams.loudnorm_bank, tstreams.r128_bank):
        with pytest.raises(ValueError, match="divisible by 8"):
            make(streams, mesh=tstreams.make_stream_mesh(8))


def test_sharded_loudnorm_bank_runs_a_step_per_shard(monkeypatch):
    """Each shard advances its slice of the streams with the batched step:
    one limiter call per shard a tick (one L1 launch per shard on the
    card); the output equals the unsharded bank's within SHARD_TOL."""
    rng = np.random.RandomState(7)
    first = rng.uniform(-0.3, 0.3, (8, LN.GAIN_LOOKAHEAD, 2)).astype(np.float32)
    frames = rng.uniform(-0.3, 0.3, (8, 2, LN.FRAME, 2)).astype(np.float32)
    plain = tstreams.loudnorm_bank(8, channels=2)
    ref = [plain.first_frame(_t(first))] + [plain.process(_t(frames[:, k])) for k in range(2)]
    calls = []
    real = LN.limiter_frames
    monkeypatch.setattr(LN, "limiter_frames", lambda w, *a: calls.append(w.shape[0]) or
                        real(w, *a))
    bank = tstreams.loudnorm_bank(8, channels=2, mesh=tstreams.make_stream_mesh(4))
    got = [bank.first_frame(_t(first))] + [bank.process(_t(frames[:, k])) for k in range(2)]
    assert calls == [2] * 12  # 4 shards x (first frame + 2 ticks), 2 streams each
    for k, (g, r) in enumerate(zip(got, ref)):
        assert float((g - r).abs().max()) <= SHARD_TOL, k


# ---------------------------------------------------------------------------
# tests/test_merged_loudness.py
# ---------------------------------------------------------------------------
def _sig(amp, secs, ch=1):
    t = np.arange(int(secs * RATE)) / RATE
    return np.repeat((amp * np.sin(2 * np.pi * 997.0 * t))[:, None], ch, axis=1)


def _both(x, n, mesh=False):
    """(port bank, JAX bank) of n mono analysers fed x [n, k, 1]."""
    tb = tstreams.r128_bank(n, channels=1, rate=RATE,
                            mesh=tstreams.make_stream_mesh(8) if mesh else None)
    tb.add_frames(_t(x))
    jmesh = jstreams.make_stream_mesh(8) if mesh else None
    jb = jstreams.r128_bank(n, channels=1, rate=RATE, mesh=jmesh)
    if mesh:
        with jmesh:
            jb.add_frames(jnp.asarray(x))
    else:
        jb.add_frames(jnp.asarray(x))
    return tb, jb


def test_merged_equals_per_stream_for_identical_streams():
    x = np.repeat(_sig(0.5, 2.0)[None], 4, axis=0).astype(np.float32)
    tb, jb = _both(x, 4)
    per, merged = tb.per_stream_loudness(), tb.merged_loudness()
    assert np.allclose(per, per[0])
    assert merged == pytest.approx(float(per[0]), abs=0.05)
    assert abs(merged + 9.0) < 0.2
    assert abs(merged - jb.merged_loudness()) <= LUFS_TOL
    assert float(np.abs(per - jb.per_stream_loudness()).max()) <= LUFS_TOL


def test_merged_pools_gated_blocks():
    x = np.stack([_sig(0.5, 2.0), _sig(0.05, 2.0)]).astype(np.float32)
    tb, jb = _both(x, 2)
    per, merged = tb.per_stream_loudness(), tb.merged_loudness()
    assert per[0] > per[1]
    assert merged == pytest.approx(float(per[0]), abs=0.2)
    assert abs(merged - jb.merged_loudness()) <= LUFS_TOL
    x2 = np.stack([_sig(0.5, 2.0), _sig(0.25, 2.0)]).astype(np.float32)
    tb2, jb2 = _both(x2, 2)
    p2, m2 = tb2.per_stream_loudness(), tb2.merged_loudness()
    assert p2[1] + 0.1 < m2 < p2[0] + 0.1
    assert abs(m2 - jb2.merged_loudness()) <= LUFS_TOL


def test_merged_on_mesh_sharded_bank(monkeypatch):
    """8 streams over 8 shards: the merged loudness is the psum of the
    shards' histograms."""
    psums = []
    real = M.psum
    monkeypatch.setattr(M, "psum", lambda parts: psums.append(len(parts)) or real(parts))
    x = np.repeat(_sig(0.25, 1.0)[None], 8, axis=0).astype(np.float32)
    tb, jb = _both(x, 8, mesh=True)
    merged = tb.merged_loudness()
    assert len(tb.states) == 8 and all(s.block_hist.shape[0] == 1 for s in tb.states)
    assert psums == [8]
    assert abs(merged - (-9.0 - 6.02)) < 0.2  # a 0.25 sine ~ -15 LUFS
    assert abs(merged - jb.merged_loudness()) <= LUFS_TOL
    assert float(np.abs(tb.per_stream_loudness() - jb.per_stream_loudness()).max()) <= LUFS_TOL


# ---------------------------------------------------------------------------
# tests/test_loudnormbank.py::test_sharded_mesh_matches_unsharded
# ---------------------------------------------------------------------------
def _run_bank(pkg, n_streams, shard, volumes, nbuf=34):
    p = pkg.Pipeline()
    bank = pkg.element_factory_make("loudnormbank")
    bank.set_property("shard", shard)
    p.add(bank)
    sinks = []
    for i in range(n_streams):
        src = pkg.element_factory_make("audiotestsrc")
        for k, v in {"wave": "sine", "freq": 440.0 + 100 * i, "volume": volumes[i],
                     "samplesperbuffer": LN.RATE // 10, "num-buffers": nbuf}.items():
            src.set_property(k, v)
        cf = pkg.element_factory_make("capsfilter")
        cf.set_property("caps", pkg.parse_caps(f"audio/x-raw,format=F32,rate={LN.RATE},channels=1"))
        sink = pkg.element_factory_make("appsink")
        for e in (src, cf, sink):
            p.add(e)
        src.link(cf)
        cf.pad("src").link(bank.request_sink_pad())
        bank.pad(f"src_{i}").link(sink.pad("sink"))
        sinks.append(sink)
    p.play_until_eos()
    return bank, [np.asarray(s.concat_audio()) for s in sinks]


def test_sharded_mesh_matches_unsharded():
    vols = [0.8, 0.25, 0.5, 0.1, 0.9, 0.3, 0.6, 0.45]
    _, plain = _run_bank(tfx, 8, False, vols)
    bank, sharded = _run_bank(tfx, 8, True, vols)
    assert bank._mesh is not None and bank._mesh.size == 8
    _, jsharded = _run_bank(jfx, 8, True, vols)
    for i, (a, b, j) in enumerate(zip(plain, sharded, jsharded)):
        assert a.shape == b.shape == j.shape == (34 * LN.RATE // 10, 1), i
        assert float(np.abs(a - b).max()) <= SHARD_TOL, i
        assert float(np.abs(b - j).max()) <= JAX_F32_TOL, i
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    r = EbuR128(1, LN.RATE, dtype=torch.float32, device="cpu")
    r.add_frames(_t(sharded[1]))
    assert abs(r.loudness_global() + 24.0) < 1.0


def test_benchmark_mesh_shards_the_banks():
    lines = []
    rows = tbench.run(8, "echo,loudnorm", seconds=0.2, window=0.1, use_mesh=True,
                      emit=lines.append)
    assert rows and all(r["buffers"] > 0 for r in rows)
    assert lines[0].startswith("# streams=8") and "mesh=8" in lines[0]


# ---------------------------------------------------------------------------
# __graft_entry__.dryrun_multichip's serving stages, through the port on 8
# CPU shards (its YOLOX training step belongs to the training scripts)
# ---------------------------------------------------------------------------
def _stage_media():
    """Streams sharded over the mesh through the echo step, the energy
    psum'd over the shards."""
    from gst_plugins_rs_tpu_torch.ops.echo import echo_apply_flat

    mesh = tstreams.make_stream_mesh()
    rng = np.random.RandomState(0)
    xs = _t(rng.uniform(-1, 1, (16, 512)).astype(np.float32))
    hist = torch.zeros(16, 1024)
    done = [echo_apply_flat(x, h, 0.5, 0.3, lag=1024)
            for x, h in zip(M.shard(xs, mesh), M.shard(hist, mesh))]
    total = M.psum([(o * o).sum() for o, _ in done])[0]
    ref, _ = echo_apply_flat(xs, hist, 0.5, 0.3, lag=1024)
    assert M.gather([o for o, _ in done]).shape == (16, 512)
    assert float(total) == pytest.approx(float((ref * ref).sum()), rel=1e-6)


def _stage_r128_psum():
    bank = tstreams.r128_bank(16, channels=1, rate=48000, mesh=tstreams.make_stream_mesh())
    t = np.arange(48000) / 48000.0
    bank.add_frames(_t(np.repeat((0.5 * np.sin(2 * np.pi * 997.0 * t))[None, :, None], 16,
                                 axis=0).astype(np.float32)))
    assert abs(bank.merged_loudness() + 9.0) < 1.0


def _stage_loudnormbank():
    bank, outs = _run_bank(tfx, 8, True, [0.1 + 0.8 * i / 8 for i in range(8)], nbuf=31)
    assert all(o.shape[0] == 31 * (LN.RATE // 10) for o in outs)
    assert bank._mesh.size == 8


def _push_one(launch, sig, frames_per_dev=None):
    from gst_plugins_rs_tpu_torch.core import SECOND, Buffer, Caps

    p = tfx.parse_launch(launch)
    if frames_per_dev is not None:
        p.by_name("ln")._TS_FRAMES_PER_DEV = frames_per_dev
    src = p.by_name("src")
    src.set_property("caps", Caps.builder("audio/x-raw", format="F32", rate=LN.RATE,
                                          channels=1, layout="interleaved"))
    src.push_buffer(Buffer(_t(sig), pts=0, duration=sig.shape[0] * SECOND // LN.RATE))
    src.end_of_stream()
    p.play_until_eos()
    return p, p.by_name("sink").concat_audio()


def _stage_time_shard_linear():
    n = 8 * LN.RATE // 10  # one subblock a shard: the all_gather halo
    sig = (0.3 * np.random.RandomState(1).standard_normal((n, 1))).astype(np.float32)
    _, out = _push_one("appsrc name=src ! audioloudnorm time-shard=true "
                       "time-shard-mode=linear ! appsink name=sink", sig)
    assert out.shape == (n, 1) and np.isfinite(out).all()


def _stage_time_shard_streaming():
    n = 3 * LN.RATE + 2 * 8 * LN.FRAME  # the first frame and two chunks
    sig = (0.25 * np.random.RandomState(2).standard_normal((n, 1))).astype(np.float32)
    launch = "appsrc name=src ! audioloudnorm name=ln time-shard=true ! appsink name=sink"
    _, out = _push_one(launch, sig, frames_per_dev=1)  # one 100 ms frame a shard a chunk
    _, ref = _push_one(launch.replace(" time-shard=true", ""), sig)
    assert out.shape == (n, 1)
    assert float(np.abs(out - ref).max()) <= JAX_F32_TOL


def _stage_yolox_data():
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import TensorMeta

    launch = []
    for i in range(8):
        launch.append("videotestsrc pattern=smpte num-buffers=2 "
                      "! video/x-raw,format=RGB,width=64,height=64,framerate=10/1 "
                      + ("! analyticscombiner name=comb batch-duration=100000000 "
                         "! yoloxinference name=det model-type=nano shard=true "
                         "! analyticssplitter name=vsplit" if i == 0 else "! comb."))
    p = tfx.parse_launch(" ".join(launch))
    sinks = []
    for i in range(8):
        sink = tfx.element_factory_make("appsink", f"vout{i}")
        p.add(sink)
        p.by_name("vsplit")._get_src(i).link(sink.sinkpad)
        sinks.append(sink)
    det = p.by_name("det")
    meshes = []
    run = det._transform_batch
    det._transform_batch = lambda buf: meshes.append(det._mesh) or run(buf)
    p.play_until_eos()
    assert meshes and all(m is not None and m.size == 8 for m in meshes)
    for sink in sinks:
        assert len(sink.samples) == 2
        assert all(s.buffer.get_meta(TensorMeta) is not None for s in sink.samples)


def _stage_yolox_tensor():
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
    from gst_plugins_rs_tpu_torch.parallel.modelparallel import apply_tp

    mesh = M.Mesh(tfx.visible_devices(), ("tp",))
    model = init_weights(Yolox.from_variant("l", num_classes=4), seed=0)
    x = _t(np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3)).astype(np.uint8))
    out, sharded = apply_tp(model, model.state_dict(), x, mesh)
    k = sharded["backbone.backbone.dark3.conv.conv.weight"]
    assert out.shape == (1, 84, 9) and torch.isfinite(out).all()
    assert len(k) == 8 and {tuple(p.shape) for p in k} == {(256 // 8, 128, 3, 3)}


@pytest.mark.parametrize("stage", [
    _stage_media, _stage_r128_psum, _stage_loudnormbank, _stage_time_shard_linear,
    _stage_time_shard_streaming, _stage_yolox_data, _stage_yolox_tensor,
], ids=lambda f: f.__name__[7:])
def test_dryrun_multichip_serving_stage(stage):
    stage()
