"""Tensor-parallel YOLOX (parallel/modelparallel.py), yoloxinference
`shard=true` in both modes, and the build-time route of dark2's C3
(models/yolox_fast.py `c3_route`), on 8 CPU shards (`set_virtual_devices(8)`)
against the JAX package on its 8 virtual CPU devices (tests/conftest.py).

Mirrors tests/test_model_parallel.py (4: YOLOX-s at 64x64, 8 classes) and
tests/test_yolox_batch_shard.py (3: YOLOX-nano, 64x64).  Weights are made
with numpy from a seed and given to both packages (the element tests load
them from one official-style checkpoint through `weights-path`).  Gates:

- the tensor-parallel forward against the single-device forward: rtol and
  atol 2e-4 (tests/test_model_parallel.py), in both packages;
- port against JAX: |d| / (|ref| + 1e-2) < 1e-3, the YOLOX parity gate of
  tests/test_torch_yolox.py (f32 sums in another order through ~60 convs);
- the sharded batch against the single-frame path: rtol 2e-4, atol 2e-5
  (tests/test_yolox_batch_shard.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.models.yolox import Yolox as JYolox
from gst_plugins_rs_tpu.parallel import modelparallel as jmp
from gst_plugins_rs_tpu_torch.elements.analytics.meta import TensorMeta
from gst_plugins_rs_tpu_torch.models.yolox import VARIANTS, Yolox
from gst_plugins_rs_tpu_torch.models.yolox_fast import FastEngine, c3_route
from gst_plugins_rs_tpu_torch.ops.yolox_c3 import c3_smem_bytes, fused_tile
from gst_plugins_rs_tpu_torch.parallel import modelparallel as tmp
from gst_plugins_rs_tpu_torch.parallel.mesh import Mesh
from torch_parity_helpers import (
    official_checkpoint, port_on_cpu, port_state, random_variables, rel_err, to_jax)

SIZE = 64
CLASSES = 8


@pytest.fixture(autouse=True)
def _eight_shards():
    with port_on_cpu():
        tfx.set_virtual_devices(8)
        try:
            yield
        finally:
            tfx.set_virtual_devices(None)


def _mesh():
    return Mesh(tfx.visible_devices(), ("tp",))


def _jmesh():
    return JMesh(np.array(jax.devices()[:8]), ("tp",))


_PAIRS = {}


def _pair(variant="s", classes=CLASSES):
    """(flax model, its variables, port model with the same weights, frames)."""
    if (variant, classes) not in _PAIRS:
        v = to_jax(random_variables(variant, seed=0, num_classes=classes))
        tm = Yolox.from_variant(variant, num_classes=classes)
        tm.load_state_dict(port_state(v))
        x = np.random.RandomState(0).randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
        _PAIRS[(variant, classes)] = (JYolox.from_variant(variant, num_classes=classes), v, tm, x)
    return _PAIRS[(variant, classes)]


# ---------------------------------------------------------------------------
# tests/test_model_parallel.py
# ---------------------------------------------------------------------------
def test_tp_shardings_partition_conv_channels():
    jm, v, tm, _ = _pair()
    specs = tmp.yolox_tp_shardings(tm.state_dict(), _mesh())
    kernels = [(t.shape, specs[k]) for k, t in tm.state_dict().items() if t.dim() == 4]
    sharded = [spec for shape, spec in kernels if shape[0] % 8 == 0]
    assert sharded and all(spec == ("tp", None, None, None) for spec in sharded)
    assert all(spec == () for shape, spec in kernels if shape[0] % 8)
    assert len(sharded) >= 0.9 * len(kernels)
    # the JAX package shards the same kernels (HWIO output axis 3) and as
    # many per-channel vectors
    jsh = jmp.yolox_tp_shardings(v, _jmesh())
    leaves = list(zip(jax.tree_util.tree_leaves(v), jax.tree_util.tree_leaves(jsh)))
    jk = [s.spec for leaf, s in leaves if np.ndim(leaf) == 4]
    assert len(jk) == len(kernels)
    assert sum(s == P(None, None, None, "tp") for s in jk) == len(sharded)
    jvec = sum(s.spec == P("tp") for leaf, s in leaves if np.ndim(leaf) == 1)
    assert jvec == sum(spec == ("tp",) for spec in specs.values())


def test_tp_forward_parity_with_single_device():
    """The tensor-parallel forward equals the single-device forward, and
    the JAX package's tensor-parallel forward."""
    jm, v, tm, x = _pair()
    with torch.no_grad():
        ref = tm(torch.from_numpy(x))
    out, sharded = tmp.apply_tp(tm, tm.state_dict(), torch.from_numpy(x), _mesh())
    assert out.shape == ref.shape == (2, 84, 5 + CLASSES)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    again, _ = tmp.apply_tp(tm, sharded, torch.from_numpy(x), _mesh(), shard_variables=False)
    assert torch.equal(again, out)
    jout, _ = jmp.apply_tp(jm, v, jnp.asarray(x), _jmesh())
    assert rel_err(np.asarray(jout), out.numpy()) < 1e-3


def test_tp_weights_are_actually_distributed():
    """Each shard holds 1/8 of a channel-sharded kernel, not a replica."""
    _, _, tm, _ = _pair()
    sharded = tmp.shard_yolox_variables(tm.state_dict(), _mesh())
    k = sharded["backbone.backbone.dark3.conv.conv.weight"]
    full = tm.state_dict()["backbone.backbone.dark3.conv.conv.weight"]
    assert len(k) == 8 and {tuple(p.shape) for p in k} == {(full.shape[0] // 8,) + tuple(full.shape[1:])}
    assert torch.equal(torch.cat(k), full)
    # the 4-channel box prediction does not divide 8: replicated
    reg = sharded["head.reg_preds_0.weight"]
    assert all(torch.equal(p, reg[0]) for p in reg) and reg[0].shape[0] == 4


def test_tp_element_surface():
    det = tfx.element_factory_make("yoloxinference")
    assert det.get_property("shard-mode") == "data"
    det.set_property("shard-mode", "tensor")
    assert det.get_property("shard-mode") == "tensor"


# ---------------------------------------------------------------------------
# tests/test_yolox_batch_shard.py
# ---------------------------------------------------------------------------
def _run(pkg, n_streams, props, num_buffers=2, variant="nano"):
    launch = []
    for i in range(n_streams):
        launch.append(
            f"videotestsrc pattern=smpte num-buffers={num_buffers} "
            f"! video/x-raw,format=RGB,width={SIZE},height={SIZE},framerate=10/1 "
            + ("! analyticscombiner name=comb batch-duration=100000000 "
               f"! yoloxinference name=det model-type={variant} {props} "
               "! analyticssplitter name=split" if i == 0 else "! comb."))
    p = pkg.parse_launch(" ".join(launch))
    sinks = []
    for i in range(n_streams):
        sink = pkg.element_factory_make("appsink", f"out{i}")
        p.add(sink)
        p.by_name("split")._get_src(i).link(sink.sinkpad)
        sinks.append(sink)
    p.play_until_eos()
    return sinks


def _tensors(sink, meta=TensorMeta):
    return [np.asarray(next(iter(s.buffer.iter_meta(meta))).tensors[0].data)
            for s in sink.samples]


@pytest.mark.parametrize("shard", [False, True])
def test_batched_inference_attaches_meta_per_stream(shard):
    for sink in _run(tfx, 3, f"shard={'true' if shard else 'false'}"):
        assert len(sink.samples) == 2
        for sample in sink.samples:
            metas = [m for m in sample.buffer.metas if isinstance(m, TensorMeta)]
            assert len(metas) == 1
            t = metas[0].tensors[0]
            assert t.id == "yolox-out" and t.dims[0] == 1 and t.dims[2] == 85


def test_sharded_matches_single_frame_path():
    """The same weights and frame: the batch over the mesh (2 frames padded
    to 8 shards) equals the plain per-frame path."""
    batched = _tensors(_run(tfx, 2, "shard=true", num_buffers=1)[0])[0]
    p = tfx.parse_launch(f"videotestsrc pattern=smpte num-buffers=1 "
                         f"! video/x-raw,format=RGB,width={SIZE},height={SIZE},framerate=10/1 "
                         "! yoloxinference model-type=nano ! appsink name=out")
    p.play_until_eos()
    single = _tensors(p.by_name("out"))[0]
    assert batched.shape == single.shape
    np.testing.assert_allclose(batched, single, rtol=2e-4, atol=2e-5)


def test_shard_spans_all_devices():
    det = tfx.element_factory_make("yoloxinference")
    det.set_property("shard", True)
    det.start()
    assert det._mesh is not None and det._mesh.devices == tfx.visible_devices()
    assert det._mesh.size == len(jax.devices()) == 8
    det.stop()


@pytest.mark.parametrize("mode,variant", [("data", "nano"), ("data", "tiny"), ("tensor", "s")])
def test_sharded_element_matches_jax(tmp_path, mode, variant):
    """yoloxinference shard=true against the JAX element, both on 8 devices
    and both loading one seeded checkpoint: data mode on nano (the reference
    graph) and tiny (the s2d engine), tensor mode on s."""
    path = str(official_checkpoint(random_variables(variant, seed=2), tmp_path / "w.pth"))
    props = f"shard=true shard-mode={mode} weights-path={path}"
    got = [_tensors(s) for s in _run(tfx, 3, props, variant=variant)]
    from gst_plugins_rs_tpu.elements.analytics.meta import TensorMeta as JTensorMeta

    ref = [_tensors(s, JTensorMeta) for s in _run(jfx, 3, props, variant=variant)]
    for g, r in zip(got, ref):
        assert len(g) == len(r) == 2
        for a, b in zip(g, r):
            assert a.shape == b.shape == (1, 84, 85)
            assert rel_err(b, a) < 1e-3


# ---------------------------------------------------------------------------
# The C3 route (ROADMAP section C.1): chosen when the engine is built
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_c3_route_across_the_zoo(variant):
    """By c3_smem_bytes, dark2's C3 fits one block of B1 in every zoo model
    and dtype but YOLOX-x in bf16, which takes the per-conv chain; depthwise
    nano runs the reference graph."""
    with torch.device("meta"):
        model = Yolox.from_variant(variant)
    for dtype in (torch.float32, torch.bfloat16):
        want = ("reference" if variant == "nano" else
                "per-conv" if (variant, dtype) == ("x", torch.bfloat16) else "fused")
        assert c3_route(model, dtype, fuse_c3=True) == want, (variant, dtype)
        assert c3_route(model, dtype, fuse_c3=False) in ("reference", "per-conv")
    if variant == "x":
        # csrc/yolox_c3.cu `Bf16Smem` at tile 2: 246,464 B > 232,448 B
        assert c3_smem_bytes(True, 160, 80, 4, 2) == 246_464
        assert fused_tile(True, 160, 80, 4) is None and fused_tile(False, 160, 80, 4) == 8


@pytest.mark.parametrize("engine", ["fast-bf16", "precision-bf16"])
def test_yolox_x_bf16_runs_the_per_conv_c3(engine):
    """YOLOX-x in bf16, both routes to it: the engine takes the per-conv C3
    when built with fuse_c3 (as the element does on CUDA), the same
    computation as fuse_c3=False; YOLOX-x in f32 and tiny in bf16 keep the
    fused route."""
    from gst_plugins_rs_tpu_torch.models.yolox import init_weights

    kw = (dict(s2d_dtype=torch.bfloat16) if engine == "fast-bf16"
          else dict(dtype=torch.bfloat16))
    model = init_weights(Yolox.from_variant("x"), seed=0)
    state = model.state_dict()
    fused = FastEngine(model, state, fuse_c3=True, **kw)
    plain = FastEngine(model, state, fuse_c3=False, **kw)
    assert fused.c3_route == plain.c3_route == "per-conv"
    x = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (1, SIZE, SIZE, 3))
                         .astype(np.uint8))
    out = fused(x)
    assert out.shape == (1, 84, 85) and torch.isfinite(out).all()
    assert torch.equal(out, plain(x))
    assert FastEngine(model, state, fuse_c3=True).c3_route == "fused"
    tiny = Yolox.from_variant("tiny")
    assert FastEngine(tiny, tiny.state_dict(), fuse_c3=True, **kw).c3_route == "fused"
