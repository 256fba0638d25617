"""Kernel B1 of the PyTorch port (ops/yolox_c3.py) against the JAX package.

On the CPU the port's `c3_s2d_fused` (the TPU kernel's dense s2d operands)
and `c3_s2d_fused_compact` (the compact operands the engine passes) run the
plain PyTorch version; both are held against the JAX Pallas kernel
(interpret mode) and the JAX per-conv `_c3_s2d`, on the same inputs made
with numpy.  The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances: f32 max abs error < 1e-4 (the same f32 products summed in
another order), as tests/test_yolox_c3_pallas.py; bf16 relative error
|d| / (|ref| + 0.1) < 0.05, as there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.models import yolox_fast as jyf
from gst_plugins_rs_tpu.ops.pallas_yolox_c3 import c3_s2d_fused as jax_c3_fused

from gst_plugins_rs_tpu_torch import requested_device, set_device
from gst_plugins_rs_tpu_torch.models import yolox_fast as tyf
from gst_plugins_rs_tpu_torch.models.convert import variables_from_jax
from gst_plugins_rs_tpu_torch.ops import yolox_c3
from torch_parity_helpers import to_numpy


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = requested_device()
    set_device("cpu")
    yield
    set_device(prev)


def _random_c3(rng, c4, hidden, n):
    """A C3 param/stat tree in the flax layout (normal domain: c4//4 in,
    hidden//4 hidden), as numpy arrays."""
    def conv_bn(ci, co, k):
        return (
            {"conv": {"kernel": (rng.randn(k, k, ci, co) * 0.2).astype(np.float32)},
             "bn": {"scale": (1.0 + 0.1 * rng.randn(co)).astype(np.float32),
                    "bias": (0.1 * rng.randn(co)).astype(np.float32)}},
            {"bn": {"mean": (0.05 * rng.randn(co)).astype(np.float32),
                    "var": (1.0 + 0.1 * rng.rand(co)).astype(np.float32)}},
        )

    ci, h = c4 // 4, hidden // 4
    params, stats = {}, {}
    params["conv1"], stats["conv1"] = conv_bn(ci, h, 1)
    params["conv2"], stats["conv2"] = conv_bn(ci, h, 1)
    for i in range(n):
        p1, s1 = conv_bn(h, h, 1)
        p2, s2 = conv_bn(h, h, 3)
        params[f"m_{i}"] = {"conv1": p1, "conv2": p2}
        stats[f"m_{i}"] = {"conv1": s1, "conv2": s2}
    params["conv3"], stats["conv3"] = conv_bn(2 * h, ci, 1)
    return params, stats


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _case(seed, n, hw, c4=32, hidden=16, batch=2):
    rng = np.random.RandomState(seed)
    params, stats = _random_c3(rng, c4, hidden, n)
    y = rng.randn(batch, hw[0], hw[1], c4).astype(np.float32)
    # the port's state_dict under a "c3" prefix, through the weight carrier
    state = variables_from_jax({"c3": params}, {"c3": stats})
    return _jax_tree(params), _jax_tree(stats), state, y


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_fused_matches_jax_kernel_and_xla_c3(n, hw):
    jp, js, _, y = _case(11 + n, n, hw)
    H, W = hw
    wts = jyf._c3_fused_weights(jp, js, n)
    ref_kernel = np.asarray(jax_c3_fused(jnp.asarray(y), **wts, width=W, n=n, interpret=True))
    ref_xla = np.asarray(jyf._c3_s2d(jp, js, jnp.asarray(y), n))
    before = yolox_c3.launches
    got = yolox_c3.c3_s2d_fused(torch.from_numpy(y), width=W, n=n,
                                **{k: torch.from_numpy(np.array(v)) for k, v in wts.items()})
    assert yolox_c3.launches == before  # a CPU tensor runs the plain version
    assert got.shape == y.shape and got.dtype == torch.float32
    assert float(np.abs(ref_kernel - got.numpy()).max()) < 1e-4
    assert float(np.abs(ref_xla - got.numpy()).max()) < 1e-4


@pytest.mark.parametrize("n", [1, 2])
def test_fused_weights_match_jax(n):
    """The port builds the kernel's operands from its own state_dict; they
    equal the JAX package's, operand by operand."""
    jp, js, state, _ = _case(3 + n, n, (8, 8))
    ref = to_numpy(jyf._c3_fused_weights(jp, js, n))
    got = tyf._c3_fused_weights(state, "c3", n)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert float(np.abs(got[k].numpy() - ref[k]).max()) < 1e-6, k


@pytest.mark.parametrize("n", [1, 2])
def test_per_conv_c3_matches_jax(n):
    """The port's per-conv s2d C3 (the unfused engine and chip_smoke's
    library yardstick) against the JAX `_c3_s2d`."""
    jp, js, state, y = _case(7 + n, n, (10, 6))
    ref = np.asarray(jyf._c3_s2d(jp, js, jnp.asarray(y), n))
    w = tyf._c3_s2d_weights(state, "c3", n)
    w = {k: tyf._prep(W, b, torch.float32, torch.device("cpu")) for k, (W, b) in w.items()}
    got = tyf._c3_s2d(w, torch.from_numpy(y), n)
    assert float(np.abs(ref - got.numpy()).max()) < 1e-4


def test_bf16_matches_jax_bf16():
    """bf16 storage: the port's plain version against the JAX kernel and
    the XLA path, both in bf16."""
    jp, js, state, y = _case(5, 1, (8, 8), batch=1)
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    ref = np.asarray(jyf._c3_s2d(jp, js, yb, 1).astype(jnp.float32))
    wts = jyf._c3_fused_weights(jp, js, 1)
    ref_kernel = np.asarray(jax_c3_fused(yb, **wts, width=8, n=1, interpret=True)
                            .astype(jnp.float32))
    ops = {k: v.to(torch.float32 if k[0] == "b" else torch.bfloat16)
           for k, v in tyf._c3_fused_weights(state, "c3", 1).items()}
    got = yolox_c3.c3_s2d_fused(torch.from_numpy(y).to(torch.bfloat16), **ops, width=8, n=1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for r in (ref, ref_kernel):
        assert float((np.abs(r - got) / (np.abs(r) + 1e-1)).max()) < 0.05


def test_wrapper_rejects_other_devices():
    """Only CPU tensors take the plain version; any other non-CUDA device
    raises instead of falling back."""
    _, _, state, _ = _case(1, 1, (8, 8))
    ops = {k: v.to("meta") for k, v in tyf._c3_fused_weights(state, "c3", 1).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        yolox_c3.c3_s2d_fused(torch.empty(1, 8, 8, 32, device="meta"), **ops, width=8, n=1)


@pytest.mark.parametrize("n", [1, 2])
def test_compact_from_s2d_matches_compact_weights(n):
    """The compact operands read out of the TPU kernel's dense s2d operands
    equal those the engine builds from the original convs, exactly."""
    _, _, state, _ = _case(21 + n, n, (8, 8), c4=64, hidden=32)
    dense = tyf._c3_fused_weights(state, "c3", n)
    got = yolox_c3.compact_from_s2d(**dense, n=n)
    ref = tyf._c3_compact_weights(state, "c3", n)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and torch.equal(got[k], ref[k]), k


def test_compact_from_s2d_rejects_dense_random():
    """A dense operand with non-zero blocks off the s2d structure has no
    compact form."""
    _, _, state, _ = _case(2, 1, (8, 8))
    dense = tyf._c3_fused_weights(state, "c3", 1)
    rng = np.random.RandomState(0)
    for k in ("W1", "Wb", "W3"):
        bad = dict(dense, **{k: torch.from_numpy(rng.randn(*dense[k].shape).astype(np.float32))})
        with pytest.raises(ValueError, match=k):
            yolox_c3.compact_from_s2d(**bad, n=1)
    # equal zero structure, but the phase blocks of a 1x1 differ
    W1 = dense["W1"].clone()
    W1[-1, -1] += 1.0
    with pytest.raises(ValueError, match="W1"):
        yolox_c3.compact_from_s2d(**dict(dense, W1=W1), n=1)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_compact_matches_jax_kernel_and_xla_c3(n, hw):
    """The engine's entry with compact operands, f32, against the JAX kernel
    (dense s2d operands, interpret mode) and the JAX per-conv chain."""
    jp, js, state, y = _case(31 + n, n, hw)
    H, W = hw
    ref_kernel = np.asarray(jax_c3_fused(jnp.asarray(y), **jyf._c3_fused_weights(jp, js, n),
                                         width=W, n=n, interpret=True))
    ref_xla = np.asarray(jyf._c3_s2d(jp, js, jnp.asarray(y), n))
    before = yolox_c3.launches
    got = yolox_c3.c3_s2d_fused_compact(torch.from_numpy(y), **tyf._c3_compact_weights(
        state, "c3", n), width=W, n=n)
    assert yolox_c3.launches == before  # a CPU tensor runs the plain version
    assert got.shape == y.shape and got.dtype == torch.float32
    assert float(np.abs(ref_kernel - got.numpy()).max()) < 1e-4
    assert float(np.abs(ref_xla - got.numpy()).max()) < 1e-4


@pytest.mark.parametrize("n,hw", [(1, (8, 8)), (2, (10, 6))])
def test_compact_bf16_matches_jax_bf16(n, hw):
    """bf16 storage through the compact entry against the JAX kernel and the
    XLA path, both in bf16."""
    jp, js, state, y = _case(41 + n, n, hw, batch=1)
    H, W = hw
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    ref = np.asarray(jyf._c3_s2d(jp, js, yb, n).astype(jnp.float32))
    ref_kernel = np.asarray(jax_c3_fused(yb, **jyf._c3_fused_weights(jp, js, n), width=W, n=n,
                                         interpret=True).astype(jnp.float32))
    ops = {k: v.to(torch.float32 if k[0] == "b" else torch.bfloat16)
           for k, v in tyf._c3_compact_weights(state, "c3", n).items()}
    got = yolox_c3.c3_s2d_fused_compact(torch.from_numpy(y).to(torch.bfloat16), **ops,
                                        width=W, n=n)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for r in (ref, ref_kernel):
        assert float((np.abs(r - got) / (np.abs(r) + 1e-1)).max()) < 0.05


@pytest.mark.parametrize("n", [1, 2])
def test_normal_chain_matches_jax(n):
    """The normal-domain per-conv chain that chip_smoke.py times beside B1
    (un_s2d, the original convs, s2d) against the JAX `_c3_s2d`."""
    jp, js, state, y = _case(51 + n, n, (10, 6))
    ref = np.asarray(jyf._c3_s2d(jp, js, jnp.asarray(y), n))
    w = tyf._c3_normal_weights(state, "c3", n)
    w = {k: tyf._prep(W, b, torch.float32, torch.device("cpu")) for k, (W, b) in w.items()}
    got = tyf._c3_normal(w, torch.from_numpy(y), n)
    assert got.shape == y.shape
    assert float(np.abs(ref - got.numpy()).max()) < 1e-4


def test_compact_wrapper_rejects_other_devices():
    _, _, state, _ = _case(1, 1, (8, 8))
    ops = {k: v.to("meta") for k, v in tyf._c3_compact_weights(state, "c3", 1).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        yolox_c3.c3_s2d_fused_compact(torch.empty(1, 8, 8, 32, device="meta"), **ops,
                                      width=8, n=1)
