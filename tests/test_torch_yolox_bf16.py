"""YOLOX-x with whole-net bf16 (`precision=bf16`): is the gap the port's?

One `init_weights(seed=0)` tree of the port's YOLOX-x is handed to both
packages (the JAX package through the weight carrier), and one seeded 64x64
frame goes through `apply_fast` in f32 and in bf16 in each, on the CPU.
Three gaps come out, each the largest score difference (sigmoid outputs,
columns 4:): the port against the JAX package in bf16, and each package's
own bf16 against its f32.  At this random-init depth both packages' bf16
scores move from their f32 by more than the bf16 gate of 0.05 (about 0.09
each), and the two bf16 runs round apart by 0.123 at most and 0.0028 on
average.  The port's bf16 is held to the JAX package's bf16 by two gates
set from those readings: the largest score gap <= 0.2 and the mean <=
0.004.  Three faults planted in one bf16 layer each (weights 10% high,
two output channels swapped) must break a gate; a smaller fault (weights
2% high, or one layer left in f32) moves the scores less than the two
packages' own rounding does and cannot be seen here.  The port's f32 must
match the JAX package's to the f32 gate (relative 1e-3,
tests/test_yolox_fast.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.models import yolox as jyolox
from gst_plugins_rs_tpu.models import yolox_fast as jyf
from gst_plugins_rs_tpu_torch.models import yolox_fast as tyf
from gst_plugins_rs_tpu_torch.models.convert import variables_to_numpy
from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
from torch_parity_helpers import port_on_cpu, rel_err

SIZE = 64
BF16_GATE = 0.05  # scores, tests/test_yolox_fast.py::test_bf16_close
F32_GATE = 1e-3   # relative to |ref| + 1e-2, tests/test_yolox_fast.py
# Port bf16 against JAX bf16, scores: the readings are 0.1230 (max) and
# 2.79e-3 (mean); the gates sit 1.6x and 1.4x above them.
PAIR_MAX_GATE = 0.2
PAIR_MEAN_GATE = 4e-3
PLANTED = (("backbone.backbone.dark3.conv", "scale"),
           ("head.cls_convs_1.conv1", "scale"),
           ("backbone.c3_p3.conv3", "swap"))


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def test_yolox_x_bf16_gaps():
    tm = init_weights(Yolox.from_variant("x"), seed=0).eval()
    state = tm.state_dict()
    variables = jax.tree_util.tree_map(jnp.asarray, variables_to_numpy(state))
    jm = jyolox.Yolox.from_variant("x")
    x = np.random.RandomState(0).randint(0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8)

    def jax_run(dtype):
        fn = jax.jit(lambda v, img: jyf.apply_fast(jm, v, img, dtype=dtype))
        return np.asarray(fn(variables, jnp.asarray(x))).astype(np.float32)

    with torch.no_grad():
        t32 = tyf.apply_fast(tm, state, torch.from_numpy(x)).numpy()
        t16 = tyf.apply_fast(tm, state, torch.from_numpy(x), dtype=torch.bfloat16).float().numpy()
    j32, j16 = jax_run(jnp.float32), jax_run(jnp.bfloat16)

    def gaps(a, b):
        d = np.abs(a[..., 4:] - b[..., 4:])
        return float(d.max()), float(d.mean())

    (pair_max, pair_mean), (jax_own, _), (port_own, _) = gaps(t16, j16), gaps(j16, j32), gaps(t16, t32)
    print(f"YOLOX-x {SIZE}x{SIZE} bf16 score gaps: port vs JAX {pair_max:.4f} "
          f"(mean {pair_mean:.3e}), JAX bf16 vs f32 {jax_own:.4f}, port bf16 vs f32 "
          f"{port_own:.4f}; f32 port vs JAX rel {rel_err(j32, t32):.3e}")
    assert t16.shape == j16.shape == t32.shape and np.isfinite(t16).all()
    assert rel_err(j32, t32) < F32_GATE
    assert pair_max <= PAIR_MAX_GATE and pair_mean <= PAIR_MEAN_GATE

    engine = tyf.FastEngine(tm, state, torch.bfloat16, device="cpu")
    for layer, fault in PLANTED:
        W, b = engine.convs[layer]
        swap = [1, 0] + list(range(2, W.shape[0]))
        engine.convs[layer] = (W * 1.1 if fault == "scale" else W[swap], b)
        f16 = engine(torch.from_numpy(x)).float().numpy()
        engine.convs[layer] = (W, b)
        fmax, fmean = gaps(f16, j16)
        print(f"planted {fault} in {layer}: max {fmax:.4f}, mean {fmean:.3e}")
        assert fmax > PAIR_MAX_GATE or fmean > PAIR_MEAN_GATE, (layer, fault)
