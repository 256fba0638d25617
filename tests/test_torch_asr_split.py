"""The arithmetic order of kernel T1 (csrc/asr_gru.cu) modelled on the CPU.

The kernel holds U in registers as tiles of 2 rows x 48 inputs a lane:
each row's sum over the 96 inputs is two parts, P_g over inputs
48 g .. 48 g + 47, each the sum of two FMA chains in increasing input order
(the even inputs, then the odd ones: e + o), and one shuffle adds them:
P_0 + P_1.  The r rows form rh = r * h once; the candidate rows sum rh U_h
the same way; the blend rounds each product and sum.  The gates are the
plain formulas here: the kernel's MUFU approximations of them (ex2, rcp)
are within ~3e-7 and not modelled bit for bit.  A slip in the tiling (a
row or an input half taken from the wrong place) still gives finite states
of the right shape, so this file
holds a host model of that order, in torch ops, to the port's plain version
`bigru_plain` and to the JAX package's scan `_gru_scan`
(gst_plugins_rs_tpu/ops/asr.py:124).

Gates and why:
- against `bigru_plain`: within T1_TOL = 1e-5 of 1 + |ref|, the kernel's
  own gate (tests/test_torch_kernels_cuda.py);
- against a float64 evaluation of the plain version: within F64_TOL = 1e-6,
  or within twice the plain f32 version's own error where that is larger.
  The two f32 versions sum in other orders and each sits up to ~7e-6 from
  float64 after 500 steps of the packaged layer 1, so they cannot be held
  to 1e-6 of each other; each can be held to float64 as closely as the
  other is;
- against the JAX scan: within GRU_TOL = 1e-5 (tests/test_torch_asr.py).
Both layers (layer 1 on the plain layer 0's states), both directions,
T = 1, 2, 50, 500, two utterances a call, the packaged and the seeded
weights, and saturated gates (the layer inputs scaled by 20).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.ops import asr as jasr
from gst_plugins_rs_tpu_torch.models.convert import asr_weights
from gst_plugins_rs_tpu_torch.ops import asr as tasr
from gst_plugins_rs_tpu_torch.ops import asr_gru
from torch_parity_helpers import port_on_cpu

T1_TOL = 1e-5
F64_TOL = 1e-6
GRU_TOL = 1e-5
H = asr_gru.HIDDEN
PARTS = 2  # lanes that share a row; each sums H / PARTS inputs
B = 2


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _fma(a, b, c):
    """fmaf in float32: the product is exact in float64, the sum rounds
    there and again to float32 (a double rounding that a true FMA lacks,
    off by one ulp at most in rare cases)."""
    return (a.double() * b.double() + c.double()).float()


def row_sums(v, W):
    """v [B, 2, H], W [2, rows, H] (each row's column of U) -> [B, 2, rows]:
    each part's even and odd chains as a lane takes them, then the shuffle."""
    n = H // PARTS
    vv = v.reshape(v.shape[0], 2, 1, PARTS, n // 2, 2)
    ww = W.reshape(1, 2, W.shape[1], PARTS, n // 2, 2)
    acc = torch.zeros(v.shape[0], 2, W.shape[1], PARTS, 2)
    for q in range(n // 2):
        acc = _fma(vv[..., q, :], ww[..., q, :], acc)
    p = acc[..., 0] + acc[..., 1]
    return p[..., 0] + p[..., 1]


def kernel_model(X, U):
    """T1's order, step by step: X [B, 2, T, 3H], U [2, 3, H, H] -> [B, 2, T, H]."""
    Bn, _, T, _ = X.shape
    Wzr = U[:, :2].transpose(2, 3).reshape(2, 2 * H, H)  # rows z 0..95, r 96..191
    Wh = U[:, 2].transpose(1, 2)
    h = X.new_zeros((Bn, 2, H))
    out = X.new_empty((Bn, 2, T, H))
    for s in range(T):
        x = torch.stack([X[:, 0, s], X[:, 1, T - 1 - s]], 1)
        g = 1.0 / (1.0 + torch.exp(-(x[..., :2 * H] + row_sums(h, Wzr))))
        z, r = g[..., :H], g[..., H:]
        hh = torch.tanh(x[..., 2 * H:] + row_sums(r * h, Wh))
        h = (1 - z) * h + z * hh
        out[:, 0, s] = h[:, 0]
        out[:, 1, T - 1 - s] = h[:, 1]
    return out


def _rel(got, ref):
    ref = ref.double()
    return float(((got.double() - ref).abs() / (1 + ref.abs())).max())


def _weights(kind):
    """(the JAX package's dict, the port's tensors) from the same arrays."""
    if kind == "packaged":
        with np.load(jasr.DEFAULT_WEIGHTS) as z:
            tree = {k: z[k] for k in z.files}
    else:
        tree = jasr.init_weights(seed=7)
    return {k: jnp.asarray(v) for k, v in tree.items()}, asr_weights(tree, "cpu")


def _check_layers(kind, x, scale=1.0):
    """Both layers on x [B, T, 40] (layer 1 on the plain layer 0's states),
    each input scaled by `scale`: the model against the plain version,
    against float64, and each direction against the JAX scan."""
    jw, tw = _weights(kind)
    for layer in range(2):
        x = x * scale
        Wx, b, U = tasr.layer_mats(tw, layer)
        X = tasr.input_projections(x, Wx, b)
        got = kernel_model(X, U)
        ref = asr_gru.bigru_plain(X, U)
        ref64 = asr_gru.bigru_plain(X.double(), U.double())
        assert got.shape == ref.shape and torch.isfinite(got).all()
        assert _rel(got, ref) <= T1_TOL, (layer, _rel(got, ref))
        gate = max(F64_TOL, 2 * _rel(ref, ref64))
        assert _rel(got, ref64) <= gate, (layer, _rel(got, ref64), gate)
        for d, name in enumerate("fb"):
            for i in range(x.shape[0]):
                jref = np.asarray(jasr._gru_scan(jw, f"gru{layer}{name}_",
                                                 jnp.asarray(x[i].numpy()), reverse=d == 1))
                assert np.abs(got[i, d].numpy() - jref).max() <= GRU_TOL, (layer, name, i)
        x = torch.cat([ref[:, 0], ref[:, 1]], -1)


@pytest.mark.parametrize("kind", ["packaged", "seeded"])
@pytest.mark.parametrize("T", [1, 2, 50, 500])
def test_model_matches_plain_and_jax(kind, T):
    x = np.random.RandomState(T).randn(B, T, tasr.N_MEL).astype(np.float32)
    _check_layers(kind, torch.from_numpy(x))


@pytest.mark.parametrize("kind", ["packaged", "seeded"])
def test_model_saturated_gates(kind):
    """Inputs 20x: the gates sit at 0 or 1 and the candidate at +-1."""
    x = np.random.RandomState(20).randn(B, 50, tasr.N_MEL).astype(np.float32)
    _check_layers(kind, torch.from_numpy(x), scale=20.0)


def test_model_of_speech_features():
    """The path's input: log-mel features of a synthesised command padded to
    a 50-frame bucket, as transcribe runs them."""
    from gst_plugins_rs_tpu_torch.ops.speechsynth import synth_sentence

    audio = synth_sentence(["open", "door", "seven"], seed=5, noise_snr_db=30)
    feats, _ = tasr.padded_features(torch.from_numpy(audio))
    _check_layers("packaged", feats[None])


def test_row_sums_take_each_weight_once():
    """With v one-hot at input i, every row's sum is U[i, row] exactly: each
    lane's tile covers its inputs and rows, and the tree adds the four parts
    of the same row."""
    U = torch.from_numpy(np.random.RandomState(1).randn(2, 3, H, H).astype(np.float32))
    W = U.transpose(2, 3).reshape(2, 3 * H, H)
    for i in (0, 1, 47, 48, 95):
        v = torch.zeros(1, 2, H)
        v[..., i] = 1.0
        assert torch.equal(row_sums(v, W)[0], W[..., i])


def test_row_sums_chain_order():
    """A part is its even chain plus its odd chain: with terms 1, 2^-24, -1
    at inputs 0, 1, 2 the sum keeps the small term only in that order (in
    input order 1 + 2^-24 rounds to 1 first); the second part adds last."""
    v = torch.zeros(1, 2, H)
    W = torch.zeros(2, 1, H)
    v[..., :3] = 1.0
    W[0, 0, :3] = torch.tensor([1.0, 2.0 ** -24, -1.0])
    assert row_sums(v, W)[0, 0, 0] == 2.0 ** -24
    v[..., H // PARTS] = 1.0
    W[0, 0, H // PARTS] = -(2.0 ** -24)
    assert row_sums(v, W)[0, 0, 0] == 0.0
