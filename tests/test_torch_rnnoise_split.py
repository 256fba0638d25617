"""The split of kernel R1 (csrc/rnnoise_gru.cu) modelled on the CPU.

The kernel computes, for every frame and channel at once, the input products
that do not depend on the state (the hoisted Xv, Xn and Xd), then runs a
recurrence over what is left.  A slip in the slices of the input matrices
(the noise GRU's input is [dense 0:24 | vad_h 24:48 | features 48:90], the
denoise GRU's [vad_h 0:24 | noise_h 24:72 | features 72:114]) still gives
finite, plausible gains, so this file holds a host model of the two stages,
in torch ops, to the port's plain version `rnn_frames_plain` and to the JAX
package's scan.  The model adds each hoisted term last, as the kernel does.

Gate: R1_TOL = 1e-5, the kernel's own gate against the plain version
(tests/test_torch_kernels_cuda.py): gains and VADs absolutely, the states
relative to 1 + |ref|.  The split alone moves the packaged weights' states
by up to ~5e-6 (float rounding of sums taken in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.ops import rnnoise as J
from gst_plugins_rs_tpu_torch.ops import rnnoise as T
from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as TG
from torch_parity_helpers import port_on_cpu

R1_TOL = 1e-5
V, N, D = T.VAD_GRU_SIZE, T.NOISE_GRU_SIZE, T.DENOISE_GRU_SIZE  # 24, 48, 96
DENSE = T.DENSE_SIZE


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def hoist(features, w):
    """Stage 1, for every frame and channel: the state-free products."""
    dense = torch.tanh(features @ w["input_dense_w"] + w["input_dense_b"])
    xv = dense @ w["vad_gru_w"] + w["vad_gru_b"]
    wn = w["noise_gru_w"]
    xn = (dense @ wn[:DENSE] + features @ wn[DENSE + V:]) + w["noise_gru_b"]
    xd = features @ w["denoise_gru_w"][V + N:] + w["denoise_gru_b"]
    return xv, xn, xd


def _update(gx, gh, h, size, act):
    z = torch.sigmoid(gx[..., :size] + gh[..., :size])
    r = torch.sigmoid(gx[..., size:2 * size] + gh[..., size:2 * size])
    return z * h + (1.0 - z) * act(gx[..., 2 * size:] + r * gh[..., 2 * size:])


def split_frames(features, silence, rnn, w):
    """The kernel's two stages: the hoisted products, then the recurrence on
    what is left, a silent frame's state held (VAD 0, gains 1)."""
    xv, xn, xd = hoist(features, w)
    wn, wd = w["noise_gru_w"], w["denoise_gru_w"]
    vad_h, noise_h, den_h = rnn
    gains, vads = [], []
    for k in range(features.shape[0]):
        v = _update(xv[k], vad_h @ w["vad_gru_u"], vad_h, V, torch.tanh)
        gx_n = v @ wn[DENSE:DENSE + V] + xn[k]
        n = _update(gx_n, noise_h @ w["noise_gru_u"], noise_h, N, torch.relu)
        gx_d = torch.cat([v, n], dim=-1) @ wd[:V + N] + xd[k]
        d = _update(gx_d, den_h @ w["denoise_gru_u"], den_h, D, torch.relu)
        keep = silence[k][:, None]
        vad_h, noise_h, den_h = (torch.where(keep, o, x) for o, x in
                                 ((vad_h, v), (noise_h, n), (den_h, d)))
        g = torch.sigmoid(d @ w["denoise_output_w"] + w["denoise_output_b"])
        a = torch.sigmoid(v @ w["vad_output_w"] + w["vad_output_b"])[:, 0]
        gains.append(torch.where(keep, torch.ones_like(g), g))
        vads.append(torch.where(silence[k], torch.zeros_like(a), a))
    return torch.stack(gains), torch.stack(vads), T.RnnState(vad_h, noise_h, den_h)


def _inputs(kind, K, C, seed):
    """tests/test_torch_kernels_cuda.py's R1 inputs: features of scale 2, a
    fifth of the frames silent, non-negative states."""
    rng = np.random.RandomState(seed)
    w = T.random_weights(seed) if kind == "random" else T.default_weights()
    feats = torch.from_numpy(rng.randn(K, C, T.NB_FEATURES).astype(np.float32) * 2.0)
    sil = torch.from_numpy(rng.rand(K, C) < 0.2)
    h = [torch.from_numpy(np.abs(rng.uniform(-0.5, 0.5, (C, n))).astype(np.float32))
         for n in (V, N, D)]
    return feats, sil, T.RnnState(*h), T.weights_to(w, "cpu")


def _errors(got, ref):
    (g, v, s), (rg, rv, rs) = got, ref
    state = max(float(((a - b) / (1 + b.abs())).abs().max()) for a, b in zip(s, rs))
    return float((g - rg).abs().max()), float((v - rv).abs().max()), state


def _check(feats, sil, rnn, w):
    got = split_frames(feats, sil, rnn, w)
    ref = TG.rnn_frames_plain(feats, sil, rnn, w)
    assert torch.equal(got[0][sil], torch.ones_like(got[0][sil]))
    assert torch.equal(got[1][sil], torch.zeros_like(got[1][sil]))
    errs = _errors(got, ref)
    assert max(errs) <= R1_TOL, errs
    return got


@pytest.mark.parametrize("kind", ["random", "packaged"])
@pytest.mark.parametrize("K,C", [(10, 2), (100, 2), (16, 16)])
def test_split_matches_plain(kind, K, C):
    _check(*_inputs(kind, K, C, K + C))


def test_hoist_slices_are_the_state_free_rows():
    """With the states and every chain row set to zero, the GRUs' gate
    inputs are exactly the hoisted terms: each slice of W is where the
    model takes it."""
    feats, _, _, w = _inputs("random", 3, 2, 5)
    xv, xn, xd = hoist(feats, w)
    dense = torch.tanh(feats @ w["input_dense_w"] + w["input_dense_b"])
    zeros = torch.zeros(3, 2, V)
    noise_in = torch.cat([dense, zeros, feats], dim=-1)
    den_in = torch.cat([zeros, torch.zeros(3, 2, N), feats], dim=-1)
    for got, ref in ((xv, dense @ w["vad_gru_w"] + w["vad_gru_b"]),
                     (xn, noise_in @ w["noise_gru_w"] + w["noise_gru_b"]),
                     (xd, den_in @ w["denoise_gru_w"] + w["denoise_gru_b"])):
        assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_split_all_silent_buffer_holds_the_state(kind):
    feats, _, rnn, w = _inputs(kind, 10, 2, 7)
    sil = torch.ones(10, 2, dtype=torch.bool)
    g, v, s = _check(feats, sil, rnn, w)
    assert all(torch.equal(a, b) for a, b in zip(s, rnn))


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_split_silent_then_speaking(kind):
    """Channel 0 silent for its first six frames, then speaking; channel 1
    speaking, then silent to the end; channel 2 alternating."""
    feats, _, rnn, w = _inputs(kind, 16, 3, 8)
    sil = torch.zeros(16, 3, dtype=torch.bool)
    sil[:6, 0] = True
    sil[9:, 1] = True
    sil[::2, 2] = True
    _check(feats, sil, rnn, w)


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_split_states_carried_across_two_calls(kind):
    """Two calls of K frames, the first's states into the second, against
    one plain call of 2K frames."""
    feats, sil, rnn, w = _inputs(kind, 20, 4, 9)
    sil[9, :] = True  # the first call ends on a silent frame
    g1, v1, s1 = split_frames(feats[:10], sil[:10], rnn, w)
    g2, v2, s2 = split_frames(feats[10:], sil[10:], s1, w)
    ref = TG.rnn_frames_plain(feats, sil, rnn, w)
    errs = _errors((torch.cat([g1, g2]), torch.cat([v1, v2]), s2), ref)
    assert max(errs) <= R1_TOL, errs


def test_split_matches_jax_scan():
    """The model against the JAX package's GRU scan (its rnn_frame under
    jax.lax.scan, a silent frame's state held and VAD 0) on packaged
    weights."""
    feats, sil, rnn, w = _inputs("packaged", 16, 2, 10)
    jw = {k: jnp.asarray(v.numpy()) for k, v in w.items()}

    def step(r, xs):
        f, s = xs
        new, g, v = J.rnn_frame(r, jw, f)
        keep = s[:, None]
        r = J.RnnState(*(jnp.where(keep, o, n) for o, n in zip(r, new)))
        return r, (g, jnp.where(s, 0.0, v))

    jr, (jg, jv) = jax.jit(lambda r, f, s: jax.lax.scan(step, r, (f, s)))(
        J.RnnState(*(jnp.asarray(h.numpy()) for h in rnn)), jnp.asarray(feats.numpy()),
        jnp.asarray(sil.numpy()))
    g, v, s = split_frames(feats, sil, rnn, w)
    # the JAX scan leaves a silent frame's gains as the network gave them
    # (the synthesis never reads them); the port writes 1
    jg = torch.from_numpy(np.array(jg))
    jg[sil] = 1.0
    errs = _errors((g, v, s), (jg, torch.from_numpy(np.asarray(jv)),
                               T.RnnState(*(torch.from_numpy(np.asarray(h)) for h in jr))))
    assert max(errs) <= R1_TOL, errs
