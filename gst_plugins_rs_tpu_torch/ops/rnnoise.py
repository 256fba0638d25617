"""RNNoise-architecture denoiser (the audiornnoise compute path), in PyTorch.

The port of gst_plugins_rs_tpu/ops/rnnoise.py, which reimplements the
`nnnoiseless` crate's DenoiseState: 480-sample frames, a 960-sample
vorbis-windowed FFT analysis, 22 band energies (eband5ms layout), a
42-feature front end (22 BFCC + 2x6 deltas + 6 pitch-correlation cepstra +
pitch period + spectral variability), the GRU stack (dense 24 tanh -> vad GRU
24 -> noise GRU 48 -> denoise GRU 96 -> 22 sigmoid band gains + sigmoid VAD),
band-gain interpolation and overlap-add synthesis.  Silent frames bypass the
network and pass the (delayed) spectrum through: zeros in, zeros out.

Two paths, as in the JAX package:
- per frame (`analysis_frame`, `denoise_frame`, `denoise_frames_scan`): the
  high-pass biquad sample by sample, one frame at a time, in plain torch; the
  reference the tests hold the fast path to;
- batched (`analysis_frames_batch`, `denoise_frames_fast`, what the element
  runs): the high-pass filter as blocked-IIR products with all block-start
  states from one product (ops/ebur128.py::biquad_apply, TF32 off), the FFTs
  and pitch searches of all frames at once, then the GRU stack over the
  buffer's frames in one call of `ops/rnnoise_gru.py::rnn_frames` (kernel R1
  on the card: the state-free input products of every frame, then the
  recurrence, two launches), then the batched synthesis.

State tensors live on the device of the frames; `ceps_idx` is a host int
(it depends only on how many frames were seen).  Products run in float32
with TF32 off.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch

from .._device import device as _default_device, no_tf32
from .ebur128 import biquad_apply
from .rfft import irfft_pair, rfft_pair

FRAME_SIZE = 480
WINDOW_SIZE = 960
FREQ_SIZE = 481
NB_BANDS = 22
CEPS_MEM = 8
NB_DELTA_CEPS = 6
NB_FEATURES = NB_BANDS + 3 * NB_DELTA_CEPS + 2  # 42

PITCH_MIN_PERIOD = 60
PITCH_MAX_PERIOD = 768
PITCH_FRAME_SIZE = 960
PITCH_BUF_SIZE = PITCH_MAX_PERIOD + PITCH_FRAME_SIZE
PITCH_FFT_LEN = 4096

# band edges in 5 ms units; bin index = eband5ms * 4 (RNNoise layout)
EBAND5MS = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 34, 40, 48, 60, 78, 100]
)

# input high-pass biquad (RNNoise constants)
HP_B = np.array([-1.99599, 0.99600])
HP_A = np.array([-1.98989, 0.98997])


def vorbis_window() -> np.ndarray:
    i = np.arange(WINDOW_SIZE // 2)
    inner = np.sin(0.5 * np.pi * (i + 0.5) / (WINDOW_SIZE // 2))
    half = np.sin(0.5 * np.pi * inner * inner)
    return np.concatenate([half, half[::-1]]).astype(np.float32)


def _band_matrix() -> np.ndarray:
    """[NB_BANDS, FREQ_SIZE] triangular interpolation weights."""
    m = np.zeros((NB_BANDS, FREQ_SIZE), np.float32)
    for b in range(NB_BANDS - 1):
        lo = EBAND5MS[b] * 4
        hi = EBAND5MS[b + 1] * 4
        size = hi - lo
        for j in range(size):
            frac = j / size
            m[b, lo + j] += 1.0 - frac
            m[b + 1, lo + j] += frac
    return m


def _dct_matrix() -> np.ndarray:
    """[NB_BANDS, NB_BANDS] orthonormal DCT-II (RNNoise dct())."""
    n = NB_BANDS
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for k in range(n):
            m[k, i] = np.cos(np.pi * (i + 0.5) * k / n)
    m *= np.sqrt(2.0 / n)
    m[0] *= 1.0 / np.sqrt(2.0)
    return m.astype(np.float32)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
WEIGHT_KEYS = [
    "input_dense_w",  # [42, 24]
    "input_dense_b",  # [24]
    "vad_gru_w",  # [24, 3*24]  (z|r|h)
    "vad_gru_u",  # [24, 3*24]
    "vad_gru_b",  # [3*24]
    "noise_gru_w",  # [90, 3*48]
    "noise_gru_u",  # [48, 3*48]
    "noise_gru_b",  # [3*48]
    "denoise_gru_w",  # [114, 3*96]
    "denoise_gru_u",  # [96, 3*96]
    "denoise_gru_b",  # [3*96]
    "denoise_output_w",  # [96, 22]
    "denoise_output_b",  # [22]
    "vad_output_w",  # [24, 1]
    "vad_output_b",  # [1]
]

DENSE_SIZE = 24
VAD_GRU_SIZE = 24
NOISE_GRU_SIZE = 48
DENOISE_GRU_SIZE = 96

WEIGHT_SHAPES = {
    "input_dense_w": (NB_FEATURES, DENSE_SIZE),
    "input_dense_b": (DENSE_SIZE,),
    "vad_gru_w": (DENSE_SIZE, 3 * VAD_GRU_SIZE),
    "vad_gru_u": (VAD_GRU_SIZE, 3 * VAD_GRU_SIZE),
    "vad_gru_b": (3 * VAD_GRU_SIZE,),
    "noise_gru_w": (DENSE_SIZE + VAD_GRU_SIZE + NB_FEATURES, 3 * NOISE_GRU_SIZE),
    "noise_gru_u": (NOISE_GRU_SIZE, 3 * NOISE_GRU_SIZE),
    "noise_gru_b": (3 * NOISE_GRU_SIZE,),
    "denoise_gru_w": (VAD_GRU_SIZE + NOISE_GRU_SIZE + NB_FEATURES, 3 * DENOISE_GRU_SIZE),
    "denoise_gru_u": (DENOISE_GRU_SIZE, 3 * DENOISE_GRU_SIZE),
    "denoise_gru_b": (3 * DENOISE_GRU_SIZE,),
    "denoise_output_w": (DENOISE_GRU_SIZE, NB_BANDS),
    "denoise_output_b": (NB_BANDS,),
    "vad_output_w": (VAD_GRU_SIZE, 1),
    "vad_output_b": (1,),
}


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic random init: the JAX package's draws from the same
    `np.random.RandomState(seed)`, so both packages hold the same numbers."""
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-0.1, 0.1, s).astype(np.float32) for k, s in WEIGHT_SHAPES.items()}


def load_weights(path: str) -> Dict[str, np.ndarray]:
    data = np.load(path)
    return {k: np.asarray(data[k], np.float32) for k in WEIGHT_KEYS}


DEFAULT_WEIGHTS_PATH = str(Path(__file__).resolve().parents[1] / "data" / "rnnoise_weights.npz")


def default_weights() -> Dict[str, np.ndarray]:
    """The packaged weights (trained in the JAX package by
    models/rnnoise_train.py; this package keeps its own copy of the file) if
    present, else the deterministic random init."""
    if os.path.exists(DEFAULT_WEIGHTS_PATH):
        return load_weights(DEFAULT_WEIGHTS_PATH)
    return random_weights(0)


def weights_to(weights, dev) -> Dict[str, torch.Tensor]:
    """The 15 weight arrays as contiguous float32 tensors on dev."""
    return {k: torch.as_tensor(np.asarray(weights[k], np.float32)).to(dev).contiguous()
            for k in WEIGHT_KEYS}


class RnnState(NamedTuple):
    vad_h: torch.Tensor  # [C, 24]
    noise_h: torch.Tensor  # [C, 48]
    denoise_h: torch.Tensor  # [C, 96]


class DenoiseState(NamedTuple):
    analysis_mem: torch.Tensor  # [C, FRAME]
    synthesis_mem: torch.Tensor  # [C, FRAME]
    pitch_buf: torch.Tensor  # [C, PITCH_BUF_SIZE]
    cepstral_hist: torch.Tensor  # [C, CEPS_MEM, NB_BANDS]
    ceps_idx: int
    hp_mem: torch.Tensor  # [C, 4] biquad x1, x2, y1, y2
    rnn: RnnState


def denoise_init(channels: int, dev=None) -> DenoiseState:
    dev = _default_device() if dev is None else torch.device(dev)

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return DenoiseState(
        analysis_mem=z(channels, FRAME_SIZE),
        synthesis_mem=z(channels, FRAME_SIZE),
        pitch_buf=z(channels, PITCH_BUF_SIZE),
        cepstral_hist=z(channels, CEPS_MEM, NB_BANDS),
        ceps_idx=0,
        hp_mem=z(channels, 4),
        rnn=RnnState(vad_h=z(channels, VAD_GRU_SIZE), noise_h=z(channels, NOISE_GRU_SIZE),
                     denoise_h=z(channels, DENOISE_GRU_SIZE)),
    )


_CONSTS: Dict[str, tuple] = {}


def _consts(dev):
    """(window [960], bands [22, 481], dct [22, 22]) float32 on dev, cached."""
    key = str(dev)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = tuple(torch.from_numpy(m).to(dev)
                    for m in (vorbis_window(), _band_matrix(), _dct_matrix()))
        _CONSTS[key] = hit
    return hit


def _forward_transform(buf):
    """buf: [B, WINDOW] -> (Xr, Xi) [B, FREQ], the windowed rfft / WINDOW."""
    window, _, _ = _consts(buf.device)
    Xr, Xi = rfft_pair(buf * window, WINDOW_SIZE)
    return Xr / WINDOW_SIZE, Xi / WINDOW_SIZE


def _inverse_transform(Xr, Xi):
    window, _, _ = _consts(Xr.device)
    return irfft_pair(Xr, Xi, WINDOW_SIZE) * WINDOW_SIZE * window


def _band_energy(Xr, Xi):
    _, bands, _ = _consts(Xr.device)
    with no_tf32():
        return (Xr * Xr + Xi * Xi) @ bands.T + 1e-2  # [B, NB_BANDS]


def _interp_band_gain(g):
    """Expand per-band gains [B, 22] to per-bin gains [B, FREQ] (linear
    within bands)."""
    _, bands, _ = _consts(g.device)
    with no_tf32():
        return g @ bands


def _cepstrum(Ex):
    _, _, dct = _consts(Ex.device)
    with no_tf32():
        return torch.log10(Ex) @ dct.T


def _pitch_search(pitch_buf):
    """FFT autocorrelation pitch: period in [PITCH_MIN, PITCH_MAX] (the first
    lag of the largest score) and the normalized correlation gain.
    pitch_buf: [B, PITCH_BUF] -> (period [B] int64, gain [B])."""
    x = pitch_buf - pitch_buf.mean(-1, keepdim=True)
    Fr, Fi = rfft_pair(x, PITCH_FFT_LEN)
    ac = irfft_pair(Fr * Fr + Fi * Fi, torch.zeros_like(Fr), PITCH_FFT_LEN)[:, :PITCH_BUF_SIZE]
    period = ac[:, PITCH_MIN_PERIOD:PITCH_MAX_PERIOD + 1].argmax(-1) + PITCH_MIN_PERIOD
    e0 = ac[:, 0]
    peak = torch.gather(ac, 1, period[:, None])[:, 0]
    gain = torch.clamp(peak / torch.clamp_min(e0, 1e-9), 0.0, 1.0)
    return period, gain


def _features(ceps, prev1, prev2, hist, period, pitch_gain):
    """The 42 features from this frame's cepstrum, the two before it, the
    cepstral history window [..., 8, 22] and the pitch."""
    d = NB_DELTA_CEPS
    d1 = ceps[..., :d] - prev2[..., :d]
    d2 = ceps[..., :d] - 2 * prev1[..., :d] + prev2[..., :d]
    pitch_ceps = pitch_gain[..., None] * ceps[..., :d]
    spec_var = hist.var(dim=-2, correction=0).mean(-1, keepdim=True)
    return torch.cat([ceps, d1, d2, pitch_ceps,
                      period[..., None].to(torch.float32) / 256.0 - 1.5, spec_var], dim=-1)


# ---------------------------------------------------------------------------
# Per-frame path (the reference of the batched one)
# ---------------------------------------------------------------------------
def _hp_frame(hp_mem, x):
    """The input high-pass biquad (direct form I) over one frame, sample by
    sample: hp_mem [C, 4] (x1, x2, y1, y2), x [C, FRAME] -> (hp_mem', y)."""
    hb0, hb1 = (float(np.float32(v)) for v in HP_B)
    ha0, ha1 = (float(np.float32(v)) for v in HP_A)
    x1, x2, y1, y2 = hp_mem.unbind(1)
    ys = []
    for n in range(x.shape[1]):
        xn = x[:, n]
        y = xn + hb0 * x1 + hb1 * x2 - ha0 * y1 - ha1 * y2
        x1, x2, y1, y2 = xn, x1, y, y1
        ys.append(y)
    return torch.stack([x1, x2, y1, y2], dim=1), torch.stack(ys, dim=1)


def analysis_frame(state: DenoiseState, x):
    """The feature front end over one 480-sample frame.

    x: [C, FRAME] (scaled to +-32767).  Returns (state' with rnn untouched,
    features [C, 42], Ex [C, NB_BANDS], Xr, Xi [C, FREQ], silence [C])."""
    hp_mem, xf = _hp_frame(state.hp_mem, x)
    Xr, Xi = _forward_transform(torch.cat([state.analysis_mem, xf], dim=-1))
    Ex = _band_energy(Xr, Xi)
    pitch_buf = torch.cat([state.pitch_buf[:, FRAME_SIZE:], xf], dim=-1)
    period, pitch_gain = _pitch_search(pitch_buf)
    # silence: the frame's band energy (RNNoise checks the band energy sum)
    silence = (Ex - 1e-2).sum(-1) < 1e-1
    ceps = _cepstrum(Ex)
    idx = state.ceps_idx
    hist = state.cepstral_hist.clone()
    prev1 = hist[:, (idx - 1) % CEPS_MEM]
    prev2 = hist[:, (idx - 2) % CEPS_MEM]
    hist[:, idx % CEPS_MEM] = ceps
    features = _features(ceps, prev1, prev2, hist, period, pitch_gain)
    new_state = DenoiseState(analysis_mem=xf, synthesis_mem=state.synthesis_mem,
                             pitch_buf=pitch_buf, cepstral_hist=hist,
                             ceps_idx=(idx + 1) % CEPS_MEM, hp_mem=hp_mem, rnn=state.rnn)
    return new_state, features, Ex, Xr, Xi, silence


def _gru(x, h, w, u, b, size: int, activation=torch.tanh):
    """RNNoise-ordered GRU: gates packed as [z | r | h~], r applied to h @ U
    before the add, the candidate through `activation` (ReLU for the noise
    and denoise GRUs, which torch.nn.GRU cannot take)."""
    gx = x @ w + b
    gh = h @ u
    z = torch.sigmoid(gx[..., :size] + gh[..., :size])
    r = torch.sigmoid(gx[..., size:2 * size] + gh[..., size:2 * size])
    hh = activation(gx[..., 2 * size:] + r * gh[..., 2 * size:])
    return z * h + (1.0 - z) * hh


def rnn_frame(rnn: RnnState, weights: Dict[str, torch.Tensor], features):
    """One GRU-stack step: features [C, 42] -> (rnn', gains [C, 22], vad [C])."""
    w = weights
    with no_tf32():
        dense = torch.tanh(features @ w["input_dense_w"] + w["input_dense_b"])
        vad_h = _gru(dense, rnn.vad_h, w["vad_gru_w"], w["vad_gru_u"], w["vad_gru_b"],
                     VAD_GRU_SIZE)
        noise_in = torch.cat([dense, vad_h, features], dim=-1)
        noise_h = _gru(noise_in, rnn.noise_h, w["noise_gru_w"], w["noise_gru_u"],
                       w["noise_gru_b"], NOISE_GRU_SIZE, torch.relu)
        den_in = torch.cat([vad_h, noise_h, features], dim=-1)
        denoise_h = _gru(den_in, rnn.denoise_h, w["denoise_gru_w"], w["denoise_gru_u"],
                         w["denoise_gru_b"], DENOISE_GRU_SIZE, torch.relu)
        gains = torch.sigmoid(denoise_h @ w["denoise_output_w"] + w["denoise_output_b"])
        vad = torch.sigmoid(vad_h @ w["vad_output_w"] + w["vad_output_b"])[:, 0]
    return RnnState(vad_h=vad_h, noise_h=noise_h, denoise_h=denoise_h), gains, vad


def denoise_frame(state: DenoiseState, weights: Dict[str, torch.Tensor], x):
    """One 480-sample frame per channel.  x: [C, FRAME] (scaled to +-32767).
    Returns (state', out [C, FRAME], vad [C])."""
    state, features, Ex, Xr, Xi, silence = analysis_frame(state, x)
    new_rnn, gains, vad = rnn_frame(state.rnn, weights, features)
    # silent frames skip the network (state held, vad 0) and pass the
    # spectrum through: RNNoise's `if !silence`
    keep = silence[:, None]
    vad = torch.where(silence, torch.zeros_like(vad), vad)
    rnn = RnnState(*(torch.where(keep, old, new) for old, new in zip(state.rnn, new_rnn)))
    gain_bins = _interp_band_gain(gains)
    Xor = torch.where(keep, Xr, Xr * gain_bins)
    Xoi = torch.where(keep, Xi, Xi * gain_bins)
    y = _inverse_transform(Xor, Xoi)  # [C, WINDOW]
    out = y[:, :FRAME_SIZE] + state.synthesis_mem
    return state._replace(synthesis_mem=y[:, FRAME_SIZE:], rnn=rnn), out, vad


def denoise_frames_scan(state: DenoiseState, weights: Dict[str, torch.Tensor], frames):
    """frames: [K, C, FRAME] -> (state', outs [K, C, FRAME], vads [K, C])."""
    outs, vads = [], []
    for fr in frames:
        state, out, vad = denoise_frame(state, weights, fr)
        outs.append(out)
        vads.append(vad)
    return state, torch.stack(outs), torch.stack(vads)


# ---------------------------------------------------------------------------
# Batched path
# ---------------------------------------------------------------------------
def _hp_filter_batch(hp_mem, frames):
    """frames [K, C, FRAME] -> (filtered [K, C, FRAME], hp_mem'): the
    high-pass biquad as blocked-IIR products, one block a frame, with every
    block-start state from one product (exact state carry)."""
    K, C, F = frames.shape
    b1, b2 = (float(v) for v in HP_B)
    a1, a2 = (float(v) for v in HP_A)
    x1, x2, y1, y2 = hp_mem.unbind(1)
    # direct-form-I memory -> the DF2T state [2, C]
    zi = torch.stack([b1 * x1 - a1 * y1 + b2 * x2 - a2 * y2, b2 * x1 - a2 * y1])
    flat = frames.permute(0, 2, 1).reshape(K * F, C)
    y, _ = biquad_apply(flat, np.array([1.0, b1, b2]), np.array([1.0, a1, a2]), zi,
                        block_target=F)
    ys = y.reshape(K, F, C).permute(0, 2, 1)
    hp_out = torch.stack([frames[-1, :, -1], frames[-1, :, -2], ys[-1, :, -1], ys[-1, :, -2]],
                         dim=1)
    return ys, hp_out


def analysis_frames_batch(state: DenoiseState, frames):
    """Batched front end: frames [K, C, FRAME] -> (state', features [K, C, 42],
    Ex, Xr, Xi [K, C, ...], silence [K, C]); the math of analysis_frame
    over the frames in turn."""
    K, C, _ = frames.shape
    xf, hp_mem = _hp_filter_batch(state.hp_mem, frames)

    # analysis windows: [previous frame, this frame]
    prev = torch.cat([state.analysis_mem[None], xf[:-1]], dim=0)
    Xr, Xi = _forward_transform(torch.cat([prev, xf], dim=-1).reshape(K * C, WINDOW_SIZE))
    Ex = _band_energy(Xr, Xi).reshape(K, C, NB_BANDS)
    Xr = Xr.reshape(K, C, FREQ_SIZE)
    Xi = Xi.reshape(K, C, FREQ_SIZE)

    # pitch windows: the PITCH_BUF_SIZE samples ending with each frame
    flat = torch.cat([state.pitch_buf, xf.permute(1, 0, 2).reshape(C, K * FRAME_SIZE)], dim=-1)
    win = flat.unfold(-1, PITCH_BUF_SIZE, FRAME_SIZE)[:, 1:K + 1]  # [C, K, PITCH_BUF]
    period, pitch_gain = _pitch_search(win.transpose(0, 1).reshape(K * C, PITCH_BUF_SIZE))
    period = period.reshape(K, C)
    pitch_gain = pitch_gain.reshape(K, C)

    silence = (Ex - 1e-2).sum(-1) < 1e-1  # [K, C]
    ceps = _cepstrum(Ex)  # [K, C, 22]
    # the prior history in chronological order (oldest first), then this
    # buffer's cepstra
    idx = state.ceps_idx
    order = [(idx + j) % CEPS_MEM for j in range(CEPS_MEM)]
    prior = state.cepstral_hist[:, order].transpose(0, 1)  # [8, C, 22]
    full = torch.cat([prior, ceps], dim=0)  # [8 + K, C, 22]
    prev1 = full[CEPS_MEM - 1:CEPS_MEM - 1 + K]
    prev2 = full[CEPS_MEM - 2:CEPS_MEM - 2 + K]
    # frame t's history window is full[t + 1 : t + 9] (variance is order-free)
    hist = full.unfold(0, CEPS_MEM, 1)[1:K + 1].transpose(-1, -2)  # [K, C, 8, 22]
    features = _features(ceps, prev1, prev2, hist, period, pitch_gain)

    # the last 8 cepstra back in the rotated-slot layout
    positions = [(idx + K + j) % CEPS_MEM for j in range(CEPS_MEM)]
    hist_out = torch.empty_like(state.cepstral_hist)
    hist_out[:, positions] = full[-CEPS_MEM:].transpose(0, 1)

    new_state = DenoiseState(analysis_mem=xf[-1], synthesis_mem=state.synthesis_mem,
                             pitch_buf=flat[:, -PITCH_BUF_SIZE:], cepstral_hist=hist_out,
                             ceps_idx=(idx + K) % CEPS_MEM, hp_mem=hp_mem, rnn=state.rnn)
    return new_state, features, Ex, Xr, Xi, silence


def denoise_frames_fast(state: DenoiseState, weights: Dict[str, torch.Tensor], frames):
    """The batched peer of denoise_frames_scan: batched front end, the GRU
    stack over the K frames in one `rnn_frames` call (kernel R1 on the card),
    batched synthesis.  frames [K, C, FRAME] -> (state', outs [K, C, FRAME],
    vads [K, C])."""
    from .rnnoise_gru import rnn_frames

    K, C, _ = frames.shape
    state, features, Ex, Xr, Xi, silence = analysis_frames_batch(state, frames)
    gains, vads, rnn = rnn_frames(features, silence, state.rnn, weights)
    gain_bins = _interp_band_gain(gains.reshape(K * C, NB_BANDS)).reshape(K, C, FREQ_SIZE)
    sil = silence[..., None]
    Xor = torch.where(sil, Xr, Xr * gain_bins)
    Xoi = torch.where(sil, Xi, Xi * gain_bins)
    y = _inverse_transform(Xor.reshape(K * C, FREQ_SIZE),
                           Xoi.reshape(K * C, FREQ_SIZE)).reshape(K, C, WINDOW_SIZE)
    tails = torch.cat([state.synthesis_mem[None], y[:-1, :, FRAME_SIZE:]], dim=0)
    outs = y[:, :, :FRAME_SIZE] + tails
    return state._replace(synthesis_mem=y[-1, :, FRAME_SIZE:], rnn=rnn), outs, vads


__all__ = [
    "DEFAULT_WEIGHTS_PATH",
    "DenoiseState",
    "FRAME_SIZE",
    "NB_BANDS",
    "NB_FEATURES",
    "RnnState",
    "WEIGHT_KEYS",
    "WEIGHT_SHAPES",
    "analysis_frame",
    "analysis_frames_batch",
    "default_weights",
    "denoise_frame",
    "denoise_frames_fast",
    "denoise_frames_scan",
    "denoise_init",
    "load_weights",
    "random_weights",
    "rnn_frame",
    "weights_to",
]
