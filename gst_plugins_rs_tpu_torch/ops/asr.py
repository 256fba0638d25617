"""asr-lite: small-vocabulary speech recognition (log-mel + BiGRU + CTC), in PyTorch.

The port of gst_plugins_rs_tpu/ops/asr.py, the inference core behind
whispertranscriber's builtin model: a log-mel front end (25 ms Hann
windows every 10 ms, a 512-point FFT, 40 HTK mel bands, per-utterance
mean and variance normalisation), two bidirectional GRU layers of 96 units
and a CTC head over a blank, a space and a..z.  The weights were trained in
the JAX package on its formant synthesiser (ops/speechsynth.py); this
package keeps its own copy of the file (data/asr_lite_weights.npz).

The GRU is not cuDNN's: the candidate gate is tanh([x, r*h] @ Wh + bh), the
reset gate multiplying h before the product.  Each layer runs in two
steps: the input part of every gate for all frames and both directions in
one product (`input_projections`, x @ W[:D] + b), then the recurrence over
the frames (`ops/asr_gru.py::bigru`, kernel T1 on the card, a step loop of
torch ops on the CPU).  Decoding takes the argmax on the device and
collapses repeats and blanks on the host, as `greedy_ids` does.

Differences from the JAX module, by design:
- `logmel` clamps its frame indices to the last sample, as JAX's gather
  clamps them: a chunk shorter than 400 samples reads its last sample
  again where torch indexing would raise.
- The input products are hoisted out of the recurrence (the JAX cell
  multiplies [x, h] by W in one product a step), so sums run in another
  order: the hidden states agree to 1e-5.
Products run in float32 with TF32 off.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .._device import no_tf32

RATE = 16000
N_FFT = 512
WIN = 400  # 25 ms
HOP = 160  # 10 ms
N_MEL = 40

# CTC charset: 0 = blank, 1 = space, 2..27 = a..z
BLANK = 0
CHARS = " abcdefghijklmnopqrstuvwxyz"
N_CLASSES = 1 + len(CHARS)

HIDDEN = 96
LAYERS = 2
BUCKET = 50  # transcribe pads the features to a multiple of 50 frames (0.5 s)
GATES = ("z", "r", "h")
DEFAULT_WEIGHTS = str(Path(__file__).resolve().parents[1] / "data" / "asr_lite_weights.npz")


def text_to_ids(text: str) -> np.ndarray:
    return np.array([CHARS.index(c) + 1 for c in text if c in CHARS], np.int32)


def ids_to_text(ids) -> str:
    return "".join(CHARS[int(i) - 1] for i in ids if int(i) >= 1)


def _mel_filterbank() -> np.ndarray:
    """[N_FFT//2+1, N_MEL] triangular mel filterbank (HTK mel scale)."""
    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def imel(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    pts = imel(np.linspace(mel(0.0), mel(RATE / 2), N_MEL + 2))
    bins = np.floor((N_FFT + 1) * pts / RATE).astype(int)
    fb = np.zeros((N_FFT // 2 + 1, N_MEL), np.float32)
    for m in range(1, N_MEL + 1):
        lo, ctr, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, ctr):
            if ctr > lo:
                fb[k, m - 1] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            if hi > ctr:
                fb[k, m - 1] = (hi - k) / (hi - ctr)
    return fb


_MEL_NP = _mel_filterbank()
# np.hanning is the symmetric window; torch.hann_window defaults to the periodic one
_WINDOW_NP = np.hanning(WIN).astype(np.float32)


def _frame_index(n: int) -> np.ndarray:
    """[t, WIN] sample indices of the frames, clamped to the last sample."""
    t = max(1, (n - WIN) // HOP + 1)
    idx = np.arange(t)[:, None] * HOP + np.arange(WIN)[None, :]
    return np.minimum(idx, max(n - 1, 0))


def logmel(audio: torch.Tensor) -> torch.Tensor:
    """[n] f32 -> [T, N_MEL] log-mel features with per-utterance CMVN."""
    audio = audio.reshape(-1).to(torch.float32)
    dev = audio.device
    idx = torch.as_tensor(_frame_index(audio.shape[0])).to(dev)
    frames = audio[idx] * torch.as_tensor(_WINDOW_NP).to(dev)
    spec = torch.fft.rfft(frames, n=N_FFT).abs() ** 2
    with no_tf32():
        mels = torch.log(spec @ torch.as_tensor(_MEL_NP).to(dev) + 1e-6)
    mean = mels.mean(0, keepdim=True)
    std = mels.std(0, correction=0, keepdim=True) + 1e-3
    return (mels - mean) / std


def logmel_np(audio: np.ndarray) -> np.ndarray:
    """numpy twin of logmel (same math, same index clamp)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    frames = audio[_frame_index(audio.shape[0])] * _WINDOW_NP
    spec = np.abs(np.fft.rfft(frames, n=N_FFT)) ** 2
    mels = np.log(spec @ _MEL_NP + 1e-6)
    mean = mels.mean(axis=0, keepdims=True)
    std = mels.std(axis=0, keepdims=True) + 1e-3
    return ((mels - mean) / std).astype(np.float32)


def init_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random weights: the JAX package's numpy draws, equal bit for bit."""
    rng = np.random.default_rng(seed)

    def mat(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    w: Dict[str, np.ndarray] = {}
    dims = [(N_MEL, HIDDEN), (2 * HIDDEN, HIDDEN)]
    for layer, (i_dim, h) in enumerate(dims):
        for d in ("f", "b"):
            p = f"gru{layer}{d}_"
            w[p + "wz"] = mat(i_dim + h, h)
            w[p + "wr"] = mat(i_dim + h, h)
            w[p + "wh"] = mat(i_dim + h, h)
            w[p + "bz"] = np.zeros(h, np.float32)
            w[p + "br"] = np.zeros(h, np.float32)
            w[p + "bh"] = np.zeros(h, np.float32)
    w["out_w"] = mat(2 * HIDDEN, N_CLASSES)
    w["out_b"] = np.zeros(N_CLASSES, np.float32)
    return w


def layer_mats(w: Dict[str, torch.Tensor], layer: int):
    """The input and recurrent parts of a layer's gate matrices:
    Wx [D, 2 * 3H] (forward z, r, h, then backward z, r, h), b [2 * 3H] and
    U [2, 3, H, H] (U[d, g] = W_g[D:] of direction d)."""
    D = N_MEL if layer == 0 else 2 * HIDDEN
    Wx, b, U = [], [], []
    for d in ("f", "b"):
        p = f"gru{layer}{d}_"
        Wx += [w[p + "w" + g][:D] for g in GATES]
        b += [w[p + "b" + g] for g in GATES]
        U.append(torch.stack([w[p + "w" + g][D:] for g in GATES]))
    return torch.cat(Wx, 1), torch.cat(b), torch.stack(U).contiguous()


def input_projections(x: torch.Tensor, Wx: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] -> X [B, 2, T, 3H]: x @ W_g[:D] + b_g of every gate and
    direction, for all frames in one product."""
    B, T, _ = x.shape
    with no_tf32():
        X = x @ Wx + b
    return X.reshape(B, T, 2, 3 * HIDDEN).permute(0, 2, 1, 3).contiguous()


def forward(w: Dict[str, torch.Tensor], feats: torch.Tensor) -> torch.Tensor:
    """[T, N_MEL] (or [B, T, N_MEL]) -> logits [T, N_CLASSES] ([B, T, ...])."""
    from .asr_gru import bigru

    x = feats if feats.dim() == 3 else feats[None]
    for layer in range(LAYERS):
        Wx, b, U = layer_mats(w, layer)
        hs = bigru(input_projections(x, Wx, b), U)  # [B, 2, T, H]
        x = torch.cat([hs[:, 0], hs[:, 1]], -1)
    with no_tf32():
        logits = x @ w["out_w"] + w["out_b"]
    return logits if feats.dim() == 3 else logits[0]


def greedy_ids(logits) -> List[int]:
    """CTC greedy decode: the argmax where the logits are, then repeats
    collapsed and blanks dropped on the host."""
    if isinstance(logits, torch.Tensor):
        path = logits.argmax(-1).cpu().numpy()
    else:
        path = np.asarray(logits).argmax(axis=-1)
    out: List[int] = []
    prev = -1
    for p in path:
        if p != prev and p != BLANK:
            out.append(int(p))
        prev = p
    return out


def padded_features(audio: torch.Tensor):
    """(features zero-padded to a multiple of BUCKET frames, true frames t).
    The backward GRU walks the zero rows first, so the padding moves the
    logits of real frames; transcribe pads as the JAX package does."""
    feats = logmel(audio)
    t = feats.shape[0]
    tp = max(BUCKET, -(-t // BUCKET) * BUCKET)
    if tp != t:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, tp - t))
    return feats, t


def transcribe(w: Dict[str, torch.Tensor], audio) -> str:
    """[n] f32 16 kHz (numpy or a tensor) -> text, on the weights' device."""
    dev = w["out_w"].device
    audio = torch.as_tensor(np.asarray(audio, np.float32) if not isinstance(audio, torch.Tensor)
                            else audio).to(dev, torch.float32).reshape(-1)
    feats, t = padded_features(audio)
    logits = forward(w, feats)
    return ids_to_text(greedy_ids(logits[:t])).strip()


def load_weights(path: str = DEFAULT_WEIGHTS, dev=None) -> Dict[str, torch.Tensor]:
    """The npz's arrays (gru{0,1}{f,b}_{wz,wr,wh,bz,br,bh}, out_w, out_b) as
    float32 tensors on dev (default: the selected device)."""
    from ..models.convert import asr_weights

    with np.load(path) as z:
        return asr_weights({k: z[k] for k in z.files}, dev)


def save_weights(w, path: str = DEFAULT_WEIGHTS) -> None:
    np.savez_compressed(path, **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                     else np.asarray(v)) for k, v in w.items()})


__all__ = ["BLANK", "CHARS", "DEFAULT_WEIGHTS", "HIDDEN", "N_CLASSES", "N_MEL", "forward",
           "greedy_ids", "ids_to_text", "init_weights", "input_projections", "layer_mats",
           "load_weights", "logmel", "logmel_np", "padded_features", "save_weights",
           "text_to_ids", "transcribe"]
