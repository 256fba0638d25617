"""The RNNoise GRU stack over a buffer's frames: kernel R1 and its plain version.

The JAX package runs the stack one frame at a time inside `lax.scan`
(gst_plugins_rs_tpu/ops/rnnoise.py: `rnn_frame` :309, scanned by
`denoise_frames_fast` :510-521, which holds each channel's state on silent
frames and forces its VAD to 0).  It is XLA there, not Pallas.  As eager
torch the scan costs ~40 small launches a 10 ms frame, so on the card the
whole scan is one call of csrc/rnnoise_gru.cu per buffer: two kernel
launches, the products that do not depend on the state for every frame at
once (into a [K, C, 504] scratch allocated here), then the recurrence with
its chain weights held on chip (design and bounds noted there).

`rnn_frames(features, silence, rnn, weights)`:
  features [K, C, 42] float32, silence [K, C] bool, rnn = RnnState of the
  [C, 24] / [C, 48] / [C, 96] states, weights = the 15 float32 arrays of
  WEIGHT_KEYS in the JAX layout ([in, 3*size], gates packed [z | r | h~]).
  Returns (gains [K, C, 22], vads [K, C], RnnState after the last frame).
  On a silent frame (of a channel) the network does not run: the state is
  held, the VAD is 0 and the gains are 1 (the synthesis passes a silent
  frame's spectrum through and never reads them).

For CUDA tensors it makes the call (counted once in `launches`) or raises;
for CPU tensors it runs `rnn_frames_plain`, a loop over the K frames of the
port's `rnn_frame` (torch ops).  The kernel sums the same products in
another order (the input products apart from the recurrent ones) and takes
`expf`/`tanhf` where torch takes its vectorised sigmoid and tanh, so the two
agree to float rounding, not bit for bit (tests/test_torch_kernels_cuda.py;
chip_smoke.py phase 3d states the gate).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import count_launch
from .rnnoise import (
    DENOISE_GRU_SIZE,
    NB_BANDS,
    NB_FEATURES,
    NOISE_GRU_SIZE,
    VAD_GRU_SIZE,
    WEIGHT_KEYS,
    WEIGHT_SHAPES,
    RnnState,
    rnn_frame,
)

launches = 0
# the hoisted products of a frame and channel (csrc/rnnoise_gru.cu): the VAD,
# noise and denoise GRUs' input terms that do not depend on the state
HOISTED = 3 * (VAD_GRU_SIZE + NOISE_GRU_SIZE + DENOISE_GRU_SIZE)


def rnn_frames_plain(features, silence, rnn: RnnState, weights: Dict[str, torch.Tensor]):
    """The GRU stack frame by frame in torch ops (the kernel's plain version)."""
    gains, vads = [], []
    for k in range(features.shape[0]):
        new, g, v = rnn_frame(rnn, weights, features[k])
        sil = silence[k]
        keep = sil[:, None]
        rnn = RnnState(*(torch.where(keep, old, n) for old, n in zip(rnn, new)))
        gains.append(torch.where(keep, torch.ones_like(g), g))
        vads.append(torch.where(sil, torch.zeros_like(v), v))
    return torch.stack(gains), torch.stack(vads), rnn


def _check(features, silence, rnn: RnnState, weights):
    dev = features.device
    if features.dtype != torch.float32 or features.dim() != 3 \
            or features.shape[2] != NB_FEATURES or features.shape[0] < 1:
        raise ValueError(f"rnn_frames: features must be float32 [K >= 1, C, {NB_FEATURES}]")
    K, C, _ = features.shape
    if silence.dtype != torch.bool or tuple(silence.shape) != (K, C):
        raise ValueError(f"rnn_frames: silence must be bool [{K}, {C}]")
    want = ((rnn.vad_h, VAD_GRU_SIZE), (rnn.noise_h, NOISE_GRU_SIZE),
            (rnn.denoise_h, DENOISE_GRU_SIZE))
    if any(h.dtype != torch.float32 or tuple(h.shape) != (C, n) for h, n in want):
        raise ValueError(f"rnn_frames: states must be float32 [{C}, 24], [{C}, 48], [{C}, 96]")
    for k in WEIGHT_KEYS:
        w = weights[k]
        if w.dtype != torch.float32 or tuple(w.shape) != WEIGHT_SHAPES[k]:
            raise ValueError(f"rnn_frames: {k} must be float32 {WEIGHT_SHAPES[k]}")
    for t in (silence, *rnn, *(weights[k] for k in WEIGHT_KEYS)):
        if t.device != dev:
            raise ValueError(f"rnn_frames: every input must be on {dev}")


def _lib():
    from ..utils.build import load

    lib = load("rnnoise_gru")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.rnnoise_gru.argtypes = [ptr] * 6 + [ctypes.c_int, ctypes.c_int] + [ptr] * 7
        lib.rnnoise_gru.restype = ctypes.c_int
        lib.rnnoise_gru_error_string.argtypes = [ctypes.c_int]
        lib.rnnoise_gru_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def rnn_frames(features, silence, rnn: RnnState, weights: Dict[str, torch.Tensor]):
    """The GRU stack over K frames: (gains [K, C, 22], vads [K, C], rnn')."""
    _check(features, silence, rnn, weights)
    dev = features.device
    if dev.type == "cpu":
        return rnn_frames_plain(features, silence, rnn, weights)
    if dev.type != "cuda":
        raise ValueError(f"rnn_frames: unsupported device {dev}")
    K, C, _ = features.shape
    features = features.contiguous()
    silence = silence.contiguous()
    h0 = [h.contiguous() for h in rnn]
    ws = [weights[k].contiguous() for k in WEIGHT_KEYS]
    hoisted = torch.empty((K, C, HOISTED), dtype=torch.float32, device=dev)
    gains = torch.empty((K, C, NB_BANDS), dtype=torch.float32, device=dev)
    vads = torch.empty((K, C), dtype=torch.float32, device=dev)
    h1 = [torch.empty_like(h) for h in h0]
    wptrs = (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws))
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rnnoise_gru(features.data_ptr(), silence.data_ptr(), h0[0].data_ptr(),
                              h0[1].data_ptr(), h0[2].data_ptr(), ctypes.addressof(wptrs), K, C,
                              hoisted.data_ptr(), gains.data_ptr(), vads.data_ptr(),
                              h1[0].data_ptr(), h1[1].data_ptr(), h1[2].data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"rnn_frames launch failed: "
                           f"{lib.rnnoise_gru_error_string(err).decode()}")
    count_launch(__name__, "launches")
    return gains, vads, RnnState(*h1)


__all__ = ["launches", "rnn_frames", "rnn_frames_plain"]
