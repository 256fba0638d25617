"""asr-lite's BiGRU recurrence over an utterance: kernel T1 and its plain version.

The JAX package runs each direction of each layer as a `lax.scan` of its
GRU cell (gst_plugins_rs_tpu/ops/asr.py::_gru_scan :124, scanned at :137).
It is XLA there, not Pallas.  The port splits the cell: the input part of
every gate comes from one product before the recurrence
(ops/asr.py::input_projections), and what depends on h runs here, on the
card as one launch of csrc/asr_gru.cu per layer (design and bounds noted
there).

`bigru(X, U)`:
  X [B, 2, T, 3H] float32: x @ W_g[:D] + b_g for the gates z, r, h (in that
  order on the last axis), direction 0 forward and 1 backward; U [2, 3, H, H]
  float32: the recurrent parts W_g[D:] of each direction's gates, H = 96.
  Returns the hidden states [B, 2, T, H]; out[:, 1, t] is the backward
  state after it has walked frames T-1 down to t, as the reversed scan
  returns it.

For CUDA tensors it launches the kernel (counted in `launches`) or raises;
for CPU tensors it runs `bigru_plain`, a step loop of torch ops that
computes the JAX cell.  The kernel holds U in registers, sums each row in
two lanes' parts of 48 terms and takes its gates from the MUFU's ex2 and
rcp approximations, so the two agree to float rounding, within 1e-5 of
1 + |ref| (tests/test_torch_kernels_cuda.py; chip_smoke.py phase 3g);
tests/test_torch_asr_split.py models the kernel's summation order on the
CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import count_launch

HIDDEN = 96

launches = 0


def bigru_plain(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The recurrence step by step in torch ops (the kernel's plain version):
    z = sigmoid(X_z + h U_z), r = sigmoid(X_r + h U_r),
    hh = tanh(X_h + (r h) U_h), h = (1 - z) h + z hh."""
    B, _, T, _ = X.shape
    H = HIDDEN
    h = X.new_zeros((B, 2, H))
    out = X.new_empty((B, 2, T, H))
    for s in range(T):
        x = torch.stack([X[:, 0, s], X[:, 1, T - 1 - s]], 1)  # [B, 2, 3H]
        z = torch.sigmoid(x[..., :H] + torch.einsum("bdi,dij->bdj", h, U[:, 0]))
        r = torch.sigmoid(x[..., H:2 * H] + torch.einsum("bdi,dij->bdj", h, U[:, 1]))
        hh = torch.tanh(x[..., 2 * H:] + torch.einsum("bdi,dij->bdj", r * h, U[:, 2]))
        h = (1 - z) * h + z * hh
        out[:, 0, s] = h[:, 0]
        out[:, 1, T - 1 - s] = h[:, 1]
    return out


def _check(X, U):
    H = HIDDEN
    if X.dtype != torch.float32 or X.dim() != 4 or X.shape[1] != 2 or X.shape[3] != 3 * H \
            or X.shape[0] < 1 or X.shape[2] < 1:
        raise ValueError(f"bigru: X must be float32 [B >= 1, 2, T >= 1, {3 * H}]")
    if U.dtype != torch.float32 or tuple(U.shape) != (2, 3, H, H):
        raise ValueError(f"bigru: U must be float32 [2, 3, {H}, {H}]")
    if U.device != X.device:
        raise ValueError(f"bigru: U must be on {X.device}")


def _lib():
    from ..utils.build import load

    lib = load("asr_gru")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.asr_gru.argtypes = [ptr, ptr, ctypes.c_int, ctypes.c_int, ptr, ptr]
        lib.asr_gru.restype = ctypes.c_int
        lib.asr_gru_error_string.argtypes = [ctypes.c_int]
        lib.asr_gru_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def bigru(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The BiGRU recurrence of one layer: hidden states [B, 2, T, H]."""
    _check(X, U)
    dev = X.device
    if dev.type == "cpu":
        return bigru_plain(X, U)
    if dev.type != "cuda":
        raise ValueError(f"bigru: unsupported device {dev}")
    X, U = X.contiguous(), U.contiguous()
    if X.data_ptr() % 16:  # the kernel copies X in 16-byte pieces
        X = X.clone()
    B, _, T, _ = X.shape
    out = torch.empty((B, 2, T, HIDDEN), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.asr_gru(X.data_ptr(), U.data_ptr(), B, T, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bigru launch failed: {lib.asr_gru_error_string(err).decode()}")
    count_launch(__name__, "launches")
    return out


__all__ = ["HIDDEN", "bigru", "bigru_plain", "launches"]
