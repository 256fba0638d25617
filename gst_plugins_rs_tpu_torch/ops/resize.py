"""Separable image resizing as two matrix products per plane (videoscale).

The port of gst_plugins_rs_tpu/ops/resize.py.  Bilinear and nearest
resampling are separable: out = A_h @ img @ A_w^T with interpolation
matrices A_h [H2, H1] and A_w [W2, W1] built on the host once per geometry
(`resize_matrix`, copied from the JAX module).  The products run in full
float32 (TF32 off, `_device.no_tf32`), so a nearest matrix, which is
one-hot, copies pixels exactly.

Weight convention: half-pixel centres (src = (i + 0.5) * in/out - 0.5),
edges clamped.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .._device import device, no_tf32


@lru_cache(maxsize=256)
def resize_matrix(n_out: int, n_in: int, method: str = "bilinear") -> np.ndarray:
    """[n_out, n_in] f32 row-stochastic interpolation matrix."""
    if n_out == n_in:
        return np.eye(n_in, dtype=np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    if method == "nearest":
        idx = np.clip(np.floor(src + 0.5).astype(np.int64), 0, n_in - 1)
        m[np.arange(n_out), idx] = 1.0
    elif method == "bilinear":
        lo = np.floor(src).astype(np.int64)
        frac = (src - lo).astype(np.float32)
        lo_c = np.clip(lo, 0, n_in - 1)
        hi_c = np.clip(lo + 1, 0, n_in - 1)
        rows = np.arange(n_out)
        np.add.at(m, (rows, lo_c), 1.0 - frac)
        np.add.at(m, (rows, hi_c), frac)
    else:
        raise ValueError(f"unknown resize method {method!r}")
    return m


def resize_plane(img: torch.Tensor, ah: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """[..., H1, W1] (any real dtype) -> [..., H2, W2] f32 via two products."""
    x = img.to(torch.float32)
    with no_tf32():
        return torch.matmul(torch.matmul(ah, x), aw.T)


def _round_u8(y: torch.Tensor) -> torch.Tensor:
    # torch.round is half to even, as jnp.round
    return torch.clamp(torch.round(y), 0.0, 255.0).to(torch.uint8)


def resize_u8(img: torch.Tensor, ah: torch.Tensor, aw: torch.Tensor) -> torch.Tensor:
    """[H1, W1] or [H1, W1, C] u8 -> resized u8, rounded half to even."""
    if img.dim() == 2:
        return _round_u8(resize_plane(img, ah, aw))
    # channels-last: one batched product over the [C, H, W] planes
    return _round_u8(resize_plane(img.permute(2, 0, 1), ah, aw)).permute(1, 2, 0).contiguous()


def resize_matrices(h_in: int, w_in: int, h_out: int, w_out: int, method: str, dev):
    """(A_h, A_w) as f32 tensors on `dev`."""
    return (torch.from_numpy(resize_matrix(h_out, h_in, method)).to(dev),
            torch.from_numpy(resize_matrix(w_out, w_in, method)).to(dev))


def make_resizer(h_in: int, w_in: int, h_out: int, w_out: int,
                 method: str = "bilinear"):
    """[H1,W1,(C)] u8 -> [H2,W2,(C)] u8 closure for one geometry, on the
    selected device (frames that arrive elsewhere are moved there)."""
    dev = device()
    ah, aw = resize_matrices(h_in, w_in, h_out, w_out, method, dev)
    return lambda img: resize_u8(torch.as_tensor(img, device=dev), ah, aw)


__all__ = ["resize_matrix", "resize_matrices", "resize_plane", "resize_u8", "make_resizer"]
