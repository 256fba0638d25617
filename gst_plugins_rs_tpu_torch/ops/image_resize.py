"""The weights of `jax.image.resize`, built on the host with numpy.

The JAX package resizes with `jax.image.resize` in two places: the
compositor's per-pad scaling (linear or nearest) and the perceptual hashes'
downscale to 8x8 (linear).  This module is the numpy twin of what that
function computes (jax 0.9.0, `jax/_src/image/scale.py`):

- linear (`compute_weight_mat` with the triangle kernel): the weight of
  input sample j in output sample i is max(0, 1 - |s_i - j| / k) with
  s_i = (i + 0.5) * in/out - 0.5 and k = max(in/out, 1), so a downscale
  widens the triangle to a support of in/out pixels (antialiasing, on by
  default); each output's weights are divided by their sum, and an output
  whose s_i lies outside [-0.5, in - 0.5] gets none.  The weights are
  computed in float64 and rounded to float32 once (jax computes them in its
  default float type and casts them to the image's float32).
- nearest (`_resize_nearest`): output i reads input floor((i + 0.5) * in
  / out) in float32, as XLA compiles it: the constant quotient folded into
  one product, (i + 0.5) * f32(f32(in) * f32(1 / out)) (720 -> 270 reads
  input 3 for output 1, where the exact quotient is 4).

`F.interpolate` is another function: its bilinear neither widens the
kernel nor renormalises (unless `antialias=True`), it clamps at the edges,
and its `nearest` reads floor(i * in / out).

`resize` applies the weights along each axis whose size changes (an axis
that keeps its size is left alone, as in jax), as products in full float32.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from .._device import no_tf32

_EPS32 = float(np.finfo(np.float32).eps)


@lru_cache(maxsize=64)
def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32: column i holds output i's weights over the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * _EPS32, w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


@lru_cache(maxsize=64)
def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """[n_out] int64: the input sample each output reads."""
    step = np.float32(n_in) * (np.float32(1.0) / np.float32(n_out))
    return np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * step).astype(np.int64)


@lru_cache(maxsize=64)
def _on_device(kind: str, n_in: int, n_out: int, dev: torch.device) -> torch.Tensor:
    arr = linear_weights(n_in, n_out) if kind == "linear" else nearest_indices(n_in, n_out)
    return torch.from_numpy(arr).to(dev)


def resize(img: torch.Tensor, size: Sequence[int], method: str = "linear") -> torch.Tensor:
    """`jax.image.resize(img, size + img.shape[2:], method)` for an [H, W] or
    [H, W, C] float32 tensor: (h, w) = size."""
    h, w = size
    h_in, w_in = img.shape[0], img.shape[1]
    dev = img.device
    if method == "nearest":
        if h != h_in:
            img = img.index_select(0, _on_device("nearest", h_in, h, dev))
        if w != w_in:
            img = img.index_select(1, _on_device("nearest", w_in, w, dev))
        return img
    if method != "linear":
        raise ValueError(f"unknown resize method {method!r}")
    with no_tf32():
        if h != h_in:
            wh = _on_device("linear", h_in, h, dev)  # [h_in, h]
            img = torch.matmul(wh.T, img.reshape(h_in, -1)).reshape((h,) + img.shape[1:])
        if w != w_in:
            ww = _on_device("linear", w_in, w, dev)  # [w_in, w]
            if img.dim() == 2:
                img = torch.matmul(img, ww)
            else:
                img = torch.matmul(img.transpose(1, 2), ww).transpose(1, 2)
    return img.contiguous()


__all__ = ["linear_weights", "nearest_indices", "resize"]
