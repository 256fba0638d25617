"""Pixel conversions shared by the per-pixel effects (colorlut, hsv).

`to_unit` is the `frame[..., c].astype(f32) / maxval` of the JAX package.
Under `jax.jit`, XLA turns that division by a constant into a product with
the f32 reciprocal of maxval, which differs from the IEEE quotient in the
last bit for 512 of the 65,536 u16 codes.  PyTorch does the same on CUDA
for a Python-scalar divisor, but not on the CPU.  So the port multiplies by
the reciprocal explicitly, on every device, and the kernels do too
(csrc/colorlut_lowrank.cu): the JAX package, the plain versions and the
kernels then see the same floats.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def to_unit(chan: torch.Tensor, maxval: float) -> torch.Tensor:
    """chan (any integer or float dtype) as float32, times f32(1 / maxval)."""
    return chan.to(torch.float32) * float(np.float32(1.0) / np.float32(maxval))


def restack(frame, offsets: Sequence[int], comps, dtype):
    """frame with channel offsets[i] replaced by comps[i] (the frame's
    spatial shape), in one stack, converted to dtype."""
    offsets = tuple(offsets)
    chans = [comps[offsets.index(ch)] if ch in offsets else frame[..., ch]
             for ch in range(frame.shape[-1])]
    return torch.stack(chans, dim=-1).to(dtype)


__all__ = ["restack", "to_unit"]
