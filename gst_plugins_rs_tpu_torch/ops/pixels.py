"""Pixel conversions shared by the per-pixel effects (colorlut, hsv).

`to_unit` is the `frame[..., c].astype(f32) / maxval` of the JAX package.
Under `jax.jit`, XLA turns that division by a constant into a product with
the f32 reciprocal of maxval, which differs from the IEEE quotient in the
last bit for 512 of the 65,536 u16 codes.  PyTorch does the same on CUDA
for a Python-scalar divisor, but not on the CPU.  So the port multiplies by
the reciprocal explicitly, on every device, and the kernels do too
(csrc/colorlut_lowrank.cu, csrc/colorlut_mxu.cu): the JAX package, the
plain versions and the kernels then see the same floats.
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


# The glue of the packed kernel entries (colorlut_lowrank_fused, colorlut_mxu)
# in plain PyTorch.  px holds pixels of four components of `bits` bits (int32
# RGBA u8 for 8, int64 RGBA64 for 16), R in the low bits, any shape; params
# [8] f32 = (scale0..2, offset0..2, maxval, 0).


def unpack_grid_coords(px, params, size: int, bits: int):
    """The three grid coordinates [P] f32 in [0, size-1] of packed pixels:
    clip(v * f32(1/maxval) * scale + offset, 0, 1) * (size-1), each product
    and sum rounded on its own, as the kernels compute it."""
    flat = px.reshape(-1)
    coords = []
    for comp in range(3):
        v = torch.bitwise_and(torch.bitwise_right_shift(flat, bits * comp), (1 << bits) - 1)
        v = v.to(torch.float32) * (1.0 / params[6])  # as to_unit
        coords.append(torch.clamp(v * params[comp] + params[3 + comp], 0.0, 1.0)
                      * (size - 1.0))
    return coords


def repack_quantized(outs, px, params, bits: int):
    """The three sampled outputs [P] f32, each rounded as round(clip(y, 0,
    1) * maxval) (half to even), packed into px's words with px's alpha."""
    flat = px.reshape(-1)
    q = [torch.round(torch.clamp(o, 0.0, 1.0) * params[6]).to(flat.dtype) for o in outs]
    # alpha: the top component of the input, as the two's-complement mask
    # ~(2^(3 bits) - 1)
    packed = (q[0] | torch.bitwise_left_shift(q[1], bits)
              | torch.bitwise_left_shift(q[2], 2 * bits)
              | torch.bitwise_and(flat, -(1 << 3 * bits)))
    return packed.reshape(px.shape)


__all__ = ["repack_quantized", "restack", "to_unit", "unpack_grid_coords"]
