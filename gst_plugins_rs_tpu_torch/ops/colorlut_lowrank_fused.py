"""Fused low-rank (CP) colorlut sampling: kernels B2 and B3 on Hopper.

The port of gst_plugins_rs_tpu/ops/pallas_colorlut_lowrank.py.  The dense
form of ops/colorlut_lowrank.py materializes [P,S] hat weights and [P,K]
projections between operators; the kernels keep the whole per-pixel chain
on chip (design and bound in csrc/colorlut_lowrank.cu):

- `lowrank_sample_fused` (B3): f32 grid coordinates xyz [3,P] -> [3,P] f32;
  `lut3d_apply_lowrank_fused` normalizes the frame, calls it, rounds and
  restacks the channels (any layout, u8 or u16);
- `lowrank_sample_packed` (B2): RGBA u8 pixels as int32 -> int32, with the
  normalization, rounding and repacking inside the kernel; alpha rides
  through;
- `lowrank_sample_packed64` (B3's chain for RGBA64): 4 x u16 pixels as
  int64 -> int64, B2's kernel at 16 bits a component.  The JAX package runs
  this glue as XLA ops around B3; the port runs it inside the kernel.
  `lut3d_apply_lowrank_packed` bit-casts an RGBA u8 or RGBA64 frame to B2
  or to it.

All three share one per-pixel chain, so they are bit-equal on the same
pixels.  For a CUDA tensor each wrapper launches its kernel or raises; for
a CPU tensor it runs the `_plain` twin, the same chain in plain PyTorch:
the two nonzero hat weights per axis (the second factor row read from a
zero column at SB, as the kernel's factor rows hold it), factors and
weights rounded to the compute type, the rank sum in f32 with k ascending,
as the kernel computes it.  The TPU kernels pad P to their lane tiles (TPL,
ROWS*TPL); these take any P, and the public wrappers return the frame's
shape.  `packed_launches`, `packed64_launches` and `fused_launches` count
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from .colorlut import grid_coord, quantize
from . import count_launch
from .pixels import repack_quantized, restack, unpack_grid_coords
from .colorlut_lowrank import compute_type

# basis rows of the padded factor layout: hat weights for rows >= S are
# exactly 0 whenever x <= S-1, so no mask is needed
SB = 48
# A block may use at most 227 KB of shared memory on sm_90.
_MAX_SMEM = 232_448

packed_launches = 0    # B2
packed64_launches = 0  # B3's chain on RGBA64 pixels
fused_launches = 0     # B3


def pack_factors(U, V, W, C, pad_rank_to: int = 16):
    """CP factors [S,K]x3 + [3,K] -> kernel layout: ut/vt/wt [Kp, SB] f32
    (transposed, zero-padded) and c [8, Kp]."""
    s, k = U.shape
    kp = -(-k // pad_rank_to) * pad_rank_to
    assert s <= SB, f"LUT size {s} exceeds kernel basis capacity {SB}"

    def t(m):
        out = np.zeros((kp, SB), np.float32)
        out[:k, :s] = m.T
        return out

    c = np.zeros((8, kp), np.float32)
    c[:3, :k] = C
    return t(U), t(V), t(W), c


# ---------------------------------------------------------------------------
# plain PyTorch versions


def _hats(x, cdt):
    """The two nonzero hat weights of x in [0, S-1]: rows i0 = floor(x) and
    i0+1, weights max(0, 1-|x-i|) rounded to the compute type."""
    f = torch.floor(x)
    h0 = torch.clamp(1.0 - torch.abs(x - f), min=0.0).to(cdt).to(torch.float32)
    h1 = torch.clamp(1.0 - torch.abs(x - (f + 1.0)), min=0.0).to(cdt).to(torch.float32)
    i0 = f.to(torch.int64)
    return i0, i0 + 1, h0, h1


def _chain_plain(x, y, z, ut, vt, wt, c, compute_dtype):
    """[3, P] f32 LUT outputs at grid coordinates x, y, z [P]."""
    cdt = compute_type(compute_dtype)
    hats = [_hats(a, cdt) for a in (x, y, z)]
    # a zero column at SB: row i0+1 = SB reads 0, as the kernel's last pair
    factors = [torch.nn.functional.pad(f.to(cdt).to(torch.float32), (0, 1))
               for f in (ut, vt, wt)]
    acc = [torch.zeros_like(x) for _ in range(3)]
    for k in range(ut.shape[0]):
        u, v, w = (f[k][i0] * h0 + f[k][i1] * h1
                   for f, (i0, i1, h0, h1) in zip(factors, hats))
        p = u * v * w
        for ch in range(3):
            acc[ch] = acc[ch] + p * c[ch, k]
    return torch.stack(acc)


def lowrank_sample_fused_plain(xyz, ut, vt, wt, c, *, compute_dtype="bfloat16"):
    """B3's function in plain PyTorch: xyz [3, P] f32 in [0, S-1] -> [3, P]."""
    return _chain_plain(xyz[0], xyz[1], xyz[2], ut, vt, wt, c, compute_dtype)


def lowrank_sample_packed_plain(px, params, ut, vt, wt, c, *, size: int,
                                compute_dtype="bfloat16", bits: int = 8):
    """B2's function in plain PyTorch (bits 8: px int32 RGBA u8 bit
    patterns) and packed64's (bits 16: px int64 RGBA64 bit patterns, 4 x
    u16), R in the low bits, any shape; params [8] f32 = (scale0..2,
    offset0..2, maxval, 0)."""
    coords = unpack_grid_coords(px, params, size, bits)
    return repack_quantized(_chain_plain(*coords, ut, vt, wt, c, compute_dtype), px, params,
                            bits)


# ---------------------------------------------------------------------------
# the kernels


def smem_bytes(k: int, compute_dtype="bfloat16") -> int:
    """Shared memory of a block at rank k: C as float4 [k], then the U, V, W
    factors as 32-bit words, [k, 48] bf16 pairs or [k, 49] f32 entries."""
    row = SB if compute_type(compute_dtype) == torch.bfloat16 else SB + 1
    return 16 * k + 3 * k * row * 4


def _check_factors(name, ref, ut, vt, wt, c, compute_dtype):
    k = ut.shape[0] if ut.dim() == 2 else -1
    for label, t, shape in (("ut", ut, (k, SB)), ("vt", vt, (k, SB)), ("wt", wt, (k, SB)),
                            ("c", c, (8, k))):
        if tuple(t.shape) != shape or k < 1:
            raise ValueError(f"{name}: {label} must be {shape} with K >= 1, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: {label} is on {t.device}, the pixels on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    smem = smem_bytes(k, compute_dtype)
    if smem > _MAX_SMEM:
        raise ValueError(f"{name}: rank {k} needs {smem} bytes of shared memory, "
                         f"more than a block's {_MAX_SMEM}")
    return k


def _lib():
    from ..utils.build import load

    lib = load("colorlut_lowrank")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.colorlut_lowrank_fused.argtypes = [ptr] * 6 + [i64, i32, i32, ptr]
        lib.colorlut_lowrank_fused.restype = ctypes.c_int
        lib.colorlut_lowrank_packed.argtypes = [ptr] * 7 + [i64] + [i32] * 4 + [ptr]
        lib.colorlut_lowrank_packed.restype = ctypes.c_int
        lib.colorlut_lowrank_error_string.argtypes = [ctypes.c_int]
        lib.colorlut_lowrank_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.colorlut_lowrank_error_string(err).decode()}")


def lowrank_sample_fused(xyz, ut, vt, wt, c, *, compute_dtype="bfloat16"):
    """xyz [3, P] f32 continuous grid coords in [0, S-1]; ut/vt/wt [Kp, SB]
    transposed axis factors (rows >= S zero); c [8, Kp] channel factors
    (rows >= 3 zero).  Returns [3, P] f32 interpolated LUT outputs."""
    if xyz.device.type == "cpu":
        return lowrank_sample_fused_plain(xyz, ut, vt, wt, c, compute_dtype=compute_dtype)
    if xyz.device.type != "cuda":
        raise ValueError(f"lowrank_sample_fused: unsupported device {xyz.device}")
    if xyz.dim() != 2 or xyz.shape[0] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"lowrank_sample_fused: xyz must be [3, P] float32, "
                         f"got {tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("lowrank_sample_fused: xyz must be contiguous")
    k = _check_factors("lowrank_sample_fused", xyz, ut, vt, wt, c, compute_dtype)
    bf16 = int(compute_type(compute_dtype) == torch.bfloat16)
    out = torch.empty_like(xyz)
    lib = _lib()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        err = lib.colorlut_lowrank_fused(xyz.data_ptr(), ut.data_ptr(), vt.data_ptr(),
                                         wt.data_ptr(), c.data_ptr(), out.data_ptr(),
                                         xyz.shape[1], k, bf16, stream)
    _raise_on(lib, err, "lowrank_sample_fused")
    count_launch(__name__, "fused_launches")
    return out


def _sample_packed(name, bits, px, params, ut, vt, wt, c, size, compute_dtype):
    """Checks the operands of a CUDA packed entry and launches its kernel
    (bits 8: B2, 16: packed64); the caller counts the launch."""
    if px.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {px.device}")
    word = torch.int32 if bits == 8 else torch.int64
    if px.dtype != word or not px.is_contiguous():
        raise ValueError(f"{name}: px must be contiguous {word}, got {px.dtype}")
    if (tuple(params.shape) != (8,) or params.dtype != torch.float32
            or params.device != px.device):
        raise ValueError(f"{name}: params must be [8] float32 on px's device")
    if not 2 <= size <= SB:
        raise ValueError(f"{name}: size must be in 2..{SB}, got {size}")
    k = _check_factors(name, px, ut, vt, wt, c, compute_dtype)
    bf16 = int(compute_type(compute_dtype) == torch.bfloat16)
    out = torch.empty_like(px)
    lib = _lib()
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        err = lib.colorlut_lowrank_packed(px.data_ptr(), params.data_ptr(), ut.data_ptr(),
                                          vt.data_ptr(), wt.data_ptr(), c.data_ptr(),
                                          out.data_ptr(), px.numel(), k, size, bits, bf16,
                                          stream)
    _raise_on(lib, err, name)
    return out


def lowrank_sample_packed(px, params, ut, vt, wt, c, *, size: int, compute_dtype="bfloat16"):
    """px int32 RGBA bit patterns, any shape (the TPU kernel takes
    [Pr, 4096]); params [8] f32 = (scale0..2, offset0..2, maxval, 0).
    Returns int32 of px's shape."""
    if px.device.type == "cpu":
        return lowrank_sample_packed_plain(px, params, ut, vt, wt, c, size=size,
                                           compute_dtype=compute_dtype)
    out = _sample_packed("lowrank_sample_packed", 8, px, params, ut, vt, wt, c, size,
                         compute_dtype)
    count_launch(__name__, "packed_launches")
    return out


def lowrank_sample_packed64(px, params, ut, vt, wt, c, *, size: int,
                            compute_dtype="bfloat16"):
    """B3's chain on RGBA64 pixels: px int64 bit patterns of 4 x u16 (R in
    the low bits), any shape; params [8] f32 = (scale0..2, offset0..2,
    maxval 65535, 0).  Returns int64 of px's shape, alpha unchanged."""
    if px.device.type == "cpu":
        return lowrank_sample_packed_plain(px, params, ut, vt, wt, c, size=size,
                                           compute_dtype=compute_dtype, bits=16)
    out = _sample_packed("lowrank_sample_packed64", 16, px, params, ut, vt, wt, c, size,
                         compute_dtype)
    count_launch(__name__, "packed64_launches")
    return out


# ---------------------------------------------------------------------------
# frame wrappers


def lut3d_apply_lowrank_fused(frame, ut, vt, wt, c, scale, offset, *,
                              size: int, offsets: Sequence[int], bits: int,
                              compute_dtype: str = "bfloat16"):
    """Drop-in peer of colorlut_lowrank.lut3d_apply_lowrank running the
    inner chain through B3.  frame [..., C] uint8/uint16."""
    maxval = float(2**bits - 1)
    fi = frame.to(torch.int32)
    xyz = torch.stack([grid_coord(fi, off, scale[comp], offset[comp], size, maxval).reshape(-1)
                       for comp, off in enumerate(offsets)])
    cc = lowrank_sample_fused(xyz, ut, vt, wt, c, compute_dtype=compute_dtype)  # [3, P]
    shp = fi.shape[:-1]
    return restack(fi, offsets, [quantize(cc[comp], maxval).reshape(shp) for comp in range(3)],
                   frame.dtype)


def packed_params(scale, offset, bits: int, device):
    """The packed entries' params [8] f32 on `device`: (scale0..2,
    offset0..2, maxval, 0)."""
    return torch.tensor([scale[0], scale[1], scale[2], offset[0], offset[1], offset[2],
                         float(2**bits - 1), 0.0], dtype=torch.float32).to(device)


def lut3d_apply_lowrank_packed(frame, ut, vt, wt, c, scale, offset, *,
                               size: int, offsets: Sequence[int], bits: int,
                               compute_dtype: str = "bfloat16", params=None):
    """Fully-fused path for RGBA frames (offsets (0,1,2)): an RGBA u8 frame
    (bits 8) is bit-cast to int32 pixels and runs B2, an RGBA64 u16 frame
    (bits 16) to int64 pixels and runs packed64; the whole
    unpack/sample/repack runs in the kernel.  Other layouts are the
    caller's job.  `params` (from `packed_params` on the frame's device)
    may be built once by the caller: the upload from host memory it
    otherwise makes on every call cannot be captured in a CUDA graph."""
    kinds = {8: (torch.uint8, torch.int32, lowrank_sample_packed),
             16: (torch.uint16, torch.int64, lowrank_sample_packed64)}
    if bits not in kinds or tuple(offsets) != (0, 1, 2) or frame.shape[-1] != 4 \
            or frame.dtype != kinds[bits][0]:
        raise ValueError("lut3d_apply_lowrank_packed takes RGBA uint8 or RGBA64 uint16 "
                         "frames only")
    dtype, word, sample = kinds[bits]
    px = frame.contiguous().view(word)  # [..., 1]
    if params is None:
        params = packed_params(scale, offset, bits, frame.device)
    out = sample(px, params, ut, vt, wt, c, size=size, compute_dtype=compute_dtype)
    return out.view(dtype).reshape(frame.shape)


__all__ = ["SB", "fused_launches", "lowrank_sample_fused", "lowrank_sample_fused_plain",
           "lowrank_sample_packed", "lowrank_sample_packed64", "lowrank_sample_packed_plain",
           "lut3d_apply_lowrank_fused", "lut3d_apply_lowrank_packed", "pack_factors",
           "packed64_launches", "packed_launches", "packed_params", "smem_bytes"]
