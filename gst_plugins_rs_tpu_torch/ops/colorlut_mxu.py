"""Trilinear 3D-LUT sampling against a bf16 packed table: kernel B5 on Hopper.

The port of gst_plugins_rs_tpu/ops/pallas_colorlut.py, whose TPU kernel
takes trilinear sampling as a dense matmul on the MXU:

    out(p) = sum_{y,z} [wy_y(p) * wz_z(p)] * T2[y*S+z, :]

then reduces each channel's 128 lanes against the x hat weights.  T2
(`pack_matmul_table`) packs, per (y,z) pair, the S x-entries of all 3
channels.  `lut3d_positions_mxu` is the kernel: for a CUDA tensor it
launches csrc/colorlut_mxu.cu, which computes only the product's nonzero
terms (design and bound noted there), or raises; for a CPU tensor it runs
`lut3d_positions_mxu_plain`, the same sparse sum in plain PyTorch.
`lut3d_apply_mxu` is the public function; as in the JAX package, no
element calls it.  Only sizes with 3*size <= 128 lanes (size <= 42) are
supported.  `launches` counts kernel launches.

Reference math: video/colorlut/src/colorlut/imp.rs:493-526 (trilinear
with x1 = min(x0+1, size-1) clamping — the hat formulation reproduces
the clamped weights exactly at the boundaries).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .colorlut import grid_coord, quantize
from .pixels import restack

LANES = 128

launches = 0


def pack_matmul_table(table: np.ndarray, size: int) -> np.ndarray:
    """[size^3, 3] flat LUT ([x + y*s + z*s^2] order) -> [YZPAD, 128] f32
    with T2[y*s + z, c*s + i] = table value of channel c at (i, y, z)."""
    if 3 * size > 128:
        raise ValueError(f"MXU colorlut kernel supports size <= 42, got {size}")
    yz = size * size
    yzpad = ((yz + 127) // 128) * 128
    t = table.reshape(size, size, size, 3)  # [z, y, x, c]
    t2 = np.zeros((yzpad, 128), np.float32)
    for c in range(3):
        # rows j = y*size + z; lanes c*size + i
        block = np.transpose(t[:, :, :, c], (1, 0, 2)).reshape(yz, size)  # [y*z, x]
        t2[:yz, c * size:(c + 1) * size] = block
    return t2


def _hat(x, size: int):
    """Rows i0 = floor(x) and i0+1 (read clamped to size-1, where the
    weight is 0) and their weights max(0, 1-|x-i|)."""
    f = torch.floor(x)
    i0 = f.to(torch.int64)
    return (i0, torch.clamp(i0 + 1, max=size - 1),
            torch.clamp(1.0 - torch.abs(x - f), min=0.0),
            torch.clamp(1.0 - torch.abs(x - (f + 1.0)), min=0.0))


def lut3d_positions_mxu_plain(xpos, ypos, zpos, t2_bf16, *, size: int):
    """B5's function in plain PyTorch: the 4 nonzero (y,z) rows in
    ascending order with weights bf16(wy*wz), then the x hat per channel."""
    x0, x1, wx0, wx1 = _hat(xpos, size)
    y0, y1, wy0, wy1 = _hat(ypos, size)
    z0, z1, wz0, wz1 = _hat(zpos, size)
    table = t2_bf16.to(torch.float32).reshape(-1)
    terms = [((ya * size + zb) * LANES, (wy * wz).to(torch.bfloat16).to(torch.float32))
             for ya, wy in ((y0, wy0), (y1, wy1)) for zb, wz in ((z0, wz0), (z1, wz1))]
    outs = []
    for c in range(3):
        lanes = []
        for xi in (x0, x1):
            o = torch.zeros_like(xpos)
            for row, w in terms:
                o = o + w * table[row + c * size + xi]
            lanes.append(o)
        outs.append(lanes[0] * wx0 + lanes[1] * wx1)
    return tuple(outs)


def _lib():
    from ..utils.build import load

    lib = load("colorlut_mxu")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.colorlut_mxu.argtypes = [ptr] * 7 + [ctypes.c_longlong, ctypes.c_int, ptr]
        lib.colorlut_mxu.restype = ctypes.c_int
        lib.colorlut_mxu_error_string.argtypes = [ctypes.c_int]
        lib.colorlut_mxu_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def lut3d_positions_mxu(xpos, ypos, zpos, t2_bf16, *, size: int):
    """positions: [P] f32 in [0, size-1]; t2_bf16 [YZPAD, 128] bf16 from
    pack_matmul_table; returns (r, g, b) [P] f32."""
    global launches
    if xpos.device.type == "cpu":
        return lut3d_positions_mxu_plain(xpos, ypos, zpos, t2_bf16, size=size)
    if xpos.device.type != "cuda":
        raise ValueError(f"lut3d_positions_mxu: unsupported device {xpos.device}")
    if not 2 <= size <= LANES // 3:
        raise ValueError(f"lut3d_positions_mxu: size must be in 2..{LANES // 3}, got {size}")
    for name, t in (("xpos", xpos), ("ypos", ypos), ("zpos", zpos)):
        if (t.dim() != 1 or t.shape != xpos.shape or t.dtype != torch.float32
                or t.device != xpos.device or not t.is_contiguous()):
            raise ValueError(f"lut3d_positions_mxu: {name} must be a contiguous [P] float32 "
                             f"on {xpos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (t2_bf16.dim() != 2 or t2_bf16.shape[1] != LANES or t2_bf16.shape[0] < size * size
            or t2_bf16.dtype != torch.bfloat16 or t2_bf16.device != xpos.device
            or not t2_bf16.is_contiguous()):
        raise ValueError(f"lut3d_positions_mxu: t2 must be a contiguous [>={size * size}, "
                         f"{LANES}] bfloat16 on {xpos.device}, got {t2_bf16.dtype} "
                         f"{tuple(t2_bf16.shape)}")
    outs = [torch.empty_like(xpos) for _ in range(3)]
    lib = _lib()
    with torch.cuda.device(xpos.device):
        stream = torch.cuda.current_stream(xpos.device).cuda_stream
        err = lib.colorlut_mxu(xpos.data_ptr(), ypos.data_ptr(), zpos.data_ptr(),
                               t2_bf16.data_ptr(), *(o.data_ptr() for o in outs),
                               xpos.numel(), size, stream)
    if err != 0:
        raise RuntimeError(f"lut3d_positions_mxu launch failed: "
                           f"{lib.colorlut_mxu_error_string(err).decode()}")
    launches += 1
    return tuple(outs)


def lut3d_apply_mxu(frame, t2_bf16, scale, offset, *, size: int,
                    offsets=(0, 1, 2), bits: int = 8):
    """Drop-in fast-path peer of ops/colorlut.lut3d_apply_packed.

    frame [..., C] uint; t2_bf16 from pack_matmul_table (cast to bf16)."""
    maxval = float(2 ** bits - 1)
    fi = frame.to(torch.int32)
    shape = fi.shape[:-1]
    pos = [grid_coord(fi, off, scale[comp], offset[comp], size, maxval).reshape(-1)
           for comp, off in enumerate(offsets)]
    rgb = lut3d_positions_mxu(*pos, t2_bf16, size=size)
    return restack(fi, offsets, [quantize(cc.reshape(shape), maxval) for cc in rgb],
                   frame.dtype)


__all__ = ["LANES", "launches", "lut3d_apply_mxu", "lut3d_positions_mxu",
           "lut3d_positions_mxu_plain", "pack_matmul_table"]
