"""Trilinear 3D-LUT sampling against a bf16 packed table: kernel B5 on Hopper.

The port of gst_plugins_rs_tpu/ops/pallas_colorlut.py, whose TPU kernel
takes trilinear sampling as a dense matmul on the MXU:

    out(p) = sum_{y,z} [wy_y(p) * wz_z(p)] * T2[y*S+z, :]

then reduces each channel's 128 lanes against the x hat weights.  T2
(`pack_matmul_table`) packs, per (y,z) pair, the S x-entries of all 3
channels.  csrc/colorlut_mxu.cu computes only the product's nonzero terms
from a table of 32-byte cells it builds from T2 in each call (`pack_cells`
is that layout in plain PyTorch; design and bound noted in the source).
Two entries launch it:

- `lut3d_positions_mxu`, the TPU kernel's signature: f32 positions in,
  f32 planes out;
- `lut3d_sample_mxu_packed` (RGBA u8 pixels as int32) and
  `lut3d_sample_mxu_packed64` (RGBA64 pixels as int64, 4 x u16): the
  normalisation, the rounding and the repacking inside the kernel, alpha
  riding through.  The JAX package runs that glue as XLA ops.

For a CUDA tensor each launches the kernel or raises; for a CPU tensor it
runs its `_plain` twin, the same sparse sum in plain PyTorch.
`lut3d_apply_mxu` is the public function: it bit-casts a contiguous RGBA
u8 or RGBA64 u16 frame (offsets (0, 1, 2)) to the packed entries and runs
every other layout through `lut3d_positions_mxu` with the glue in torch;
the two routes give the same frame bit for bit.  As in the JAX package, no
element calls it.  Only sizes with 3*size <= 128 lanes (size <= 42) are
supported.  `launches` counts launches of the TPU signature's kernel,
`packed_launches` those of the packed entries (both widths).

Reference math: video/colorlut/src/colorlut/imp.rs:493-526 (trilinear
with x1 = min(x0+1, size-1) clamping — the hat formulation reproduces
the clamped weights exactly at the boundaries).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .colorlut import grid_coord, quantize
from . import count_launch
from .pixels import repack_quantized, restack, unpack_grid_coords

LANES = 128
CELL = 16  # bf16 values a cell: 3 channels x 4, then 4 zeros (32 bytes)

launches = 0         # lut3d_positions_mxu
packed_launches = 0  # lut3d_sample_mxu_packed and lut3d_sample_mxu_packed64


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


def pack_cells(t2_bf16, size: int):
    """The kernel's cell table, [size, size, size, 16] bf16 indexed (y, z, x):
    for c = 0..2 the values T2[(y,z), c*S+x], T2[(y,z), c*S+x1],
    T2[(y,z1), c*S+x], T2[(y,z1), c*S+x1] with x1 = min(x+1, S-1) and
    z1 = min(z+1, S-1), then 4 zeros.  The kernel builds the same table on
    the card in each call."""
    s = size
    i = torch.arange(s, device=t2_bf16.device)
    i1 = torch.clamp(i + 1, max=s - 1)
    y, z, x = (a.reshape(-1) for a in torch.meshgrid(i, i, i, indexing="ij"))
    z1, x1 = i1[z], i1[x]
    flat = t2_bf16.reshape(-1)
    vals = [flat[(y * s + zz) * LANES + c * s + xx]
            for c in range(3) for zz in (z, z1) for xx in (x, x1)]
    vals += [torch.zeros_like(vals[0])] * (CELL - len(vals))
    return torch.stack(vals, dim=-1).reshape(s, s, s, CELL)


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


def lut3d_sample_mxu_packed_plain(px, params, t2_bf16, *, size: int, bits: int = 8):
    """The packed entries' function in plain PyTorch (bits 8: px int32 RGBA
    u8 bit patterns; 16: px int64 RGBA64 bit patterns, 4 x u16), R in the
    low bits, any shape; params [8] f32 = (scale0..2, offset0..2, maxval,
    0).  The chain of colorlut_lowrank_fused.lowrank_sample_packed_plain
    with B5's sample in place of the low-rank one."""
    coords = unpack_grid_coords(px, params, size, bits)
    return repack_quantized(lut3d_positions_mxu_plain(*coords, t2_bf16, size=size), px, params,
                            bits)


def _lib():
    from ..utils.build import load

    lib = load("colorlut_mxu")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.colorlut_mxu.argtypes = [ptr] * 8 + [i64, i32, ptr]
        lib.colorlut_mxu.restype = i32
        lib.colorlut_mxu_packed.argtypes = [ptr] * 5 + [i64, i32, i32, ptr]
        lib.colorlut_mxu_packed.restype = i32
        lib.colorlut_mxu_cells.argtypes = [ptr, ptr, i32, ptr]
        lib.colorlut_mxu_cells.restype = i32
        lib.colorlut_mxu_error_string.argtypes = [i32]
        lib.colorlut_mxu_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_table(name, t2_bf16, size, device):
    if not 2 <= size <= LANES // 3:
        raise ValueError(f"{name}: size must be in 2..{LANES // 3}, got {size}")
    if (t2_bf16.dim() != 2 or t2_bf16.shape[1] != LANES or t2_bf16.shape[0] < size * size
            or t2_bf16.dtype != torch.bfloat16 or t2_bf16.device != device
            or not t2_bf16.is_contiguous()):
        raise ValueError(f"{name}: t2 must be a contiguous [>={size * size}, {LANES}] "
                         f"bfloat16 on {device}, got {t2_bf16.dtype} {tuple(t2_bf16.shape)} "
                         f"on {t2_bf16.device}")


def _launch(name, device, entry, *args):
    """Calls the C entry point `entry` on the current stream of `device` and
    raises if the launch failed."""
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.colorlut_mxu_error_string(err).decode()}")


def _cells(size, device):
    return torch.empty((size, size, size, CELL), dtype=torch.bfloat16, device=device)


def lut3d_positions_mxu(xpos, ypos, zpos, t2_bf16, *, size: int):
    """positions: [P] f32 in [0, size-1]; t2_bf16 [YZPAD, 128] bf16 from
    pack_matmul_table; returns (r, g, b) [P] f32."""
    if xpos.device.type == "cpu":
        return lut3d_positions_mxu_plain(xpos, ypos, zpos, t2_bf16, size=size)
    if xpos.device.type != "cuda":
        raise ValueError(f"lut3d_positions_mxu: unsupported device {xpos.device}")
    for name, t in (("xpos", xpos), ("ypos", ypos), ("zpos", zpos)):
        if (t.dim() != 1 or t.shape != xpos.shape or t.dtype != torch.float32
                or t.device != xpos.device or not t.is_contiguous()):
            raise ValueError(f"lut3d_positions_mxu: {name} must be a contiguous [P] float32 "
                             f"on {xpos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    _check_table("lut3d_positions_mxu", t2_bf16, size, xpos.device)
    outs = [torch.empty_like(xpos) for _ in range(3)]
    _launch("lut3d_positions_mxu", xpos.device, "colorlut_mxu", xpos.data_ptr(),
            ypos.data_ptr(), zpos.data_ptr(), t2_bf16.data_ptr(),
            _cells(size, xpos.device).data_ptr(), *(o.data_ptr() for o in outs),
            xpos.numel(), size)
    count_launch(__name__, "launches")
    return tuple(outs)


def _sample_packed(name, bits, px, params, t2_bf16, size):
    """Checks the operands of a CUDA packed entry and launches its kernel;
    the caller counts the launch."""
    if px.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {px.device}")
    word = torch.int32 if bits == 8 else torch.int64
    if px.dtype != word or not px.is_contiguous():
        raise ValueError(f"{name}: px must be contiguous {word}, got {px.dtype}")
    if (tuple(params.shape) != (8,) or params.dtype != torch.float32
            or params.device != px.device):
        raise ValueError(f"{name}: params must be [8] float32 on px's device")
    _check_table(name, t2_bf16, size, px.device)
    out = torch.empty_like(px)
    _launch(name, px.device, "colorlut_mxu_packed", px.data_ptr(), params.data_ptr(),
            t2_bf16.data_ptr(), _cells(size, px.device).data_ptr(), out.data_ptr(), px.numel(),
            size, bits)
    return out


def lut3d_sample_mxu_packed(px, params, t2_bf16, *, size: int):
    """px int32 RGBA u8 bit patterns (R in the low bits), any shape; params
    [8] f32 = (scale0..2, offset0..2, maxval 255, 0); t2_bf16 from
    pack_matmul_table.  Returns int32 of px's shape, alpha unchanged."""
    if px.device.type == "cpu":
        return lut3d_sample_mxu_packed_plain(px, params, t2_bf16, size=size)
    out = _sample_packed("lut3d_sample_mxu_packed", 8, px, params, t2_bf16, size)
    count_launch(__name__, "packed_launches")
    return out


def lut3d_sample_mxu_packed64(px, params, t2_bf16, *, size: int):
    """The same on RGBA64 pixels: px int64 bit patterns of 4 x u16 (R in the
    low bits); params' maxval 65535.  Returns int64 of px's shape."""
    if px.device.type == "cpu":
        return lut3d_sample_mxu_packed_plain(px, params, t2_bf16, size=size, bits=16)
    out = _sample_packed("lut3d_sample_mxu_packed64", 16, px, params, t2_bf16, size)
    count_launch(__name__, "packed_launches")
    return out


# frame type and pixel word of each bit depth the packed entries take
_PACKED = {8: (torch.uint8, torch.int32), 16: (torch.uint16, torch.int64)}


def lut3d_apply_mxu(frame, t2_bf16, scale, offset, *, size: int,
                    offsets=(0, 1, 2), bits: int = 8):
    """Drop-in fast-path peer of ops/colorlut.lut3d_apply_packed.

    frame [..., C] uint; t2_bf16 from pack_matmul_table (cast to bf16).  A
    contiguous RGBA u8 (bits 8) or RGBA64 u16 (bits 16) frame with offsets
    (0, 1, 2) goes to the packed entry, bit-cast to its pixel words; any
    other layout through lut3d_positions_mxu with the glue in torch."""
    maxval = float(2 ** bits - 1)
    kind = _PACKED.get(bits)
    if (kind is not None and frame.dtype == kind[0] and frame.shape[-1] == 4
            and tuple(offsets) == (0, 1, 2) and frame.is_contiguous()):
        sample = lut3d_sample_mxu_packed if bits == 8 else lut3d_sample_mxu_packed64
        params = torch.tensor([float(v) for v in scale] + [float(v) for v in offset]
                              + [maxval, 0.0], dtype=torch.float32).to(frame.device)
        out = sample(frame.view(kind[1]), params, t2_bf16, size=size)
        return out.view(frame.dtype).reshape(frame.shape)
    fi = frame.to(torch.int32)
    shape = fi.shape[:-1]
    pos = [grid_coord(fi, off, scale[comp], offset[comp], size, maxval).reshape(-1)
           for comp, off in enumerate(offsets)]
    rgb = lut3d_positions_mxu(*pos, t2_bf16, size=size)
    return restack(fi, offsets, [quantize(cc.reshape(shape), maxval) for cc in rgb],
                   frame.dtype)


__all__ = ["CELL", "LANES", "launches", "lut3d_apply_mxu", "lut3d_positions_mxu",
           "lut3d_positions_mxu_plain", "lut3d_sample_mxu_packed", "lut3d_sample_mxu_packed64",
           "lut3d_sample_mxu_packed_plain", "pack_cells", "pack_matmul_table",
           "packed_launches"]
