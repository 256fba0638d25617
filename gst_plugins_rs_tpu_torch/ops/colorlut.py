"""Adobe .cube LUT parsing and 1D/3D LUT color-grade kernels.

Reference: video/colorlut/src/parser.rs (grammar: TITLE / DOMAIN_MIN /
DOMAIN_MAX / LUT_1D_SIZE 2..=65536 / LUT_3D_SIZE 2..=256; header-after-data
rejected; 3D layout [x + y*size + z*size^2] with x indexed by R) and the
sampling in colorlut/imp.rs:399-543 (domain normalize -> clamp -> linear /
trilinear interpolation -> round-to-nearest quantization).

The port of gst_plugins_rs_tpu/ops/colorlut.py: the parser is the same
numpy code; the sampling is plain PyTorch (gathers by indexing, as XLA
gathers in the JAX package), on whatever device the frame lies on.  Frames
are [..., C] uint8 or uint16; they are converted to int32 once on the way in
and back on the way out (few PyTorch operators take uint16).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .pixels import restack, to_unit

LUT_1D_MIN_SIZE, LUT_1D_MAX_SIZE = 2, 65536
LUT_3D_MIN_SIZE, LUT_3D_MAX_SIZE = 2, 256


class CubeParseError(ValueError):
    pass


@dataclass
class CubeLut:
    domain_scale: np.ndarray  # [3] f32
    domain_offset: np.ndarray  # [3] f32
    is_3d: bool
    size: int
    # 1D: table [size, 3]; 3D: flat [size^3, 3] in [x + y*s + z*s^2] order
    table: np.ndarray

    @staticmethod
    def parse(text: str) -> "CubeLut":
        domain_min = np.zeros(3, np.float32)
        domain_max = np.ones(3, np.float32)
        state = "header"  # header | 1d | 3d
        size = 0
        have_data = False
        values: List[List[float]] = []

        def err(line_no, line, msg="Invalid line"):
            raise CubeParseError(f"{msg} at line {line_no}: {line}")

        for idx, raw in enumerate(text.splitlines()):
            line_no = idx + 1
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            first = parts[0]
            if first in ("TITLE", "DOMAIN_MIN", "DOMAIN_MAX", "LUT_1D_SIZE", "LUT_3D_SIZE"):
                if have_data:
                    err(line_no, line, "Header found after LUT data")
            if first == "TITLE":
                continue
            elif first in ("DOMAIN_MIN", "DOMAIN_MAX"):
                if len(parts) != 4:
                    err(line_no, line)
                try:
                    vec = np.array([float(v) for v in parts[1:]], np.float32)
                except ValueError:
                    err(line_no, line, "Invalid float")
                if first == "DOMAIN_MIN":
                    domain_min = vec
                else:
                    domain_max = vec
            elif first in ("LUT_1D_SIZE", "LUT_3D_SIZE"):
                if state != "header":
                    err(line_no, line, f"Invalid {first}")
                if len(parts) != 2:
                    err(line_no, line)
                try:
                    size = int(parts[1])
                except ValueError:
                    err(line_no, line, "Invalid integer")
                lo, hi = (
                    (LUT_1D_MIN_SIZE, LUT_1D_MAX_SIZE)
                    if first == "LUT_1D_SIZE"
                    else (LUT_3D_MIN_SIZE, LUT_3D_MAX_SIZE)
                )
                if not lo <= size <= hi:
                    err(line_no, line, f"Invalid LUT size {size}, expected {lo}..={hi}")
                state = "1d" if first == "LUT_1D_SIZE" else "3d"
            else:
                if state == "header":
                    err(line_no, line, "LUT data found before LUT size")
                if len(parts) != 3:
                    err(line_no, line)
                try:
                    values.append([float(v) for v in parts])
                except ValueError:
                    err(line_no, line, "Invalid float")
                have_data = True

        if np.any(domain_min >= domain_max):
            raise CubeParseError(f"Invalid domain min {domain_min}, max {domain_max}")
        if state == "header":
            raise CubeParseError("Missing LUT size")
        expected = size if state == "1d" else size**3
        if len(values) != expected:
            raise CubeParseError(
                f"Invalid {'1D' if state == '1d' else '3D'} LUT value count, "
                f"expected {expected}, got {len(values)}"
            )
        scale = (1.0 / (domain_max - domain_min)).astype(np.float32)
        offset = (-domain_min * scale).astype(np.float32)
        return CubeLut(
            domain_scale=scale,
            domain_offset=offset,
            is_3d=(state == "3d"),
            size=size,
            table=np.asarray(values, np.float32),
        )

    @staticmethod
    def parse_file(path: str) -> "CubeLut":
        with open(path, "r") as f:
            return CubeLut.parse(f.read())


def _norm(v, scale, offset, size):
    return torch.clamp(v * scale + offset, 0.0, 1.0) * (size - 1.0)


def grid_coord(frame_i32, off: int, scale, offset, size: int, maxval: float):
    """Continuous LUT index in [0, size-1] of channel `off`."""
    return _norm(to_unit(frame_i32[..., off], maxval), scale, offset, size)


def quantize(y, maxval: float):
    """round(clip(y, 0, 1) * maxval), half to even, as int32."""
    return torch.round(torch.clamp(y, 0.0, 1.0) * maxval).to(torch.int32)


def _floor_index(x, size: int):
    x0 = torch.clamp(torch.floor(x).to(torch.int64), max=size - 1)
    return x0, x - x0.to(torch.float32)


def lut1d_apply(frame, table, scale, offset, *, size: int, offsets: Tuple[int, int, int], bits: int):
    """Per-component linear 1D LUT. frame [..., C] uint; table [size, 3]."""
    maxval = float(2**bits - 1)
    fi = frame.to(torch.int32)
    comps = []
    for comp, off in enumerate(offsets):
        x = grid_coord(fi, off, scale[comp], offset[comp], size, maxval)
        x0, t = _floor_index(x, size)
        x1 = torch.clamp(x0 + 1, max=size - 1)
        col = table[:, comp]
        y = col[x0] + (col[x1] - col[x0]) * t
        comps.append(quantize(y, maxval))
    return restack(fi, offsets, comps, frame.dtype)


def pack_corner_table(table: np.ndarray, size: int) -> np.ndarray:
    """Precompute, per 3D cell index, all 8 corner RGB values as one row.

    Sampling then takes one wide-row gather per pixel instead of 8
    scattered ones.  The reference's x1=min(x0+1,size-1) clamping is baked
    in.  Row layout: corners ordered (z1,y1,x1) bits = (0..7), each corner
    3 floats RGB."""
    t = table.reshape(size, size, size, 3)  # [z, y, x, 3] flat order x fastest
    # build clamped shifted views
    def sh(a, axis):
        idx = np.minimum(np.arange(size) + 1, size - 1)
        return np.take(a, idx, axis=axis)

    corners = []
    for zb in (0, 1):
        for yb in (0, 1):
            for xb in (0, 1):
                c = t
                if zb:
                    c = sh(c, 0)
                if yb:
                    c = sh(c, 1)
                if xb:
                    c = sh(c, 2)
                corners.append(c)
    packed = np.stack(corners, axis=3)  # [z, y, x, 8, 3]
    return packed.reshape(size**3, 24).astype(np.float32)


def _xyz(fi, offsets, scale, offset, size, maxval):
    return [grid_coord(fi, off, scale[comp], offset[comp], size, maxval)
            for comp, off in enumerate(offsets)]


def lut3d_apply_packed(
    frame, packed, scale, offset, *, size: int, offsets: Tuple[int, int, int], bits: int
):
    """Trilinear 3D LUT via the packed corner table (one gather per pixel).

    packed: [size^3, 24] from pack_corner_table, float32 or bfloat16
    (precision=fast).  Bit-identical lerp order to lut3d_apply / the
    reference (imp.rs:494-534)."""
    maxval = float(2**bits - 1)
    fi = frame.to(torch.int32)
    x, y, z = _xyz(fi, offsets, scale, offset, size, maxval)
    x0, tx = _floor_index(x, size)
    y0, ty = _floor_index(y, size)
    z0, tz = _floor_index(z, size)

    rows = packed[x0 + y0 * size + z0 * size * size].to(torch.float32)  # [..., 24]
    c = rows.reshape(rows.shape[:-1] + (8, 3))
    tx, ty, tz = tx[..., None], ty[..., None], tz[..., None]
    c00 = c[..., 0, :] + (c[..., 1, :] - c[..., 0, :]) * tx
    c10 = c[..., 2, :] + (c[..., 3, :] - c[..., 2, :]) * tx
    c01 = c[..., 4, :] + (c[..., 5, :] - c[..., 4, :]) * tx
    c11 = c[..., 6, :] + (c[..., 7, :] - c[..., 6, :]) * tx
    c0 = c00 + (c10 - c00) * ty
    c1 = c01 + (c11 - c01) * ty
    cc = c0 + (c1 - c0) * tz
    return restack(fi, offsets, [quantize(cc[..., comp], maxval) for comp in range(3)],
                   frame.dtype)


# Above this size the packed table gets large (size^3 * 96 B); 65^3 ~ 26 MB.
PACKED_TABLE_MAX_SIZE = 65


def lut3d_apply(frame, table, scale, offset, *, size: int, offsets: Tuple[int, int, int], bits: int):
    """Trilinear 3D LUT grade; alpha/extra channels preserved.

    frame: [..., C] uint8/uint16; table: [size^3, 3] flat in
    [x + y*size + z*size^2] layout (x indexed by R)."""
    maxval = float(2**bits - 1)
    fi = frame.to(torch.int32)
    x, y, z = _xyz(fi, offsets, scale, offset, size, maxval)

    def fl(v):
        v0, t = _floor_index(v, size)
        return v0, torch.clamp(v0 + 1, max=size - 1), t[..., None]

    x0, x1, tx = fl(x)
    y0, y1, ty = fl(y)
    z0, z1, tz = fl(z)

    def at(xi, yi, zi):
        return table[xi + yi * size + zi * size * size]

    c00 = at(x0, y0, z0) + (at(x1, y0, z0) - at(x0, y0, z0)) * tx
    c10 = at(x0, y1, z0) + (at(x1, y1, z0) - at(x0, y1, z0)) * tx
    c01 = at(x0, y0, z1) + (at(x1, y0, z1) - at(x0, y0, z1)) * tx
    c11 = at(x0, y1, z1) + (at(x1, y1, z1) - at(x0, y1, z1)) * tx
    c0 = c00 + (c10 - c00) * ty
    c1 = c01 + (c11 - c01) * ty
    c = c0 + (c1 - c0) * tz
    return restack(fi, offsets, [quantize(c[..., comp], maxval) for comp in range(3)],
                   frame.dtype)


__all__ = [
    "CubeLut",
    "CubeParseError",
    "grid_coord",
    "lut1d_apply",
    "lut3d_apply",
    "lut3d_apply_packed",
    "pack_corner_table",
    "quantize",
    "PACKED_TABLE_MAX_SIZE",
]
