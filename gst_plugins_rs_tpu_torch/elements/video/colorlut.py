"""colorlut: Adobe .cube LUT color-grade element.

Parity target: video/colorlut/src/colorlut/imp.rs (543 LoC) + parser.rs.
Caps RGBA / RGBA64LE / RGBA64BE; NeverInPlace; LUT parsed at start() from
`location`; alpha preserved (imp.rs:262,291-294).

The port of gst_plugins_rs_tpu/elements/video/colorlut.py.  Frames are
moved to the device `gst_plugins_rs_tpu_torch.set_device` selects (CUDA
unless the CPU was requested) and graded there.  precision=approx runs the
low-rank kernels through ops/colorlut_lowrank_fused.lut3d_apply_lowrank_packed:
B2 for RGBA u8, packed64 (B3's chain, with the normalisation, rounding and
restacking in the kernel) for RGBA64LE/BE; the JAX element runs B3 with that
glue as XLA ops around it.  lut3d_apply_lowrank_fused (B3 with B3's TPU
signature) stays the route for any other channel layout.  The frame's
device picks the CUDA kernel or its plain version.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

from ...core import (
    Buffer,
    Prop,
    TransformMode,
    VideoFilter,
    register,
    video_caps_template,
)
from ..._device import device
from ...ops.colorlut import (
    PACKED_TABLE_MAX_SIZE,
    CubeLut,
    lut1d_apply,
    lut3d_apply,
    lut3d_apply_packed,
    pack_corner_table,
)
from ...ops.colorlut_lowrank import fit_lowrank

log = logging.getLogger(__name__)

_FORMATS = ("RGBA", "RGBA64LE", "RGBA64BE")

# max node error accepted for precision=approx, in LUT output units
# (u8 LSBs); trilinear interp of the residual is a convex combination of
# node errors, so this bounds the f32 fit's error over the whole continuous
# domain
APPROX_TOLERANCE_LSB = 2.0
# what precision=approx reads against precision=exact on seeded random
# 1080p RGBA frames of a 33^3 grade fitted at rank 16, in this package and
# in the JAX package alike (tests/test_torch_colorlut_approx.py): the fit's
# node error and the final rounding, plus the bf16 rounding of the factors
# and hat weights in the sampling chain, which the load-time check does not
# bound.  A documented divergence in text only: the JAX element's doc claims
# <= 2 LSB.
APPROX_MEASURED_LSB = 5


@register
class ColorLut(VideoFilter):
    ELEMENT_NAME = "colorlut"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Applies .cube LUT (Look-Up Table) to video frames"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = video_caps_template(_FORMATS)
    SRC_CAPS = video_caps_template(_FORMATS)
    PROPERTIES = [
        Prop("location", None, type="str", mutable="ready", doc="Path of the .cube file"),
        Prop("precision", "exact", type="enum",
             choices=["exact", "fast", "approx"],
             mutable="ready",
             doc="exact: f32 table, bit-matches the reference math; "
                 "fast: bf16 table, <=1 u8 LSB deviation. Only 3D LUTs of "
                 "size <= 65 use the fast path; other LUTs run exact with a "
                 "warning. "
                 "approx: low-rank CP factorization sampled by the fused "
                 "kernels (B2, B3's chain); the f32 fit is validated at load "
                 "to <=2 u8 LSB at the LUT nodes (falls back to exact with a "
                 "warning when the LUT does not factor within tolerance), "
                 "and the bf16 sampling chain adds its rounding: measured "
                 "<=5 u8 LSB against exact on random 1080p frames of a 33^3 "
                 "grade at rank 16"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._lut: Optional[CubeLut] = None
        self._table = None
        self._scale = None
        self._offset = None
        self._cp = None  # packed CP factors when precision=approx fits
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        location = self.get_property("location")
        if location is None:
            raise RuntimeError(f"{self.name}: no .cube file location set")
        self._device = device()
        self._lut = CubeLut.parse_file(location)
        if self._lut.is_3d and self._lut.size <= PACKED_TABLE_MAX_SIZE:
            table = pack_corner_table(self._lut.table, self._lut.size)
            self._packed = True
        else:
            table = self._lut.table
            self._packed = False
        self._table = torch.from_numpy(table).to(self._device)
        precision = self.get_property("precision")
        self._cp = None
        if precision == "fast":
            if self._packed:
                self._table = self._table.to(torch.bfloat16)
            else:
                # 1D LUTs and 3D LUTs over PACKED_TABLE_MAX_SIZE don't take
                # the packed-corner path, where the bf16 table lives; say
                # so rather than silently running exact
                log.warning(
                    "%s: precision=fast has no effect for this LUT (%s, "
                    "size %d): only 3D LUTs of size <= %d use the packed "
                    "bf16 path; running exact", self.name,
                    "3D" if self._lut.is_3d else "1D", self._lut.size,
                    PACKED_TABLE_MAX_SIZE)
        elif precision == "approx":
            self._setup_approx()
        self._scale = [float(v) for v in self._lut.domain_scale]
        self._offset = [float(v) for v in self._lut.domain_offset]

    def _setup_approx(self) -> None:
        from ...ops.colorlut_lowrank_fused import SB, pack_factors

        lut = self._lut
        if not lut.is_3d or lut.size > SB - 1:
            log.warning(
                "%s: precision=approx needs a 3D LUT of size <= %d "
                "(got %s size %d); running exact", self.name, SB - 1,
                "3D" if lut.is_3d else "1D", lut.size)
            return
        fit = fit_lowrank(lut.table, lut.size,
                          tolerance=APPROX_TOLERANCE_LSB / 255.0)
        if fit is None:
            log.warning(
                "%s: LUT does not factor within %.1f u8 LSB at rank <= 128; "
                "running exact", self.name, APPROX_TOLERANCE_LSB)
            return
        ut, vt, wt, c = pack_factors(fit.U, fit.V, fit.W, fit.C)
        self._cp = tuple(torch.from_numpy(a).to(self._device) for a in (ut, vt, wt, c))
        log.info("%s: approx rank %d, max node err %.2f u8 LSB",
                 self.name, fit.U.shape[1], fit.max_node_err * 255.0)

    def stop(self) -> None:
        self._lut = None
        self._table = None
        self._cp = None

    def pure_kernel(self):
        """Function of the frame over the loaded LUT and negotiated caps."""
        info = self.video_info
        lut = self._lut
        assert info is not None and lut is not None, f"{self.name}: pure_kernel before caps"
        r, g, b, _a = info.rgb_offsets
        bits = 8 if info.format == "RGBA" else 16
        scale, offset, size = self._scale, self._offset, lut.size
        if self._cp is not None:
            from ...ops.colorlut_lowrank_fused import (
                lut3d_apply_lowrank_fused, lut3d_apply_lowrank_packed, packed_params)

            ut, vt, wt, c = self._cp
            if (r, g, b) == (0, 1, 2) and info.components == 4:
                # RGBA u8 (B2) and RGBA64 (packed64): the whole
                # unpack/sample/repack in the kernel; the params are
                # uploaded here, once, so a CUDA graph can capture the call
                params = packed_params(scale, offset, bits, ut.device)
                return lambda data: lut3d_apply_lowrank_packed(
                    data, ut, vt, wt, c, scale, offset, size=size,
                    offsets=(r, g, b), bits=bits, params=params)
            return lambda data: lut3d_apply_lowrank_fused(
                data, ut, vt, wt, c, scale, offset, size=size,
                offsets=(r, g, b), bits=bits)
        if lut.is_3d:
            fn = lut3d_apply_packed if self._packed else lut3d_apply
        else:
            fn = lut1d_apply
        table = self._table
        return lambda data: fn(
            data, table, scale, offset, size=size, offsets=(r, g, b), bits=bits
        )

    def transform(self, inbuf: Buffer) -> Buffer:
        data = torch.as_tensor(inbuf.data, device=self._device)
        out = Buffer(self.pure_kernel()(data))
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["APPROX_MEASURED_LSB", "ColorLut"]
