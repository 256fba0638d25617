"""videoscale and videoconvertscale: separable resampling (ops/resize.py).

The port of gst_plugins_rs_tpu/elements/video/videoscale.py.  `method`
nearest|bilinear; the format is kept and width/height renegotiate freely
(a downstream caps filter picks the target size).  4:2:0 formats scale
luma and chroma with per-plane matrices (even output dimensions required).
videoconvertscale composes the port's format converter
(elements/generic/convert.py::build_format_converter) with the scaler, in
the order that keeps the scaling in the packed domain when one side is
packed.  Frames run on the selected device; frames that arrive elsewhere
are moved there.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import (
    Buffer,
    Caps,
    IntRange,
    PadDirection,
    Prop,
    TransformMode,
    VideoFilter,
    register,
    video_caps_template,
)
from ..._device import device
from ...core.video import RGB_FORMATS

_U8_RGB = tuple(f for f in RGB_FORMATS
                if RGB_FORMATS[f][1].__name__ == "uint8")
_FORMATS = _U8_RGB + ("I420", "NV12")


def build_scaler(fmt: str, h_in: int, w_in: int, h_out: int, w_out: int,
                 method: str, dev=None):
    """payload -> payload scaler for one geometry with its matrices on
    `dev` (the selected device by default), or None for the identity.
    Composable with build_format_converter (the fused videoconvertscale
    path)."""
    from ...ops.resize import resize_matrices, resize_u8

    if (h_in, w_in) == (h_out, w_out):
        return None
    dev = device() if dev is None else dev
    ah, aw = resize_matrices(h_in, w_in, h_out, w_out, method, dev)
    if fmt not in ("I420", "NV12"):
        return lambda img: resize_u8(img, ah, aw)
    ah2, aw2 = resize_matrices(h_in // 2, w_in // 2, h_out // 2, w_out // 2, method, dev)
    if fmt == "NV12":

        def fn(payload):
            from ...ops.yuv import nv12_to_uv, uv_to_nv12

            y, uv = payload
            u, v = nv12_to_uv(uv)
            return (resize_u8(y, ah, aw),
                    uv_to_nv12(resize_u8(u, ah2, aw2), resize_u8(v, ah2, aw2)))
    else:

        def fn(payload):
            y, u, v = payload
            return (resize_u8(y, ah, aw), resize_u8(u, ah2, aw2), resize_u8(v, ah2, aw2))

    return fn


def _on_device(data, planar: bool, dev):
    if planar:
        return tuple(torch.as_tensor(p, device=dev) for p in data)
    return torch.as_tensor(data, device=dev)


@register
class VideoScale(VideoFilter):
    ELEMENT_NAME = "videoscale"
    ELEMENT_CLASS = "Filter/Converter/Video/Scaler"
    ELEMENT_DESCRIPTION = "Resizes video (separable MXU-matmul resampling)"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(_FORMATS)
    SRC_CAPS = video_caps_template(_FORMATS)
    PROPERTIES = [
        Prop("method", "bilinear", type="enum",
             choices=["bilinear", "nearest"], mutable="ready",
             doc="Resampling filter (one-hot matrices make nearest "
                 "bit-identical to the gather form)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._fn = None
        self._device: Optional[torch.device] = None

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK
                   else self.SINK_CAPS).copy()
        for s in out.structures:
            s["width"] = IntRange(1, 32768)
            s["height"] = IntRange(1, 32768)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        s = caps.structure(0)
        return othercaps.fixate({"width": s.get("width"),
                                 "height": s.get("height")})

    def setup(self, in_info, out_info) -> None:
        self._fn = None
        self._device = device()
        if (in_info.width, in_info.height) == (out_info.width, out_info.height):
            return  # passthrough
        if in_info.is_planar and (out_info.width % 2 or out_info.height % 2):
            raise ValueError(
                f"{self.name}: 4:2:0 output needs even dimensions, got "
                f"{out_info.width}x{out_info.height}")
        self._fn = build_scaler(in_info.format, in_info.height, in_info.width,
                                out_info.height, out_info.width,
                                self.get_property("method"), self._device)

    def pure_kernel(self):
        """Chain-fusion hook (parallel/fuse.py): the payload function built
        at caps time (the scaler, or videoconvertscale's two stages), the
        identity when there is none."""
        fn = self._fn
        return fn if fn is not None else (lambda d: d)

    def transform(self, inbuf: Buffer) -> Buffer:
        if self._fn is None:
            out = Buffer(inbuf.data)
        else:
            payload = self._fn(_on_device(inbuf.data, self.video_info.is_planar, self._device))
            out = Buffer(tuple(payload) if isinstance(payload, (tuple, list)) else payload)
        out.copy_metadata_from(inbuf)
        return out


@register
class VideoConvertScale(VideoScale):
    """videoconvertscale: format conversion and scaling in one element.
    Converts first at the input geometry, then scales in the output
    format's plane layout, unless the input is packed and the output
    planar: then it scales first."""

    ELEMENT_NAME = "videoconvertscale"
    ELEMENT_CLASS = "Filter/Converter/Video/Scaler"
    ELEMENT_DESCRIPTION = "Converts video format and size in one fused kernel"

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        from ...core import ValueList

        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK
                   else self.SINK_CAPS).copy()
        for s in out.structures:
            s["format"] = ValueList(_FORMATS)
            s["width"] = IntRange(1, 32768)
            s["height"] = IntRange(1, 32768)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        s = caps.structure(0)
        return othercaps.fixate({"format": s.get("format"),
                                 "width": s.get("width"),
                                 "height": s.get("height")})

    def setup(self, in_info, out_info) -> None:
        from ..generic.convert import build_format_converter

        self._fn = None
        self._device = device()
        same_fmt = in_info.format == out_info.format
        same_dims = (in_info.width, in_info.height) == (out_info.width,
                                                        out_info.height)
        if same_fmt and same_dims:
            return  # passthrough
        # 4:2:0 work happens wherever the payload is planar; the packed
        # side tolerates any geometry.  Order the two stages so scaling
        # runs in the packed domain when one exists:
        #   packed -> planar: scale (packed, input format) THEN convert
        #   planar -> packed: convert THEN scale (packed, output format)
        # so only the planar side's dimensions must be even.
        scale_first = out_info.is_planar and not in_info.is_planar
        if in_info.is_planar and (in_info.width % 2 or in_info.height % 2):
            raise ValueError(
                f"{self.name}: 4:2:0 input needs even dimensions, got "
                f"{in_info.width}x{in_info.height}")
        if out_info.is_planar and (out_info.width % 2 or out_info.height % 2):
            raise ValueError(
                f"{self.name}: 4:2:0 output needs even dimensions, got "
                f"{out_info.width}x{out_info.height}")
        conv = None if same_fmt else build_format_converter(in_info, out_info)
        scale = build_scaler(
            in_info.format if scale_first else out_info.format,
            in_info.height, in_info.width,
            out_info.height, out_info.width,
            self.get_property("method"), self._device)
        stages = [s for s in ((scale, conv) if scale_first else (conv, scale)) if s is not None]

        def fn(payload):
            for stage in stages:
                payload = stage(payload)
            return payload

        self._fn = fn


__all__ = ["VideoScale", "VideoConvertScale", "build_scaler"]
