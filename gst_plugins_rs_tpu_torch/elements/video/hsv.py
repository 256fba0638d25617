"""hsvfilter / hsvdetector elements.

Parity targets: video/hsv/src/hsvfilter/imp.rs (377 LoC, in-place HSV
adjust over 10 RGB-family formats) and hsvdetector/imp.rs (708 LoC,
chroma-key detector RGB->RGBA alpha mask, NeverInPlace with caps rewrite).

The port of gst_plugins_rs_tpu/elements/video/hsv.py.  Frames are moved to
the device `gst_plugins_rs_tpu_torch.set_device` selects.  hsvfilter runs
kernel B4 (ops/hsv_planes.py): the RGB channels split into f32 planes
(ops/pixels.to_unit), B4 (its plain version for a CPU frame), then
clip(x*255, 0, 255) truncated to u8.  The JAX element runs the XLA op `hsv_filter_frame`
instead; the math is the same within the documented <=1 u8 LSB.
"In place" rebinds `buf.data` to the new frame: the payload tensor that
came in (which videotestsrc shares between its buffers) is never written.
hsvdetector stays plain PyTorch (ops/hsv.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import (
    Buffer,
    Caps,
    PadDirection,
    Prop,
    TransformMode,
    ValueList,
    VideoFilter,
    register,
    video_caps_template,
)
from ..._device import device
from ...ops.hsv import hsv_detect_frame, quantize_u8, split_rgb
from ...ops.hsv_planes import hsv_filter_planes
from ...ops.pixels import restack

_FILTER_FORMATS = ("RGBx", "xRGB", "BGRx", "xBGR", "RGBA", "ARGB", "BGRA", "ABGR", "RGB", "BGR")
_DETECT_IN_FORMATS = ("RGBx", "xRGB", "BGRx", "xBGR", "RGB", "BGR")
_DETECT_OUT_FORMATS = ("RGBA", "ARGB", "BGRA", "ABGR")


def hsv_filter_b4(frame, params, *, offsets):
    """hsvfilter through kernel B4: [..., C] u8 frame -> new u8 frame."""
    planes = [p.contiguous() for p in split_rgb(frame, offsets)]
    outs = hsv_filter_planes(*planes, params)
    return restack(frame, offsets, [quantize_u8(o) for o in outs], torch.uint8)


@register
class HsvFilter(VideoFilter):
    ELEMENT_NAME = "hsvfilter"
    ELEMENT_CLASS = "Filter/Effect/Converter/Video"
    ELEMENT_DESCRIPTION = "Works within the HSV colorspace to apply tranformations to incoming frames"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = video_caps_template(_FILTER_FORMATS)
    SRC_CAPS = video_caps_template(_FILTER_FORMATS)
    PROPERTIES = [
        Prop("hue-shift", 0.0, mutable="playing", doc="Hue shifting in degrees"),
        Prop("saturation-mul", 1.0, mutable="playing"),
        Prop("saturation-off", 0.0, mutable="playing"),
        Prop("value-mul", 1.0, mutable="playing"),
        Prop("value-off", 0.0, mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def _params(self):
        return torch.tensor(
            [
                # pre-reduce mod 360 so the kernel's sextant-unit hue path
                # only needs conditional subtracts
                self.get_property("hue-shift") % 360.0,
                self.get_property("saturation-mul"),
                self.get_property("saturation-off"),
                self.get_property("value-mul"),
                self.get_property("value-off"),
            ],
            dtype=torch.float32,
        ).to(self._device)

    def transform_ip(self, buf: Buffer) -> Buffer:
        buf.data = self.pure_kernel()(torch.as_tensor(buf.data, device=self._device))
        return buf

    def pure_kernel(self):
        """Function of the frame over the negotiated caps and the current
        properties."""
        info = self.video_info
        assert info is not None, f"{self.name}: pure_kernel before caps"
        r, g, b, _a = info.rgb_offsets
        params = self._params()
        return lambda data: hsv_filter_b4(data, params, offsets=(r, g, b))


@register
class HsvDetector(VideoFilter):
    ELEMENT_NAME = "hsvdetector"
    ELEMENT_CLASS = "Filter/Effect/Converter/Video"
    ELEMENT_DESCRIPTION = "Works within the HSV colorspace to detect if a pixel is within the specified ranges"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = video_caps_template(_DETECT_IN_FORMATS)
    SRC_CAPS = video_caps_template(_DETECT_OUT_FORMATS)
    PROPERTIES = [
        Prop("hue-ref", 0.0, mutable="playing", doc="Hue reference in degrees"),
        Prop("hue-var", 10.0, minimum=0.0, maximum=180.0, mutable="playing"),
        Prop("saturation-ref", 0.0, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("saturation-var", 0.15, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("value-ref", 0.0, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("value-var", 0.3, minimum=0.0, maximum=1.0, mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
        # swap the format field for the opposite side's format list
        # (hsvdetector/imp.rs:386-411)
        out = caps.copy()
        formats = _DETECT_IN_FORMATS if direction == PadDirection.SRC else _DETECT_OUT_FORMATS
        for s in out.structures:
            s["format"] = ValueList(formats)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Buffer:
        in_info, out_info = self.video_info, self.out_video_info
        assert in_info is not None and out_info is not None
        ir, ig, ib, _ = in_info.rgb_offsets
        outr, outg, outb, oa = out_info.rgb_offsets
        params = torch.tensor(
            [
                self.get_property("hue-ref"),
                self.get_property("hue-var"),
                self.get_property("saturation-ref"),
                self.get_property("saturation-var"),
                self.get_property("value-ref"),
                self.get_property("value-var"),
            ],
            dtype=torch.float32,
        ).to(self._device)
        out_data = hsv_detect_frame(
            torch.as_tensor(inbuf.data, device=self._device),
            params,
            in_offsets=(ir, ig, ib),
            out_offsets=(outr, outg, outb),
            out_channels=out_info.components,
            alpha_off=oa,
        )
        out = Buffer(out_data)
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["HsvFilter", "HsvDetector", "hsv_filter_b4"]
