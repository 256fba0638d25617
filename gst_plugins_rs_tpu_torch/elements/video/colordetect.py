"""colordetect: posts a message when the dominant frame colour changes.

The port of gst_plugins_rs_tpu/elements/video/colordetect.py (parity target
video/videofx/src/colordetect/imp.rs): a passthrough video filter; a
color-thief palette with a `quality` sampling step and `max-colors`; the
CSS name of the dominant colour; a `colordetect` element message with
dominant-color and palette (0xRRGGBB list) only when the dominant colour
changes.  The histogram is built on the device (ops/palette.py) and read
back once a frame (32^3 counts); the median cut runs on the host.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import (
    Buffer,
    Message,
    MessageType,
    Prop,
    Structure,
    TransformMode,
    VideoFilter,
    register,
    video_caps_template,
)
from ..._device import device
from ...ops.palette import color_histogram, css_color_name, median_cut_palette

_FORMATS = ("RGB", "RGBA", "RGBx", "BGR", "BGRA", "BGRx")


@register
class ColorDetect(VideoFilter):
    ELEMENT_NAME = "colordetect"
    ELEMENT_CLASS = "Filter/Analyzer/Video"
    ELEMENT_DESCRIPTION = "Detects the dominant color of a video"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = True
    TRANSFORM_IP_ON_PASSTHROUGH = True
    SINK_CAPS = video_caps_template(_FORMATS)
    SRC_CAPS = video_caps_template(_FORMATS)

    PROPERTIES = [
        Prop("quality", 10, type="uint", minimum=1, maximum=10, mutable="playing",
             doc="A step in pixels to improve performance"),
        Prop("max-colors", 2, type="uint", minimum=1, maximum=255, mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._current: Optional[str] = None
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._current = None
        self._device = device()

    def transform_ip(self, buf: Buffer) -> Buffer:
        info = self.video_info
        assert info is not None
        r_off, g_off, b_off, a_off = info.rgb_offsets
        frame = torch.as_tensor(buf.data, device=self._device)
        # normalize channel order for the histogram (r,g,b[,a] layout)
        chans = [frame[..., r_off], frame[..., g_off], frame[..., b_off]]
        if a_off is not None:
            chans.append(frame[..., a_off])
        hist = color_histogram(torch.stack(chans, dim=-1), quality=self.get_property("quality"),
                               has_alpha=a_off is not None).cpu().numpy()
        palette = median_cut_palette(hist, self.get_property("max-colors"))
        if not palette:
            return buf
        name = css_color_name(palette[0])
        if name != self._current:
            self._current = name
            s = Structure(
                "colordetect",
                **{
                    "dominant-color": name,
                    "palette": tuple((r << 16) | (g << 8) | b for r, g, b in palette),
                },
            )
            self.post_message(Message(MessageType.ELEMENT, structure=s))
        return buf


__all__ = ["ColorDetect"]
