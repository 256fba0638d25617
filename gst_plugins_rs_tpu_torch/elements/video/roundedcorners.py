"""roundedcorners: adds an alpha plane with rounded corners (I420 -> A420).

The port of gst_plugins_rs_tpu/elements/video/roundedcorners.py (parity
target video/videofx/src/border/imp.rs: sink I420, src I420 at radius 0 or
A420; the alpha mask is made again only when the radius or the caps
change).  The mask is a rounded-rect signed-distance field with an
antialiased edge, computed on the selected device in float32 with the JAX
function's operations in its order, truncated to int32 and then to u8, and
cached per (height, width, radius).
"""
from __future__ import annotations

from typing import Optional, Tuple

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
)
from ...core.caps import IntRange, Structure
from ..._device import device


def _planar_caps(formats) -> Caps:
    fields = {
        "format": formats[0] if len(formats) == 1 else ValueList(formats),
        "width": IntRange(1, 32768),
        "height": IntRange(1, 32768),
    }
    return Caps([Structure("video/x-raw", **fields)])


def rounded_alpha_mask(*, h: int, w: int, radius: int, dev=None) -> torch.Tensor:
    """[h, w] uint8 alpha: opaque inside the rounded rect, antialiased edge."""
    dev = device() if dev is None else dev
    if radius == 0:
        return torch.full((h, w), 255, dtype=torch.uint8, device=dev)
    y = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    x = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    r = float(radius)
    # distance from each pixel to the rounded-rect interior
    cx = torch.clamp(x, r, w - r)
    cy = torch.clamp(y, r, h - r)
    dx, dy = x - cx, y - cy
    d = torch.sqrt(dx * dx + dy * dy) - r
    alpha = torch.clamp(0.5 - d, 0.0, 1.0) * 255.0
    return alpha.to(torch.int32).to(torch.uint8)


@register
class RoundedCorners(VideoFilter):
    ELEMENT_NAME = "roundedcorners"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Adds rounded corners to video via an alpha plane"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = _planar_caps(("I420",))
    SRC_CAPS = _planar_caps(("I420", "A420"))

    PROPERTIES = [
        Prop("border-radius-px", 0, type="uint", mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._mask = None
        self._mask_key: Optional[Tuple[int, int, int]] = None
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        for s in out.structures:
            if direction == PadDirection.SRC:
                s["format"] = "I420"
            else:
                # radius 0 may stay I420; otherwise alpha is required
                if self.get_property("border-radius-px") == 0:
                    s["format"] = ValueList(("I420", "A420"))
                else:
                    s["format"] = "A420"
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _get_mask(self, h: int, w: int):
        radius = self.get_property("border-radius-px")
        key = (h, w, radius)
        if self._mask_key != key:
            self._mask = rounded_alpha_mask(h=h, w=w, radius=radius, dev=self._device)
            self._mask_key = key
        return self._mask

    def transform(self, inbuf: Buffer) -> Buffer:
        out_info = self.out_video_info
        assert out_info is not None
        planes = inbuf.data if isinstance(inbuf.data, tuple) else (inbuf.data,)
        planes = tuple(torch.as_tensor(p, device=self._device) for p in planes)
        if out_info.format == "I420":
            out = Buffer(planes)
        else:
            y = planes[0]
            alpha = self._get_mask(int(y.shape[0]), int(y.shape[1]))
            out = Buffer(planes[:3] + (alpha,))
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["RoundedCorners", "rounded_alpha_mask"]
