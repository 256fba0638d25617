"""imagersoverlay: composite a still image over video frames on the device.

Parity target: video/image/src/overlay (imagersoverlay, overlay/imp.rs:20;
offset-x/offset-y with negative = from right/bottom edge,
overlay/imp.rs:122-143).  The overlay image is decoded once on the host
(Pillow, imported inside `start`) and put on the device
`gst_plugins_rs_tpu_torch.set_device` selects, once, when the element
starts.  The placement (padding and cropping to the frame) is built there
from it and cached per frame size and position, so each frame is one
elementwise blend in f32: `f * (1 - alpha) + rgb * alpha`, clipped and cast
back, as the JAX package's jitted `_blend`.  A host frame is moved to that
device; a tensor on another device raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..._device import device
from ...core import (
    Buffer,
    Prop,
    TransformMode,
    VideoFilter,
    register,
    video_caps_template,
)

VIDEO_CAPS = video_caps_template(("RGB", "RGBA"))


def blend(frame: torch.Tensor, overlay_rgb: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    f = frame.to(torch.float32)
    out = f * (1.0 - alpha) + overlay_rgb * alpha
    return torch.clamp(out, 0.0, 255.0).to(frame.dtype)


@register
class ImageOverlay(VideoFilter):
    ELEMENT_NAME = "imagersoverlay"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Overlays an image onto video frames on device"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = VIDEO_CAPS
    SRC_CAPS = VIDEO_CAPS
    PROPERTIES = [
        Prop("location", None, type="str", doc="image file to overlay"),
        Prop("offset-x", 0, type="int", mutable="playing",
             doc="negative = offset from the right edge (overlay/imp.rs:126)"),
        Prop("offset-y", 0, type="int", mutable="playing",
             doc="negative = offset from the bottom edge"),
        Prop("alpha", 1.0, type="float", minimum=0.0, maximum=1.0,
             mutable="playing", doc="global overlay opacity multiplier"),
        Prop("overlay-width", 0, type="int", mutable="playing",
             doc="scale the overlay to this width (0 = native)"),
        Prop("overlay-height", 0, type="int", mutable="playing",
             doc="scale the overlay to this height (0 = native)"),
        Prop("relative-x", 0.0, type="float", minimum=-1.0, maximum=1.0,
             mutable="playing",
             doc="extra offset as a fraction of the video width"),
        Prop("relative-y", 0.0, type="float", minimum=-1.0, maximum=1.0,
             mutable="playing",
             doc="extra offset as a fraction of the video height"),
        Prop("coef-x", 0.0, type="float", minimum=-1.0, maximum=1.0,
             mutable="playing",
             doc="additional fractional offset (pixels-absolute mode)"),
        Prop("coef-y", 0.0, type="float", minimum=-1.0, maximum=1.0,
             mutable="playing"),
        Prop("positioning-mode", "pixels-relative-to-edges", type="enum",
             choices=["pixels-relative-to-edges", "pixels-absolute"],
             mutable="playing",
             doc="how offset-x/-y are interpreted (overlay/imp.rs:36-42)"),
        Prop("max-alloc-bytes", 0, type="uint64",
             doc="reject overlay images whose RGBA allocation exceeds "
                 "this (0 = unlimited)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._image: Optional[torch.Tensor] = None  # RGBA u8 on the device
        self._placed: Optional[Tuple] = None  # (key, rgb, alpha) on the device

    def start(self) -> None:
        loc = self.get_property("location")
        self._image = None
        if loc:
            from PIL import Image

            img = Image.open(loc).convert("RGBA")
            ow = self.get_property("overlay-width") or img.width
            oh = self.get_property("overlay-height") or img.height
            limit = self.get_property("max-alloc-bytes")
            if limit and ow * oh * 4 > limit:
                raise ValueError(
                    f"{self.name}: overlay {ow}x{oh} exceeds "
                    f"max-alloc-bytes={limit}")
            if (ow, oh) != (img.width, img.height):
                img = img.resize((ow, oh))
            self._image = torch.from_numpy(np.array(img)).to(device())
        self._placed = None

    def property_changed(self, name: str, value) -> None:
        self._placed = None

    def _placement(self, h: int, w: int, channels: int):
        ox, oy = self.get_property("offset-x"), self.get_property("offset-y")
        rx, ry = self.get_property("relative-x"), self.get_property("relative-y")
        cx, cy = self.get_property("coef-x"), self.get_property("coef-y")
        mode = self.get_property("positioning-mode")
        key = (h, w, channels, ox, oy, rx, ry, cx, cy, mode)
        if self._placed is not None and self._placed[0] == key:
            return self._placed[1], self._placed[2]
        img = self._image
        ih, iw = img.shape[:2]
        # positioning per overlay/imp.rs:121-146
        if mode == "pixels-absolute":
            x = ox + int(rx * w) + int(cx * w)
            y = oy + int(ry * h) + int(cy * h)
        else:
            x = (w + ox - iw if ox < 0 else ox) + int(rx * w)
            y = (h + oy - ih if oy < 0 else oy) + int(ry * h)
        rgb = torch.zeros((h, w, channels), dtype=torch.float32, device=img.device)
        alpha = torch.zeros((h, w, 1), dtype=torch.float32, device=img.device)
        sx, sy = max(0, -x), max(0, -y)
        dx, dy = max(0, x), max(0, y)
        cw = min(iw - sx, w - dx)
        ch = min(ih - sy, h - dy)
        if cw > 0 and ch > 0:
            crop = img[sy : sy + ch, sx : sx + cw].to(torch.float32)
            rgb[dy : dy + ch, dx : dx + cw, :3] = crop[..., :3]
            if channels == 4:
                rgb[dy : dy + ch, dx : dx + cw, 3] = 255.0
            # a true division on every device: CUDA divides by a host
            # scalar as a product with its reciprocal, one ulp off the CPU's
            # (and numpy's) quotient, which the blend's truncation can show
            alpha[dy : dy + ch, dx : dx + cw, 0] = crop[..., 3] / torch.full(
                (), 255.0, device=img.device)
        self._placed = (key, rgb, alpha)
        return rgb, alpha

    def transform(self, inbuf: Buffer) -> Buffer:
        if self._image is None:
            out = Buffer(inbuf.data)
            out.copy_metadata_from(inbuf)
            return out
        frame = inbuf.data
        if not isinstance(frame, torch.Tensor):
            frame = torch.as_tensor(np.asarray(frame), device=self._image.device)
        elif frame.device != self._image.device:
            raise ValueError(f"{self.name}: a frame on {frame.device}, the overlay on "
                             f"{self._image.device}")
        rgb, alpha = self._placement(frame.shape[0], frame.shape[1], frame.shape[2])
        galpha = self.get_property("alpha")
        if galpha != 1.0:
            alpha = alpha * galpha
        out = Buffer(blend(frame, rgb, alpha))
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["ImageOverlay", "blend"]
