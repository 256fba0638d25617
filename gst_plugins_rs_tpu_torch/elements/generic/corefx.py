"""GStreamer-core support elements: volume, videoflip, videocrop, videorate,
audiorate.

The port of gst_plugins_rs_tpu/elements/generic/corefx.py.  None of these
live in gst-plugins-rs itself (they are gstreamer/gst-plugins-base core),
but its documented pipelines compose with them.  volume, videoflip and
videocrop run on the device `gst_plugins_rs_tpu_torch.set_device` selects
(frames that arrive elsewhere are moved there): volume is one product in the
payload's type, videoflip and videocrop are layout operations whose output
is a new contiguous frame (the JAX package's arrays are never views).
videoflip has the chain-fusion hook (parallel/fuse.py).  videorate and
audiorate are PTS-timeline logic on the host; audiorate's silence is
`torch.zeros` on the payload's device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    Prop,
    TransformMode,
    VideoFilter,
    audio_caps_template,
    register,
    video_caps_template,
)
from ...core.video import RGB_FORMATS


@register
class Volume(BaseTransform):
    """Gain + mute (gst-plugins-base volume element surface)."""

    ELEMENT_NAME = "volume"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Adjusts audio volume"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = audio_caps_template(formats=("F32", "F64"))
    SRC_CAPS = audio_caps_template(formats=("F32", "F64"))
    PROPERTIES = [
        Prop("volume", 1.0, minimum=0.0, maximum=10.0, mutable="playing",
             doc="volume factor, 1.0 = 100%"),
        Prop("mute", False, type="bool", mutable="playing"),
    ]

    def transform(self, inbuf: Buffer) -> Buffer:
        g = 0.0 if self.get_property("mute") else self.get_property("volume")
        d = torch.as_tensor(inbuf.data, device=device())
        if g != 1.0:
            # the gain rounded to the payload's type, as the JAX element's
            # jnp.asarray(g, dtype); F64 stays F64
            np_dtype = np.float64 if d.dtype == torch.float64 else np.float32
            d = d * float(np.asarray(g, np_dtype))
        out = Buffer(d)
        out.copy_metadata_from(inbuf)
        return out


_FLIP_METHODS = ["none", "clockwise", "rotate-180", "counterclockwise",
                 "horizontal-flip", "vertical-flip",
                 "upper-left-diagonal", "upper-right-diagonal"]
_SWAPS_DIMS = {"clockwise", "counterclockwise",
               "upper-left-diagonal", "upper-right-diagonal"}


def flip_frame(method: str, x: torch.Tensor) -> torch.Tensor:
    """One videoflip method on an [H, W, ...] frame, as a new contiguous
    frame (`x` itself for "none")."""
    if method == "clockwise":
        y = torch.rot90(x, k=-1, dims=(0, 1))
    elif method == "counterclockwise":
        y = torch.rot90(x, k=1, dims=(0, 1))
    elif method == "rotate-180":
        y = torch.flip(x, dims=(0, 1))
    elif method == "horizontal-flip":
        y = torch.flip(x, dims=(1,))
    elif method == "vertical-flip":
        y = torch.flip(x, dims=(0,))
    elif method == "upper-left-diagonal":
        y = x.transpose(0, 1)
    elif method == "upper-right-diagonal":
        y = torch.flip(x, dims=(0, 1)).transpose(0, 1)
    else:
        return x
    return y.contiguous()


@register
class VideoFlip(VideoFilter):
    """Rotate/flip (gst-plugins-base videoflip surface)."""

    ELEMENT_NAME = "videoflip"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Flips and rotates video"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(tuple(RGB_FORMATS))
    SRC_CAPS = video_caps_template(tuple(RGB_FORMATS))
    PROPERTIES = [
        Prop("method", "none", type="enum", choices=_FLIP_METHODS,
             mutable="ready", doc="rotation/flip method"),
    ]

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK
                   else self.SINK_CAPS).copy()
        if self.get_property("method") in _SWAPS_DIMS:
            for s in out.structures:
                w, h = s.get("width"), s.get("height")
                if w is not None and h is not None:
                    s["width"], s["height"] = h, w
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def pure_kernel(self):
        """Chain-fusion hook (parallel/fuse.py)."""
        m = self.get_property("method")
        return lambda x: flip_frame(m, x)

    def transform(self, inbuf: Buffer) -> Buffer:
        data = torch.as_tensor(inbuf.data, device=device())
        out = Buffer(flip_frame(self.get_property("method"), data))
        out.copy_metadata_from(inbuf)
        return out


@register
class VideoCrop(VideoFilter):
    """Edge cropping (gst-plugins-base videocrop surface)."""

    ELEMENT_NAME = "videocrop"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Crops video into a region of interest"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(tuple(RGB_FORMATS))
    SRC_CAPS = video_caps_template(tuple(RGB_FORMATS))
    PROPERTIES = [
        Prop("top", 0, type="int", minimum=0, mutable="ready"),
        Prop("bottom", 0, type="int", minimum=0, mutable="ready"),
        Prop("left", 0, type="int", minimum=0, mutable="ready"),
        Prop("right", 0, type="int", minimum=0, mutable="ready"),
    ]

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        dx = self.get_property("left") + self.get_property("right")
        dy = self.get_property("top") + self.get_property("bottom")
        sign = -1 if direction == PadDirection.SINK else 1
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK
                   else self.SINK_CAPS).copy()
        for s in out.structures:
            w, h = s.get("width"), s.get("height")
            if isinstance(w, int):
                s["width"] = max(1, w + sign * dx)
            if isinstance(h, int):
                s["height"] = max(1, h + sign * dy)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def setup(self, in_info, out_info) -> None:
        dx = self.get_property("left") + self.get_property("right")
        dy = self.get_property("top") + self.get_property("bottom")
        if dx >= in_info.width or dy >= in_info.height:
            raise ValueError(
                f"{self.name}: crop ({dx}x{dy}) consumes the whole "
                f"{in_info.width}x{in_info.height} frame")

    def transform(self, inbuf: Buffer) -> Buffer:
        t, b = self.get_property("top"), self.get_property("bottom")
        l, r = self.get_property("left"), self.get_property("right")
        data = torch.as_tensor(inbuf.data, device=device())
        h, w = data.shape[0], data.shape[1]
        out = Buffer(data[t:h - b, l:w - r].contiguous())
        out.copy_metadata_from(inbuf)
        return out


@register
class VideoRate(VideoFilter):
    """Framerate conversion by duplicating/dropping frames on the PTS
    timeline (gst-plugins-base videorate behavior: each output slot gets
    the most recent input frame whose PTS does not exceed it)."""

    ELEMENT_NAME = "videorate"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Converts framerate by duplicating or dropping frames"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(tuple(RGB_FORMATS))
    SRC_CAPS = video_caps_template(tuple(RGB_FORMATS))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._pending: List[Buffer] = []
        self._held: Optional[Buffer] = None
        self._out_n = 0

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK
                   else self.SINK_CAPS).copy()
        # preference order: keep the stream's framerate (first structure);
        # fall back to a framerate-free wildcard that adopts ANY peer rate
        # (absent field = wildcard under Structure.intersect)
        structures = []
        for s in out.structures:
            if s.get("framerate") is not None:
                structures.append(s.copy())
            wild = s.copy()
            wild.fields.pop("framerate", None)
            structures.append(wild)
        out = Caps(structures)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        s = caps.structure(0)
        return othercaps.fixate({"framerate": s.get("framerate")})

    def _slot_pts(self, n: int) -> int:
        fps = self.out_video_info.fps
        return n * 1_000_000_000 * fps.denominator // fps.numerator

    def _emit_up_to(self, pts_limit: int) -> None:
        """Emit output slots strictly before pts_limit using the held frame."""
        if self._held is None:
            return
        while self._slot_pts(self._out_n) < pts_limit:
            slot = self._slot_pts(self._out_n)
            dup = Buffer(self._held.data, pts=slot,
                         duration=self._slot_pts(self._out_n + 1) - slot)
            self._pending.append(dup)
            self._out_n += 1

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            pts = inbuf.pts if inbuf.pts is not None else 0
            self._emit_up_to(pts)  # slots before this frame use the old one
            self._held = inbuf
        if self._pending:
            return self._pending.pop(0)
        return None

    def drain(self) -> Optional[Buffer]:
        if self._held is not None:
            end = (self._held.pts or 0) + (self._held.duration or 0)
            self._emit_up_to(end)
            self._held = None
        while len(self._pending) > 1:
            self.srcpad.push(self._pending.pop(0))
        return self._pending.pop(0) if self._pending else None

    def on_paused_to_ready(self) -> None:
        super().on_paused_to_ready()
        self._pending = []
        self._held = None
        self._out_n = 0


@register
class AudioRate(BaseTransform):
    """Gap-filling / overlap-trimming on the sample timeline
    (gst-plugins-base audiorate behavior): output sample count always
    equals PTS-elapsed x rate — discontinuities become silence, overlaps
    are dropped."""

    ELEMENT_NAME = "audiorate"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Drops/duplicates samples to repair timestamp gaps"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = audio_caps_template(formats=("F32",))
    SRC_CAPS = audio_caps_template(formats=("F32",))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._next_sample = 0
        self._base_pts = None
        self._rate = 0

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self._rate = incaps.structure(0)["rate"]
        self._next_sample = 0
        self._base_pts = None

    def transform(self, inbuf: Buffer) -> Buffer:
        x = torch.atleast_2d(torch.as_tensor(inbuf.data, device=device()))
        if self._base_pts is None:
            self._base_pts = inbuf.pts if inbuf.pts is not None else 0
        if inbuf.pts is not None:
            want = round((inbuf.pts - self._base_pts) * self._rate / 1_000_000_000)
        else:
            # no timestamp = contiguous with the running timeline
            want = self._next_sample
        delta = want - self._next_sample
        if delta > 0:  # gap: prepend silence
            x = torch.cat([torch.zeros((int(delta), x.shape[1]), dtype=x.dtype,
                                       device=x.device), x], dim=0)
        elif delta < 0:  # overlap: drop the stale head
            x = x[int(-delta):] if -delta < x.shape[0] else x[:0]
        pts_out = (self._base_pts
                   + self._next_sample * 1_000_000_000 // self._rate)
        self._next_sample += int(x.shape[0])
        return Buffer(x, pts=pts_out,
                      duration=int(x.shape[0]) * 1_000_000_000 // self._rate)

    def on_paused_to_ready(self) -> None:
        super().on_paused_to_ready()
        self._next_sample = 0
        self._base_pts = None


__all__ = ["AudioRate", "VideoCrop", "VideoFlip", "VideoRate", "Volume", "flip_frame"]
