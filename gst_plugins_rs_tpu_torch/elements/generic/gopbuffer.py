"""gopbuffer: buffers complete GOPs (keyframe-delimited groups) before
forwarding.

Parity target: generic/gopbuffer (1098 LoC): a valve that queues buffers and
only forwards whole GOPs once at least `minimum-duration` is buffered; a
buffer without the DELTA_UNIT flag starts a new GOP.
"""
from __future__ import annotations

from typing import List, Optional

from ...core import (
    BaseTransform,
    Buffer,
    BufferFlags,
    PadPresence,
    PadTemplate,
    Prop,
    SECOND,
    TransformMode,
    register,
)


@register
class GopBuffer(BaseTransform):
    ELEMENT_NAME = "gopbuffer"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Buffers complete GOPs before forwarding them"
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("minimum-duration", SECOND, type="uint64", mutable="playing",
             doc="Minimum duration to buffer before forwarding complete GOPs"),
        Prop("max-size-time", 0, type="uint64", mutable="playing",
             doc="Maximum duration to store (0=disable): oldest complete "
                 "GOPs are dropped when the buffered span exceeds this"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        # the reference names the always pads video_sink/video_src
        # (gopbuffer/imp.rs pad templates)
        for old, new in (("sink", "video_sink"), ("src", "video_src")):
            pad = self.pads.pop(old)
            pad.name = new
            pad.template = PadTemplate(new, pad.direction,
                                       PadPresence.ALWAYS, pad.template.caps)
            self.pads[new] = pad
        self._gops: List[List[Buffer]] = []  # closed GOPs
        self._current: List[Buffer] = []

    def start(self) -> None:
        self._gops = []
        self._current = []

    def _buffered_duration(self) -> int:
        bufs = [b for gop in self._gops for b in gop] + self._current
        with_pts = [b for b in bufs if b.pts is not None]
        if len(with_pts) < 1:
            return 0
        last = with_pts[-1]
        end = last.pts + (last.duration or 0)
        return end - with_pts[0].pts

    def submit_input_buffer(self, buf: Buffer) -> None:
        is_key = not buf.has_flag(BufferFlags.DELTA_UNIT)
        if is_key and self._current:
            self._gops.append(self._current)
            self._current = []
        self._current.append(buf)
        # max-size-time: cap the stored span by dropping oldest closed GOPs
        # (gopbuffer/imp.rs max-size-time semantics)
        limit = self.get_property("max-size-time")
        while limit and len(self._gops) > 1 and self._buffered_duration() > limit:
            self._gops.pop(0)

    def generate_output(self) -> Optional[Buffer]:
        # pushes complete GOPs in order directly; always returns None
        while self._gops and self._buffered_duration() >= self.get_property("minimum-duration"):
            for b in self._gops.pop(0):
                self.srcpad.push(b)
        return None

    def drain(self) -> Optional[Buffer]:
        if self._current:
            self._gops.append(self._current)
            self._current = []
        for gop in self._gops:
            for b in gop:
                self.srcpad.push(b)
        self._gops = []
        return None


__all__ = ["GopBuffer"]
