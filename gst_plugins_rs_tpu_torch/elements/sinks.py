"""Sinks: appsink (collects samples for the application), fakesink."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import BaseSink, Buffer, Caps, FlowReturn, Prop, register
from ..core.payload import host_array


class Sample:
    """Buffer + the caps it was produced under (gst::Sample analog)."""

    __slots__ = ("buffer", "caps")

    def __init__(self, buffer: Buffer, caps: Optional[Caps]):
        self.buffer = buffer
        self.caps = caps

    def __repr__(self):
        return f"Sample({self.buffer!r}, {self.caps!r})"


@register
class AppSink(BaseSink):
    ELEMENT_NAME = "appsink"
    ELEMENT_CLASS = "Sink/Generic"
    ELEMENT_DESCRIPTION = "Collect buffers for the application"
    PROPERTIES = [
        Prop("sync", False, type="bool"),
        Prop("max-buffers", 0, type="uint", doc="0 = unbounded"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.samples: List[Sample] = []

    def render(self, buffer: Buffer) -> FlowReturn:
        self.samples.append(Sample(buffer, self.caps))
        maxb = self.get_property("max-buffers")
        if maxb and len(self.samples) > maxb:
            self.samples.pop(0)
        return FlowReturn.OK

    def pull_sample(self) -> Optional[Sample]:
        return self.samples.pop(0) if self.samples else None

    def concat_audio(self) -> np.ndarray:
        """Concatenate all collected audio payloads to one [frames, ch] host array."""
        if not self.samples:
            return np.zeros((0, 0), np.float32)
        return np.concatenate([host_array(s.buffer.data) for s in self.samples], axis=0)

    def on_paused_to_ready_keep_samples(self) -> None:
        pass  # samples survive teardown so tests can inspect them


@register
class FakeSink(BaseSink):
    ELEMENT_NAME = "fakesink"
    ELEMENT_CLASS = "Sink/Generic"
    ELEMENT_DESCRIPTION = "Discard all buffers"
    PROPERTIES = [
        Prop("sync", False, type="bool"),
        Prop("num-rendered", 0, type="uint64", doc="read-only counter"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.rendered = 0
        self.last_buffer: Optional[Buffer] = None

    def render(self, buffer: Buffer) -> FlowReturn:
        self.rendered += 1
        self.last_buffer = buffer
        self._props["num-rendered"] = self.rendered
        return FlowReturn.OK


__all__ = ["AppSink", "FakeSink", "Sample"]
