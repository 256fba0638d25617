"""audiomixer: mixes N audio streams by summation, on the device.

The port of gst_plugins_rs_tpu/elements/audiofx/audiomixer.py, a stand-in
for GStreamer's core audiomixer, which the reference's loudnorm limiter
tests use to mix tick trains into quiet sines
(audio/audiofx/tests/audioloudnorm.rs:40-49).  It aggregates per-pad queues
(core/aggregator.py) and emits buffers of `output-buffer-duration`; a pad at
EOS with less left is padded with zeros.  The sum runs on the device of the
incoming buffers.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import (
    Adapter,
    AudioInfo,
    Buffer,
    Event,
    EventType,
    FlowReturn,
    Prop,
    SECOND,
    Segment,
    audio_caps_template,
    register,
)
from ...core.aggregator import Aggregator, AggregatorPad


@register
class AudioMixer(Aggregator):
    ELEMENT_NAME = "audiomixer"
    ELEMENT_CLASS = "Generic/Audio"
    ELEMENT_DESCRIPTION = "Mixes multiple audio streams by summation"
    SINK_TEMPLATE_CAPS = audio_caps_template(formats=("F32", "F64"))
    SRC_TEMPLATE_CAPS = audio_caps_template(formats=("F32", "F64"))

    PROPERTIES = [
        Prop("output-buffer-duration", 10 * SECOND // 1000, type="uint64", mutable="ready"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._adapters = {}
        self._info: Optional[AudioInfo] = None
        self._sent_caps = False
        self._out_frames = 0
        self._position = 0  # frames emitted

    def sink_event(self, pad: AggregatorPad, event: Event) -> bool:
        if event.type == EventType.CAPS and self._info is None:
            self._info = AudioInfo.from_caps(event.get("caps"))
            self._out_frames = (
                self.get_property("output-buffer-duration") * self._info.rate // SECOND
            )
        return True

    def _adapter(self, pad: AggregatorPad) -> Adapter:
        if pad.name not in self._adapters:
            self._adapters[pad.name] = Adapter()
        return self._adapters[pad.name]

    def aggregate(self, timeout: bool) -> FlowReturn:
        info = self._info
        if info is None:
            return FlowReturn.OK
        pads = self.agg_pads()
        for pad in pads:
            while pad.queue:
                self._adapter(pad).push(pad.pop_buffer())

        ret = FlowReturn.OK
        while True:
            adapters = [self._adapter(p) for p in pads]
            active = [(p, a) for p, a in zip(pads, adapters) if not (p.eos and a.available() == 0)]
            if not active:
                break
            n = self._out_frames
            ready = all(a.available() >= n or p.eos for p, a in active)
            if not ready:
                break
            mix = None
            for p, a in active:
                take = min(n, a.available())
                if take == 0:
                    continue
                chunk = torch.as_tensor(a.take(take))
                if take < n:
                    chunk = torch.cat([chunk, chunk.new_zeros((n - take, chunk.shape[1]))])
                mix = chunk if mix is None else mix + chunk.to(mix.device)
            if mix is None:
                break
            if not self._sent_caps:
                caps = info.to_caps()
                self.srcpad.current_caps = caps
                self.srcpad.push_event(Event.new_caps(caps))
                self.srcpad.push_event(Event.new_segment(Segment()))
                self._sent_caps = True
            pts = self._position * SECOND // info.rate
            self._position += n
            dur = self._position * SECOND // info.rate - pts
            ret = self.finish_buffer(Buffer(mix, pts=pts, duration=dur))
            if ret != FlowReturn.OK:
                return ret
        return ret

    def _try_aggregate(self) -> FlowReturn:
        ret = FlowReturn.OK
        pads = self.agg_pads()
        if not pads:
            return ret
        n = self._out_frames or 1

        def pad_ready(p):
            queued = self._adapter(p).available() + sum(b.n_frames for b in p.queue)
            return p.eos or queued >= n

        if self._info is not None and all(pad_ready(p) for p in pads):
            ret = self.aggregate(timeout=False)
        # EOS is forwarded by the base class once every pad is inactive
        return ret


__all__ = ["AudioMixer"]
