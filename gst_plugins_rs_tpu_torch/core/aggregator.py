"""Aggregator base class: N request sink pads -> one src pad.

Rebuild of gst_base::Aggregator as used by the reference's videocompare
(video/videofx/src/videocompare/imp.rs) and analyticscombiner
(analytics/analytics/src/combiner/imp.rs).  Synchronous model: aggregate()
fires whenever every non-EOS sink pad has at least one queued buffer (or on
EOS drain).

Buffers may arrive from several threads at once (a `queue` in front of each
sink pad runs its own).  One reentrant lock per aggregator is held around a
pad's queue append and the whole aggregation loop, and around the sink
events (EOS and flush touch the pad queues), so two threads never pop and
push at once and the output keeps its order.  It is reentrant because
aggregate() pushes downstream in the same thread, and a downstream element
may come back into this one.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

from .buffer import Buffer
from .caps import Caps
from .element import (
    Element,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
)
from .events import Event, EventType, Segment


class AggregatorPad(Pad):
    def __init__(self, name: str, template: PadTemplate):
        super().__init__(name, PadDirection.SINK, template)
        self.queue: deque = deque()
        self.eos = False
        self.segment: Optional[Segment] = None
        self.stream_id: Optional[str] = None

    def peek_buffer(self) -> Optional[Buffer]:
        return self.queue[0] if self.queue else None

    def pop_buffer(self) -> Optional[Buffer]:
        return self.queue.popleft() if self.queue else None

    def has_buffer(self) -> bool:
        return bool(self.queue)

    def is_inactive(self) -> bool:
        return self.eos and not self.queue


class Aggregator(Element):
    SINK_TEMPLATE_CAPS: Caps = Caps.new_any()
    SRC_TEMPLATE_CAPS: Caps = Caps.new_any()
    # subclasses that push their own segment downstream (analyticscombiner)
    # set this False so the first pad's segment is not forwarded verbatim
    FORWARD_SINK_SEGMENT = True

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC, PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, self.SRC_TEMPLATE_CAPS))
        )
        self._pad_counter = 0
        self._sent_stream_start = False
        self._eos_sent = False
        self._sink_template = PadTemplate(
            "sink_%u", PadDirection.SINK, PadPresence.REQUEST, self.SINK_TEMPLATE_CAPS
        )
        self._agg_lock = threading.RLock()

    # -- pads -----------------------------------------------------------------
    def request_sink_pad(self, name: Optional[str] = None) -> AggregatorPad:
        if name is None:
            name = f"sink_{self._pad_counter}"
        self._pad_counter += 1
        pad = AggregatorPad(name, self._sink_template)
        pad.chain_function = self._sink_chain
        pad.event_function = self._sink_event
        pad.query_function = self._sink_query
        return self.add_pad(pad)  # type: ignore[return-value]

    def _sink_query(self, pad: Pad, query) -> bool:
        from .events import QueryType

        if query.type == QueryType.CAPS:
            # sink caps are independent of the (batch-format) src side
            filter_ = query.fields.get("filter")
            caps = self.SINK_TEMPLATE_CAPS
            if filter_ is not None:
                caps = filter_.intersect(caps)
            query.result["caps"] = caps
            return True
        return self._default_query(pad, query)

    def request_pad(self, template_name: str = "sink_%u") -> AggregatorPad:
        return self.request_sink_pad()

    def agg_pads(self) -> List[AggregatorPad]:
        return [p for p in self.sink_pads() if isinstance(p, AggregatorPad)]

    # -- subclass hooks ----------------------------------------------------------
    def aggregate(self, timeout: bool) -> FlowReturn:
        """Consume queued buffers from the sink pads and push output."""
        raise NotImplementedError

    def sink_event(self, pad: AggregatorPad, event: Event) -> bool:
        return True

    def negotiated_src_caps(self, caps: Caps) -> None: ...

    def drain(self) -> None:
        """Hook: flush pending output right before EOS goes downstream
        (the gst_base::Aggregator EOS-drain contract muxers rely on)."""

    def finish_buffer(self, buf: Buffer) -> FlowReturn:
        return self.srcpad.push(buf)

    # -- dataflow ------------------------------------------------------------------
    def _maybe_forward_stream_start(self, pad: AggregatorPad, event: Event) -> None:
        if not self._sent_stream_start:
            self._sent_stream_start = True
            self.srcpad.push_event(event)

    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        assert isinstance(pad, AggregatorPad)
        with self._agg_lock:
            pad.queue.append(buf)
            return self._try_aggregate()

    def _try_aggregate(self) -> FlowReturn:
        ret = FlowReturn.OK
        with self._agg_lock:
            while True:
                pads = self.agg_pads()
                if not pads:
                    return ret
                active = [p for p in pads if not p.is_inactive()]
                if not active:
                    # everything EOS and drained
                    if not self._eos_sent:
                        self._eos_sent = True
                        self.drain()
                        self.srcpad.push_event(Event.new_eos())
                    return ret
                if all(p.has_buffer() for p in active):
                    ret = self.aggregate(timeout=False)
                    if ret not in (FlowReturn.OK,):
                        return ret
                else:
                    return ret

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        assert isinstance(pad, AggregatorPad)
        with self._agg_lock:
            if event.type == EventType.STREAM_START:
                pad.stream_id = event.get("stream_id")
                self._maybe_forward_stream_start(pad, event)
                return True
            if event.type == EventType.CAPS:
                pad.current_caps = event.get("caps")
                self.sink_event(pad, event)
                return True
            if event.type == EventType.SEGMENT:
                pad.segment = event.get("segment")
                if self.FORWARD_SINK_SEGMENT and pad is self.agg_pads()[0]:
                    return self.srcpad.push_event(event)
                return True
            if event.type == EventType.EOS:
                pad.eos = True
                self.sink_event(pad, event)
                self._try_aggregate()
                if not self._eos_sent and all(p.is_inactive() for p in self.agg_pads()):
                    self._eos_sent = True
                    return self.srcpad.push_event(event)
                return True
            return self.sink_event(pad, event)


__all__ = ["Aggregator", "AggregatorPad"]
