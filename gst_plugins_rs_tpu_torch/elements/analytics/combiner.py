"""analyticscombiner / analyticssplitter: N-stream batcher / debatcher.

Parity target: analytics/analytics/src/combiner/imp.rs (1108 LoC) +
splitter/imp.rs (441): the combiner aggregates buffers from all sink pads
into `multistream/x-analytics-batch` buffers over `batch-duration` (default
100 ms) windows with a per-pad `batch-strategy` (all / first-in-batch /
last-in-batch / first-in-batch-with-overlap); the splitter demuxes the batch
back into per-stream src pads.  This is the reference's mechanism for
amortizing inference across streams (SURVEY.md §2.3) — here it feeds
yoloxinference one batched forward pass per window.

Scenario semantics mirrored from analytics/analytics/tests/
analyticscombiner.rs + analyticssplitter.rs:
- each batch entry carries the contributing pad's stream-id, segment and
  caps; a requested pad that has not produced a stream yet contributes an
  EMPTY entry (no stream-id/segment/caps) and the src caps advertise
  `application/unknown` for its slot until it appears,
- the src caps carry a `streams` array of the per-stream caps and are
  re-pushed whenever that array changes (late-joining streams),
- `first-in-batch-with-overlap` selects the queued buffer whose PTS is
  CLOSEST to the window start — including a buffer left over from before
  the boundary — consuming everything up to the selection and retaining
  the rest for later windows (combiner/imp.rs:712-770),
- when one pad has data for a window but another stream has not started,
  the batch is emitted on the aggregator timeout (clock-armed; a
  TestClock.crank() fires it, the gst_check crank_single_clock_wait analog),
- the splitter re-emits each stream's ORIGINAL stream-start id, caps and
  segment on `src_<generation>_<index>` sometimes-pads and signals
  `pad-added` so applications can link late-appearing streams.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Meta,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    SECOND,
    Segment,
    register,
)
from ...core.aggregator import Aggregator, AggregatorPad

BATCH_CAPS = Caps.builder("multistream/x-analytics-batch")
UNKNOWN_CAPS = Caps.builder("application/unknown")

STRATEGIES = ["all", "first-in-batch", "last-in-batch", "first-in-batch-with-overlap"]


class BatchStreamEntry:
    """One stream's contribution to a batch window."""

    __slots__ = ("index", "caps", "buffers", "stream_id", "segment")

    def __init__(
        self,
        index: int,
        caps: Optional[Caps],
        buffers: List[Buffer],
        stream_id: Optional[str] = None,
        segment: Optional[Segment] = None,
    ):
        self.index = index
        self.caps = caps
        self.buffers = buffers
        self.stream_id = stream_id
        self.segment = segment

    def __repr__(self):
        return f"BatchStreamEntry(index={self.index}, n={len(self.buffers)})"


class BatchMeta(Meta):
    """gst_analytics::AnalyticsBatchMeta analog."""

    api = "analytics-batch"

    def __init__(self, streams: List[BatchStreamEntry]):
        self.streams = streams

    def __repr__(self):
        return f"BatchMeta({self.streams})"


class CombinerSinkPad(AggregatorPad):
    def __init__(self, name: str, template: PadTemplate, index: int):
        super().__init__(name, template)
        self.index = index
        self.batch_strategy = "all"


@register
class AnalyticsCombiner(Aggregator):
    ELEMENT_NAME = "analyticscombiner"
    ELEMENT_CLASS = "Combiner/Analytics"
    ELEMENT_DESCRIPTION = "Batches buffers from multiple streams for analytics processing"
    SRC_TEMPLATE_CAPS = BATCH_CAPS
    FORWARD_SINK_SEGMENT = False  # pushes its own segment after the batch caps
    PROPERTIES = [
        Prop("batch-duration", 100 * SECOND // 1000, type="uint64", mutable="ready"),
        Prop("force-live", False, type="bool", mutable="ready"),
    ]
    # GstAnalyticsCombinerSinkPad surface (reference rsanalytics other-types)
    PAD_PROPERTIES = {
        "sink": [
            Prop("batch-strategy", "all", type="enum", choices=STRATEGIES,
                 mutable="ready",
                 doc="which of the window's buffers this stream contributes"),
            Prop("index", 0, type="uint", mutable="ready",
                 doc="stream index inside the batch (defaults to request "
                     "order)"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._window_start = 0
        self._caps_streams: Optional[Tuple] = None
        self._lock = threading.Lock()
        self._timeout_id = None
        self._timeout_gen = 0

    def request_sink_pad(self, name: Optional[str] = None) -> CombinerSinkPad:
        idx = self._pad_counter
        if name is None:
            name = f"sink_{idx}"
        self._pad_counter += 1
        pad = CombinerSinkPad(name, self._sink_template, idx)
        pad.chain_function = self._sink_chain
        pad.event_function = self._sink_event
        pad.query_function = self._sink_query
        self.add_pad(pad)
        pad._props["index"] = idx  # default = request order
        return pad

    def pad_property_changed(self, pad, name: str, value) -> None:
        if name == "batch-strategy":
            pad.batch_strategy = value
        elif name == "index":
            pad.index = value

    def set_pad_strategy(self, pad: CombinerSinkPad, strategy: str) -> None:
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown batch strategy {strategy!r}")
        pad.batch_strategy = strategy
        pad._props["batch-strategy"] = strategy

    # ------------------------------------------------------------------
    def _window_complete(self, pad: CombinerSinkPad, end: int) -> bool:
        """A pad's window contribution is complete when EOS or a queued
        buffer starts at/after the window end."""
        if pad.eos:
            return True
        for buf in pad.queue:
            if buf.pts is not None and buf.pts >= end:
                return True
        return False

    def _collect_pad(self, pad: CombinerSinkPad, end: int) -> List[Buffer]:
        """Consume this window's contribution from the pad queue per its
        batch strategy."""
        strategy = pad.batch_strategy
        if strategy == "first-in-batch-with-overlap":
            # Candidates: everything queued before the window end, including
            # leftovers from before the window boundary.  Pick the buffer
            # closest to the window START, consume up to and including it,
            # retain the rest (combiner/imp.rs:712-770).
            cand = [b for b in pad.queue if b.pts is None or b.pts < end]
            if not cand:
                return []
            start = self._window_start
            best = min(
                range(len(cand)),
                key=lambda i: abs((cand[i].pts if cand[i].pts is not None else start) - start),
            )
            for _ in range(best + 1):
                pad.pop_buffer()
            return [cand[best]]
        bufs: List[Buffer] = []
        while pad.queue and (pad.queue[0].pts is None or pad.queue[0].pts < end):
            bufs.append(pad.pop_buffer())
        if strategy == "first-in-batch" and len(bufs) > 1:
            bufs = bufs[:1]
        elif strategy == "last-in-batch" and len(bufs) > 1:
            bufs = bufs[-1:]
        return bufs

    def _update_src_caps(self, entries: List[BatchStreamEntry]) -> None:
        streams = [e.caps if e.caps is not None else UNKNOWN_CAPS for e in entries]
        sig = tuple(repr(c) for c in streams)
        if sig == self._caps_streams:
            return
        first = self._caps_streams is None
        caps = Caps.builder("multistream/x-analytics-batch", streams=streams)
        self.srcpad.current_caps = caps
        self.srcpad.push_event(Event.new_caps(caps))
        if first:
            self.srcpad.push_event(Event.new_segment(Segment()))
        self._caps_streams = sig

    def aggregate(self, timeout: bool) -> FlowReturn:
        duration = self.get_property("batch-duration")
        pads = sorted(self.agg_pads(), key=lambda p: p.index)  # type: ignore[attr-defined]
        end = self._window_start + duration
        if not timeout and not all(
            self._window_complete(p, end) for p in pads if not p.is_inactive()
        ):
            return FlowReturn.OK  # need more data for this window

        entries = []
        for pad in pads:
            bufs = self._collect_pad(pad, end)
            started = pad.stream_id is not None or pad.current_caps is not None
            if started:
                entries.append(
                    BatchStreamEntry(
                        pad.index, pad.current_caps, bufs,
                        stream_id=pad.stream_id, segment=pad.segment,
                    )
                )
            else:
                # stream not started: empty slot with no events or anything
                entries.append(BatchStreamEntry(pad.index, None, []))

        self._update_src_caps(entries)

        out = Buffer(None, pts=self._window_start, duration=duration)
        out.add_meta(BatchMeta(entries))
        self._window_start = end
        return self.finish_buffer(out)

    # -- timeout (the aggregator live-timeout analog) -------------------
    def _arm_timeout(self) -> None:
        """Arm a clock wait so a window with data is not blocked forever by
        a stream that has not started (reference: aggregator timeout, fired
        in tests via gst_check crank_single_clock_wait)."""
        clock = getattr(self, "clock", None)
        if clock is None or self._timeout_id is not None:
            return
        # non-live aggregation never times out (gst_base::Aggregator
        # contract); a TestClock counts as live — it is the harness's
        # crank_single_clock_wait hook
        from ...core.clock import TestClock

        if not self.get_property("force-live") and not isinstance(clock, TestClock):
            return
        if not any(p.queue for p in self.agg_pads()):
            return
        duration = self.get_property("batch-duration")
        gen = self._timeout_gen
        cid = clock.new_single_shot_id(clock.now() + duration)
        self._timeout_id = cid

        def fired(_cid):
            # on the clock's thread: take the base's aggregator lock first,
            # as a streaming thread does (Aggregator._sink_chain, then
            # _try_aggregate's _lock), so no pad queue is appended to while
            # the timeout reads it, and the two locks are always taken in
            # one order
            with self._agg_lock:
                with self._lock:
                    self._timeout_id = None
                    if gen != self._timeout_gen:
                        return  # window advanced since this was armed
                    if any(p.queue for p in self.agg_pads()):
                        self.aggregate(timeout=True)
                        self._timeout_gen += 1
                self._try_aggregate()

        cid.wait_async(fired)

    def _try_aggregate(self) -> FlowReturn:
        # override: windows complete on pts boundaries, not queue fullness
        ret = FlowReturn.OK
        with self._lock:
            while True:
                pads = self.agg_pads()
                active = [p for p in pads if not p.is_inactive()]
                duration = self.get_property("batch-duration")
                end = self._window_start + duration
                if pads and active and all(self._window_complete(p, end) for p in active):
                    ret = self.aggregate(timeout=False)
                    self._timeout_gen += 1
                    if ret != FlowReturn.OK:
                        return ret
                    continue
                if pads and not active:
                    # drain any remaining partial windows
                    while any(p.queue for p in pads):
                        ret = self.aggregate(timeout=True)
                        self._timeout_gen += 1
                        if ret != FlowReturn.OK:
                            return ret
                    if not self._eos_sent:
                        self._eos_sent = True
                        self.srcpad.push_event(Event.new_eos())
                elif pads and active:
                    self._arm_timeout()
                return ret


@register
class AnalyticsSplitter(Element):
    ELEMENT_NAME = "analyticssplitter"
    EXTRA_PAD_TEMPLATES = [
        ('src_%u_%u', 'src', 'sometimes', 'ANY'),
    ]
    ELEMENT_CLASS = "Demuxer/Analytics"
    ELEMENT_DESCRIPTION = "Splits analytics batch buffers back into per-stream pads"
    SIGNALS = {"pad-added": None}

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK, PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, BATCH_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._src_pads: Dict[int, Pad] = {}
        self._started: Dict[int, bool] = {}
        self._generation = 0

    def _get_src(self, index: int) -> Pad:
        if index not in self._src_pads:
            pad = Pad(
                f"src_{self._generation}_{index}",
                PadDirection.SRC,
                PadTemplate("src_%u_%u", PadDirection.SRC, PadPresence.SOMETIMES, Caps.new_any()),
            )
            self.add_pad(pad)
            self._src_pads[index] = pad
            self._started[index] = False
            self.emit("pad-added", pad)
        return self._src_pads[index]

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        meta = buf.get_meta(BatchMeta)
        if meta is None:
            return FlowReturn.ERROR
        ret = FlowReturn.OK
        for entry in meta.streams:
            if entry.stream_id is None and entry.caps is None and not entry.buffers:
                continue  # stream not present in this batch yet
            src = self._get_src(entry.index)
            if not self._started[entry.index]:
                # re-emit the ORIGINAL stream events captured in the batch
                # (analyticssplitter.rs asserts the upstream stream-id/caps)
                sid = entry.stream_id or f"{self.name}-src_{self._generation}_{entry.index}"
                src.push_event(Event.new_stream_start(sid))
                if entry.caps is not None:
                    src.current_caps = entry.caps
                    src.push_event(Event.new_caps(entry.caps))
                src.push_event(Event.new_segment(entry.segment if entry.segment is not None else Segment()))
                self._started[entry.index] = True
            elif entry.caps is not None and entry.caps != src.current_caps:
                src.current_caps = entry.caps
                src.push_event(Event.new_caps(entry.caps))
            if src.peer is None:
                continue
            for b in entry.buffers:
                r = src.push(b)
                if r != FlowReturn.OK:
                    ret = r
        return ret

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type in (EventType.EOS, EventType.FLUSH_START, EventType.FLUSH_STOP):
            ok = True
            for src in self._src_pads.values():
                ok = src.push_event(event) and ok
            return ok
        return True


__all__ = ["AnalyticsCombiner", "AnalyticsSplitter", "BatchMeta", "BatchStreamEntry", "STRATEGIES"]
