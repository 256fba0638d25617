"""togglerecord: synchronized multi-stream record valve.

Parity target: utils/togglerecord (togglerecord/imp.rs, 2339 LoC).  One
main stream (always pads `sink`/`src`) drives the recording state machine;
any number of secondary streams (request `sink_%u` paired with `src_%u`)
are clipped to the exact running-time spans the main stream recorded, so
e.g. audio tracks line up with the video track that gates the recording.

Recording state machine (imp.rs:113-131):

- Stopped:   dropping (live upstream) or blocking (non-live upstream)
- Starting:  record=true seen; main waits for the next keyframe, sets
             last_recording_start, then waits for secondaries to catch up
- Recording: passing everything
- Stopping:  record=false seen; main passes until the next keyframe, sets
             last_recording_stop right before it, waits for secondaries

Secondary streams must always run *behind* the main stream (imp.rs:115);
a secondary buffer ahead of the main stream's watermark blocks until the
main stream advances past it (or goes EOS), exactly like the reference's
condvar design.  Main-stream EOS ends the recording and sends secondaries
EOS once they pass the final recording stop.

Timeline handling: when `is-live=false` (default) the recorded spans are
made contiguous — the reference shifts the out-segment's running-time
basis by `running_time_offset` (imp.rs:1418); in this framework buffer PTS
is the timeline downstream elements consume, so the same offset lands on
the output PTS (with a fresh SEGMENT + DISCONT at each restart, matching
segment_pending/discont_pending).  `is-live=true` keeps timestamps
untouched for live downstreams.

Upstream liveness comes from a LATENCY query on the main sink pad
(imp.rs:1336-1347).  Divergence: an *unanswered* query counts as live
(drop semantics) rather than non-live (block semantics) so synchronous
harness pushes cannot deadlock; an explicit live=false answer gets the
reference's blocking behavior (buffers wait for record=true, nothing is
lost, and with a clock the blocked wall time shifts live-mode output).

Raw audio (audio/x-raw with a rate) is clipped sample-exactly at span
boundaries (imp.rs:287-335 only clips raw caps); everything else passes
or drops whole buffers on keyframe boundaries.  A clip is a slice of the
payload where it lies (a view of a tensor on the device, or of a host
array); every other buffer that passes is the incoming object, or a new
Buffer around the same payload when its timestamps move.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    Query,
    State,
    register,
)
from ...core.buffer import BufferFlags
from ...core.element import FlowError
from ...core.events import Segment

STOPPED, STARTING, RECORDING, STOPPING = "stopped", "starting", "recording", "stopping"


def _lt(a: Optional[int], b: Optional[int]) -> bool:
    return a is not None and b is not None and a < b


def _le(a: Optional[int], b: Optional[int]) -> bool:
    return a is not None and b is not None and a <= b


def _ge(a: Optional[int], b: Optional[int]) -> bool:
    return a is not None and b is not None and a >= b


class _Stream:
    """Per-stream pads + timeline state (imp.rs Stream/StreamState)."""

    def __init__(self, sinkpad: Pad, srcpad: Pad):
        self.sinkpad = sinkpad
        self.srcpad = srcpad
        self.segment = Segment()
        self.current_rt: Optional[int] = None
        self.current_rt_end: Optional[int] = None
        self.eos = False
        self.flushing = False
        self.segment_pending = False
        self.discont_pending = False
        self.pending_events: List[Event] = []
        self.audio_rate: Optional[int] = None
        self.upstream_live: Optional[bool] = None

    def reset_timeline(self) -> None:
        self.segment = Segment()
        self.current_rt = None
        self.current_rt_end = None
        self.eos = False
        self.segment_pending = False
        self.discont_pending = False
        self.pending_events = []

    # running time <-> pts on FORMAT_TIME segments
    def to_rt(self, pts: Optional[int]) -> Optional[int]:
        return self.segment.to_running_time(pts)

    def from_rt(self, rt: Optional[int]) -> Optional[int]:
        if rt is None:
            return None
        seg = self.segment
        return int((rt - seg.base) * seg.rate) + seg.start


@register
class ToggleRecord(Element):
    ELEMENT_NAME = "togglerecord"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = (
        "Valve that records on toggle, keeping all streams aligned")
    PROPERTIES = [
        Prop("record", False, type="bool", mutable="playing",
             doc="start/stop recording (stops at the next main-stream "
                 "keyframe)"),
        Prop("recording", False, type="bool",
             doc="(read) whether recording is currently taking place"),
        Prop("is-live", False, type="bool", mutable="ready",
             doc="live output mode: timestamps pass unmodified instead of "
                 "being collapsed into a contiguous recording"),
    ]
    EXTRA_PAD_TEMPLATES = [
        ("sink_%u", "sink", "request", "ANY"),
        ("src_%u", "src", "sometimes", "ANY"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._cond = threading.Condition()
        self._rec_state = STOPPED
        self._last_start: Optional[int] = None  # running time
        self._last_stop: Optional[int] = None
        self._recording_duration = 0
        self._blocked_duration = 0
        self._time_start_block: Optional[int] = None
        self._offset = 0  # signed ns applied to output pts
        self._pad_counter = 0

        sink = Pad("sink", PadDirection.SINK,
                   PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                               Caps.new_any()))
        src = Pad("src", PadDirection.SRC,
                  PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                              Caps.new_any()))
        self.add_pad(sink)
        self.add_pad(src)
        self._main = _Stream(sink, src)
        self._others: List[_Stream] = []
        self._by_pad = {sink.name: self._main}
        self._install(self._main)

    # -- pads ---------------------------------------------------------------
    def _install(self, stream: _Stream) -> None:
        stream.sinkpad.chain_function = self._sink_chain
        stream.sinkpad.event_function = self._sink_event
        stream.sinkpad.query_function = self._sink_query

    def request_pad(self, template_name: str = "sink_%u") -> Pad:
        return self.request_sink_pad()

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        n = self._pad_counter
        self._pad_counter += 1
        sink = Pad(name or f"sink_{n}", PadDirection.SINK,
                   PadTemplate("sink_%u", PadDirection.SINK,
                               PadPresence.REQUEST, Caps.new_any()))
        src = Pad(f"src_{n}", PadDirection.SRC,
                  PadTemplate("src_%u", PadDirection.SRC,
                              PadPresence.SOMETIMES, Caps.new_any()))
        self.add_pad(sink)
        self.add_pad(src)
        stream = _Stream(sink, src)
        self._install(stream)
        with self._cond:
            self._others.append(stream)
            self._by_pad[sink.name] = stream
        return sink

    # -- properties -----------------------------------------------------------
    def get_property(self, name: str):
        if name == "recording":
            return self._rec_state == RECORDING
        return super().get_property(name)

    def set_property(self, name: str, value) -> None:
        super().set_property(name, value)
        if name == "record":
            with self._cond:
                self._cond.notify_all()

    # -- state ----------------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        with self._cond:
            self._rec_state = STOPPED
            self._last_start = self._last_stop = None
            self._recording_duration = 0
            self._blocked_duration = 0
            self._time_start_block = None
            self._offset = 0
            for s in [self._main] + self._others:
                s.reset_timeline()
                s.flushing = False

    def on_paused_to_ready(self) -> None:
        with self._cond:
            for s in [self._main] + self._others:
                s.flushing = True
            self._cond.notify_all()

    # -- upstream liveness (imp.rs:1336-1347) ---------------------------------
    def _upstream_live(self, stream: _Stream) -> bool:
        if stream.upstream_live is None:
            q = Query.new_latency()
            if stream.sinkpad.peer is not None and stream.sinkpad.peer_query(q):
                stream.upstream_live = bool(q.result.get("live", False))
            else:
                # divergence from the reference (assumes non-live/blocking
                # here): unanswered queries count as live so synchronous
                # harnesses can't deadlock; retried on the next buffer
                return True
        return stream.upstream_live

    # -- clipping (raw audio only, imp.rs:287-335) -----------------------------
    @staticmethod
    def _can_clip(stream: _Stream, buf: Buffer) -> bool:
        return (stream.audio_rate is not None
                and isinstance(buf.data, (np.ndarray, torch.Tensor)) and buf.data.ndim >= 1)

    def _clip(self, stream: _Stream, buf: Buffer,
              start_rt: Optional[int], stop_rt: Optional[int]) -> Optional[Buffer]:
        """Trim a raw-audio buffer to [start_rt, stop_rt) running time."""
        rate = stream.audio_rate
        assert rate is not None
        pts = buf.pts or 0
        frames = int(buf.data.shape[0])
        dur = buf.duration if buf.duration is not None else int(frames * 1e9 / rate)
        lo = stream.from_rt(start_rt)
        hi = stream.from_rt(stop_rt)
        cut0 = 0 if lo is None else max(0, min(frames, round((lo - pts) * rate / 1e9)))
        cut1 = frames if hi is None else max(0, min(frames, round((hi - pts) * rate / 1e9)))
        if cut1 <= cut0:
            return None
        out = Buffer(buf.data[cut0:cut1],
                     pts=pts + int(cut0 * 1e9 / rate),
                     duration=int((cut1 - cut0) * 1e9 / rate),
                     flags=buf.flags)
        out.metas = list(buf.metas)
        return out

    # -- events -----------------------------------------------------------------
    def _sink_event(self, pad: Pad, event: Event) -> bool:
        stream = self._by_pad[pad.name]
        et = event.type
        if et == EventType.SEGMENT:
            with self._cond:
                stream.segment = event.get("segment") or Segment()
                stream.segment_pending = True
            return True  # forwarded (rewritten) before the next passed buffer
        if et == EventType.CAPS:
            caps = event.get("caps")
            with self._cond:
                stream.audio_rate = None
                if caps is not None and len(caps.structures) == 1:
                    s = caps.structures[0]
                    if s.name == "audio/x-raw" and s.fields.get("rate"):
                        stream.audio_rate = int(s.fields["rate"])
            return stream.srcpad.push_event(event)
        if et == EventType.FLUSH_START:
            with self._cond:
                stream.flushing = True
                self._cond.notify_all()
            return stream.srcpad.push_event(event)
        if et == EventType.FLUSH_STOP:
            with self._cond:
                stream.reset_timeline()
                stream.flushing = False
            return stream.srcpad.push_event(event)
        if et == EventType.EOS:
            with self._cond:
                stream.eos = True
                if stream is self._main:
                    # main EOS freezes the final span: secondaries drain
                    # up to last_stop then go EOS (imp.rs:116)
                    if self._rec_state == RECORDING and self._last_stop is None:
                        self._last_stop = stream.current_rt_end
                    if all(s.eos for s in self._others):
                        # every stream has ended: recording stops
                        # (check_and_update_eos, imp.rs:1230-1266;
                        # togglerecord tests test_*_secondary_eos_first)
                        self._rec_state = STOPPED
                self._cond.notify_all()
            return stream.srcpad.push_event(event)
        if et == EventType.STREAM_START:
            with self._cond:
                stream.eos = False
            return stream.srcpad.push_event(event)
        if et == EventType.GAP:
            # gaps ride the record machine like keyframe buffers: they
            # advance positions, are dropped while stopped, and come out
            # re-timestamped onto the recording timeline (imp.rs gap
            # handling; togglerecord tests test_one_stream_gaps_open /
            # test_two_stream_open_close_open_gaps)
            g = Buffer(None, pts=event.get("pts"),
                       duration=event.get("duration"), flags=BufferFlags.GAP)
            upstream_live = self._upstream_live(stream)
            handler = (self._handle_main if stream is self._main
                       else self._handle_secondary)
            kind, payload = handler(stream, g, upstream_live)
            if kind == "eos":
                stream.srcpad.push_event(Event.new_eos())
                return True
            if kind == "pass":
                self._push_out(stream, payload, upstream_live)
            return True
        # other serialized events wait for a pending segment (imp.rs:1664-1676)
        with self._cond:
            if stream.segment_pending:
                stream.pending_events.append(event)
                return True
        return stream.srcpad.push_event(event)

    def _sink_query(self, pad: Pad, query: Query) -> bool:
        return self._default_query(pad, query)

    # -- output -------------------------------------------------------------------
    def _push_out(self, stream: _Stream, buf: Buffer,
                  upstream_live: bool) -> FlowReturn:
        with self._cond:
            # the offset collapses the timeline only across the live
            # boundary (imp.rs:1415: applied iff rec_state.live !=
            # upstream_live): live->recorded collapses gaps, non-live
            # blocked->live shifts by the blocked wall time
            offset = self._offset
            if bool(super().get_property("is-live")) == bool(upstream_live):
                offset = 0
            segment_pending = stream.segment_pending
            discont = stream.discont_pending
            pending = stream.pending_events
            stream.segment_pending = False
            stream.discont_pending = False
            stream.pending_events = []
        out = buf
        if offset:
            out = Buffer(buf.data, pts=(None if buf.pts is None else buf.pts + offset),
                         dts=(None if buf.dts is None else buf.dts + offset),
                         duration=buf.duration, offset=buf.offset,
                         offset_end=buf.offset_end, flags=buf.flags)
            out.metas = list(buf.metas)
        if segment_pending:
            stream.srcpad.push_event(Event.new_segment(stream.segment.copy()))
        if discont:
            if out is buf:
                out = Buffer(buf.data, pts=buf.pts, dts=buf.dts,
                             duration=buf.duration, offset=buf.offset,
                             offset_end=buf.offset_end, flags=buf.flags)
                out.metas = list(buf.metas)
            out.set_flag(BufferFlags.DISCONT)
        for ev in pending:
            stream.srcpad.push_event(ev)
        if out.data is None and out.has_flag(BufferFlags.GAP):
            # re-timestamped gap events stay events downstream
            stream.srcpad.push_event(Event.new_gap(out.pts, out.duration))
            return FlowReturn.OK
        return stream.srcpad.push(out)

    # -- chain --------------------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        stream = self._by_pad[pad.name]
        upstream_live = self._upstream_live(stream)
        if stream is self._main:
            result = self._handle_main(stream, buf, upstream_live)
        else:
            result = self._handle_secondary(stream, buf, upstream_live)
        kind, payload = result
        if kind == "drop":
            return FlowReturn.OK
        if kind == "eos":
            stream.srcpad.push_event(Event.new_eos())
            return FlowReturn.EOS
        return self._push_out(stream, payload, upstream_live)

    def _wait(self, stream: _Stream) -> None:
        """One bounded condvar wait; flushing is re-checked by callers."""
        self._cond.wait(timeout=0.1)
        if self.state < State.PAUSED:
            stream.flushing = True

    def _force_key_unit(self, stream: _Stream) -> None:
        stream.sinkpad.push_event(Event(
            EventType.CUSTOM_UPSTREAM, name="GstForceKeyUnit", **{"all-headers": True}))

    # -- main stream (imp.rs:431-721) -----------------------------------------------
    def _handle_main(self, stream: _Stream, buf: Buffer,
                     upstream_live: bool) -> Tuple[str, Optional[Buffer]]:
        if buf.pts is None and buf.dts is None:
            raise FlowError(FlowReturn.ERROR, "buffer without DTS or PTS")
        with self._cond:
            t = buf.dts if buf.dts is not None else buf.pts
            dur = buf.duration or 0
            rt = stream.to_rt(max(t, stream.segment.start))
            rt_end = stream.to_rt(max(t + dur, stream.segment.start))
            stream.current_rt = max(filter(lambda x: x is not None,
                                           [stream.current_rt, rt]), default=rt)
            stream.current_rt_end = max(filter(lambda x: x is not None,
                                               [stream.current_rt_end, rt_end]),
                                        default=rt_end)
            self._cond.notify_all()

            record = super().get_property("record")
            settings_changed = False
            if self._rec_state == RECORDING and not record:
                self._rec_state = STOPPING
                if self.clock is not None:
                    self._time_start_block = self.clock.now()
                settings_changed = True
            elif self._rec_state == STOPPED and record:
                self._rec_state = STARTING
                settings_changed = True

            keyframe = not buf.has_flag(BufferFlags.DELTA_UNIT)

            if self._rec_state == RECORDING:
                self._last_stop = rt_end
                return ("pass", buf)

            if self._rec_state == STOPPING:
                if not keyframe:
                    self._last_stop = rt_end
                    if settings_changed:
                        self._force_key_unit(stream)
                    return ("pass", buf)
                # stop right before this keyframe
                self._last_stop = rt
                span = 0
                if self._last_start is not None and rt is not None:
                    span = max(0, rt - self._last_start)
                while (not stream.flushing
                       and not all(s.eos or _ge(s.current_rt, rt)
                                   for s in self._others)):
                    self._wait(stream)
                if stream.flushing:
                    raise FlowError(FlowReturn.FLUSHING)
                self._rec_state = STOPPED
                self._recording_duration += span
                self._last_start = self._last_stop = None
                if self._block_if_not_live(stream, upstream_live):
                    return ("pass", buf)
                return ("drop", None)

            if self._rec_state == STOPPED:
                if not upstream_live:
                    self._rec_state = STARTING
                if self._block_if_not_live(stream, upstream_live):
                    return ("pass", buf)
                return ("drop", None)

            # STARTING
            if not keyframe:
                if settings_changed:
                    self._force_key_unit(stream)
                if not upstream_live:
                    return ("pass", buf)  # non-live upstream never drops
                return ("drop", None)
            self._last_start = rt
            if not super().get_property("is-live") or upstream_live:
                self._offset = -(max(0, (rt or 0) - self._recording_duration))
            stream.segment_pending = True
            stream.discont_pending = True
            for s in self._others:
                s.segment_pending = True
                s.discont_pending = True
            while (not stream.flushing
                   and not all(s.eos or _ge(s.current_rt, rt)
                               for s in self._others)):
                self._wait(stream)
            if stream.flushing:
                raise FlowError(FlowReturn.FLUSHING)
            self._rec_state = RECORDING
            self._last_stop = rt_end
            return ("pass", buf)

    def _block_if_not_live(self, stream: _Stream, upstream_live: bool) -> bool:
        """Stopped handling: drop for live upstream, block until record=true
        for non-live (imp.rs:370-428).  Returns True to pass the buffer.
        Caller holds self._cond."""
        if upstream_live:
            return False
        if self._time_start_block is None and self.clock is not None:
            self._time_start_block = self.clock.now()
        while not super().get_property("record") and not stream.flushing:
            self._wait(stream)
        if stream.flushing:
            raise FlowError(FlowReturn.FLUSHING)
        stream.segment_pending = True
        stream.discont_pending = True
        for s in self._others:
            s.segment_pending = True
            s.discont_pending = True
        if self._time_start_block is not None and self.clock is not None:
            self._blocked_duration += self.clock.now() - self._time_start_block
            if super().get_property("is-live"):
                self._offset = self._blocked_duration
            self._time_start_block = None
        return True

    # -- secondary streams (imp.rs:725-1224) ------------------------------------------
    def _handle_secondary(self, stream: _Stream, buf: Buffer,
                          upstream_live: bool) -> Tuple[str, Optional[Buffer]]:
        if buf.pts is None:
            raise FlowError(FlowReturn.ERROR, "buffer without PTS")
        if buf.dts is not None and buf.dts != buf.pts:
            raise FlowError(FlowReturn.ERROR,
                            "DTS != PTS not supported for secondary streams")
        if buf.has_flag(BufferFlags.DELTA_UNIT):
            raise FlowError(FlowReturn.ERROR,
                            "delta-units not supported for secondary streams")
        with self._cond:
            pts = max(buf.pts, stream.segment.start)
            dur = buf.duration or 0
            rt = stream.to_rt(pts)
            rt_end = stream.to_rt(pts + dur)
            stream.current_rt = max(filter(lambda x: x is not None,
                                           [stream.current_rt, rt]), default=rt)
            stream.current_rt_end = max(filter(lambda x: x is not None,
                                               [stream.current_rt_end, rt_end]),
                                        default=rt_end)
            self._cond.notify_all()
            main = self._main

            # wait until the main stream has decided up to our position
            # (imp.rs:1028-1060 predicate, verbatim logic)
            while ((main.current_rt is None
                    or (self._rec_state not in (STARTING, STOPPING)
                        and _lt(main.current_rt_end, rt_end))
                    or (self._rec_state == STARTING
                        and (self._last_start is None
                             or _le(self._last_start, rt)))
                    or (self._rec_state == STOPPING
                        and (self._last_stop is None
                             or _le(self._last_stop, rt))))
                   and not main.eos and not stream.flushing):
                self._wait(stream)
            if stream.flushing:
                raise FlowError(FlowReturn.FLUSHING)

            if main.eos:
                return self._secondary_after_main_eos(stream, buf, rt, rt_end)

            if not upstream_live:
                return ("pass", buf)

            if self._rec_state == RECORDING:
                return ("pass", buf)
            if self._rec_state == STOPPING:
                if self._last_stop is None:  # main still waiting for keyframe
                    return ("pass", buf)
                if _le(rt_end, self._last_stop):
                    return ("pass", buf)
                if self._can_clip(stream, buf) and _lt(rt, self._last_stop) \
                        and _lt(self._last_stop, rt_end):
                    clipped = self._clip(stream, buf, None, self._last_stop)
                    return ("pass", clipped) if clipped is not None else ("drop", None)
                return ("drop", None)
            if self._rec_state == STOPPED:
                return ("drop", None)
            # STARTING
            if self._last_start is None:  # main still waiting for keyframe
                return ("drop", None)
            if _ge(rt, self._last_start):
                return ("pass", buf)
            if self._can_clip(stream, buf) and _lt(rt, self._last_start) \
                    and _lt(self._last_start, rt_end):
                clipped = self._clip(stream, buf, self._last_start, None)
                return ("pass", clipped) if clipped is not None else ("drop", None)
            return ("drop", None)

    def _secondary_after_main_eos(self, stream: _Stream, buf: Buffer,
                                  rt: Optional[int], rt_end: Optional[int]
                                  ) -> Tuple[str, Optional[Buffer]]:
        """Main is EOS: drain this stream up to the final recording stop,
        then EOS (imp.rs:860-1037).  Caller holds self._cond."""
        if self._last_start is None or self._last_stop is None:
            self._mark_eos(stream)
            return ("eos", None)
        start, stop = self._last_start, self._last_stop
        if self._can_clip(stream, buf) and _lt(rt, start) and _lt(start, rt_end):
            clipped = self._clip(stream, buf, start, stop)
            return ("pass", clipped) if clipped is not None else ("drop", None)
        if _lt(rt, start):
            return ("drop", None)
        if self._can_clip(stream, buf) and _lt(rt, stop) and _lt(stop, rt_end):
            clipped = self._clip(stream, buf, start, stop)
            if clipped is not None:
                return ("pass", clipped)
            self._mark_eos(stream)
            return ("eos", None)
        if _lt(stop, rt_end):
            self._mark_eos(stream)
            return ("eos", None)
        return ("pass", buf)

    def _mark_eos(self, stream: _Stream) -> None:
        """check_and_update_eos (imp.rs:1230-1266)."""
        stream.eos = True
        if self._rec_state != STOPPED and all(s.eos for s in self._others):
            self._rec_state = STOPPED


__all__ = ["ToggleRecord"]
