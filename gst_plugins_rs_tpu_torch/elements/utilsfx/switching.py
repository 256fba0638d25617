"""Failure-detection / recovery elements: fallbackswitch, livesync,
togglerecord.

Parity targets (SURVEY.md §5): utils/fallbackswitch (priority-based input
selector with per-pad priority + is-healthy, auto-switch and a clock-armed
`timeout` that switches to the next healthy lower-priority input when the
active one stalls, fallbackswitch/imp.rs:20-29,57-68,88-126), utils/livesync
(repeats the last buffer on missed deadlines, livesync/imp.rs:9-40) and
utils/togglerecord (multi-stream synchronized record valve — see togglerecord.py).

Clocked pipelines (core/clock.py) get the reference's real time-based
behavior: fallbackswitch arms a single-shot clock id per deadline and
switches on expiry with no data; livesync re-pushes the last buffer each
period while upstream stalls.  Clockless pipelines/harnesses keep the
event-driven path (GAP events and EOS), which the reference's tests also
exercise via DISCONT/gap injection.

Payloads: fallbackswitch passes the active input's buffer objects on.
livesync passes its input's payload on and works on it where it lies: it
reads the sample count from the payload's shape, clips a tensor to a view,
and makes its silence and resized repeats with zeros of the payload's
dtype on the payload's device.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ...core import (
    Buffer,
    BufferFlags,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Message,
    MessageType,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    Query,
    QueryType,
    SECOND,
    Segment,
    SegmentFlags,
    Structure,
    register,
)
from ...core.aggregator import Aggregator, AggregatorPad
from ...core.payload import zeros_like_payload


class FallbackSinkPad(AggregatorPad):
    """Per-pad surface parity: GstFallbackSwitchSinkPad priority/is-healthy
    (reference utils/fallbackswitch/src/fallbackswitch/imp.rs:57-68)."""

    def __init__(self, name: str, template: PadTemplate, priority: int):
        super().__init__(name, template)
        self.priority = priority
        self.is_healthy = True
        self.timed_out = False  # set when the clock timeout expires with no data


@register
class FallbackSwitch(Aggregator):
    ELEMENT_NAME = "fallbackswitch"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Forwards the highest-priority healthy input"
    PROPERTIES = [
        Prop("timeout", SECOND, type="uint64", mutable="playing",
             doc="Switch to the next healthy input after this long without "
                 "data on the active one (clock-armed; 0 disables)"),
        Prop("immediate-fallback", False, type="bool", mutable="playing"),
        Prop("auto-switch", True, type="bool", mutable="playing"),
        Prop("active-pad", None, type="object", mutable="playing",
             doc="(read; settable when auto-switch=false) the pad whose "
                 "buffers flow — a pad object or its name"),
        Prop("latency", 0, type="uint64", mutable="playing",
             doc="extra latency to report downstream"),
        Prop("min-upstream-latency", 0, type="uint64", mutable="playing",
             doc="floor for the upstream latency used in the timeout "
                 "bookkeeping"),
        Prop("stop-on-eos", False, type="bool", mutable="playing",
             doc="stop for good as soon as ANY input is EOS; when false "
                 "(default) the active pad's EOS forwards downstream but a "
                 "healthy lower-priority input can still take over once "
                 "the timeout retires the ended input"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._active: Optional[FallbackSinkPad] = None
        self._sent_caps_for: Optional[FallbackSinkPad] = None
        self._flow_lock = threading.RLock()
        self._timeout_id = None
        self._eos_sent = False

    def get_property(self, name: str):
        if name == "active-pad":
            return self._active
        return super().get_property(name)

    def set_property(self, name: str, value) -> None:
        if name == "active-pad":
            if self.get_property("auto-switch"):
                raise RuntimeError(
                    f"{self.ELEMENT_NAME}: active-pad is only settable "
                    "with auto-switch=false")
            pad = value if not isinstance(value, str) else self.pads.get(value)
            with self._flow_lock:
                self._active = pad
            return
        super().set_property(name, value)

    def latency_additional_ns(self) -> int:
        return self.get_property("latency")

    # -- clock-armed health timeout (fallbackswitch/imp.rs:88-126) ---------
    def on_paused_to_playing(self) -> None:
        self._arm_timeout()

    def on_playing_to_paused(self) -> None:
        self._cancel_timeout()

    def _cancel_timeout(self) -> None:
        with self._flow_lock:
            if self._timeout_id is not None:
                self._timeout_id.unschedule()
                self._timeout_id = None

    def _arm_timeout(self) -> None:
        timeout = self.get_property("timeout")
        if self.clock is None or not timeout:
            return
        with self._flow_lock:
            if self._timeout_id is not None:
                self._timeout_id.unschedule()
            cid = self.clock.new_single_shot_id(self.clock.now() + timeout)
            self._timeout_id = cid
            cid.wait_async(self._on_timeout)

    def _on_timeout(self, cid) -> None:
        with self._flow_lock:
            if cid is not self._timeout_id or cid._unscheduled:
                return
            self._timeout_id = None
            # the active input missed its deadline -> failed until it
            # produces data again
            pad = self._active if self._active is not None else self._pick_active()
            if pad is not None:
                pad.timed_out = True
            self._try_aggregate()
        self._arm_timeout()

    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._flow_lock:
            pad.timed_out = False  # data flowing again -> healthy
            ret = super()._sink_chain(pad, buf)
            if pad is self._active:
                self._arm_timeout()  # deadline = last active buffer + timeout
            return ret

    PAD_PROPERTIES = {
        "sink": [
            Prop("priority", 0, type="uint", mutable="playing",
                 doc="pad priority; lower wins (0 = highest). New request "
                     "pads default to their request order."),
            Prop("is-healthy", True, type="bool", mutable="playing",
                 doc="whether this input is currently usable; unhealthy "
                     "pads are skipped when picking the active input"),
        ],
    }

    def request_sink_pad(self, name: Optional[str] = None) -> FallbackSinkPad:
        idx = self._pad_counter
        if name is None:
            name = f"sink_{idx}"
        self._pad_counter += 1
        pad = FallbackSinkPad(name, self._sink_template, priority=idx)
        pad.chain_function = self._sink_chain
        pad.event_function = self._sink_event
        pad.query_function = self._sink_query
        self.add_pad(pad)
        pad._props["priority"] = idx  # default = request order
        return pad

    def pad_property_changed(self, pad, name: str, value) -> None:
        if name == "priority":
            pad.priority = value
        elif name == "is-healthy":
            self.set_pad_healthy(pad, value)

    def set_pad_priority(self, pad: FallbackSinkPad, priority: int) -> None:
        pad.priority = priority
        pad._props["priority"] = priority

    def set_pad_healthy(self, pad: FallbackSinkPad, healthy: bool) -> None:
        pad.is_healthy = healthy
        pad._props["is-healthy"] = healthy
        self._try_aggregate()

    def _pick_active(self) -> Optional[FallbackSinkPad]:
        candidates = [
            p for p in self.agg_pads()
            if p.is_healthy and not p.timed_out
            # an EOS'd input cannot TAKE OVER, but the current active stays
            # active through its own EOS until the timeout machinery
            # declares it stalled (the reference switches on timeout, not
            # on EOS: fallbackswitch/imp.rs handle_buffer cases 1-4)
            and (not p.is_inactive() or p is self._active)
        ]
        if not candidates:
            return None
        if self.get_property("immediate-fallback") and self._active is None:
            # don't wait a full timeout at startup: the best input that
            # already has data wins until a higher-priority one produces
            with_data = [p for p in candidates if p.has_buffer()]
            if with_data:
                candidates = with_data
        return min(candidates, key=lambda p: p.priority)  # type: ignore[attr-defined]

    def aggregate(self, timeout: bool) -> FlowReturn:
        if self.get_property("auto-switch") or self._active is None:
            new_active = self._pick_active()
        else:
            new_active = self._active if not self._active.is_inactive() else self._pick_active()
        if new_active is not self._active:
            self._active = new_active
            if new_active is not None:
                # only the newest frame held while inactive is output on a
                # switch; older ones were consumed un-output at each cycle
                # (fallbackswitch.rs test_long_drop_and_eos)
                while len(new_active.queue) > 1:
                    new_active.queue.popleft()
                if self._eos_sent:
                    # taking over after the previous active EOS'd: restart
                    # the downstream stream (the reference re-pushes the new
                    # pad's sticky events on a switch, imp.rs:1126-1144)
                    self._eos_sent = False
                    self.srcpad.push_event(
                        Event.new_stream_start(new_active.name))
                    from ...core import Segment as _Segment

                    self.srcpad.push_event(Event.new_segment(_Segment()))
                    self._sent_caps_for = None
            self.post_message(
                Message(
                    MessageType.ELEMENT,
                    structure=Structure(
                        "fallbackswitch-active-pad-changed",
                        pad=None if new_active is None else new_active.name,
                    ),
                )
            )
        ret = FlowReturn.OK
        for pad in self.agg_pads():
            if pad is self._active:
                if self._sent_caps_for is not pad and pad.current_caps is not None:
                    self.srcpad.current_caps = pad.current_caps
                    self.srcpad.push_event(Event.new_caps(pad.current_caps))
                    self._sent_caps_for = pad
                while pad.queue:
                    ret = self.finish_buffer(pad.pop_buffer())
            else:
                # inactive inputs keep their NEWEST frame so a switch can
                # output it immediately (the reference aggregator holds one
                # pending buffer per pad; fallbackswitch.rs
                # test_long_drop_and_eos outputs the fallback frame queued
                # just before the timeout fired)
                while len(pad.queue) > 1:
                    pad.queue.popleft()
        return ret

    def _try_aggregate(self) -> FlowReturn:
        # forward as soon as the active pad has data; drop others eagerly
        ret = FlowReturn.OK
        pads = self.agg_pads()
        if not pads:
            return ret
        # events (incl. EOS) forward from the ACTIVE pad only: its EOS is
        # pushed downstream (imp.rs:1110-1147; the reference tests never
        # require EOS on the fallback), but the element keeps running — a
        # healthy lower-priority input can still take over when the
        # timeout machinery retires the EOS'd active pad.  stop-on-eos
        # strengthens to ANY pad's EOS ending the stream for good
        # (imp.rs:660-663).
        any_eos = any(p.is_inactive() for p in pads)
        if (self._active is not None and self._active.is_inactive()) or (
                self.get_property("stop-on-eos") and any_eos):
            if not self._eos_sent:
                self._eos_sent = True
                self.srcpad.push_event(Event.new_eos())
            if self.get_property("stop-on-eos") or all(
                    p.is_inactive() for p in pads):
                return ret  # no input can take over: the stream is done
        active = self._pick_active() if self.get_property("auto-switch") or self._active is None else self._active
        if active is None:
            if all(p.is_inactive() for p in pads):
                if not self._eos_sent:
                    self._eos_sent = True
                    self.srcpad.push_event(Event.new_eos())
            return ret
        if active.has_buffer() or active is not self._active:
            ret = self.aggregate(timeout=False)
        return ret


# livesync lateness classification (utils/livesync/src/livesync/imp.rs:108-112)
_ON_TIME = 0
_LATE_UNDER = 1  # regressed, within late-threshold of the last input: drop
_LATE_OVER = 2  # regressed by more than late-threshold: stream restart, accept

_LS_MIN_DURATION = 8_000_000  # imp.rs:244-246 MINIMUM/DEFAULT/MAXIMUM_DURATION
_LS_DEFAULT_DURATION = 100_000_000
_LS_MAX_DURATION = 10 * SECOND
_U64_MAX = (1 << 64) - 1


@register
class LiveSync(Element):
    """Produce a continuous live stream: one buffer per slot on the output
    timeline, repeating the previous buffer (GAP-flagged, audio as silence)
    whenever upstream misses its deadline, dropping input that regressed
    behind the repeated timeline, and accepting input more than
    `late-threshold` behind the last input as a stream restart.

    Rebuild of utils/livesync/src/livesync/imp.rs (1 930 lines).  The
    reference runs a dedicated src task blocking on single-shot clock ids;
    here the same slot machine is push- and clock-callback-driven: each
    emitted slot arms a wait at the slot's end running time (buffer running
    times include `latency` + upstream latency, imp.rs:586-631), and the
    wait's expiry emits the next slot — a queued on-time buffer if one is
    due, otherwise the repeat.  `sync=false` additionally lets an arriving
    buffer cancel the pending gap wait (imp.rs:1279-1285); unlike the
    reference it is the default here so clockless pipelines free-run.
    """

    ELEMENT_NAME = "livesync"
    ELEMENT_CLASS = "Filter/Generic"
    ELEMENT_DESCRIPTION = "Fills stream gaps by repeating the last buffer"
    PROPERTIES = [
        Prop("latency", 0, type="uint64", mutable="ready",
             doc="additional time upstream may take to produce a buffer "
                 "before the slot is repeated; also bounds the queue"),
        Prop("single-segment", False, type="bool", mutable="ready",
             doc="output a single running-time segment; input buffers are "
                 "clipped to their segment and re-timestamped (imp.rs:1179-1235)"),
        Prop("late-threshold", 2 * SECOND, type="uint64", mutable="playing",
             doc="input that regressed behind the output timeline is dropped "
                 "unless it is this much past the LAST input (then it is a "
                 "stream restart and accepted; imp.rs:1693-1707). "
                 f"{_U64_MAX} = never accept, 0 = always accept"),
        Prop("sync", False, type="bool", mutable="playing",
             doc="strictly pace output on the clock; false lets a new buffer "
                 "cancel the pending gap wait (reference defaults true; false "
                 "here so non-live pipelines free-run)"),
        Prop("silent", True, type="bool", mutable="playing",
             doc="suppress in/out/drop/duplicate notify signals"),
        Prop("in", 0, type="uint64", doc="(read) buffers received"),
        Prop("out", 0, type="uint64", doc="(read) buffers sent"),
        Prop("drop", 0, type="uint64", doc="(read) late buffers dropped"),
        Prop("duplicate", 0, type="uint64",
             doc="(read) repeats emitted on missed deadlines"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(Pad(
            "sink", PadDirection.SINK,
            PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                        Caps.new_any())))
        self.srcpad = self.add_pad(Pad(
            "src", PadDirection.SRC,
            PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                        Caps.new_any())))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._sink_event
        self.srcpad.query_function = self._src_query
        self._lock = threading.RLock()
        self._reset()

    def _reset(self) -> None:
        self._queue: deque = deque()  # ("buffer", buf, rt, lateness)|("event", e)
        self._out_buffer: Optional[Buffer] = None
        self._out_dup = False
        self._out_last: Optional[tuple] = None  # (start_rt, end_rt)
        self._in_last: Optional[tuple] = None
        self._in_segment: Optional[tuple] = None  # (Segment, seqnum)
        self._pending_segment: Optional[tuple] = None
        self._out_segment: Optional[tuple] = None  # ([Segment], seqnum) mutable
        self._pending_caps: Optional[Caps] = None
        self._in_audio_rate: Optional[int] = None
        self._out_audio_rate: Optional[int] = None
        self._in_duration: Optional[int] = None
        self._out_duration: Optional[int] = None
        self._upstream_latency: Optional[int] = None
        self._eos = False
        self._eos_sent = False
        self._clock_id = None
        self._n_in = self._n_out = self._n_drop = self._n_dup = 0

    def get_property(self, name: str):
        if name == "in":
            return self._n_in
        if name == "out":
            return self._n_out
        if name == "drop":
            return self._n_drop
        if name == "duplicate":
            return self._n_dup
        return super().get_property(name)

    def on_ready_to_paused(self) -> None:
        self._reset()

    def on_playing_to_paused(self) -> None:
        with self._lock:
            self._unschedule()

    def on_paused_to_playing(self) -> None:
        with self._lock:
            self._continue()

    # -- helpers -------------------------------------------------------------
    def _unschedule(self) -> None:
        if self._clock_id is not None:
            self._clock_id.unschedule()
            self._clock_id = None

    @staticmethod
    def _caps_audio_rate(caps: Optional[Caps]) -> Optional[int]:
        if caps is None or caps.is_any() or not caps.structures:
            return None
        s = caps.structures[0]
        if s.name.startswith("audio/x-raw"):
            return s.get("rate")
        return None

    @staticmethod
    def _caps_duration(caps: Optional[Caps]) -> Optional[int]:
        """Nominal buffer duration from caps framerate (imp.rs:97-105)."""
        if caps is None or caps.is_any() or not caps.structures:
            return None
        fr = caps.structures[0].get("framerate")
        if fr is None:
            return None
        if isinstance(fr, str):
            num, _, den = fr.partition("/")
            num, den = int(num), int(den or 1)
        elif isinstance(fr, tuple):
            num, den = fr
        else:
            num, den = int(fr), 1
        if num <= 0:
            return None
        return SECOND * den // num

    def _rt_range(self, pts: Optional[int], duration: int,
                  segment: Segment) -> Optional[tuple]:
        """Running time covered by a buffer, latency included
        (imp.rs:586-631)."""
        if pts is None:
            return None
        lat = self.get_property("latency") + (self._upstream_latency or 0)
        if self.get_property("single-segment"):
            # buffer pts already re-timestamped to running time + latency
            start = pts + (self._upstream_latency or 0)
            return (start, start + duration)
        a, b = (pts, pts + duration) if segment.rate > 0 else (pts + duration, pts)
        def rt(t):
            r = segment.base + int((t - segment.start) / abs(segment.rate)) + lat
            return max(r, 0)
        return (rt(a), rt(b))

    def _classify(self, rt: Optional[tuple]) -> int:
        """BufferLateness (imp.rs:1667-1708)."""
        if rt is None or self._out_last is None:
            return _ON_TIME
        if rt[1] > self._out_last[1]:
            return _ON_TIME
        thr = self.get_property("late-threshold")
        if thr == 0:
            return _LATE_OVER
        if thr == _U64_MAX or self._in_last is None:
            return _LATE_UNDER
        return _LATE_OVER if rt[0] > self._in_last[1] + thr else _LATE_UNDER

    def _is_early(self, rt: Optional[tuple]) -> bool:
        """A buffer starting more than one gap-filler duration past the last
        output's end waits its turn behind repeats (imp.rs:1710-1750)."""
        if rt is None or self._out_last is None or self._out_buffer is None:
            return False
        slack = self._out_duration if self._out_duration is not None \
            else _LS_DEFAULT_DURATION
        slack = min(max(slack, _LS_MIN_DURATION), _LS_MAX_DURATION)
        return rt[0] >= self._out_last[1] + slack

    def connect(self, signal: str, callback) -> None:
        # GObject-style notify::<counter> observation (the reference's
        # statistics are plain property notifies, imp.rs:1249-1254)
        if signal.startswith("notify::"):
            if not hasattr(self, "_signal_handlers"):
                self._signal_handlers = {}
            self._signal_handlers.setdefault(signal, []).append(callback)
            return
        super().connect(signal, callback)

    def _notify(self, prop: str) -> None:
        if self.get_property("silent"):
            return
        for cb in getattr(self, "_signal_handlers", {}).get(
                f"notify::{prop}", []):
            cb(self, prop)

    # -- sink side -------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._lock:
            if self._eos:
                return FlowReturn.EOS
            if self._upstream_latency is None:
                q = Query.new_latency()
                if pad.peer_query(q) and q.result.get("live"):
                    self._upstream_latency = q.result.get("min_latency") or 0
                else:
                    self._upstream_latency = 0
            if self._in_segment is None:
                return FlowReturn.ERROR
            segment, _ = self._in_segment

            # patch missing/incorrect duration (imp.rs:1118-1171)
            duration = buf.duration
            if self._in_audio_rate:
                samples = int(buf.data.shape[0])
                calc = samples * SECOND // self._in_audio_rate
                if duration is None or abs(duration - calc) > SECOND // self._in_audio_rate:
                    duration = calc
            elif duration is None:
                duration = self._in_duration if self._in_duration is not None \
                    else _LS_DEFAULT_DURATION
                duration = min(max(duration, _LS_MIN_DURATION), _LS_MAX_DURATION)
            pts = buf.pts

            if self.get_property("single-segment") and pts is not None:
                # clip to the input segment, then re-timestamp into running
                # time offset by latency (imp.rs:1179-1235)
                end = pts + duration
                stop = segment.stop
                if (stop is not None and pts >= stop) or end <= segment.start:
                    return FlowReturn.OK  # entirely outside the segment
                cs = max(pts, segment.start)
                ce = min(end, stop) if stop is not None else end
                if self._in_audio_rate and (cs > pts or ce < end):
                    data = buf.data
                    rate = self._in_audio_rate
                    i0 = (cs - pts) * rate // SECOND
                    i1 = int(data.shape[0]) - (end - ce) * rate // SECOND
                    buf = Buffer(data[i0:i1], pts=cs, duration=ce - cs,
                                 offset=buf.offset, offset_end=buf.offset_end,
                                 flags=buf.flags)
                rt0 = segment.base + int((cs - segment.start) / abs(segment.rate))
                rt1 = segment.base + int((ce - segment.start) / abs(segment.rate))
                pts = rt0 + self.get_property("latency")
                duration = rt1 - rt0

            out = Buffer(buf.data, pts=pts, dts=buf.dts, duration=duration,
                         offset=buf.offset, offset_end=buf.offset_end,
                         flags=buf.flags)
            out.metas = list(buf.metas)
            rt = self._rt_range(pts, duration, segment)
            lateness = self._classify(rt)
            if lateness == _LATE_UNDER:
                self._n_drop += 1
                self._notify("drop")
                return FlowReturn.OK
            self._queue.append(("buffer", out, rt, lateness))
            if rt is not None:
                self._in_last = rt
            if not self.get_property("sync") and self._clock_id is not None:
                # a new buffer interrupts the pending gap wait (imp.rs:1279-1285)
                self._unschedule()
                self._emit_slot()
            self._continue()
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        with self._lock:
            t = event.type
            if t == EventType.FLUSH_START:
                self.srcpad.push_event(event)
                self._unschedule()
                return True
            if t == EventType.FLUSH_STOP:
                self.srcpad.push_event(event)
                self._reset()
                return True
            if t == EventType.STREAM_START:
                self._eos = False
                self._eos_sent = False
            elif t == EventType.SEGMENT:
                seg = event.get("segment")
                if seg.format != "time":
                    return False
                self._in_segment = (seg.copy(), event.seqnum)
                self._eos = False
                self._eos_sent = False
            elif t == EventType.CAPS:
                caps = event.get("caps")
                self._in_audio_rate = self._caps_audio_rate(caps)
                self._in_duration = self._caps_duration(caps)
            elif t in (EventType.EOS, EventType.SEGMENT_DONE):
                self._eos = True
            elif t == EventType.GAP:
                # the repeat machinery covers gaps (imp.rs:858-861); in a
                # clockless harness synthesize the covering repeat directly
                if self.clock is None and self._out_buffer is not None:
                    self._patch_output(None)
                    self._push_out_buffer()
                return True
            if t in (EventType.STREAM_START, EventType.SEGMENT):
                self._eos_sent = False  # a new stream restarts the output
            self._queue.append(("event", event))
            self._continue()
        return True

    def _src_query(self, pad: Pad, query: Query) -> bool:
        if query.type == QueryType.LATENCY:
            ok = self.sinkpad.peer_query(query)
            if ok:
                query.result["min_latency"] = (
                    (query.result.get("min_latency") or 0)
                    + self.get_property("latency"))
            return ok
        return self.sinkpad.peer_query(query)

    # -- slot machine ------------------------------------------------------
    def _continue(self) -> None:
        """Process queued events, then arm the clock for the next slot."""
        while True:
            if self._eos_sent:
                return
            if self._queue and self._queue[0][0] == "event":
                self._handle_event(self._queue.popleft()[1])
                continue
            break
        if not self._queue and self._out_last is None:
            return  # nothing to pace yet
        if self._clock_id is not None:
            return  # already armed
        if self._queue and self._out_last is None:
            # first buffer: sync to its start running time (imp.rs:1404-1421)
            rt = self._queue[0][2]
            start = rt[0] if rt else 0
            self._out_last = (start, start)
        self._arm(self._out_last[1])

    def _arm(self, rt: int) -> None:
        if self.clock is None:
            # clockless: every deadline is immediately due, but only emit
            # queued buffers — unbounded repeats would never terminate
            while self._queue and not self._eos_sent:
                self._emit_slot()
            return
        cid = self.clock.new_single_shot_id(self.base_time + rt)
        self._clock_id = cid
        cid.wait_async(self._on_deadline)

    def _on_deadline(self, cid) -> None:
        with self._lock:
            if cid is not self._clock_id or cid._unscheduled:
                return
            self._clock_id = None
            if self._eos_sent:
                return
            self._emit_slot()
            self._continue()

    def _handle_event(self, event: Event) -> None:
        t = event.type
        if t == EventType.SEGMENT:
            self._pending_segment = (event.get("segment").copy(), event.seqnum)
        elif t == EventType.CAPS:
            self._pending_caps = event.get("caps")
        elif t in (EventType.EOS, EventType.SEGMENT_DONE):
            self._finalize(t)
        else:
            self.srcpad.push_event(event)

    def _finalize(self, in_type: EventType) -> None:
        """Terminate the output stream (imp.rs:1450-1479)."""
        self._out_buffer = None
        self._out_dup = False
        self._out_last = None
        self._unschedule()
        self._eos_sent = True
        if self._out_segment is not None:
            seg, seqnum = self._out_segment
            if in_type == EventType.SEGMENT_DONE or (
                    in_type is None and seg[0].flags & SegmentFlags.SEGMENT):
                self.srcpad.push_event(
                    Event.new_segment_done(seg[0].position, seqnum=seqnum))
            else:
                self.srcpad.push_event(Event.new_eos(seqnum=seqnum))
        else:
            self.srcpad.push_event(Event.new_eos())

    def _emit_slot(self) -> None:
        """Produce one output slot: a due queued buffer or the repeat —
        the reference's src_loop_inner (imp.rs:1344-1665)."""
        # events queued since the wait was armed come first
        while self._queue and self._queue[0][0] == "event":
            self._handle_event(self._queue.popleft()[1])
            if self._eos_sent:
                return
        item = None
        if self._queue:
            _, buf, rt, lateness = self._queue[0]
            if lateness == _ON_TIME and self._is_early(rt):
                pass  # leave queued; this slot repeats (imp.rs:1422-1432)
            else:
                self._queue.popleft()
                item = (buf, rt, lateness)

        caps = segment = None
        if item is None:
            if self._out_buffer is None:
                return  # nothing to repeat yet
            self._patch_output(None)
        else:
            buf, rt, lateness = item
            if lateness == _ON_TIME:
                self._n_in += 1
                if self._out_buffer is None or self._out_dup:
                    # starting, or done bridging a gap (imp.rs:1521-1524)
                    buf.set_flag(BufferFlags.DISCONT)
                self._out_buffer = buf
                self._out_dup = False
                self._out_last = rt
                caps, self._pending_caps = self._pending_caps, None
                segment, self._pending_segment = self._pending_segment, None
            elif self._pending_caps is None and self._pending_segment is None:
                # accepted late buffer: repeat slot carries its data
                self._n_in += 1
                self._patch_output(buf)
                self._notify("duplicate")
            else:
                # cannot resync onto a late buffer across pending events
                self._n_drop += 1
                self._notify("drop")
                self._patch_output(None)

        if caps is not None:
            self.srcpad.push_event(Event.new_caps(caps))
            self._out_audio_rate = self._caps_audio_rate(caps)
            self._out_duration = self._caps_duration(caps)
        if segment is not None:
            in_seg, in_seqnum = segment
            if not self.get_property("single-segment"):
                out_seg = in_seg.copy()
                self._out_segment = ([out_seg], in_seqnum)
                self.srcpad.push_event(
                    Event.new_segment(out_seg, seqnum=in_seqnum))
            elif self._out_segment is not None:
                # keep the live segment, adopt the new seqnum (imp.rs:1581-1583)
                self._out_segment = (self._out_segment[0], in_seqnum)
            else:
                out_seg = Segment()
                self._out_segment = ([out_seg], in_seqnum)
                self.srcpad.push_event(
                    Event.new_segment(out_seg, seqnum=in_seqnum))
        self._push_out_buffer()

    def _push_out_buffer(self) -> None:
        buffer = self._out_buffer
        if buffer is None or self._out_segment is None:
            return
        seg_box, seqnum = self._out_segment
        out_seg = seg_box[0]
        if not self.get_property("single-segment") and buffer.pts is not None:
            # buffer beyond the output segment terminates the stream
            # (imp.rs:1612-1646)
            stop = out_seg.stop
            end = buffer.pts + (buffer.duration or 0)
            if (stop is not None and buffer.pts >= stop) or end <= out_seg.start:
                flag_done = bool(out_seg.flags & SegmentFlags.SEGMENT)
                self._out_buffer = None
                self._out_dup = False
                self._out_last = None
                self._unschedule()
                self._eos_sent = True
                if flag_done:
                    self.srcpad.push_event(
                        Event.new_segment_done(out_seg.position, seqnum=seqnum))
                else:
                    self.srcpad.push_event(Event.new_eos(seqnum=seqnum))
                return
        if buffer.pts is not None:
            out_seg.position = buffer.pts + (buffer.duration or 0)
        self._n_out += 1
        self.srcpad.push(buffer)

    def _patch_output(self, source: Optional[Buffer]) -> None:
        """Advance the repeat timeline by one slot (imp.rs:1768-1858)."""
        out = self._out_buffer
        duration = out.duration or _LS_DEFAULT_DURATION
        seg_rate = 1.0
        if self._out_segment is not None and not self.get_property("single-segment"):
            seg_rate = self._out_segment[0][0].rate
        if out.pts is None:
            pts = None
        elif seg_rate > 0 or self.get_property("single-segment"):
            pts = out.pts + duration
        else:
            pts = max(out.pts - duration, 0)

        base = source if source is not None else out
        was_dup = self._out_dup and source is None
        data = base.data
        new_duration = base.duration or duration
        dur_ok = _LS_MIN_DURATION <= new_duration <= _LS_MAX_DURATION
        if self._out_duration is not None or not dur_ok:
            new_duration = self._out_duration if self._out_duration is not None \
                else _LS_DEFAULT_DURATION
            new_duration = min(max(new_duration, _LS_MIN_DURATION),
                               _LS_MAX_DURATION)
            if self._out_audio_rate:
                samples = new_duration * self._out_audio_rate // SECOND
                data = zeros_like_payload(data, (samples,) + tuple(data.shape[1:]))
        if not was_dup and self._out_audio_rate and source is None:
            # audio gaps repeat as silence (imp.rs:1837-1845)
            data = zeros_like_payload(data)
        flags = (base.flags | BufferFlags.GAP) & ~BufferFlags.DISCONT
        repeat = Buffer(data, pts=pts, duration=new_duration,
                        offset=base.offset, offset_end=base.offset_end,
                        flags=flags)
        self._out_buffer = repeat
        self._out_dup = True
        self._n_dup += 1
        if self._out_segment is not None and pts is not None:
            self._out_last = self._rt_range(pts, new_duration,
                                            self._out_segment[0][0])
        elif pts is not None and self._out_last is not None:
            self._out_last = (self._out_last[1],
                              self._out_last[1] + new_duration)


from .togglerecord import ToggleRecord  # noqa: F401 (re-export)

__all__ = ["FallbackSwitch", "LiveSync", "ToggleRecord"]
