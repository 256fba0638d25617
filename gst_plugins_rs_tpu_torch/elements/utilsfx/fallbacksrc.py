"""fallbacksrc: stream-aware source wrapper with automatic fallback/retry.

Parity target: utils/fallbackswitch/src/fallbacksrc/imp.rs (4660 LoC).  The
reference wraps uridecodebin3 + per-stream fallbackswitch instances inside a
bin with clock-armed retry timers; this element composes the same machinery
from in-repo parts: rsfilesrc/`source` -> decodebin -> per-media-type
fallbackswitch (the REAL element, with its clock-armed no-data timeout) ->
public sometimes pads, plus a fallback/dummy stream per type and a
clock-driven restart/retry state machine.

Semantics table — every property of the reference ParamSpec block
(imp.rs:332-463) and its implementation here; each row is test-gated in
tests/test_fallbacksrc.py:

| property             | reference semantics (imp.rs:332-463)      | here |
|----------------------|-------------------------------------------|------|
| uri                  | URI to use                                | file:// uri -> rsfilesrc -> decodebin |
| source               | element used instead of the uri           | BaseSrc-style element feeding decodebin |
| fallback-uri         | fallback stream URI                       | second chain feeding the switch's priority-1 pad |
| fallback-source      | element instead of fallback-uri           | same, element-driven |
| timeout              | ns without data -> switch to fallback     | delegated to the internal fallbackswitch's clock-armed timeout |
| restart-timeout      | ns before restarting a failed source      | clock single-shot wait between retries |
| retry-timeout        | ns of repeated failure before stopping    | wall-clock (pipeline clock) window; exceeded -> ERROR + Stopped (default 60 s) |
| restart-on-eos       | restart source on EOS                     | rebuilds the primary chain instead of forwarding EOS |
| status               | Stopped/Buffering/Retrying/Running (read) | same enum, `fallbacksrc-status` bus message per transition |
| min-latency          | extra configured latency                  | added to LATENCY query results |
| buffer-duration      | buffering duration ns (-1 auto)           | accepted; file sources read synchronously (buffering-percent stays 100) |
| statistics           | num-retry / num-fallback-retry /          | live Structure, same field names |
|                      | last-retry-reason / buffering-percent     |      |
| manual-unblock       | app must call `unblock` to leave fallback | recovered primary held unhealthy until unblock() |
| immediate-fallback   | forward fallback streams at startup       | delegated to the switch's immediate-fallback |
| fallback-audio/video-caps | raw caps for the fallback stream (deprecated) | constrain the fallback chain's caps |
| audio-caps/video-caps| caps on which to stop decoding            | constrain/fixate the primary stream caps |
| dummy-audio/video-caps | raw caps for the dummy streams          | dummy generator formats |
| enable-audio/video   | produce that stream type (deprecated)     | gates dummy/fallback production per type |
| enable-dummy         | built-in dummy when nothing else works    | silence (audio) / black frames (video) / zero bytes |

Signals (reference fallbacksrc signals): `unblock`, `update-uri`,
`map-streams` (request surface).

The dummy audio and video streams are made on the port's device
(`device()`), so a fallbackswitch never mixes host and device payloads on
one output; the dummy byte stream stays host bytes.
"""
from __future__ import annotations

import threading
from fractions import Fraction
from typing import Dict, Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    Query,
    QueryType,
    SECOND,
    register,
)
from ...core.caps import Structure
from ...core.events import Message, MessageType, Segment
from ...core.registry import element_factory_make


class _PrimaryError(Exception):
    pass


def _uri_path(uri: str) -> str:
    return uri[7:] if uri.startswith("file://") else uri


def _classify(caps_name: str) -> str:
    if caps_name.startswith("audio/"):
        return "audio"
    if caps_name.startswith(("video/", "image/")):
        return "video"
    return "src"


class _StreamOut:
    """One public output stream: a REAL internal fallbackswitch (priority-0
    primary input, priority-1 fallback input) ghosted out on a sometimes
    pad — the reference's per-stream architecture."""

    def __init__(self, parent: "FallbackSrc", kind: str):
        self.kind = kind
        self.parent = parent
        sw = element_factory_make("fallbackswitch", f"{parent.name}-sw-{kind}")
        sw.parent = parent.parent
        sw.set_property("timeout", parent.get_property("timeout"))
        sw.set_property("immediate-fallback",
                        parent.get_property("immediate-fallback"))
        # a clean primary EOS ends the stream (unless restart-on-eos
        # intercepts it before the switch ever sees the EOS)
        sw.set_property("stop-on-eos", True)
        self.switch = sw
        self.primary = sw.request_sink_pad()  # priority 0
        self.fallback = sw.request_sink_pad()  # priority 1
        # the switch posts through the parent's bus
        sw.post_message = parent.post_message

        caps = {"audio": Caps.builder("audio/x-raw"),
                "video": Caps.builder("video/x-raw")}.get(kind, Caps.new_any())
        self.public = Pad(kind, PadDirection.SRC,
                          PadTemplate(kind, PadDirection.SRC,
                                      PadPresence.SOMETIMES, caps))
        self.public.query_function = parent._src_query
        parent.add_pad(self.public)

        term = Pad(f"{parent.name}-{kind}-out", PadDirection.SINK,
                   PadTemplate("inner", PadDirection.SINK,
                               PadPresence.ALWAYS, Caps.new_any()))
        term.element = parent
        term.chain_function = lambda pad, buf: self.public.push(buf)
        term.event_function = self._on_out_event
        sw.pads["src"].peer = term
        term.peer = sw.pads["src"]

        if parent._pending_peer is not None and parent._pending_peer.peer is None:
            self.public.link(parent._pending_peer)
        if parent.clock is not None:
            sw.clock = parent.clock
            sw.base_time = parent.base_time
        from ...core.element import State

        sw.set_state(State.PLAYING)

    def _on_out_event(self, pad: Pad, ev: Event) -> bool:
        if ev.type == EventType.CAPS:
            self.public.current_caps = ev.get("caps")
        if ev.type == EventType.EOS:
            self.parent._stream_eos(self)
        return self.public.push_event(ev)

    def feed_primary(self, buf: Buffer) -> None:
        self.parent._note_primary_data(self)
        self.primary.chain(buf)

    def stop(self) -> None:
        from ...core.element import State

        self.switch.set_state(State.NULL)


@register
class FallbackSrc(Element):
    ELEMENT_NAME = "fallbacksrc"
    ELEMENT_CLASS = "Source/Generic/Bin"
    ELEMENT_DESCRIPTION = "Live source with uri fallback"
    EXTRA_PAD_TEMPLATES = [
        ("audio", "src", "sometimes", "audio/x-raw"),
        ("video", "src", "sometimes", "video/x-raw"),
        ("src", "src", "sometimes", "ANY"),
    ]
    PROPERTIES = [
        Prop("uri", None, type="str", mutable="ready"),
        Prop("source", None, type="object", mutable="ready",
             doc="source element to use instead of the URI"),
        Prop("fallback-uri", None, type="str", mutable="ready"),
        Prop("fallback-source", None, type="object", mutable="ready"),
        Prop("timeout", 5 * SECOND, type="uint64", mutable="ready",
             doc="ns without primary data before the internal switch "
                 "forwards the fallback stream (clock-armed)"),
        Prop("restart-timeout", 5 * SECOND, type="uint64", mutable="ready",
             doc="ns to wait on the pipeline clock before restarting a "
                 "failed source"),
        Prop("retry-timeout", 60 * SECOND, type="uint64", mutable="ready",
             doc="wall-clock ns of repeated failure before giving up with "
                 "an error (reference default 60 s)"),
        Prop("restart-on-eos", False, type="bool", mutable="ready"),
        Prop("status", "stopped", type="enum",
             choices=["stopped", "buffering", "retrying", "running"],
             doc="(read) current source status"),
        Prop("min-latency", 0, type="uint64", mutable="ready",
             doc="extra latency reported to the pipeline"),
        Prop("buffer-duration", -1, type="int", mutable="ready",
             doc="buffering duration ns (-1 automatic; file sources read "
                 "synchronously so buffering-percent stays 100)"),
        Prop("statistics", None, type="object",
             doc="(read) application/x-fallbacksrc-stats structure"),
        Prop("manual-unblock", False, type="bool", mutable="ready",
             doc="hold the fallback after the primary recovers until the "
                 "unblock signal"),
        Prop("immediate-fallback", False, type="bool", mutable="ready",
             doc="forward the fallback streams immediately at startup"),
        Prop("enable-audio", True, type="bool", mutable="ready"),
        Prop("enable-video", True, type="bool", mutable="ready"),
        Prop("enable-dummy", True, type="bool", mutable="ready",
             doc="built-in dummy stream (silence/black/zeros) when no "
                 "fallback works"),
        Prop("audio-caps", None, type="object", mutable="ready"),
        Prop("video-caps", None, type="object", mutable="ready"),
        Prop("fallback-audio-caps", None, type="object", mutable="ready"),
        Prop("fallback-video-caps", None, type="object", mutable="ready"),
        Prop("dummy-audio-caps",
             "audio/x-raw,format=F32,rate=48000,channels=2",
             type="object", mutable="ready"),
        Prop("dummy-video-caps",
             "video/x-raw,format=RGB,width=320,height=240,framerate=30/1",
             type="object", mutable="ready"),
    ]

    SIGNALS = {
        "unblock": "unblock",
        "update-uri": "update_uri",
        "map-streams": None,  # request: app remaps the stream selection
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.status = "stopped"
        self._streams: Dict[str, _StreamOut] = {}
        self._streams_lock = threading.RLock()
        self._pending_peer: Optional[Pad] = None
        self._stop_evt = threading.Event()
        self._threads = []
        self._retry_id = None
        self._retries = 0
        self._fallback_retries = 0
        self._last_retry_reason = "none"
        self._unblock_evt = threading.Event()
        self._had_failure = False
        self._eos_streams = set()
        self._done = threading.Event()

    # -- public surface ---------------------------------------------------
    def update_uri(self, uri: str) -> None:
        """`update-uri` action: the next (re)start uses the new uri."""
        self._props["uri"] = uri

    def unblock(self) -> None:
        """manual-unblock release: allow switching back to the primary."""
        self._unblock_evt.set()
        with self._streams_lock:
            for st in self._streams.values():
                st.primary.set_property("is-healthy", True)

    def get_property(self, name: str):
        if name == "statistics":
            return self.statistics
        if name == "status":
            return self.status
        return super().get_property(name)

    @property
    def statistics(self) -> Structure:
        return Structure(
            "application/x-fallbacksrc-stats",
            **{"num-retry": self._retries,
               "num-fallback-retry": self._fallback_retries,
               "last-retry-reason": self._last_retry_reason,
               "buffering-percent": 100,
               "fallback-buffering-percent": 100})

    def link(self, downstream) -> None:
        sink = next((p for p in downstream.sink_pads() if p.peer is None),
                    None)
        if sink is None and hasattr(downstream, "request_sink_pad"):
            sink = downstream.request_sink_pad()
        self._pending_peer = sink

    def _src_query(self, pad: Pad, query: Query) -> bool:
        if query.type == QueryType.LATENCY:
            query.result["min_latency"] = (query.result.get("min_latency", 0)
                                           + self.get_property("min-latency"))
            query.result.setdefault("live", True)
            return True
        return self._default_query(pad, query)

    # -- status -------------------------------------------------------------
    def _set_status(self, status: str) -> None:
        if status != self.status:
            self.status = status
            self.post_message(Message(
                MessageType.ELEMENT,
                structure=Structure("fallbacksrc-status", status=status)))

    # -- lifecycle ------------------------------------------------------------
    def on_paused_to_playing(self) -> None:
        self._stop_evt.clear()
        self._done.clear()
        self._unblock_evt.clear()
        self._retries = 0
        self._fallback_retries = 0
        self._eos_streams = set()
        self._set_status("buffering")
        t = threading.Thread(target=self._primary_worker, daemon=True,
                             name=f"{self.name}-primary")
        t.start()
        self._threads = [t]
        if self.get_property("fallback-uri") \
                or self.get_property("fallback-source") is not None:
            tf = threading.Thread(target=self._fallback_worker, daemon=True,
                                  name=f"{self.name}-fallback")
            tf.start()
            self._threads.append(tf)

    def on_playing_to_paused(self) -> None:
        self._stop_evt.set()
        self._done.set()
        if self._retry_id is not None:
            self._retry_id.unschedule()
        for t in self._threads:
            t.join(5.0)
        self._threads = []
        with self._streams_lock:
            for st in self._streams.values():
                st.stop()
            self._streams = {}
        self._set_status("stopped")

    def wait_stream_done(self) -> None:
        """Pipeline.run integration: block until EOS reached every exposed
        stream, the retry machinery gave up, or the element left PLAYING."""
        self._done.wait()

    # -- clock helpers ---------------------------------------------------------
    def _running_time(self) -> int:
        if self.clock is not None:
            return self.clock.now() - self.base_time
        import time as _t

        return _t.monotonic_ns()

    def _clock_wait(self, ns: int) -> None:
        if self.clock is not None:
            cid = self.clock.new_single_shot_id(self.clock.now() + ns)
            self._retry_id = cid
            cid.wait()
            self._retry_id = None
        else:
            self._stop_evt.wait(ns / 1e9)

    # -- streams ----------------------------------------------------------------
    def _stream_for(self, kind: str) -> _StreamOut:
        with self._streams_lock:
            st = self._streams.get(kind)
            if st is None:
                st = _StreamOut(self, kind)
                self._streams[kind] = st
                self._start_fallback_feeder(st)
            return st

    def _note_primary_data(self, st: _StreamOut) -> None:
        if self.status in ("buffering", "retrying"):
            self._set_status("running")
        if (self._had_failure and self.get_property("manual-unblock")
                and not self._unblock_evt.is_set()):
            # hold the recovered primary until the app calls unblock
            # (imp.rs manual-unblock)
            st.primary.set_property("is-healthy", False)

    def _stream_eos(self, st: _StreamOut) -> None:
        self._eos_streams.add(st.kind)
        with self._streams_lock:
            kinds = set(self._streams)
        if kinds and self._eos_streams >= kinds:
            self._done.set()

    # -- primary chain ------------------------------------------------------------
    def _build_chain(self, uri: Optional[str], source, route) -> "_Chain":
        return _Chain(self, uri, source, route)

    def _primary_worker(self) -> None:
        first_failure = None
        while not self._stop_evt.is_set():
            outcome = "error"
            reason = "error"
            try:
                chain = self._build_chain(
                    self.get_property("uri"), self.get_property("source"),
                    self._route_primary)
                first_failure_reset = [first_failure]

                def on_data():
                    first_failure_reset[0] = None

                outcome = chain.run(self._stop_evt, on_data)
                first_failure = first_failure_reset[0]
                reason = "eos" if outcome == "eos" else "error"
            except _PrimaryError as e:
                outcome, reason = "error", str(e) or "error"
            if self._stop_evt.is_set():
                return
            if outcome == "eos":
                if self.get_property("restart-on-eos"):
                    self._retries += 1
                    self._last_retry_reason = "eos"
                    continue
                # forward EOS through every stream's primary pad; the
                # switches run stop-on-eos so this ends the streams
                with self._streams_lock:
                    streams = list(self._streams.values())
                for st in streams:
                    st.primary.send_event(Event.new_eos())
                if not streams:
                    self._done.set()
                return
            # error path: clock-armed restart/retry (imp.rs restart-timeout /
            # retry-timeout)
            self._had_failure = True
            self._retries += 1
            self._last_retry_reason = reason
            now = self._running_time()
            if first_failure is None:
                first_failure = now
            if now - first_failure >= self.get_property("retry-timeout"):
                self.post_message(Message(
                    MessageType.ERROR,
                    text=f"{self.name}: giving up after retry-timeout"))
                self._set_status("stopped")
                self._done.set()
                return
            self._set_status("retrying")
            self._ensure_outage_streams()
            self._clock_wait(self.get_property("restart-timeout"))

    def _route_primary(self, kind: str, item) -> None:
        st = self._stream_for(kind)
        if isinstance(item, Buffer):
            st.feed_primary(item)
            return
        if item.type == EventType.CAPS and kind in ("audio", "video"):
            # audio-caps / video-caps: constrain the decoded stream
            want = self.get_property(f"{kind}-caps")
            if want is not None:
                from ...core.parse import parse_caps

                wantc = parse_caps(want) if isinstance(want, str) else want
                cut = wantc.intersect(item.get("caps"))
                if not cut.is_empty():
                    item = Event.new_caps(cut)
        st.primary.send_event(item)

    # -- fallback / dummy streams ---------------------------------------------
    def _start_fallback_feeder(self, st: _StreamOut) -> None:
        """Per-stream dummy generator.  When a fallback-uri/source chain is
        configured it owns the fallback pads instead (the reference uses the
        fallback stream for the types it provides and dummy for the rest;
        here a configured fallback chain disables dummies — documented
        simplification)."""
        if self.get_property("fallback-uri") \
                or self.get_property("fallback-source") is not None:
            return
        enabled = self.get_property(
            "enable-audio" if st.kind == "audio"
            else "enable-video" if st.kind == "video" else "enable-dummy")
        if enabled and self.get_property("enable-dummy"):
            t = threading.Thread(target=self._dummy_loop, args=(st,),
                                 daemon=True,
                                 name=f"{self.name}-dummy-{st.kind}")
            t.start()
            self._threads.append(t)

    def _fallback_worker(self) -> None:
        """The fallback-uri/fallback-source chain: decoded streams feed the
        priority-1 pads, creating output streams for their types if the
        primary hasn't yet.  Like the reference (which freezes/loops the
        fallback image/stream), the chain restarts on EOS so the fallback
        keeps producing for as long as it is needed — the switch drops
        inactive input, so a finite fallback must loop to be available at
        switch-over time."""
        def route(kind, item):
            st = self._stream_for(kind)
            if isinstance(item, Buffer):
                st.fallback.chain(item)
            else:
                st.fallback.send_event(item)

        while not self._stop_evt.is_set():
            self._fallback_retries += 1
            try:
                chain = self._build_chain(
                    self.get_property("fallback-uri"),
                    self.get_property("fallback-source"), route)
                outcome = chain.run(self._stop_evt, lambda: None)
            except _PrimaryError:
                return
            if outcome == "stopped":
                return
            # pace the loop so tiny fallback files don't spin hot
            if self.clock is not None:
                self.clock.new_single_shot_id(
                    self.clock.now() + SECOND // 50).wait()
            else:
                self._stop_evt.wait(0.02)

    def _ensure_outage_streams(self) -> None:
        """The primary failed before exposing any stream: create the
        enabled dummy streams so the element still produces output
        (the reference's 'output silence/black if there's no audio/video
        in the configured URI')."""
        if self.get_property("fallback-uri") \
                or self.get_property("fallback-source") is not None:
            return  # the fallback chain creates its own streams
        if not self.get_property("enable-dummy"):
            return
        with self._streams_lock:
            if self._streams:
                return  # existing streams already have dummy feeders
        if self.get_property("enable-audio"):
            self._stream_for("audio")
        if self.get_property("enable-video"):
            self._stream_for("video")

    def _dummy_caps(self, kind: str) -> Caps:
        from ...core.parse import parse_caps

        prop = ("dummy-audio-caps" if kind == "audio"
                else "dummy-video-caps")
        if kind == "src":
            return Caps.builder("application/octet-stream")
        v = self.get_property(prop)
        return parse_caps(v) if isinstance(v, str) else v

    def _dummy_loop(self, st: _StreamOut) -> None:
        """Paced dummy stream: silence / black frames / zero bytes, one
        buffer per period on the pipeline clock (the reference's
        audiotestsrc wave=silence / videotestsrc pattern=black roles)."""
        caps = self._dummy_caps(st.kind)
        s = caps.structure(0)
        if st.kind == "audio":
            rate = int(s.get("rate", 48000))
            ch = int(s.get("channels", 2))
            n = rate // 50  # 20 ms
            payload = torch.zeros((n, ch), dtype=torch.float32, device=device())
            period = SECOND // 50
        elif st.kind == "video":
            w, h = int(s.get("width", 320)), int(s.get("height", 240))
            fr = s.get("framerate", "30/1")
            fr = Fraction(fr) if isinstance(fr, str) else fr
            payload = torch.zeros((h, w, 3), dtype=torch.uint8, device=device())
            period = SECOND * fr.denominator // fr.numerator
        else:
            payload = np.zeros(4096, np.uint8)
            period = SECOND // 50
        st.fallback.send_event(Event.new_stream_start(f"{self.name}-dummy"))
        st.fallback.send_event(Event.new_caps(caps))
        st.fallback.send_event(Event.new_segment(Segment()))
        pts = 0
        while not self._stop_evt.is_set():
            st.fallback.chain(Buffer(payload, pts=pts, duration=period))
            pts += period
            if self.clock is not None:
                self.clock.new_single_shot_id(
                    self.clock.now() + period).wait()
            else:
                self._stop_evt.wait(period / 1e9)


class _Chain:
    """One source chain: uri/source element -> decodebin -> typed routing.

    Runs synchronously on the caller's thread; `route(kind, buffer|event)`
    receives classified output.  Raises _PrimaryError when the source
    cannot start; returns "eos" on clean EOS, "error" on mid-stream
    failure, "stopped" when the stop event fires."""

    def __init__(self, parent: FallbackSrc, uri: Optional[str], source,
                 route) -> None:
        self.parent = parent
        self.route = route
        self._kind = None
        if source is not None:
            self.src = source
        elif uri:
            self.src = element_factory_make(
                "rsfilesrc", f"{parent.name}-filesrc")
            self.src.set_property("location", _uri_path(uri))
        else:
            raise _PrimaryError("no-uri")
        self.db = element_factory_make("decodebin", f"{parent.name}-db")
        self.db.parent = parent.parent
        self._hook_decodebin()

    def _hook_decodebin(self) -> None:
        orig_add = self.db.add_pad

        def hooked(pad: Pad):
            out = orig_add(pad)
            if pad.direction != PadDirection.SRC:
                return out
            term = Pad(f"{pad.name}-route", PadDirection.SINK,
                       PadTemplate("inner", PadDirection.SINK,
                                   PadPresence.ALWAYS, Caps.new_any()))
            term.element = self.db
            state = {"kind": None}

            def on_event(p, ev):
                if ev.type == EventType.CAPS:
                    caps = ev.get("caps")
                    state["kind"] = _classify(caps.structure(0).name)
                    self._kind = state["kind"]
                if state["kind"] is not None and ev.type != EventType.EOS:
                    self.route(state["kind"], ev)
                return True

            def on_chain(p, buf):
                if self._kind is not None:
                    self.route(self._kind, buf)
                from ...core.element import FlowReturn

                return FlowReturn.OK

            term.event_function = on_event
            term.chain_function = on_chain
            pad.peer = term
            term.peer = pad
            return out

        self.db.add_pad = hooked

    def run(self, stop_evt: threading.Event, on_data) -> str:
        from ...core.element import State

        try:
            if hasattr(self.src, "start"):
                self.src.start()
        except Exception as e:
            raise _PrimaryError(str(e) or "error")
        self.db.set_state(State.PLAYING)
        sink = self.db.sink_pads()[0]
        sink.send_event(Event.new_stream_start(f"{self.parent.name}-chain"))
        sink.send_event(Event.new_segment(Segment()))
        try:
            while not stop_evt.is_set():
                try:
                    buf = self.src.create()
                except Exception:
                    return "error"
                if buf is None or getattr(self.src, "RETRY", None) is buf:
                    if buf is None:
                        sink.send_event(Event.new_eos())
                        return "eos"
                    continue
                on_data()
                sink.chain(buf)
            return "stopped"
        finally:
            try:
                if hasattr(self.src, "stop"):
                    self.src.stop()
            except Exception:
                pass
            self.db.set_state(State.NULL)


__all__ = ["FallbackSrc"]
