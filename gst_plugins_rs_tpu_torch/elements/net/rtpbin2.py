"""RTP session elements: rtpsend, rtprecv, ts-jitterbuffer.

Parity targets: reference net/rtp/src/rtpbin2 (rtpsend.rs, rtprecv.rs,
session.rs, jitterbuffer.rs) and threadshare's ts-jitterbuffer.

rtpsend: request `rtp_sink_%u` -> always-paired `rtp_src_%u` plus
`rtcp_src_%u`; forwards RTP while tracking per-SSRC packet/octet counts and
emits compound RTCP SR+SDES on the rtcp pad.  With a pipeline clock, RTCP
is timer-scheduled with RFC 3550 §6.3 0.5x-1.5x interval randomization
(the reference's session.rs scheduling) so a stalled sender still reports;
media-keyed reports additionally fire every rtcp-interval of stream time.

rtprecv: request `rtp_sink_%u`; demuxes SSRCs to sometimes-pads named
`rtp_src_%u_%ssrc_%pt` (rtprecv.rs pad naming), reordering each SSRC
through a latency-windowed jitterbuffer; emits RTCP RR per interval on
`rtcp_src_%u`; accepts RTCP SR on `rtcp_sink_%u` to fill LSR fields.
"""
from __future__ import annotations

import logging
import random as _random
import threading
import time as _time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

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
    SECOND,
    register,
)
from ...core.events import Segment
from ...core.payload import host_bytes
from ...net import rtcp
from ...net.jitterbuffer import JitterBuffer
from ...net.rtp import (
    RtpPacket,
    build_onebyte_extensions,
    parse_onebyte_extensions,
)

RTP_CAPS = Caps.builder("application/x-rtp")
RTCP_CAPS = Caps.builder("application/x-rtcp")
DEFAULT_RTCP_INTERVAL = 5 * SECOND  # RFC 3550 §6.2 nominal
# how long before an un-repaired NACKed seq may be re-requested
NACK_RETRY_NS = SECOND // 10


def _onebyte_profile_ok(extension) -> bool:
    """True when an extension can safely be rewritten as RFC 8285 one-byte
    (absent, or already profile 0xBEDE)."""
    from ...net.rtp import ONE_BYTE_EXT_PROFILE
    return extension is None or extension[0] == ONE_BYTE_EXT_PROFILE


class _RtcpTimerMixin:
    """Clock-armed compound-RTCP scheduling, RFC 3550 §6.3 style.

    The reference schedules RTCP on timers with interval reconsideration
    (net/rtp/src/rtpbin2/session.rs); keying reports off buffer pts (the
    pre-clock design here) meant a stalled sender never reported.  With a
    pipeline clock present, reports fire on randomized 0.5x-1.5x intervals
    of `rtcp-interval` (the §6.3 timer randomization; Tmin handling is the
    property's own floor) regardless of media flow.  Clockless pipelines
    keep the pts-keyed fallback.
    """

    def _rtcp_timer_init(self) -> None:
        self._rtcp_timer_id = None
        self._rtcp_timer_lock = threading.RLock()
        self._rtcp_clocked = False

    def on_paused_to_playing(self) -> None:
        if self.clock is not None:
            self._rtcp_clocked = True
            self._arm_rtcp_timer()

    def on_playing_to_paused(self) -> None:
        self._rtcp_clocked = False
        with self._rtcp_timer_lock:
            if self._rtcp_timer_id is not None:
                self._rtcp_timer_id.unschedule()
                self._rtcp_timer_id = None

    def _arm_rtcp_timer(self) -> None:
        if self.clock is None or not self._rtcp_clocked:
            return
        interval = self.get_property("rtcp-interval")
        # RFC 3550 §6.3.1: uniformly distributed on [0.5, 1.5] x interval,
        # floored by min-rtcp-interval when the element exposes it
        deadline = int(interval * _random.uniform(0.5, 1.5))
        deadline = max(deadline, self._props.get("min-rtcp-interval", 0))
        with self._rtcp_timer_lock:
            if self._rtcp_timer_id is not None:
                self._rtcp_timer_id.unschedule()
            cid = self.clock.new_single_shot_id(self.clock.now() + deadline)
            self._rtcp_timer_id = cid
            cid.wait_async(self._on_rtcp_timer)

    def _on_rtcp_timer(self, cid) -> None:
        with self._rtcp_timer_lock:
            if cid is not self._rtcp_timer_id or cid._unscheduled:
                return
            self._rtcp_timer_id = None
        try:
            self._rtcp_timer_tick()
        finally:
            self._arm_rtcp_timer()

    def _rtcp_timer_tick(self) -> None:  # overridden per element
        raise NotImplementedError


def _fixed_caps_query(caps: Caps):
    """Pads of the session elements answer their own caps instead of
    proxying — the RTCP loopback topology (recv rtcp_src -> send
    rtcp_sink) would otherwise cycle the default caps-query forwarding."""
    from ...core import QueryType

    def q(pad: Pad, query) -> bool:
        if query.type == QueryType.CAPS:
            f = query.fields.get("filter")
            query.result["caps"] = caps if f is None else f.intersect(caps)
            return True
        # non-CAPS queries (LATENCY etc.) keep the element default routing
        if pad.element is not None:
            return pad.element._default_query(pad, query)
        return False

    return q


class _SendStream:
    def __init__(self) -> None:
        self.packet_count = 0
        self.octet_count = 0
        self.last_rtp_ts = 0
        self.last_pts: Optional[int] = None
        self.next_rtcp_pts = 0
        # retransmission history: seq -> wire bytes (bounded FIFO)
        self.history: "OrderedDict[int, bytes]" = OrderedDict()
        self.idx = "0"
        self.rtx_seq = 0


# rtp-id registry: the reference's rtpsend/rtprecv halves share one
# session object keyed by rtp-id (rtpbin2/mod.rs). Here the registry
# pairs the elements — and carries the shared GstRtp2Session state
# (pt-map/clock-map/sdes, signal handlers) — so feedback arriving at
# either half reaches the right session state.
class _SessionState:
    """Shared per-rtp-id session state (session.rs Session analog)."""

    SIGNALS = ("bye-ssrc", "new-ssrc", "timeout-ssrc")

    def __init__(self) -> None:
        self.elements: Dict[str, "Element"] = {}
        self.pt_map: Dict[int, Caps] = {}     # payload type -> caps
        self.clock_map: Dict[str, Any] = {}   # RFC 7273 ts-refclk -> clock
        self.sdes: Dict[str, str] = {}        # extra local SDES items
        self.handlers: Dict[str, List[Any]] = {}

    def emit(self, signal: str, *args) -> None:
        for cb in self.handlers.get(signal, []):
            cb(*args)


_RTP_SESSIONS: Dict[str, _SessionState] = {}


def _session_state(rtp_id: str) -> _SessionState:
    state = _RTP_SESSIONS.get(rtp_id)
    if state is None:
        state = _RTP_SESSIONS[rtp_id] = _SessionState()
    return state


def _session_register(rtp_id: str, role: str, element) -> None:
    _session_state(rtp_id).elements[role] = element


def _session_peer(rtp_id: str, role: str):
    return _session_state(rtp_id).elements.get(role)


class _SessionFacade:
    """What `get-session` returns: the GstRtp2Session analog — the paired
    send/recv halves of one rtp-id plus the session property surface
    (clock-map / pt-map / sdes / stats) and the bye-ssrc / new-ssrc /
    timeout-ssrc signals (reference rsrtp other-types GstRtp2Session;
    net/rtp/src/rtpbin2/session.rs)."""

    def __init__(self, rtp_id: str):
        self.rtp_id = rtp_id

    @property
    def _state(self) -> _SessionState:
        return _session_state(self.rtp_id)

    @property
    def send(self):
        return _session_peer(self.rtp_id, "send")

    @property
    def recv(self):
        return _session_peer(self.rtp_id, "recv")

    def connect(self, signal: str, callback) -> None:
        if signal not in _SessionState.SIGNALS:
            raise KeyError(f"RtpSession: no signal {signal!r}")
        self._state.handlers.setdefault(signal, []).append(callback)

    def get_property(self, name: str):
        from ...core.caps import Structure

        state = self._state
        if name == "pt-map":
            return Structure("application/x-rtp2-pt-map",
                             **{str(pt): caps for pt, caps in
                                sorted(state.pt_map.items())})
        if name == "clock-map":
            return Structure("application/x-rtp2-clock-map",
                             **dict(state.clock_map))
        if name == "sdes":
            send = self.send
            cname = ""
            if send is not None:
                cname = send.get_property("cname") or send.name
            return Structure("application/x-rtp2-sdes",
                             cname=state.sdes.get("cname", cname),
                             **{k: v for k, v in state.sdes.items()
                                if k != "cname"})
        if name == "stats":
            fields: Dict[str, Any] = {}
            if self.send is not None:
                fields["send"] = self.send.get_property("stats")
            if self.recv is not None:
                fields["recv"] = self.recv.get_property("stats")
            return Structure("application/x-rtp2-session-stats", **fields)
        raise KeyError(f"RtpSession: no property {name!r}")

    def set_property(self, name: str, value) -> None:
        state = self._state
        items = (dict(value.fields) if hasattr(value, "fields")
                 else dict(value or {}))
        if name == "pt-map":
            state.pt_map = {int(pt): caps for pt, caps in items.items()}
        elif name == "clock-map":
            state.clock_map = items
        elif name == "sdes":
            state.sdes = {str(k): v for k, v in items.items()}
            send = self.send
            if send is not None and "cname" in state.sdes:
                send.set_property("cname", state.sdes["cname"])
        else:
            raise KeyError(f"RtpSession: no writable property {name!r}")

    def __repr__(self):
        return f"RtpSession({self.rtp_id!r}, send={self.send}, recv={self.recv})"


class _GetSessionMixin:
    #: GstRtp2Session surface handed out by get-session (reference rsrtp
    #: other-types; properties audited by ci/prop_parity.py OBJECT_TYPES)
    OBJECT_PROPERTIES = {
        "GstRtp2Session": [
            Prop("clock-map", None, type="object",
                 doc="RFC 7273 ts-refclk string -> synced clock mapping "
                     "(application/x-rtp2-clock-map)"),
            Prop("pt-map", None, type="object",
                 doc="RTP payload type -> caps mapping consumed when "
                     "rtprecv creates stream pads "
                     "(application/x-rtp2-pt-map)"),
            Prop("sdes", None, type="object",
                 doc="local SDES items; setting cname reconfigures the "
                     "send half (application/x-rtp2-sdes)"),
            Prop("stats", None, type="object",
                 doc="(read) merged send+recv session statistics"),
        ],
    }

    def get_session(self, _id: int = 0) -> "_SessionFacade":
        return _SessionFacade(self.get_property("rtp-id"))


@register
class RtpSend(_GetSessionMixin, _RtcpTimerMixin, Element):
    ELEMENT_NAME = "rtpsend"
    EXTRA_PAD_TEMPLATES = [
        ('rtp_sink_%u', 'sink', 'request', 'application/x-rtp'),
        ('rtp_src_%u', 'src', 'sometimes', 'application/x-rtp'),
        ('rtcp_src_%u', 'src', 'sometimes', 'application/x-rtcp'),
        ('rtcp_sink_%u', 'sink', 'request', 'application/x-rtcp'),
    ]
    ELEMENT_CLASS = "Network/RTP/Session"
    SIGNALS = {"get-session": "get_session"}
    ELEMENT_DESCRIPTION = "RTP session sender: forwards RTP, generates RTCP SRs"
    PROPERTIES = [
        Prop("rtcp-interval", DEFAULT_RTCP_INTERVAL, type="uint64"),
        Prop("min-rtcp-interval", 0, type="uint64",
             doc="floor (ns) under the randomized RTCP send interval"),
        Prop("reduced-size-rtcp", False, type="bool",
             doc="RFC 5506: allow non-compound RTCP — SDES rides only "
                 "every fifth report instead of every one"),
        Prop("rtp-id", "rtp-id", type="str",
             doc="session id pairing this element with an rtprecv; NACK/"
                 "TWCC feedback arriving at the paired recv half is "
                 "forwarded here"),
        Prop("rtp-profile", "avp", type="enum", choices=["avp", "avpf"],
             doc="avpf permits reduced-size RTCP; incoming feedback is "
                 "accepted under either profile (liberal receive)"),
        Prop("stats", None, type="object",
             doc="(read) per-ssrc packet/octet counters"),
        Prop("cname", "", type="str", doc="SDES CNAME ('' = element name)"),
        Prop("history-size", 512, type="uint",
             doc="retained packets per SSRC for NACK retransmission"),
        Prop("rtx-pt", 0, type="uint", maximum=127,
             doc="RFC 4588 RTX payload type (0 = retransmit as-is)"),
        Prop("rtx-ssrc", 0, type="uint64",
             doc="RTX stream SSRC (0 = media SSRC + 1)"),
        Prop("twcc-ext-id", 0, type="uint", maximum=14,
             doc="transport-wide-cc header-extension id to stamp (0 = off)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._streams: Dict[int, _SendStream] = {}  # ssrc -> stats
        self._rtcp_started: Dict[str, bool] = {}
        self._twcc_seq = 0
        self._twcc_profile_warned = False
        self._sr_count = 0
        # twcc seq -> (send_time_ns, size); bounded
        self._twcc_sent: "OrderedDict[int, Tuple[int, int]]" = OrderedDict()
        # RFC 3550 §8.2 collision resolution: old ssrc -> replacement;
        # outgoing packets are rewritten after a collision was detected
        self._ssrc_rewrite: Dict[int, int] = {}
        self._rtcp_timer_init()
        _session_register(self.get_property("rtp-id"), "send", self)

    def property_changed(self, name: str, value) -> None:
        if name == "rtp-id":
            _session_register(value, "send", self)

    def get_property(self, name: str):
        if name == "stats":
            from ...core.caps import Structure

            fields = {}
            for ssrc, st in self._streams.items():
                fields[f"ssrc-{ssrc}"] = Structure(
                    "source-stats",
                    **{"packets-sent": st.packet_count,
                       "octets-sent": st.octet_count})
            return Structure("rtpsend-stats", **fields)
        return super().get_property(name)

    def _rtcp_timer_tick(self) -> None:
        """Clock-scheduled compound SR for every stream — fires even when
        media has stalled (the pts path can't)."""
        now = self.running_time()
        for ssrc, st in list(self._streams.items()):
            self._send_sr(st.idx, ssrc, st, now)

    def request_pad(self, template_name: str = "rtp_sink_%u") -> Pad:
        n = sum(1 for p in self.pads if p.startswith("rtp_sink_"))
        return self.request_sink_pad(f"rtp_sink_{n}")

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        if name is None:
            name = f"rtp_sink_{sum(1 for p in self.pads if p.startswith('rtp_sink_'))}"
        idx = name.rsplit("_", 1)[1]
        sink = Pad(name, PadDirection.SINK,
                   PadTemplate("rtp_sink_%u", PadDirection.SINK, PadPresence.REQUEST, RTP_CAPS))
        sink.chain_function = lambda pad, buf, i=idx: self._rtp_chain(pad, buf, i)
        sink.event_function = lambda pad, ev, i=idx: self._rtp_event(pad, ev, i)
        sink.query_function = _fixed_caps_query(RTP_CAPS)
        self.add_pad(sink)
        src = Pad(f"rtp_src_{idx}", PadDirection.SRC,
                  PadTemplate("rtp_src_%u", PadDirection.SRC, PadPresence.SOMETIMES, RTP_CAPS))
        src.query_function = _fixed_caps_query(RTP_CAPS)
        self.add_pad(src)
        rtcp_src = Pad(f"rtcp_src_{idx}", PadDirection.SRC,
                       PadTemplate("rtcp_src_%u", PadDirection.SRC, PadPresence.SOMETIMES, RTCP_CAPS))
        rtcp_src.query_function = _fixed_caps_query(RTCP_CAPS)
        self.add_pad(rtcp_src)
        rtcp_sink = Pad(f"rtcp_sink_{idx}", PadDirection.SINK,
                        PadTemplate("rtcp_sink_%u", PadDirection.SINK,
                                    PadPresence.REQUEST, RTCP_CAPS))
        rtcp_sink.chain_function = lambda pad, buf, i=idx: self._rtcp_chain(pad, buf, i)
        rtcp_sink.event_function = lambda pad, ev: True
        rtcp_sink.query_function = _fixed_caps_query(RTCP_CAPS)
        self.add_pad(rtcp_sink)
        return sink

    # -- RTCP feedback in: NACK -> retransmit, TWCC -> upstream event --------
    # (incoming feedback is processed under either profile — liberal in
    # what we accept, like the reference session; the profile gates what
    # WE emit: reduced-size RTCP requires avpf, session.rs:944)
    def _rtcp_chain(self, pad: Pad, buf: Buffer, idx: str) -> FlowReturn:
        for pkt in rtcp.parse_compound(host_bytes(buf.data)):
            if isinstance(pkt, rtcp.GenericNack):
                self._handle_nack(pkt)
            elif isinstance(pkt, rtcp.TwccFeedback):
                self._handle_twcc(pkt, idx)
        return FlowReturn.OK

    def _handle_nack(self, nack: "rtcp.GenericNack") -> None:
        """RFC 4585 NACK -> retransmit from history, as an RFC 4588 RTX
        stream when rtx-pt is set (rtpbin2's send-side RTX machinery,
        net/rtp/src/rtpbin2/session.rs)."""
        st = self._streams.get(nack.media_ssrc)
        if st is None:
            return
        out = self.pad(f"rtp_src_{st.idx}")
        if out.peer is None:
            return
        rtx_pt = self.get_property("rtx-pt")
        for seq in nack.seqnums:
            wire = st.history.get(seq & 0xFFFF)
            if wire is None:
                continue  # aged out of history
            if rtx_pt:
                orig = RtpPacket.parse(wire)
                rtx_ssrc = self.get_property("rtx-ssrc") or ((orig.ssrc + 1) & 0xFFFFFFFF)
                rtx = RtpPacket(
                    payload_type=rtx_pt,
                    sequence_number=st.rtx_seq,
                    timestamp=orig.timestamp,
                    ssrc=rtx_ssrc,
                    # RFC 4588 §4: OSN in the first two payload bytes
                    payload=(orig.sequence_number & 0xFFFF).to_bytes(2, "big")
                    + orig.payload,
                    marker=orig.marker,
                )
                st.rtx_seq = (st.rtx_seq + 1) & 0xFFFF
                out.push(Buffer(np.frombuffer(rtx.to_bytes(), np.uint8)))
            else:
                out.push(Buffer(np.frombuffer(wire, np.uint8)))

    def _handle_twcc(self, fb: "rtcp.TwccFeedback", idx: str) -> None:
        """Correlate TWCC feedback with send records and hand the result to
        an upstream rtpgccbwe as the rtp-twcc-feedback event (gcc/imp.rs)."""
        packets = []
        for seq, arrival in fb.packets:
            rec = self._twcc_sent.get(seq)
            if rec is None:
                continue
            send_ns, size = rec
            packets.append((seq, send_ns, arrival, size))
        if not packets:
            return
        ev = Event(EventType.CUSTOM_UPSTREAM,
                   name="rtp-twcc-feedback", packets=packets)
        self.pad(f"rtp_sink_{idx}").push_event(ev)

    # first free rtp sink pad for `!`-style linking
    def link(self, downstream) -> None:
        src = next((p for p in self.src_pads()
                    if p.peer is None and p.name.startswith("rtp_src_")), None)
        if src is None:
            raise ValueError(f"{self.name}: no free rtp_src pad")
        sink = next((p for p in downstream.sink_pads() if p.peer is None), None)
        if sink is None and hasattr(downstream, "request_sink_pad"):
            sink = downstream.request_sink_pad()
        src.link(sink)

    def _rtp_event(self, pad: Pad, event: Event, idx: str) -> bool:
        return self.pad(f"rtp_src_{idx}").push_event(event)

    def _ensure_rtcp_stream(self, idx: str) -> Pad:
        pad = self.pad(f"rtcp_src_{idx}")
        if not self._rtcp_started.get(idx) and pad.peer is not None:
            self._rtcp_started[idx] = True
            pad.push_event(Event.new_stream_start(f"{self.name}-rtcp-{idx}"))
            pad.push_event(Event.new_caps(RTCP_CAPS))
            pad.push_event(Event.new_segment(Segment()))
        return pad

    def _handle_ssrc_collision(self, old: int) -> None:
        """RFC 3550 §8.2: a remote source chose one of our send SSRCs.
        Send BYE on the old identity with the standard reason, pick a new
        random SSRC and rewrite all subsequent outgoing packets to it
        (session.rs local-ssrc-collision handling)."""
        if old in self._ssrc_rewrite:
            return
        taken = set(self._streams) | set(self._ssrc_rewrite.values())
        new = old
        while new in taken or new == old:
            new = _random.getrandbits(32)
        st = self._streams.get(old)
        idx = st.idx if st is not None else "0"
        rtcp_pad = self._ensure_rtcp_stream(idx)
        if rtcp_pad.peer is not None:
            bye = rtcp.Bye([old], "ssrc collision detected")
            rtcp_pad.push(Buffer(np.frombuffer(bye.to_bytes(), np.uint8),
                                 pts=st.last_pts if st is not None else None))
        self._ssrc_rewrite[old] = new
        if st is not None:
            # the stream keeps its stats under the new identity; the NACK
            # history is invalid across the rename (different wire ssrc)
            st.history.clear()
            self._streams[new] = st
            del self._streams[old]
        log.warning("%s: ssrc collision on %#010x -> new ssrc %#010x",
                    self.name, old, new)

    def _rtp_chain(self, pad: Pad, buf: Buffer, idx: str) -> FlowReturn:
        wire = host_bytes(buf.data)
        pkt = RtpPacket.parse(wire)
        if pkt.ssrc in self._ssrc_rewrite:
            pkt.ssrc = self._ssrc_rewrite[pkt.ssrc]
            wire = pkt.to_bytes()
            out = Buffer(np.frombuffer(wire, np.uint8), pts=buf.pts,
                         duration=buf.duration)
            out.copy_metadata_from(buf)
            buf = out
        st = self._streams.setdefault(pkt.ssrc, _SendStream())
        st.idx = idx
        st.packet_count += 1
        st.octet_count += len(pkt.payload)
        st.last_rtp_ts = pkt.timestamp
        st.last_pts = buf.pts
        twcc_id = self.get_property("twcc-ext-id")
        if twcc_id and not _onebyte_profile_ok(pkt.extension):
            # The packet already carries a two-byte/unknown-profile header
            # extension; rewriting it as 0xBEDE would destroy it. Skip TWCC
            # stamping for this packet rather than corrupting the extension.
            if not self._twcc_profile_warned:
                self._twcc_profile_warned = True
                log.warning("%s: not stamping TWCC: packet has a non-one-byte "
                            "RTP header extension profile", self.name)
        elif twcc_id:
            # stamp the transport-wide sequence extension and record the
            # send time/size for later feedback correlation
            self._twcc_seq = (self._twcc_seq + 1) & 0xFFFF
            exts = parse_onebyte_extensions(pkt.extension)
            exts[twcc_id] = self._twcc_seq.to_bytes(2, "big")
            pkt.extension = build_onebyte_extensions(exts)
            wire = pkt.to_bytes()
            send_ns = buf.pts if buf.pts is not None else _time.monotonic_ns()
            self._twcc_sent[self._twcc_seq] = (send_ns, len(wire))
            while len(self._twcc_sent) > 2048:
                self._twcc_sent.popitem(last=False)
            out = Buffer(np.frombuffer(wire, np.uint8), pts=buf.pts,
                         duration=buf.duration)
            out.copy_metadata_from(buf)
            buf = out
        st.history[pkt.sequence_number & 0xFFFF] = wire
        while len(st.history) > self.get_property("history-size"):
            st.history.popitem(last=False)
        ret = self.pad(f"rtp_src_{idx}").push(buf)
        if ret != FlowReturn.OK:
            return ret
        # media-keyed reports keep their cadence; the clock timer (when a
        # clock exists) additionally guarantees reports while stalled
        # (RFC 3550 §6.3)
        if buf.pts is not None and buf.pts >= st.next_rtcp_pts:
            st.next_rtcp_pts = buf.pts + max(
                self.get_property("rtcp-interval"),
                self.get_property("min-rtcp-interval"))
            self._send_sr(idx, pkt.ssrc, st, buf.pts)
        return ret

    def _send_sr(self, idx: str, ssrc: int, st: _SendStream, pts: int) -> None:
        rtcp_pad = self._ensure_rtcp_stream(idx)
        if rtcp_pad.peer is None:
            return
        sr = rtcp.SenderReport(
            ssrc=ssrc,
            ntp_timestamp=rtcp.ntp_from_ns(_time.time_ns()),
            rtp_timestamp=st.last_rtp_ts,
            packet_count=st.packet_count,
            octet_count=st.octet_count,
        )
        data = sr.to_bytes()
        self._sr_count += 1
        # RFC 5506 reduced-size (avpf only, session.rs:944): SDES rides
        # only every fifth report
        reduced = self.get_property("reduced-size-rtcp") \
            and self.get_property("rtp-profile") == "avpf"
        if not reduced or self._sr_count % 5 == 1:
            cname = self.get_property("cname") or self.name
            data += rtcp.Sdes(ssrc, cname).to_bytes()
        rtcp_pad.push(Buffer(np.frombuffer(data, np.uint8), pts=pts))

    def on_paused_to_ready(self) -> None:
        self._streams.clear()
        self._rtcp_started.clear()


class ReferenceTimestampMeta:
    """NTP wall-clock reference for a buffer (GstReferenceTimestampMeta
    analog); timestamp is NTP-era ns reconstructed from sender reports."""

    def __init__(self, reference: str, timestamp: int):
        self.reference = reference
        self.timestamp = timestamp

    def __repr__(self):
        return f"ReferenceTimestampMeta({self.reference}, {self.timestamp})"


class _RecvStream:
    def __init__(self, latency: int) -> None:
        self.jb = JitterBuffer(latency)
        self.pad: Optional[Pad] = None
        self.packets = 0
        self.highest_seq: Optional[int] = None
        self.last_sr_ntp_middle = 0
        self.last_sr_ntp: Optional[int] = None  # full 64-bit NTP
        self.last_sr_rtp: Optional[int] = None
        self.first_rtp: Optional[int] = None
        self.first_pts: Optional[int] = None
        self.next_rtcp_pts = 0
        # seq -> time (ns) the last NACK for it was sent; entries are removed
        # on arrival and re-NACKed when older than NACK_RETRY_NS (the
        # reference rtpbin2 re-sends NACKs on a timer — session.rs)
        self.nacked: "OrderedDict[int, int]" = OrderedDict()
        self.cname: Optional[str] = None       # remote SDES CNAME
        self.last_arrival: Optional[int] = None  # clock time of last packet


@register
class RtpRecv(_GetSessionMixin, _RtcpTimerMixin, Element):
    ELEMENT_NAME = "rtprecv"
    EXTRA_PAD_TEMPLATES = [
        ('rtp_sink_%u', 'sink', 'request', 'application/x-rtp'),
        ('rtp_src_%u_%u_%u', 'src', 'sometimes', 'application/x-rtp'),
        ('rtcp_src_%u', 'src', 'sometimes', 'application/x-rtcp'),
        ('rtcp_sink_%u', 'sink', 'request', 'application/x-rtcp'),
    ]
    ELEMENT_CLASS = "Network/RTP/Session"
    SIGNALS = {"get-session": "get_session"}
    ELEMENT_DESCRIPTION = "RTP session receiver: SSRC demux + jitterbuffer + RTCP RRs"
    PROPERTIES = [
        Prop("latency", 0, type="uint64", doc="jitterbuffer latency in ns"),
        Prop("rtcp-interval", DEFAULT_RTCP_INTERVAL, type="uint64"),
        Prop("rtp-id", "rtp-id", type="str",
             doc="session id pairing this element with an rtpsend: NACK/"
                 "TWCC feedback arriving on this element's rtcp_sink is "
                 "forwarded to the paired sender (shared-session model)"),
        Prop("stats", None, type="object",
             doc="(read) per-ssrc received/lost/late/duplicate counters"),
        Prop("add-reference-timestamp-meta", False, type="bool",
             doc="attach ReferenceTimestampMeta with the NTP time "
                 "reconstructed from sender reports"),
        Prop("timestamping-mode", "skew", type="enum",
             choices=["arrival", "rtp", "skew"],
             doc="output pts source: arrival keeps upstream arrival "
                 "stamps, rtp derives pts from RTP timestamps anchored at "
                 "the first packet; skew behaves as rtp with the arrival "
                 "anchor re-synced on large drift"),
        Prop("enable-nack", False, type="bool",
             doc="send RFC 4585 Generic NACKs for detected seqnum gaps"),
        Prop("rtx-pt-map", "", type="str",
             doc="RFC 4588 RTX de-mapping, 'rtxpt=mediapt[,rtxpt=mediapt]'"),
        Prop("twcc-ext-id", 0, type="uint", maximum=14,
             doc="transport-wide-cc extension id to read (0 = off)"),
        Prop("twcc-feedback-count", 8, type="uint", minimum=1,
             doc="send TWCC feedback every N received packets"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._streams: Dict[int, _RecvStream] = {}  # ssrc -> state
        self._idx_for_ssrc: Dict[int, str] = {}
        self._rtcp_started: Dict[str, bool] = {}
        self._ssrc_recv = 0x0F0F0F0F  # our receiver SSRC in RRs
        self._media_ssrc_for_pt: Dict[int, int] = {}
        self._twcc_recv: List[Tuple[int, int]] = []  # (seq, arrival_ns)
        self._twcc_fb_count = 0
        self._rtcp_timer_init()
        _session_register(self.get_property("rtp-id"), "recv", self)

    def get_property(self, name: str):
        if name == "stats":
            from ...core.caps import Structure

            fields = {}
            for ssrc, st in self._streams.items():
                fields[f"ssrc-{ssrc}"] = Structure(
                    "source-stats",
                    **{"packets-received": st.packets,
                       "lost": st.jb.num_lost,
                       "late": st.jb.num_late_dropped,
                       "duplicates": st.jb.num_duplicates,
                       **({"cname": st.cname} if st.cname else {})})
            return Structure("rtprecv-stats", **fields)
        return super().get_property(name)

    def _rtcp_timer_tick(self) -> None:
        """Clock-scheduled RRs for every stream — a stalled upstream still
        gets reception reports.  Also expires sources idle for more than
        five report intervals (RFC 3550 §6.3.5 timeout; the reference
        emits timeout-ssrc on its session — session.rs)."""
        now = self.running_time()
        timeout = 5 * self.get_property("rtcp-interval")
        clock_now = self.clock.now() if self.clock is not None else None
        for ssrc, st in list(self._streams.items()):
            if (clock_now is not None and st.last_arrival is not None
                    and clock_now - st.last_arrival > timeout):
                self._streams.pop(ssrc, None)
                self._idx_for_ssrc.pop(ssrc, None)
                if st.pad is not None and st.pad.peer is not None:
                    for item in st.jb.flush():
                        st.pad.push(item)
                _session_state(self.get_property("rtp-id")).emit(
                    "timeout-ssrc", ssrc)
                continue
            idx = self._idx_for_ssrc.get(ssrc)
            if idx is not None:
                self._send_rr(idx, ssrc, st, now)

    def request_pad(self, template_name: str = "rtp_sink_%u") -> Pad:
        return self.request_sink_pad()

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        if name is None:
            name = f"rtp_sink_{sum(1 for p in self.pads if p.startswith('rtp_sink_'))}"
        idx = name.rsplit("_", 1)[1]
        sink = Pad(name, PadDirection.SINK,
                   PadTemplate("rtp_sink_%u", PadDirection.SINK, PadPresence.REQUEST, RTP_CAPS))
        sink.chain_function = lambda pad, buf, i=idx: self._rtp_chain(pad, buf, i)
        sink.event_function = lambda pad, ev, i=idx: self._rtp_event(pad, ev, i)
        sink.query_function = _fixed_caps_query(RTP_CAPS)
        self.add_pad(sink)
        rtcp_sink = Pad(f"rtcp_sink_{idx}", PadDirection.SINK,
                        PadTemplate("rtcp_sink_%u", PadDirection.SINK, PadPresence.REQUEST, RTCP_CAPS))
        rtcp_sink.chain_function = self._rtcp_chain
        rtcp_sink.event_function = lambda pad, ev: True
        rtcp_sink.query_function = _fixed_caps_query(RTCP_CAPS)
        self.add_pad(rtcp_sink)
        rtcp_src = Pad(f"rtcp_src_{idx}", PadDirection.SRC,
                       PadTemplate("rtcp_src_%u", PadDirection.SRC, PadPresence.SOMETIMES, RTCP_CAPS))
        rtcp_src.query_function = _fixed_caps_query(RTCP_CAPS)
        self.add_pad(rtcp_src)
        return sink

    def _stream_pad(self, idx: str, pkt: RtpPacket, caps: Optional[Caps]) -> Pad:
        st = self._streams[pkt.ssrc]
        if st.pad is None:
            # sometimes-pad per (session, ssrc, pt) like rtprecv.rs
            name = f"rtp_src_{idx}_{pkt.ssrc}_{pkt.payload_type}"
            pad = Pad(name, PadDirection.SRC,
                      PadTemplate("rtp_src_%u_%u_%u", PadDirection.SRC,
                                  PadPresence.SOMETIMES, RTP_CAPS))
            self.add_pad(pad)
            # auto-link to a free downstream-style pad if the element was
            # linked before the ssrc appeared
            if self._pending_peer is not None and self._pending_peer.peer is None:
                pad.link(self._pending_peer)
            if pad.peer is not None:
                # session pt-map takes precedence over upstream caps when
                # the application registered caps for this payload type
                mapped = _session_state(self.get_property("rtp-id")) \
                    .pt_map.get(pkt.payload_type)
                pad.push_event(Event.new_stream_start(f"{self.name}-{pkt.ssrc}"))
                pad.push_event(Event.new_caps(mapped or caps or RTP_CAPS))
                pad.push_event(Event.new_segment(Segment()))
            st.pad = pad
        return st.pad

    _pending_peer: Optional[Pad] = None

    def link(self, downstream) -> None:
        """`rtprecv ! elem` defers linking until the first SSRC pad appears."""
        sink = next((p for p in downstream.sink_pads() if p.peer is None), None)
        if sink is None and hasattr(downstream, "request_sink_pad"):
            sink = downstream.request_sink_pad()
        self._pending_peer = sink

    def _rtp_event(self, pad: Pad, event: Event, idx: str) -> bool:
        if event.type == EventType.EOS:
            for ssrc, st in self._streams.items():
                for item in st.jb.flush():
                    if st.pad is not None and st.pad.peer is not None:
                        st.pad.push(item)
            ok = True
            for ssrc, st in self._streams.items():
                if st.pad is not None and st.pad.peer is not None:
                    ok = st.pad.push_event(event) and ok
            return ok
        if event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT):
            return True  # per-ssrc pads get their own
        ok = True
        for st in self._streams.values():
            if st.pad is not None and st.pad.peer is not None:
                ok = st.pad.push_event(event) and ok
        return ok

    def _rtx_map(self) -> Dict[int, int]:
        # parsed once per property change, not per packet (hot receive path)
        cached = getattr(self, "_rtx_map_cache", None)
        if cached is not None:
            return cached
        out: Dict[int, int] = {}
        for part in self.get_property("rtx-pt-map").split(","):
            if "=" in part:
                a, b = part.split("=", 1)
                out[int(a)] = int(b)
        self._rtx_map_cache = out
        return out

    def property_changed(self, name: str, value) -> None:
        if name == "rtx-pt-map":
            self._rtx_map_cache = None
        elif name == "rtp-id":
            _session_register(value, "recv", self)

    def _rtcp_out(self, idx: str) -> Optional[Pad]:
        pad = self.pads.get(f"rtcp_src_{idx}")
        if pad is None or pad.peer is None:
            return None
        if not self._rtcp_started.get(idx):
            self._rtcp_started[idx] = True
            pad.push_event(Event.new_stream_start(f"{self.name}-rtcp-{idx}"))
            pad.push_event(Event.new_caps(RTCP_CAPS))
            pad.push_event(Event.new_segment(Segment()))
        return pad

    def _rtp_chain(self, pad: Pad, buf: Buffer, idx: str) -> FlowReturn:
        wire = host_bytes(buf.data)
        pkt = RtpPacket.parse(wire)
        # RFC 3550 §8.2 third-party collision with one of the paired send
        # half's source identifiers.  A packet that is byte-equal to one
        # the send half recently emitted is our own data looped back (the
        # "same source transport address" case) and is processed normally;
        # a DIFFERENT packet under our SSRC forces the sender to
        # re-identify (session.rs collision handling).
        peer = _session_peer(self.get_property("rtp-id"), "send")
        if peer is not None and pkt.ssrc in peer._streams:
            sent = peer._streams[pkt.ssrc].history.get(
                pkt.sequence_number & 0xFFFF)
            if sent is not None and sent != wire:
                peer._handle_ssrc_collision(pkt.ssrc)
        rtx_map = self._rtx_map()
        if pkt.payload_type in rtx_map:
            # RFC 4588 §4: original seqnum in the first two payload bytes;
            # reconstruct the media packet and process it normally
            if len(pkt.payload) < 2:
                return FlowReturn.OK
            osn = int.from_bytes(pkt.payload[:2], "big")
            media_pt = rtx_map[pkt.payload_type]
            media_ssrc = self._media_ssrc_for_pt.get(media_pt)
            if media_ssrc is None:
                return FlowReturn.OK  # no media stream to repair yet
            pkt = RtpPacket(
                payload_type=media_pt, sequence_number=osn,
                timestamp=pkt.timestamp, ssrc=media_ssrc,
                payload=pkt.payload[2:], marker=pkt.marker)
            rep = Buffer(np.frombuffer(pkt.to_bytes(), np.uint8), pts=buf.pts,
                         duration=buf.duration)
            buf = rep
        else:
            self._media_ssrc_for_pt.setdefault(pkt.payload_type, pkt.ssrc)
        if pkt.ssrc not in self._streams:
            self._streams[pkt.ssrc] = _RecvStream(self.get_property("latency"))
            self._idx_for_ssrc[pkt.ssrc] = idx
            _session_state(self.get_property("rtp-id")).emit(
                "new-ssrc", pkt.ssrc)
        st = self._streams[pkt.ssrc]
        st.packets += 1
        if self.clock is not None:
            st.last_arrival = self.clock.now()
        # TWCC arrival bookkeeping (feedback generated on the rtcp pad)
        twcc_id = self.get_property("twcc-ext-id")
        if twcc_id:
            ext = parse_onebyte_extensions(pkt.extension).get(twcc_id)
            if ext is not None and len(ext) >= 2:
                arrival = buf.pts
                if arrival is None and self.clock is not None:
                    arrival = self.clock.now()
                if arrival is not None:
                    self._twcc_recv.append(
                        (int.from_bytes(ext[:2], "big"), arrival))
                    if len(self._twcc_recv) >= self.get_property("twcc-feedback-count"):
                        self._send_twcc(idx, pkt.ssrc)
        # NACK generation on seq gaps (RFC 4585 §6.2.1)
        if self.get_property("enable-nack"):
            seq = pkt.sequence_number
            now = buf.pts
            if now is None:
                now = self.clock.now() if self.clock is not None else 0
            # a (re)transmission arriving repairs the hole: stop tracking it
            st.nacked.pop(seq, None)
            missing: List[int] = []
            if st.highest_seq is not None:
                delta = (seq - st.highest_seq) & 0xFFFF
                if 1 < delta < 0x8000:
                    missing = [(st.highest_seq + k) & 0xFFFF
                               for k in range(1, delta)
                               if (st.highest_seq + k) & 0xFFFF
                               not in st.nacked]
            # age out earlier NACKs whose retransmission was itself lost:
            # past the retry deadline the seq is eligible to be re-requested
            retry = [s for s, t in st.nacked.items()
                     if now - t >= NACK_RETRY_NS]
            missing.extend(retry)
            if missing:
                for s in missing:
                    st.nacked.pop(s, None)
                    st.nacked[s] = now
                while len(st.nacked) > 1024:
                    st.nacked.popitem(last=False)
                out = self._rtcp_out(idx)
                if out is not None:
                    nack = rtcp.GenericNack(
                        self._ssrc_recv, pkt.ssrc, missing)
                    out.push(Buffer(
                        np.frombuffer(nack.to_bytes(), np.uint8),
                        pts=buf.pts))
            if st.highest_seq is None or ((seq - st.highest_seq) & 0xFFFF) < 0x8000:
                st.highest_seq = seq
        # timestamping-mode: rtp/skew derive pts from RTP timestamps
        # anchored at the first packet's arrival pts (rtpbin2 sync.rs);
        # arrival keeps the upstream stamps untouched
        mode = self.get_property("timestamping-mode")
        clock_rate = (pad.current_caps.structure(0).get("clock-rate", 90000)
                      if pad.current_caps is not None else 90000)
        if mode in ("rtp", "skew") and buf.pts is not None:
            if st.first_rtp is None:
                st.first_rtp = pkt.timestamp
                st.first_pts = buf.pts
            rtp_pts = st.first_pts + ((pkt.timestamp - st.first_rtp)
                                      & 0xFFFFFFFF) * SECOND // clock_rate
            if mode == "skew" and abs(rtp_pts - buf.pts) > SECOND:
                st.first_rtp = pkt.timestamp  # re-anchor on gross drift
                st.first_pts = buf.pts
                rtp_pts = buf.pts
            buf.pts = rtp_pts
        if self.get_property("add-reference-timestamp-meta") \
                and st.last_sr_ntp is not None and st.last_sr_rtp is not None:
            delta = ((pkt.timestamp - st.last_sr_rtp) & 0xFFFFFFFF)
            ntp_ns = rtcp.ns_from_ntp(st.last_sr_ntp) + delta * SECOND // clock_rate
            buf.add_meta(ReferenceTimestampMeta("timestamp/x-ntp", ntp_ns))
        out_pad = self._stream_pad(idx, pkt, pad.current_caps)
        ret = FlowReturn.OK
        for item in st.jb.insert(pkt.sequence_number, buf, buf.pts):
            if out_pad.peer is not None:
                r = out_pad.push(item)
                if r != FlowReturn.OK:
                    ret = r
        if buf.pts is not None and buf.pts >= st.next_rtcp_pts:
            st.next_rtcp_pts = buf.pts + self.get_property("rtcp-interval")
            self._send_rr(idx, pkt.ssrc, st, buf.pts)
        return ret

    def _send_twcc(self, idx: str, media_ssrc: int) -> None:
        out = self._rtcp_out(idx)
        recv, self._twcc_recv = self._twcc_recv, []
        if out is None or not recv:
            return
        # unwrap the 16-bit seqs around the first entry so a window that
        # straddles 65535 -> 0 stays a handful of entries, not ~65536
        base = recv[0][0]

        def unwrap(s: int) -> int:
            d = (s - base) & 0xFFFF
            return base + (d - 0x10000 if d >= 0x8000 else d)

        seqs = {unwrap(s): a for s, a in recv}
        lo, hi = min(seqs), max(seqs)
        if hi - lo > 512:
            return  # wildly disjoint window (stream reset): drop the batch
        packets = [((s & 0xFFFF), seqs.get(s)) for s in range(lo, hi + 1)]
        fb = rtcp.TwccFeedback(self._ssrc_recv, media_ssrc,
                               self._twcc_fb_count & 0xFF, packets)
        self._twcc_fb_count += 1
        out.push(Buffer(np.frombuffer(fb.to_bytes(), np.uint8)))

    def _send_rr(self, idx: str, ssrc: int, st: _RecvStream, pts: int) -> None:
        pad = self.pads.get(f"rtcp_src_{idx}")
        if pad is None or pad.peer is None:
            return
        if not self._rtcp_started.get(idx):
            self._rtcp_started[idx] = True
            pad.push_event(Event.new_stream_start(f"{self.name}-rtcp-{idx}"))
            pad.push_event(Event.new_caps(RTCP_CAPS))
            pad.push_event(Event.new_segment(Segment()))
        expected = st.packets + st.jb.num_lost
        frac = min(255, st.jb.num_lost * 256 // max(expected, 1))
        rr = rtcp.ReceiverReport(
            self._ssrc_recv,
            [rtcp.ReportBlock(
                ssrc, frac, st.jb.num_lost,
                st.jb._tracker.ext or 0, 0, st.last_sr_ntp_middle, 0,
            )],
        )
        pad.push(Buffer(np.frombuffer(rr.to_bytes(), np.uint8), pts=pts))

    def _rtcp_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        for pkt in rtcp.parse_compound(host_bytes(buf.data)):
            if isinstance(pkt, rtcp.SenderReport) and pkt.ssrc in self._streams:
                st = self._streams[pkt.ssrc]
                st.last_sr_ntp_middle = (pkt.ntp_timestamp >> 16) & 0xFFFFFFFF
                st.last_sr_ntp = pkt.ntp_timestamp
                st.last_sr_rtp = pkt.rtp_timestamp
            elif isinstance(pkt, (rtcp.GenericNack, rtcp.TwccFeedback)):
                # shared-session model: feedback for the SEND half arriving
                # on the recv half's rtcp socket reaches the paired rtpsend
                peer = _session_peer(self.get_property("rtp-id"), "send")
                if peer is not None:
                    if isinstance(pkt, rtcp.GenericNack):
                        peer._handle_nack(pkt)
                    else:
                        peer._handle_twcc(pkt, "0")
            elif isinstance(pkt, rtcp.Sdes):
                # surface the remote CNAME in stats (session.rs SDES items)
                st = self._streams.get(pkt.ssrc)
                if st is not None and pkt.cname:
                    st.cname = pkt.cname
            elif isinstance(pkt, rtcp.Bye):
                for ssrc in pkt.ssrcs:
                    st = self._streams.pop(ssrc, None)  # tear the stream down
                    self._idx_for_ssrc.pop(ssrc, None)
                    if st is not None and st.pad is not None and st.pad.peer is not None:
                        for item in st.jb.flush():
                            st.pad.push(item)
                        st.pad.push_event(Event.new_eos())
                    # reason propagated to the session signal (RFC 3550
                    # §6.6 BYE reason; session.rs bye handling)
                    _session_state(self.get_property("rtp-id")).emit(
                        "bye-ssrc", ssrc, pkt.reason)
        return FlowReturn.OK

    def on_paused_to_ready(self) -> None:
        self._streams.clear()
        self._idx_for_ssrc.clear()
        self._rtcp_started.clear()


@register
class TsJitterBuffer(Element):
    """Standalone jitterbuffer element (threadshare ts-jitterbuffer analog,
    generic/threadshare/src/jitterbuffer/)."""

    ELEMENT_NAME = "ts-jitterbuffer"
    ELEMENT_CLASS = "Network/RTP"
    SIGNALS = {
        "clear-pt-map": "clear_pt_map",
        "request-pt-map": None,  # request: app answers with caps for a pt
    }
    ELEMENT_DESCRIPTION = "Reorders RTP packets by seqnum within a latency window"
    PROPERTIES = [
        Prop("latency", 200_000_000, type="uint64", doc="reorder window in ns"),
        Prop("context", "", type="str",
             doc="Context name to share threads with (parity; this element "
                 "runs on the caller's thread, timers on the clock)"),
        Prop("context-wait", 5, type="uint", maximum=1000,
             doc="Throttle the context loop (parity, see context)"),
        Prop("do-lost", False, type="bool",
             doc="Send a GAP event downstream when packets are declared lost"),
        Prop("max-dropout-time", 60_000, type="uint",
             doc="max ms of missing packets tolerated before resync"),
        Prop("max-misorder-time", 2_000, type="uint",
             doc="max ms of misordered packets tolerated before resync"),
        Prop("stats", None, type="object",
             doc="(read) num-pushed/num-lost/num-late/num-duplicates"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        import threading

        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._jb = JitterBuffer(self.get_property("latency"))
        self._lock = threading.RLock()
        self._timer_id = None
        self._num_pushed = 0
        self._last_seq: Optional[int] = None
        self._last_pts: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        self._jb = JitterBuffer(self.get_property("latency"))
        self._num_pushed = 0
        self._last_seq = None
        self._last_pts = None

    def clear_pt_map(self) -> None:
        """`clear-pt-map` action: drop cached pt->caps answers, so the
        next unknown pt re-emits request-pt-map."""
        self._pt_map = {}

    def pt_caps(self, pt: int):
        """caps for a payload type: cached, else ask the request-pt-map
        handler (jitterbuffer pt-map model)."""
        cache = getattr(self, "_pt_map", None)
        if cache is None:
            cache = self._pt_map = {}
        if pt not in cache:
            cache[pt] = self.emit("request-pt-map", pt)
        return cache[pt]

    def get_property(self, name: str):
        if name == "stats":
            from ...core.caps import Structure

            return Structure(
                "ts-jitterbuffer-stats",
                **{"num-pushed": self._num_pushed,
                   "num-lost": self._jb.num_lost,
                   "num-late": self._jb.num_late_dropped,
                   "num-duplicates": self._jb.num_duplicates})
        return super().get_property(name)

    def on_playing_to_paused(self) -> None:
        with self._lock:
            if self._timer_id is not None:
                self._timer_id.unschedule()
                self._timer_id = None

    # -- clock-armed lost timers (rtpbin2/jitterbuffer.rs timer model):
    # a held gap flushes when its deadline passes even with no new arrivals
    def _arm_timer(self) -> None:
        if self.clock is None:
            return
        with self._lock:
            deadline = self._jb.next_deadline()
            if self._timer_id is not None:
                self._timer_id.unschedule()
                self._timer_id = None
            if deadline is None:
                return
            cid = self.clock.new_single_shot_id(deadline)
            self._timer_id = cid
            cid.wait_async(self._on_timer)

    def _on_timer(self, cid) -> None:
        # pushes stay inside the lock: ordering is this element's whole
        # contract, so the timer thread and streaming thread must not
        # interleave their srcpad.push calls
        with self._lock:
            if cid is not self._timer_id or cid._unscheduled:
                return
            self._timer_id = None
            self._push_released(self._jb.release_expired(self.clock.now()))
        self._arm_timer()

    def _maybe_resync(self, seq: int, pts: Optional[int]) -> None:
        """Reference dropout/misorder resync: a forward gap longer than
        max-dropout-time, or stale backward packets older than
        max-misorder-time, restart the buffer as a new stream."""
        if self._last_seq is None or pts is None or self._last_pts is None:
            return
        dist = ((seq - self._last_seq + 0x8000) & 0xFFFF) - 0x8000
        if dist > 0 and pts - self._last_pts > \
                self.get_property("max-dropout-time") * 1_000_000:
            self._jb = JitterBuffer(self.get_property("latency"))
        elif dist < 0 and self._last_pts - pts > \
                self.get_property("max-misorder-time") * 1_000_000:
            self._jb = JitterBuffer(self.get_property("latency"))

    def _push_released(self, items) -> FlowReturn:
        """Push released packets, emitting GAP events on fresh losses when
        do-lost is set. Caller holds the lock."""
        ret = FlowReturn.OK
        do_lost = self.get_property("do-lost")
        for item in items:
            if do_lost and self._jb.num_lost > getattr(self, "_lost_seen", 0):
                self._lost_seen = self._jb.num_lost
                if getattr(item, "pts", None) is not None:
                    self.srcpad.push_event(Event.new_gap(item.pts, 0))
            r = self.srcpad.push(item)
            self._num_pushed += 1
            if r != FlowReturn.OK:
                ret = r
        if do_lost:
            self._lost_seen = self._jb.num_lost
        return ret

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        pkt = RtpPacket.parse(host_bytes(buf.data))
        arrival = self.clock.now() if self.clock is not None else None
        with self._lock:
            self._maybe_resync(pkt.sequence_number, buf.pts)
            self._last_seq = pkt.sequence_number
            if buf.pts is not None:
                self._last_pts = buf.pts
            ret = self._push_released(
                self._jb.insert(pkt.sequence_number, buf, buf.pts,
                                arrival=arrival))
        self._arm_timer()
        return ret

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            with self._lock:
                self._push_released(self._jb.flush())
        return self.srcpad.push_event(event)


__all__ = ["RtpSend", "RtpRecv", "TsJitterBuffer"]
