"""mpegtsmux: MPEG transport stream muxer over the TS layer in mux/mpegts.py.

The reference has no in-repo TS muxer (its hlssink3 drives the external
mpegtsmux element); this one exists so hlssink3/rtpmp2tpay2/mpegtslivesrc
chains close end-to-end inside the framework.  Emits PAT/PMT every
`pat-interval` packets, PES-packetizes each input with 90 kHz PTS, and
stamps PCR from the first stream onto its PES-start packets.

Stream types: video/x-h264 -> 0x1B, video/mpeg -> 0x02, audio/mpeg v1 ->
0x03 / v4 -> 0x0F, audio/x-ac3 -> 0x81, meta/x-klv -> 0x06 (private PES),
anything else -> 0x06.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ...core import (
    Buffer,
    BufferFlags,
    Caps,
    FlowReturn,
    Prop,
    register,
)
from ...core.aggregator import Aggregator, AggregatorPad
from ...core.caps import Structure
from ...core.events import Event, Segment
from ...core.payload import host_bytes
from ...mux import mpegts

TS_CAPS = Caps.builder("video/mpegts", systemstream=True, packetsize=188)

_STREAM_TYPES = [
    ("video/x-h264", 0x1B),
    ("video/mpeg", 0x02),
    ("audio/x-ac3", 0x81),
    ("meta/x-klv", 0x06),
]


def _stream_type(s: Structure) -> int:
    if s.name == "audio/mpeg":
        return 0x0F if s.get("mpegversion", 1) == 4 else 0x03
    for name, stype in _STREAM_TYPES:
        if s.name == name:
            return stype
    return 0x06  # private PES


def _stream_id(stype: int, index: int) -> int:
    if stype in (0x02, 0x1B):
        return 0xE0 + (index & 0x0F)  # video
    if stype in (0x03, 0x0F):
        return 0xC0 + (index & 0x1F)  # audio
    return 0xBD  # private stream 1


@register
class MpegTsMux(Aggregator):
    ELEMENT_NAME = "mpegtsmux"
    ELEMENT_CLASS = "Muxer"
    ELEMENT_DESCRIPTION = "Muxes streams into an MPEG transport stream"
    SRC_TEMPLATE_CAPS = TS_CAPS
    PROPERTIES = [
        Prop("pat-interval", 100, type="uint", minimum=1,
             doc="emit PAT/PMT every N output packets"),
        Prop("pmt-pid", 0x100, type="uint"),
        Prop("start-pid", 0x101, type="uint", doc="first elementary PID"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._configured = False
        self._cc: Dict[int, int] = {}
        self._since_pat = 10**9
        self._sent_caps = False
        self._pkt_count = 0

    def on_paused_to_ready(self) -> None:
        self._configured = False
        self._cc = {}
        self._since_pat = 10**9
        self._sent_caps = False
        self._pkt_count = 0

    def _pid_of(self, pad: AggregatorPad) -> int:
        return self.get_property("start-pid") + self.agg_pads().index(pad)

    def _psi(self) -> bytes:
        pmt_pid = self.get_property("pmt-pid")
        streams = []
        pcr_pid = None
        for pad in self.agg_pads():
            if pad.current_caps is None:
                continue
            pid = self._pid_of(pad)
            streams.append((_stream_type(pad.current_caps.structure(0)), pid))
            if pcr_pid is None:
                pcr_pid = pid
        pat = mpegts.build_pat(pmt_pid=pmt_pid)
        pmt = mpegts.build_pmt(streams, pmt_pid=pmt_pid, pcr_pid=pcr_pid or pmt_pid)
        return pat + pmt

    def _emit(self, data: bytes, pts, *, has_psi: bool) -> FlowReturn:
        if not self._sent_caps:
            self._sent_caps = True
            self.srcpad.push_event(Event.new_caps(TS_CAPS))
            self.srcpad.push_event(Event.new_segment(Segment()))
        self._pkt_count += len(data) // mpegts.TS_PACKET_SIZE
        buf = Buffer(np.frombuffer(data, np.uint8), pts=pts)
        if not has_psi:
            # segmenters (hlssink3) cut at non-DELTA boundaries = PAT/PMT
            buf.set_flag(BufferFlags.DELTA_UNIT)
        return self.finish_buffer(buf)

    def aggregate(self, timeout: bool) -> FlowReturn:
        pads = [p for p in self.agg_pads() if p.has_buffer()]
        if not pads:
            return FlowReturn.OK
        if any(p.current_caps is None for p in self.agg_pads()):
            return FlowReturn.OK
        # earliest-pts buffer first
        pad = min(pads, key=lambda p: p.peek_buffer().pts or 0)
        buf = pad.pop_buffer()
        out = bytearray()
        has_psi = self._since_pat >= self.get_property("pat-interval")
        if has_psi:
            out += self._psi()
            self._since_pat = 0
        pid = self._pid_of(pad)
        stype = _stream_type(pad.current_caps.structure(0))
        sid = _stream_id(stype, self.agg_pads().index(pad))
        d = buf.data
        payload = d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
        pts_90k = None if buf.pts is None else buf.pts * 90000 // 1_000_000_000
        pes = mpegts.build_pes(sid, payload, pts_90k=pts_90k)
        cc = self._cc.get(pid, 0)
        pkts = mpegts.packetize_pes(pid, pes, continuity_start=cc)
        self._cc[pid] = (cc + len(pkts)) & 0xF
        # PCR rides the first stream's PES-start packet
        if pad is self.agg_pads()[0] and buf.pts is not None:
            pcr_pkt = mpegts.build_packet(
                pid, b"", continuity=cc, pcr=buf.pts * 27_000_000 // 1_000_000_000
            )
            # adaptation-only packet does not consume a continuity increment
            out += pcr_pkt
        for p in pkts:
            out += p
        self._since_pat += len(out) // mpegts.TS_PACKET_SIZE
        return self._emit(bytes(out), buf.pts, has_psi=has_psi)


__all__ = ["MpegTsMux"]
