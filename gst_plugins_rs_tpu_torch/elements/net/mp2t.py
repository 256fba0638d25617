"""MPEG-TS carriage elements: rtpmp2tpay2, rtpmp2tdepay2, mpegtslivesrc.

Parity targets: net/rtp/src/mp2t (whole-TS-packet RTP carriage, static PT
33, 7x188 = 1316-byte payloads, mp2t/pay/imp.rs:37-42; packetsize list
188/192/204/208, pay/imp.rs:167) and net/mpegtslive (mpegtslivesrc,
imp.rs:41: live source smoothing timestamps from the PCR).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ...core import Buffer, Caps, Prop, register
from ...core.caps import Structure, ValueList
from ...core.payload import host_bytes
from ...mux import mpegts
from ...net.rtp import RtpPacket
from .rtppay import RtpBaseDepay, RtpBasePay
from .udp import _UdpSrcBase

MP2T_CAPS = Caps(
    [Structure("video/mpegts", systemstream=True,
               packetsize=ValueList([188, 192, 204, 208]))]
)


@register
class RtpMp2tPay(RtpBasePay):
    ELEMENT_NAME = "rtpmp2tpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload MPEG-TS packets into RTP (RFC 2250)"
    DEFAULT_PT = 33  # static MP2T assignment
    SINK_CAPS = MP2T_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()
        self._psize = 188

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()

    def rtp_structure(self, s: Structure) -> Structure:
        self._psize = s.get("packetsize", 188)
        return Structure(
            "application/x-rtp", media="video",
            **{"encoding-name": "MP2T", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        self._acc += host_bytes(buf.data, np.uint8)
        per_rtp = max(self.max_payload_size() // self._psize, 1)  # 7 at mtu 1400
        chunk = per_rtp * self._psize
        while len(self._acc) >= chunk:
            self.queue_packet(bytes(self._acc[:chunk]), pts=buf.pts)
            del self._acc[:chunk]

    def drain(self) -> Optional[Buffer]:
        # flush remaining whole TS packets at EOS
        whole = (len(self._acc) // self._psize) * self._psize
        if whole:
            self.queue_packet(bytes(self._acc[:whole]), pts=None)
            del self._acc[:whole]
        return self._packets.popleft() if self._packets else None


@register
class RtpMp2tDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpmp2tdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload MPEG-TS packets from RTP (RFC 2250)"
    SRC_CAPS = MP2T_CAPS
    PROPERTIES = RtpBaseDepay.PROPERTIES + [
        Prop("skip-first-bytes", 0, type="uint",
             doc="bytes to strip from each payload before the TS packets "
                 "(header extensions some encoders prepend)"),
    ]

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/mpegts", systemstream=True, packetsize=188)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        payload = pkt.payload[self.get_property("skip-first-bytes"):]
        # drop bytes before the first sync (resynchronization)
        start = payload.find(bytes([mpegts.SYNC_BYTE]))
        if start < 0:
            return None
        whole = ((len(payload) - start) // 188) * 188
        if not whole:
            return None
        out.data = np.frombuffer(payload[start : start + whole], np.uint8)
        return out


@register
class MpegTsLiveSrc(_UdpSrcBase):
    """Live MPEG-TS over UDP with PCR-derived timestamps: buffers get pts
    from the most recent program clock reference so downstream sees a
    smooth live timeline (reference net/mpegtslive/src/mpegtslive/imp.rs —
    it wraps an inner source and rewrites timestamps from PCR/PTS)."""

    ELEMENT_NAME = "mpegtslivesrc"
    ELEMENT_CLASS = "Source/Network"
    ELEMENT_DESCRIPTION = "Receives live MPEG-TS over UDP, timestamps from PCR"
    IS_LIVE = True
    PROPERTIES = _UdpSrcBase.PROPERTIES + [
        Prop("source", None, type="object",
             doc="(read) the inner source element — the UDP receive path "
                 "is built in here, so this element itself is returned"),
        Prop("window-size", 32, type="int", minimum=2, maximum=1024,
             doc="number of PCR observations used to estimate clock rate "
                 "and offset"),
    ]

    def get_property(self, name: str):
        if name == "source":
            return self
        return super().get_property(name)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._first_pcr: Optional[int] = None
        self._last_pts = 0
        self._pcr_window: List[Tuple[int, int]] = []  # (pcr_ns, mono_ns)

    def start(self) -> None:
        super().start()
        self._first_pcr = None
        self._last_pts = 0
        self._pcr_window = []

    def fixate(self, caps: Caps) -> Caps:
        configured = self.get_property("caps")
        if configured is not None:
            return super().fixate(caps)
        return Caps.builder("video/mpegts", systemstream=True, packetsize=188)

    def create(self) -> Optional[Buffer]:
        buf = super().create()
        if buf is None:
            return None
        data = host_bytes(buf.data, np.uint8)
        pcr = None
        for pkt in mpegts.iter_packets(data):
            if pkt.pcr is not None:
                pcr = pkt.pcr
        if pcr is not None:
            if self._first_pcr is None:
                self._first_pcr = pcr
            # PCR wraps at 2^33*300; unwrap relative to the first seen
            delta = pcr - self._first_pcr
            if delta < 0:
                delta += (1 << 33) * 300
            pcr_ns = mpegts.pcr_to_ns(delta)
            # window-size PCR observations estimate the sender-clock rate
            # vs local time; the slope correction smooths sender drift
            # (mpegtslive/imp.rs rate/offset window)
            import time as _t

            self._pcr_window.append((pcr_ns, _t.monotonic_ns()))
            win = self.get_property("window-size")
            if len(self._pcr_window) > win:
                self._pcr_window = self._pcr_window[-win:]
            if len(self._pcr_window) >= 2:
                (p0, m0), (p1, m1) = self._pcr_window[0], self._pcr_window[-1]
                # the slope is only meaningful once the observations span
                # real time on BOTH clocks (bursty arrival otherwise
                # collapses the local span and fabricates drift)
                if p1 - p0 >= 1_000_000_000 and m1 - m0 > 0:
                    rate = (m1 - m0) / (p1 - p0)  # local ns per PCR ns
                    # a genuine sender-clock drift is tiny; anything larger
                    # is burst/jitter in the arrival times — don't "correct"
                    if abs(rate - 1.0) <= 0.001:
                        pcr_ns = p0 + int((pcr_ns - p0) * rate)
            self._last_pts = pcr_ns
        buf.pts = self._last_pts
        return buf


__all__ = ["RtpMp2tPay", "RtpMp2tDepay", "MpegTsLiveSrc"]
