"""RTP pay/depay pairs for compressed codecs: Opus (RFC 7587), AC-3
(RFC 4184), MPEG audio (RFC 2250), MPEG video (RFC 2250), AMR (RFC 4867).

Parity targets: net/rtp/src/{opus,ac3,mpa,mpv,amr} pay/depay pairs
(element names rtpopuspay2/..., lib.rs:74-110).  The payloads are opaque
encoded frames — the encoders themselves live outside this framework (as
they do outside the reference) — so pay/depay operate on framed input
buffers and the tests drive them with synthetic frames; the RTP-level
framing (headers, fragmentation, marker semantics) follows each RFC.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from ...core import Buffer, BufferFlags, Caps, IntRange, Prop, register
from ...core.caps import Structure
from ...core.payload import host_bytes
from ...net.rtp import RtpPacket
from .rtppay import (
    AGGREGATE_PROPS,
    RtpAggregateMixin,
    RtpBaseDepay,
    RtpBasePay,
)

SECOND = 1_000_000_000


def _bytes_of(buf: Buffer) -> bytes:
    d = buf.data
    return d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)


# ---------------------------------------------------------------------------
# Opus — RFC 7587: one Opus packet per RTP packet, clock rate always 48000
# ---------------------------------------------------------------------------
OPUS_CAPS = Caps([Structure("audio/x-opus", **{"channel-mapping-family": 0})])


@register
class RtpOpusPay(RtpBasePay):
    ELEMENT_NAME = "rtpopuspay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload Opus audio into RTP packets (RFC 7587)"
    SINK_CAPS = OPUS_CAPS
    PROPERTIES = RtpBasePay.PROPERTIES + [
        Prop("dtx", False, type="bool",
             doc="discontinuous transmission: DTX frames (<=2 byte TOC-only "
                 "packets from an Opus encoder in DTX mode) are not sent"),
    ]

    def rtp_structure(self, s: Structure) -> Structure:
        st = Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "OPUS", "clock-rate": 48000,
               "encoding-params": "2"},
        )
        if self.get_property("dtx"):
            st["usedtx"] = "1"
        return st

    def handle_buffer(self, buf: Buffer) -> None:
        data = _bytes_of(buf)
        if self.get_property("dtx") and len(data) <= 2:
            return  # RFC 7587 §3.1.3: suppress DTX frames on the wire
        self.queue_packet(data, pts=buf.pts, duration=buf.duration)


@register
class RtpOpusDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpopusdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload Opus audio from RTP packets (RFC 7587)"
    SRC_CAPS = OPUS_CAPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("audio/x-opus", **{"channel-mapping-family": 0})

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        out.data = np.frombuffer(pkt.payload, np.uint8)
        return out


# ---------------------------------------------------------------------------
# AC-3 — RFC 4184: 2-byte payload header (FT, NF), marker on frame end
# ---------------------------------------------------------------------------
AC3_CAPS = Caps([Structure("audio/x-ac3", framed=True,
                           rate=IntRange(1, 96000), alignment="frame")])


@register
class RtpAc3Pay(RtpAggregateMixin, RtpBasePay):
    ELEMENT_NAME = "rtpac3pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload AC-3 audio into RTP packets (RFC 4184)"
    SINK_CAPS = AC3_CAPS
    PROPERTIES = RtpBasePay.PROPERTIES + AGGREGATE_PROPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "AC3", "clock-rate": s.get("rate", 48000)},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        frame = _bytes_of(buf)
        maxp = self.max_payload_size() - 2
        if len(frame) <= maxp:
            self.aggregate_frame(frame, buf.pts, buf.duration,
                                 base_overhead=2)
            return
        self._agg_flush()  # fragments never share a packet
        n_frags = -(-len(frame) // maxp)
        pos = 0
        for i in range(n_frags):
            chunk = frame[pos : pos + maxp]
            pos += len(chunk)
            if i == 0:
                ft = 1 if len(chunk) * 8 >= len(frame) * 5 else 2  # >=5/8ths rule
            else:
                ft = 3
            self.queue_packet(bytes([ft, n_frags]) + chunk, pts=buf.pts,
                              marker=i == n_frags - 1)

    def flush_frames(self, frames) -> None:
        # FT=0: NF complete frames in one packet (RFC 4184 §4.1.1)
        payload = bytes([0, len(frames)]) + b"".join(f for f, _, _ in frames)
        dur = sum(d or 0 for _, _, d in frames) or None
        self.queue_packet(payload, pts=frames[0][1], duration=dur, marker=True)


@register
class RtpAc3Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpac3depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload AC-3 audio from RTP packets (RFC 4184)"
    SRC_CAPS = AC3_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frags: List[bytes] = []

    def media_structure(self, s: Structure) -> Structure:
        return Structure("audio/x-ac3", framed=True,
                         rate=s.get("clock-rate", 48000), alignment="frame")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if len(pkt.payload) < 2:
            return None
        ft = pkt.payload[0] & 0x3
        data = pkt.payload[2:]
        if out.has_flag(BufferFlags.DISCONT):
            self._frags.clear()
        if ft == 0:
            out.data = np.frombuffer(data, np.uint8)
            return out
        self._frags.append(data)
        if not pkt.marker:
            return None
        frame = b"".join(self._frags)
        self._frags.clear()
        out.data = np.frombuffer(frame, np.uint8)
        return out


# ---------------------------------------------------------------------------
# MPEG audio — RFC 2250 §3.5: 4-byte header (MBZ u16, frag offset u16)
# ---------------------------------------------------------------------------
MPA_CAPS = Caps([Structure("audio/mpeg", mpegversion=1)])


@register
class RtpMpaPay(RtpAggregateMixin, RtpBasePay):
    ELEMENT_NAME = "rtpmpapay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload MPEG audio into RTP packets (RFC 2250)"
    DEFAULT_PT = 14  # static MPA assignment
    SINK_CAPS = MPA_CAPS
    PROPERTIES = RtpBasePay.PROPERTIES + AGGREGATE_PROPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "MPA", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        frame = _bytes_of(buf)
        maxp = self.max_payload_size() - 4
        if len(frame) <= maxp:
            self.aggregate_frame(frame, buf.pts, buf.duration,
                                 base_overhead=4)
            return
        self._agg_flush()
        pos = 0
        while pos < len(frame):
            chunk = frame[pos : pos + maxp]
            hdr = struct.pack(">HH", 0, pos)
            self.queue_packet(hdr + chunk, pts=buf.pts, duration=buf.duration,
                              marker=pos + len(chunk) >= len(frame))
            pos += len(chunk)

    def flush_frames(self, frames) -> None:
        # RFC 2250 §3.5: several complete frames may follow the 4-byte
        # MPA header (fragment offset 0)
        payload = struct.pack(">HH", 0, 0) + b"".join(f for f, _, _ in frames)
        dur = sum(d or 0 for _, _, d in frames) or None
        self.queue_packet(payload, pts=frames[0][1], duration=dur, marker=True)


@register
class RtpMpaDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpmpadepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload MPEG audio from RTP packets (RFC 2250)"
    SRC_CAPS = MPA_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frags: List[bytes] = []

    def media_structure(self, s: Structure) -> Structure:
        return Structure("audio/mpeg", mpegversion=1)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if len(pkt.payload) < 4:
            return None
        if out.has_flag(BufferFlags.DISCONT):
            self._frags.clear()
        self._frags.append(pkt.payload[4:])
        if not pkt.marker:
            return None
        out.data = np.frombuffer(b"".join(self._frags), np.uint8)
        self._frags.clear()
        return out


# ---------------------------------------------------------------------------
# MPEG video — RFC 2250 §3.4: 4-byte video header; B/E slice bits
# ---------------------------------------------------------------------------
MPV_CAPS = Caps([Structure("video/mpeg", mpegversion=IntRange(1, 2),
                           systemstream=False)])


@register
class RtpMpvPay(RtpBasePay):
    ELEMENT_NAME = "rtpmpvpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload MPEG-1/2 video into RTP packets (RFC 2250)"
    DEFAULT_PT = 32  # static MPV assignment
    SINK_CAPS = MPV_CAPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="video",
            **{"encoding-name": "MPV", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        frame = _bytes_of(buf)
        maxp = self.max_payload_size() - 4
        pos = 0
        while pos < len(frame):
            chunk = frame[pos : pos + maxp]
            last = pos + len(chunk) >= len(frame)
            # MBZ/T=0 | TR=0 | AN/N/S=0 | B = starts slice, E = ends slice
            flags = (0x10 if pos == 0 else 0) | (0x08 if last else 0)
            hdr = struct.pack(">I", flags << 8)  # bits 13-14 of the 3rd byte
            self.queue_packet(hdr + chunk, pts=buf.pts, duration=buf.duration,
                              marker=last)
            pos += len(chunk)


@register
class RtpMpvDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpmpvdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload MPEG-1/2 video from RTP packets (RFC 2250)"
    SRC_CAPS = MPV_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frags: List[bytes] = []

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/mpeg", mpegversion=2, systemstream=False)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if len(pkt.payload) < 4:
            return None
        if out.has_flag(BufferFlags.DISCONT):
            self._frags.clear()
        self._frags.append(pkt.payload[4:])
        if not pkt.marker:
            return None
        out.data = np.frombuffer(b"".join(self._frags), np.uint8)
        self._frags.clear()
        return out


# ---------------------------------------------------------------------------
# AMR — RFC 4867 octet-aligned: CMR byte + TOC entries + frame data
# ---------------------------------------------------------------------------
AMR_CAPS = Caps([Structure("audio/AMR", rate=8000, channels=1),
                 Structure("audio/AMR-WB", rate=16000, channels=1)])
# AMR-NB core frame sizes (bytes, excluding TOC) per FT 0..7 + SID
_AMR_NB_SIZES = {0: 12, 1: 13, 2: 15, 3: 17, 4: 19, 5: 20, 6: 26, 7: 31, 8: 5}
# AMR-WB (RFC 4867 §3.2 / TS 26.201) core frame sizes per FT 0..8 + SID
_AMR_WB_SIZES = {0: 17, 1: 23, 2: 32, 3: 36, 4: 40, 5: 46, 6: 50, 7: 58,
                 8: 60, 9: 5}


@register
class RtpAmrPay(RtpAggregateMixin, RtpBasePay):
    ELEMENT_NAME = "rtpamrpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload AMR audio into RTP packets (RFC 4867)"
    SINK_CAPS = AMR_CAPS
    PROPERTIES = RtpBasePay.PROPERTIES + AGGREGATE_PROPS + [
        Prop("alignment-threshold", 40_000_000, type="uint64",
             doc="ns of pts discontinuity between frames tolerated inside "
                 "one aggregated packet before flushing"),
        Prop("discont-wait", 1_000_000_000, type="uint64",
             doc="ns of accumulated misalignment before a DISCONT resync"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._expected_pts: Optional[int] = None
        self._misaligned_since: Optional[int] = None

    def rtp_structure(self, s: Structure) -> Structure:
        wb = s.name == "audio/AMR-WB"
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "AMR-WB" if wb else "AMR",
               "clock-rate": 16000 if wb else 8000,
               "octet-align": "1"},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        # input: one AMR frame per buffer with its TOC byte first
        # (file-storage framing)
        frame = _bytes_of(buf)
        if not frame:
            return
        # alignment: a pts jump beyond alignment-threshold breaks the
        # aggregation run; persisting past discont-wait resyncs timing
        if buf.pts is not None and self._expected_pts is not None:
            delta = abs(buf.pts - self._expected_pts)
            if delta > self.get_property("alignment-threshold"):
                self._agg_flush()
                if self._misaligned_since is None:
                    self._misaligned_since = buf.pts
                elif buf.pts - self._misaligned_since > \
                        self.get_property("discont-wait"):
                    self._expected_pts = None
                    self._misaligned_since = None
            else:
                self._misaligned_since = None
        if buf.pts is not None:
            self._expected_pts = buf.pts + (buf.duration or 20_000_000)
        self.aggregate_frame(frame, buf.pts, buf.duration, base_overhead=1)

    def flush_frames(self, frames) -> None:
        # RFC 4867 §4.4 octet-aligned: CMR, TOC run (F bit chains), frames
        tocs = bytearray()
        bodies = bytearray()
        for i, (frame, _, _) in enumerate(frames):
            toc = frame[0] & 0x7C
            if i != len(frames) - 1:
                toc |= 0x80  # F: another TOC entry follows
            tocs.append(toc)
            bodies += frame[1:]
        payload = bytes([0xF0]) + bytes(tocs) + bytes(bodies)
        dur = sum(d or 0 for _, _, d in frames) or None
        self.queue_packet(payload, pts=frames[0][1], duration=dur, marker=True)


@register
class RtpAmrDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpamrdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload AMR audio from RTP packets (RFC 4867)"
    SRC_CAPS = AMR_CAPS

    def media_structure(self, s: Structure) -> Structure:
        if s.get("encoding-name") == "AMR-WB":
            return Structure("audio/AMR-WB", rate=16000, channels=1)
        return Structure("audio/AMR", rate=8000, channels=1)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        p = pkt.payload
        if len(p) < 2:
            return None
        wb = (self.out_caps is not None
              and self.out_caps.structure(0).name == "audio/AMR-WB")
        sizes = _AMR_WB_SIZES if wb else _AMR_NB_SIZES
        # skip CMR; collect TOC entries until F bit clear
        tocs = []
        i = 1
        while i < len(p):
            tocs.append(p[i])
            follows = p[i] & 0x80
            i += 1
            if not follows:
                break
        frames = bytearray()
        for toc in tocs:
            ft = (toc >> 3) & 0x0F
            size = sizes.get(ft, 0)
            frames += bytes([toc & 0x7C]) + p[i : i + size]
            i += size
        out.data = np.frombuffer(bytes(frames), np.uint8)
        return out


__all__ = [
    "RtpOpusPay", "RtpOpusDepay", "RtpAc3Pay", "RtpAc3Depay",
    "RtpMpaPay", "RtpMpaDepay", "RtpMpvPay", "RtpMpvDepay",
    "RtpAmrPay", "RtpAmrDepay",
]


# ---------------------------------------------------------------------------
# MPEG audio robust (ADU) depayloader — RFC 5219
# ---------------------------------------------------------------------------
@register
class RtpMpaRobustDepay(RtpBaseDepay):
    """RFC 5219 loss-tolerant MPEG audio: parses 1-/2-byte ADU descriptors
    (C continuation bit, T size-extension bit, 6/14-bit size), reassembles
    fragmented ADUs, and emits them with audio/mpeg caps from the first
    frame header (reference mparobust/depay/imp.rs:192-320; header parse
    mpeg_audio_utils.rs).  ADU -> MP3 bit-reservoir reconstruction is not
    performed (the ADUs themselves carry the sync headers downstream
    decoders need)."""

    ELEMENT_NAME = "rtpmparobustdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload loss-tolerant MPEG audio (RFC 5219 ADUs)"
    SRC_CAPS = MPA_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._partial = b""
        self._partial_size = 0
        self._caps_sent = False

    def media_structure(self, s: Structure) -> Structure:
        return Structure("audio/mpeg", mpegversion=1)

    def _maybe_caps(self, adu: bytes) -> None:
        if self._caps_sent:
            return
        from ...net.mpa import peek_frame_header
        from ...core.events import Event

        hdr = peek_frame_header(adu)
        if hdr is not None:
            caps = Caps([Structure(
                "audio/mpeg", mpegversion=1 if hdr.version == 1 else 2,
                layer=hdr.layer, rate=hdr.sample_rate, channels=hdr.channels,
            )])
            self.out_caps = caps
            self.srcpad.current_caps = caps
            self.srcpad.push_event(Event.new_caps(caps))
            self._caps_sent = True

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if out.has_flag(BufferFlags.DISCONT):
            self._partial = b""
            self._partial_size = 0
        p = pkt.payload
        pos = 0
        adus: List[bytes] = []
        while pos < len(p):
            b0 = p[pos]
            cont = bool(b0 & 0x80)
            two_byte = bool(b0 & 0x40)
            if two_byte:
                if pos + 2 > len(p):
                    break
                size = ((b0 & 0x3F) << 8) | p[pos + 1]
                pos += 2
            else:
                size = b0 & 0x3F
                pos += 1
            if cont:
                # continuation: descriptor repeats the TOTAL ADU size
                need = size - len(self._partial)
                data = p[pos : pos + need]
                pos += len(data)
                self._partial += data
                if len(self._partial) == size:
                    adus.append(self._partial)
                    self._partial = b""
                    self._partial_size = 0
            else:
                data = p[pos : pos + size]
                pos += len(data)
                if len(data) < size:
                    self._partial = data  # rest arrives with C=1
                    self._partial_size = size
                else:
                    adus.append(data)
        if not adus:
            return None
        for adu in adus:
            self._maybe_caps(adu)
        joined = b"".join(adus)
        out.data = np.frombuffer(joined, np.uint8)
        return out
