"""RFC 3550 RTP packet serialization/parsing.

From-scratch equivalent of the rtp-types crate the reference builds on
(net/rtp/src/basepay/mod.rs:84-88 uses rtp_types::RtpPacketBuilder).
Fixed 12-byte header + CSRCs + optional one-/two-byte header extensions.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

VERSION = 2
HEADER_LEN = 12
U32 = 0xFFFFFFFF
U16 = 0xFFFF


@dataclass
class RtpPacket:
    payload_type: int
    sequence_number: int
    timestamp: int
    ssrc: int
    payload: bytes = b""
    marker: bool = False
    csrcs: Tuple[int, ...] = ()
    extension: Optional[Tuple[int, bytes]] = None  # (profile id, data, 32-bit padded)
    padding: int = 0  # trailing pad bytes incl. count byte

    def to_bytes(self) -> bytes:
        if not 0 <= self.payload_type <= 127:
            raise ValueError(f"payload type {self.payload_type} out of range")
        b0 = (VERSION << 6) | (0x20 if self.padding else 0)
        b0 |= 0x10 if self.extension is not None else 0
        b0 |= len(self.csrcs)
        b1 = (0x80 if self.marker else 0) | self.payload_type
        out = struct.pack(
            ">BBHII",
            b0,
            b1,
            self.sequence_number & U16,
            self.timestamp & U32,
            self.ssrc & U32,
        )
        out += b"".join(struct.pack(">I", c & U32) for c in self.csrcs)
        if self.extension is not None:
            profile, data = self.extension
            if len(data) % 4:
                data = data + b"\x00" * (4 - len(data) % 4)
            out += struct.pack(">HH", profile, len(data) // 4) + data
        out += self.payload
        if self.padding:
            out += b"\x00" * (self.padding - 1) + bytes([self.padding])
        return out

    @staticmethod
    def parse(data: bytes) -> "RtpPacket":
        if len(data) < HEADER_LEN:
            raise ValueError(f"RTP packet too short: {len(data)}")
        b0, b1, seq, ts, ssrc = struct.unpack_from(">BBHII", data, 0)
        if b0 >> 6 != VERSION:
            raise ValueError(f"bad RTP version {b0 >> 6}")
        cc = b0 & 0x0F
        pos = HEADER_LEN
        if len(data) < pos + 4 * cc:
            raise ValueError("truncated CSRC list")
        csrcs = struct.unpack_from(f">{cc}I", data, pos) if cc else ()
        pos += 4 * cc
        extension = None
        if b0 & 0x10:
            profile, words = struct.unpack_from(">HH", data, pos)
            pos += 4
            extension = (profile, data[pos : pos + 4 * words])
            pos += 4 * words
        end = len(data)
        padding = 0
        if b0 & 0x20:
            padding = data[-1]
            if padding == 0 or padding > end - pos:
                raise ValueError(f"bad RTP padding count {padding}")
            end -= padding
        return RtpPacket(
            payload_type=b1 & 0x7F,
            sequence_number=seq,
            timestamp=ts,
            ssrc=ssrc,
            payload=data[pos:end],
            marker=bool(b1 & 0x80),
            csrcs=tuple(csrcs),
            extension=extension,
            padding=padding,
        )


ONE_BYTE_EXT_PROFILE = 0xBEDE


def build_onebyte_extensions(items: dict) -> Tuple[int, bytes]:
    """RFC 8285 §4.2 one-byte header extensions from {id: data(1..16 B)}."""
    out = bytearray()
    for ext_id, data in items.items():
        if not 1 <= ext_id <= 14 or not 1 <= len(data) <= 16:
            raise ValueError(f"bad one-byte extension {ext_id}/{len(data)}")
        out.append((ext_id << 4) | (len(data) - 1))
        out += data
    return ONE_BYTE_EXT_PROFILE, bytes(out)


def parse_onebyte_extensions(extension: Optional[Tuple[int, bytes]]) -> dict:
    """{id: data} from a parsed (profile, data) RTP extension; {} if absent
    or not the one-byte profile."""
    if extension is None or extension[0] != ONE_BYTE_EXT_PROFILE:
        return {}
    items = {}
    data = extension[1]
    i = 0
    while i < len(data):
        b = data[i]
        if b == 0:  # padding
            i += 1
            continue
        ext_id = b >> 4
        length = (b & 0x0F) + 1
        if ext_id == 15:
            break
        items[ext_id] = data[i + 1:i + 1 + length]
        i += 1 + length
    return items


class SeqnumTracker:
    """Extends 16-bit seqnums to a monotonic 64-bit count and flags gaps."""

    def __init__(self) -> None:
        self.ext: Optional[int] = None

    def update(self, seq: int) -> Tuple[int, int]:
        """Returns (extended_seqnum, gap) where gap==1 for in-order flow."""
        if self.ext is None:
            self.ext = seq
            return seq, 1
        delta = (seq - self.ext) & U16
        if delta >= 0x8000:  # reordered/old packet
            delta -= 0x10000
        self.ext += delta
        return self.ext, delta


class TimestampTracker:
    """Extends 32-bit RTP timestamps past wraparound."""

    def __init__(self) -> None:
        self.ext: Optional[int] = None

    def update(self, ts: int) -> int:
        if self.ext is None:
            self.ext = ts
            return ts
        delta = (ts - self.ext) & U32
        if delta >= 0x80000000:
            delta -= 0x100000000
        self.ext += delta
        return self.ext


class RtpHeaderExtension:
    """RTP header extension implementation (gst_rtp::RTPHeaderExtension
    analog; reference basepay `extensions` property element type,
    net/rtp/src/basepay/imp.rs:2010-2020).

    Instances are enabled on payloaders/depayloaders via the `extensions`
    property (a list) or auto-enabled from caps `extmap-N` fields when
    `auto-header-extension` is true and the URI is known."""

    URI = ""

    def __init__(self, ext_id: int):
        if not 1 <= ext_id <= 14:
            raise ValueError(f"one-byte extension id {ext_id} out of range")
        self.id = ext_id

    def write(self, buffer) -> Optional[bytes]:
        """Payloader side: bytes to embed for this output packet (None =
        skip on this packet)."""
        return None

    def read(self, data: bytes, buffer) -> None:
        """Depayloader side: consume the received extension element
        (typically attaching a Meta to the output buffer)."""


class AudioLevelExtension(RtpHeaderExtension):
    """RFC 6464 client-to-mixer audio level."""

    URI = "urn:ietf:params:rtp-hdrext:ssrc-audio-level"

    def __init__(self, ext_id: int):
        super().__init__(ext_id)
        self.level = 127  # -dBov
        self.voice = False
        self.last_read: Optional[Tuple[int, bool]] = None

    def write(self, buffer) -> Optional[bytes]:
        level, voice = self.level, self.voice
        for m in getattr(buffer, "metas", []):
            if type(m).__name__ == "AudioLevelMeta":
                level, voice = m.level, m.voice
                break
        return bytes([(0x80 if voice else 0) | (min(level, 127) & 0x7F)])

    def read(self, data: bytes, buffer) -> None:
        if data:
            self.last_read = (data[0] & 0x7F, bool(data[0] & 0x80))


class TransmissionOffsetExtension(RtpHeaderExtension):
    """RFC 5450 transmission time offset."""

    URI = "urn:ietf:params:rtp-hdrext:toffset"

    def __init__(self, ext_id: int):
        super().__init__(ext_id)
        self.offset = 0
        self.last_read: Optional[int] = None

    def write(self, buffer) -> Optional[bytes]:
        return struct.pack(">i", self.offset)[1:]  # 24-bit signed

    def read(self, data: bytes, buffer) -> None:
        if len(data) >= 3:
            v = int.from_bytes(data[:3], "big", signed=False)
            if v & 0x800000:
                v -= 0x1000000
            self.last_read = v


#: URI -> implementation for auto-header-extension resolution
KNOWN_EXTENSIONS = {
    AudioLevelExtension.URI: AudioLevelExtension,
    TransmissionOffsetExtension.URI: TransmissionOffsetExtension,
}


__all__ = [
    "RtpPacket", "SeqnumTracker", "TimestampTracker", "HEADER_LEN",
    "ONE_BYTE_EXT_PROFILE", "build_onebyte_extensions", "parse_onebyte_extensions",
    "RtpHeaderExtension", "AudioLevelExtension", "TransmissionOffsetExtension",
    "KNOWN_EXTENSIONS",
]
