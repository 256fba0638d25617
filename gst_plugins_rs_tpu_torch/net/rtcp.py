"""RFC 3550 RTCP packet serialization/parsing: SR, RR, SDES, BYE.

From-scratch equivalent of the rtcp-types crate used by the reference's
rtpbin2 session machinery (net/rtp/src/rtpbin2/session.rs).  Compound
packets are concatenations of 32-bit-aligned packets, each with the common
|V=2|P|count|PT|length| header.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

PT_SR = 200
PT_RR = 201
PT_SDES = 202
PT_BYE = 203

# NTP epoch (1900) to UNIX epoch (1970) in seconds
NTP_UNIX_OFFSET = 2_208_988_800


def ntp_from_ns(unix_ns: int) -> int:
    """64-bit NTP timestamp from unix nanoseconds."""
    secs, frac_ns = divmod(unix_ns, 1_000_000_000)
    return ((secs + NTP_UNIX_OFFSET) << 32) | (frac_ns * (1 << 32) // 1_000_000_000)


def ns_from_ntp(ntp: int) -> int:
    """Unix nanoseconds from a 64-bit NTP timestamp (inverse of
    ntp_from_ns)."""
    secs = (ntp >> 32) - NTP_UNIX_OFFSET
    frac = ntp & 0xFFFFFFFF
    return secs * 1_000_000_000 + frac * 1_000_000_000 // (1 << 32)


@dataclass
class ReportBlock:
    ssrc: int
    fraction_lost: int  # 0..255
    cumulative_lost: int
    ext_highest_seq: int
    jitter: int
    lsr: int  # middle 32 bits of last SR NTP
    dlsr: int  # delay since last SR, 1/65536 s

    def to_bytes(self) -> bytes:
        lost = self.cumulative_lost & 0xFFFFFF
        return struct.pack(
            ">IIIIII",
            self.ssrc,
            (self.fraction_lost << 24) | lost,
            self.ext_highest_seq & 0xFFFFFFFF,
            self.jitter,
            self.lsr,
            self.dlsr,
        )

    @staticmethod
    def parse(data: bytes) -> "ReportBlock":
        ssrc, fl_lost, seq, jitter, lsr, dlsr = struct.unpack_from(">IIIIII", data)
        lost = fl_lost & 0xFFFFFF
        if lost >= 0x800000:
            lost -= 0x1000000
        return ReportBlock(ssrc, fl_lost >> 24, lost, seq, jitter, lsr, dlsr)


def _header(pt: int, count: int, payload: bytes) -> bytes:
    assert len(payload) % 4 == 0
    return struct.pack(">BBH", (2 << 6) | count, pt, len(payload) // 4) + payload


@dataclass
class SenderReport:
    ssrc: int
    ntp_timestamp: int  # 64-bit NTP
    rtp_timestamp: int
    packet_count: int
    octet_count: int
    reports: List[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack(
            ">IQIII",
            self.ssrc,
            self.ntp_timestamp,
            self.rtp_timestamp & 0xFFFFFFFF,
            self.packet_count & 0xFFFFFFFF,
            self.octet_count & 0xFFFFFFFF,
        )
        body += b"".join(r.to_bytes() for r in self.reports)
        return _header(PT_SR, len(self.reports), body)


@dataclass
class ReceiverReport:
    ssrc: int
    reports: List[ReportBlock] = field(default_factory=list)

    def to_bytes(self) -> bytes:
        body = struct.pack(">I", self.ssrc)
        body += b"".join(r.to_bytes() for r in self.reports)
        return _header(PT_RR, len(self.reports), body)


@dataclass
class Sdes:
    ssrc: int
    cname: str

    def to_bytes(self) -> bytes:
        cname = self.cname.encode()
        item = struct.pack(">IBB", self.ssrc, 1, len(cname)) + cname
        pad = (4 - (len(item) + 1) % 4) % 4  # +1 for the terminating zero
        return _header(PT_SDES, 1, item + b"\x00" * (pad + 1))


@dataclass
class Bye:
    ssrcs: List[int]
    reason: str = ""

    def to_bytes(self) -> bytes:
        body = b"".join(struct.pack(">I", s) for s in self.ssrcs)
        if self.reason:
            r = self.reason.encode()
            body += bytes([len(r)]) + r
            body += b"\x00" * ((4 - len(body) % 4) % 4)
        return _header(PT_BYE, len(self.ssrcs), body)


Packet = Union[SenderReport, ReceiverReport, Sdes, Bye]


PT_RTPFB = 205
FMT_NACK = 1
FMT_TWCC = 15


@dataclass
class GenericNack:
    """RFC 4585 §6.2.1 Generic NACK: lost seqnums as (PID, BLP) FCI pairs."""

    sender_ssrc: int
    media_ssrc: int
    seqnums: List[int]

    def to_bytes(self) -> bytes:
        # group seqnums into PID + 16-bit following-loss bitmap
        fci = b""
        seqs = sorted(set(s & 0xFFFF for s in self.seqnums))
        i = 0
        while i < len(seqs):
            pid = seqs[i]
            blp = 0
            j = i + 1
            while j < len(seqs) and 0 < ((seqs[j] - pid) & 0xFFFF) <= 16:
                blp |= 1 << (((seqs[j] - pid) & 0xFFFF) - 1)
                j += 1
            fci += struct.pack(">HH", pid, blp)
            i = j
        body = struct.pack(">II", self.sender_ssrc, self.media_ssrc) + fci
        hdr = struct.pack(">BBH", (2 << 6) | FMT_NACK, PT_RTPFB, len(body) // 4)
        return hdr + body

    @staticmethod
    def parse(body: bytes) -> "GenericNack":
        sender, media = struct.unpack_from(">II", body)
        seqs: List[int] = []
        for off in range(8, len(body) - 3, 4):
            pid, blp = struct.unpack_from(">HH", body, off)
            seqs.append(pid)
            for bit in range(16):
                if blp >> bit & 1:
                    seqs.append((pid + bit + 1) & 0xFFFF)
        return GenericNack(sender, media, seqs)


@dataclass
class TwccFeedback:
    """Transport-wide congestion control feedback
    (draft-holmer-rmcat-transport-wide-cc-extensions-01 §3.1), the packet
    the reference's rtpbin2 TWCC machinery produces/consumes.

    packets: [(twcc_seq, arrival_ns | None)] — None = lost.  Arrival times
    are absolute; the wire carries reference_time + deltas in 250 us units.
    """

    sender_ssrc: int
    media_ssrc: int
    fb_count: int
    packets: List[Tuple[int, Optional[int]]]

    DELTA_US = 250

    def to_bytes(self) -> bytes:
        seqs = [s for s, _ in self.packets]
        base_seq = seqs[0]
        count = len(self.packets)
        first_arrival = next((a for _, a in self.packets if a is not None), 0)
        ref_time_64ms = (first_arrival // 64_000_000) & 0xFFFFFF
        ref_ns = ref_time_64ms * 64_000_000
        # per-packet 2-bit statuses + deltas
        statuses: List[int] = []
        deltas = b""
        prev = ref_ns
        for _, arrival in self.packets:
            if arrival is None:
                statuses.append(0)
                continue
            d = round((arrival - prev) / (self.DELTA_US * 1000))
            prev = arrival
            if 0 <= d <= 0xFF:
                statuses.append(1)
                deltas += struct.pack(">B", d)
            else:
                statuses.append(2)
                deltas += struct.pack(">h", max(-32768, min(32767, d)))
        chunks = b""
        for k in range(0, len(statuses), 7):
            grp = statuses[k:k + 7] + [0] * (7 - len(statuses[k:k + 7]))
            word = 0xC000  # status vector chunk, 2-bit symbols
            for i, s in enumerate(grp):
                word |= s << (12 - 2 * i)
            chunks += struct.pack(">H", word)
        body = struct.pack(">II", self.sender_ssrc, self.media_ssrc)
        body += struct.pack(">HH", base_seq & 0xFFFF, count)
        body += ref_time_64ms.to_bytes(3, "big") + bytes([self.fb_count & 0xFF])
        body += chunks + deltas
        if len(body) % 4:
            body += b"\x00" * (4 - len(body) % 4)
        hdr = struct.pack(">BBH", (2 << 6) | FMT_TWCC, PT_RTPFB, len(body) // 4)
        return hdr + body

    @staticmethod
    def parse(body: bytes) -> "TwccFeedback":
        sender, media = struct.unpack_from(">II", body)
        base_seq, count = struct.unpack_from(">HH", body, 8)
        ref_time_64ms = int.from_bytes(body[12:15], "big")
        fb_count = body[15]
        pos = 16
        statuses: List[int] = []
        while len(statuses) < count:
            (word,) = struct.unpack_from(">H", body, pos)
            pos += 2
            if word & 0x8000:  # status vector
                if word & 0x4000:  # 2-bit symbols x7
                    for i in range(7):
                        statuses.append((word >> (12 - 2 * i)) & 3)
                else:  # 1-bit symbols x14
                    for i in range(14):
                        statuses.append(1 if word >> (13 - i) & 1 else 0)
            else:  # run length
                statuses.extend([word >> 13 & 3] * (word & 0x1FFF))
        statuses = statuses[:count]
        t = ref_time_64ms * 64_000_000
        packets: List[Tuple[int, Optional[int]]] = []
        for i, s in enumerate(statuses):
            seq = (base_seq + i) & 0xFFFF
            if s == 0:
                packets.append((seq, None))
            elif s == 1:
                d = body[pos]
                pos += 1
                t += d * TwccFeedback.DELTA_US * 1000
                packets.append((seq, t))
            else:
                (d,) = struct.unpack_from(">h", body, pos)
                pos += 2
                t += d * TwccFeedback.DELTA_US * 1000
                packets.append((seq, t))
        return TwccFeedback(sender, media, fb_count, packets)


def parse_compound(data: bytes) -> List[Packet]:
    try:
        return _parse_compound(data)
    except (struct.error, IndexError) as e:
        # short/corrupt packet bodies surface as the one documented error
        raise ValueError(f"corrupt RTCP packet: {e}") from None


def _parse_compound(data: bytes) -> List[Packet]:
    out: List[Packet] = []
    pos = 0
    while pos + 4 <= len(data):
        b0, pt, words = struct.unpack_from(">BBH", data, pos)
        if b0 >> 6 != 2:
            raise ValueError(f"bad RTCP version at {pos}")
        count = b0 & 0x1F
        end = pos + 4 + 4 * words
        body = data[pos + 4 : end]
        if pt == PT_SR:
            ssrc, ntp, rtpts, pc, oc = struct.unpack_from(">IQIII", body)
            reports = [ReportBlock.parse(body[24 + 24 * i :]) for i in range(count)]
            out.append(SenderReport(ssrc, ntp, rtpts, pc, oc, reports))
        elif pt == PT_RR:
            (ssrc,) = struct.unpack_from(">I", body)
            reports = [ReportBlock.parse(body[4 + 24 * i :]) for i in range(count)]
            out.append(ReceiverReport(ssrc, reports))
        elif pt == PT_SDES and count >= 1:
            ssrc, item_type, length = struct.unpack_from(">IBB", body)
            cname = body[6 : 6 + length].decode(errors="replace") if item_type == 1 else ""
            out.append(Sdes(ssrc, cname))
        elif pt == PT_BYE:
            ssrcs = list(struct.unpack_from(f">{count}I", body))
            reason = ""
            if len(body) > 4 * count:
                rlen = body[4 * count]
                reason = body[4 * count + 1 : 4 * count + 1 + rlen].decode(errors="replace")
            out.append(Bye(ssrcs, reason))
        elif pt == PT_RTPFB and count == FMT_NACK:
            out.append(GenericNack.parse(body))
        elif pt == PT_RTPFB and count == FMT_TWCC:
            out.append(TwccFeedback.parse(body))
        pos = end
    return out


__all__ = [
    "SenderReport", "ReceiverReport", "ReportBlock", "Sdes", "Bye",
    "GenericNack", "TwccFeedback",
    "parse_compound", "ntp_from_ns",
    "PT_SR", "PT_RR", "PT_SDES", "PT_BYE", "PT_RTPFB", "FMT_NACK", "FMT_TWCC",
]
