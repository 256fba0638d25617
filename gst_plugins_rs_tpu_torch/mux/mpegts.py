"""MPEG transport stream packet utilities (ISO/IEC 13818-1).

Supports the TS-touching elements: rtpmp2tpay2/rtpmp2tdepay2 (whole-packet
RTP carriage) and mpegtslivesrc (PCR-based timestamping, reference
net/mpegtslive).  Includes a minimal writer (PAT/PMT/PES/PCR) used by tests
to synthesize conformant streams — the reference ships no TS muxer either.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

TS_PACKET_SIZE = 188
SYNC_BYTE = 0x47
PCR_CLOCK = 27_000_000  # 27 MHz system clock; PCR base ticks at 90 kHz


@dataclass
class TsPacket:
    pid: int
    payload_unit_start: bool
    continuity: int
    payload: bytes
    pcr: Optional[int] = None  # 27 MHz ticks

    @staticmethod
    def parse(data: bytes) -> "TsPacket":
        if len(data) != TS_PACKET_SIZE or data[0] != SYNC_BYTE:
            raise ValueError("not a TS packet")
        pusi = bool(data[1] & 0x40)
        pid = ((data[1] & 0x1F) << 8) | data[2]
        afc = (data[3] >> 4) & 0x3
        cc = data[3] & 0x0F
        pos = 4
        pcr = None
        if afc & 0x2:  # adaptation field present
            af_len = data[4]
            if af_len > 0 and (data[5] & 0x10):  # PCR flag
                b = data[6:12]
                base = (b[0] << 25) | (b[1] << 17) | (b[2] << 9) | (b[3] << 1) | (b[4] >> 7)
                ext = ((b[4] & 0x01) << 8) | b[5]
                pcr = base * 300 + ext
            pos = 5 + af_len
        payload = data[pos:] if afc & 0x1 else b""
        return TsPacket(pid, pusi, cc, payload, pcr)


def pcr_to_ns(pcr: int) -> int:
    return pcr * 1_000_000_000 // PCR_CLOCK


def build_packet(
    pid: int,
    payload: bytes = b"",
    *,
    pusi: bool = False,
    continuity: int = 0,
    pcr: Optional[int] = None,
) -> bytes:
    """One 188-byte packet; payload padded via adaptation-field stuffing."""
    header = bytearray(4)
    header[0] = SYNC_BYTE
    header[1] = (0x40 if pusi else 0) | (pid >> 8)
    header[2] = pid & 0xFF
    af = b""
    need_af = pcr is not None
    space = TS_PACKET_SIZE - 4
    if need_af or len(payload) < space:
        # adaptation field (for PCR and/or stuffing)
        flags = 0x10 if pcr is not None else 0x00
        body = bytearray([flags])
        if pcr is not None:
            base, ext = divmod(pcr, 300)
            body += bytes(
                [
                    (base >> 25) & 0xFF,
                    (base >> 17) & 0xFF,
                    (base >> 9) & 0xFF,
                    (base >> 1) & 0xFF,
                    ((base & 1) << 7) | 0x7E | ((ext >> 8) & 1),
                    ext & 0xFF,
                ]
            )
        stuffing = space - 1 - len(body) - len(payload)
        if stuffing < 0:
            raise ValueError("payload too large for one TS packet")
        body += b"\xff" * stuffing
        af = bytes([len(body)]) + bytes(body)
    afc = (0x2 if af else 0) | (0x1 if payload else 0)
    header[3] = (afc << 4) | (continuity & 0x0F)
    pkt = bytes(header) + af + payload
    assert len(pkt) == TS_PACKET_SIZE, len(pkt)
    return pkt


def _crc32_mpeg(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
    return crc


def _section(table_id: int, table_body: bytes) -> bytes:
    """PSI section with header + CRC32."""
    length = len(table_body) + 5 + 4  # after section_length field
    sec = bytes([table_id, 0xB0 | (length >> 8), length & 0xFF])
    sec += struct.pack(">HBBB", 1, 0xC1, 0, 0)  # id ext, version/current, sec 0, last 0
    sec += table_body
    sec += struct.pack(">I", _crc32_mpeg(sec))
    return b"\x00" + sec  # pointer_field


def build_pat(pmt_pid: int = 0x100, program: int = 1) -> bytes:
    body = struct.pack(">HH", program, 0xE000 | pmt_pid)
    return build_packet(0, _section(0x00, body), pusi=True)


def build_pmt(
    streams: List[Tuple[int, int]], *, pmt_pid: int = 0x100, pcr_pid: int = 0x100
) -> bytes:
    """streams: [(stream_type, elementary_pid)]."""
    body = struct.pack(">HH", 0xE000 | pcr_pid, 0xF000)  # pcr pid, no program info
    for stype, epid in streams:
        body += struct.pack(">BHH", stype, 0xE000 | epid, 0xF000)
    return build_packet(pmt_pid, _section(0x02, body), pusi=True)


def build_pes(stream_id: int, payload: bytes, pts_90k: Optional[int] = None) -> bytes:
    """PES packet bytes (to be split across TS packets)."""
    header_data = b""
    flags = 0
    if pts_90k is not None:
        flags = 0x80
        p = pts_90k & 0x1FFFFFFFF
        header_data = bytes(
            [
                0x21 | ((p >> 29) & 0x0E),
                (p >> 22) & 0xFF,
                0x01 | ((p >> 14) & 0xFE),
                (p >> 7) & 0xFF,
                0x01 | ((p << 1) & 0xFE),
            ]
        )
    total = 3 + len(header_data) + len(payload)
    pes_len = total if total <= 0xFFFF else 0
    return (
        b"\x00\x00\x01"
        + bytes([stream_id])
        + struct.pack(">H", pes_len)
        + bytes([0x80, flags, len(header_data)])
        + header_data
        + payload
    )


def packetize_pes(pid: int, pes: bytes, continuity_start: int = 0) -> List[bytes]:
    out = []
    pos = 0
    cc = continuity_start
    first = True
    while pos < len(pes):
        chunk = pes[pos : pos + TS_PACKET_SIZE - 4]
        out.append(build_packet(pid, chunk, pusi=first, continuity=cc))
        cc = (cc + 1) & 0xF
        pos += len(chunk)
        first = False
    return out


def iter_packets(data: bytes):
    for i in range(0, len(data) - TS_PACKET_SIZE + 1, TS_PACKET_SIZE):
        if data[i] == SYNC_BYTE:
            yield TsPacket.parse(data[i : i + TS_PACKET_SIZE])


__all__ = [
    "TsPacket", "TS_PACKET_SIZE", "SYNC_BYTE", "PCR_CLOCK",
    "build_packet", "build_pat", "build_pmt", "build_pes", "packetize_pes",
    "iter_packets", "pcr_to_ns",
]
