"""SMPTE ST-2038 ancillary data packet pack/unpack.

From-scratch equivalent of the reference's st2038anc_utils.rs: the
bit-packed ANC data packet (6 zero bits, c_not_y flag, 11-bit line,
12-bit horizontal offset, 10-bit DID/SDID/DC words with even/odd parity
in bits 8-9, 10-bit user words, ST-291 checksum word, ones-padding to a
byte boundary).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass
class AncPacket:
    c_not_y: bool
    line_number: int
    horizontal_offset: int
    did: int
    sdid: int
    data: bytes
    checksum_ok: bool = True


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        out = 0
        for _ in range(n):
            if self.pos >= len(self.data) * 8:
                raise ValueError("truncated ANC packet")
            out = (out << 1) | ((self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return out


def _parity10(v: int) -> int:
    """bits 8-9 carry even/odd parity (st2038anc_utils.rs:76-82)."""
    return (0x100 if bin(v & 0xFF).count("1") % 2 == 0 else 0x200) | (v & 0xFF)


def pack(
    did: int,
    sdid: int,
    payload: bytes,
    *,
    c_not_y: bool = False,
    line_number: int = 9,
    horizontal_offset: int = 0,
) -> bytes:
    if len(payload) > 255:
        raise ValueError("ANC payload must be < 256 bytes")
    bits: List[int] = []

    def w(value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    w(0, 6)
    w(1 if c_not_y else 0, 1)
    w(line_number, 11)
    w(horizontal_offset, 12)
    words = [_parity10(did), _parity10(sdid), _parity10(len(payload))]
    words += [_parity10(b) for b in payload]
    checksum = sum(wd & 0x1FF for wd in words) & 0x1FF
    checksum |= ((~(checksum >> 8)) & 1) << 9  # b9 = NOT b8 (ST-291 §6.7)
    for wd in words + [checksum]:
        w(wd, 10)
    while len(bits) % 8:
        bits.append(1)  # ones padding
    out = bytearray()
    for i in range(0, len(bits), 8):
        b = 0
        for bit in bits[i : i + 8]:
            b = (b << 1) | bit
        out.append(b)
    return bytes(out)


def unpack(data: bytes, pos: int = 0) -> Tuple[AncPacket, int]:
    """Parse one ANC packet at byte offset pos -> (packet, next offset)."""
    r = _BitReader(data[pos:])
    if r.read(6) != 0:
        raise ValueError("ANC zero bits not zero")
    c_not_y = bool(r.read(1))
    line = r.read(11)
    hoff = r.read(12)
    did_w = r.read(10)
    sdid_w = r.read(10)
    dc_w = r.read(10)
    count = dc_w & 0xFF
    words = [r.read(10) for _ in range(count)]
    checksum = r.read(10)
    expected = (sum(w & 0x1FF for w in [did_w, sdid_w, dc_w] + words)) & 0x1FF
    ok = (checksum & 0x1FF) == expected
    while r.pos % 8:
        if r.read(1) != 1:
            raise ValueError("ANC padding bits not ones")
    return (
        AncPacket(c_not_y, line, hoff, did_w & 0xFF, sdid_w & 0xFF,
                  bytes(w & 0xFF for w in words), ok),
        pos + r.pos // 8,
    )


def unpack_all(data: bytes) -> List[AncPacket]:
    out = []
    pos = 0
    while pos < len(data):
        pkt, pos = unpack(data, pos)
        out.append(pkt)
    return out


__all__ = ["AncPacket", "pack", "unpack", "unpack_all"]
