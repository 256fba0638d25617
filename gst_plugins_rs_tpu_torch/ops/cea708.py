"""CEA-708 (DTVCC) closed-caption codec: cc_data triplets, DTVCC packets,
service blocks, a basic caption-channel command set, and CDP framing.

From-scratch equivalent of the cea708-types usage in the reference
(video/closedcaption/src/cea708utils.rs and the cea708mux/tttocea708/
cea708overlay elements).  Covers the interop core:

- cc_data triplets (cc_valid/cc_type marker byte + 2 bytes): type 0/1 =
  CEA-608 field 1/2 compatibility bytes, type 3 = DTVCC packet start,
  type 2 = continuation.
- DTVCC caption channel packets (2-bit sequence + 6-bit size in words)
  containing service blocks (3-bit service number + 5-bit block size).
- Service-level commands needed for pop-on text: RST, DeleteWindows,
  DefineWindow, SetPenLocation, G0 text, CR, DisplayWindows.
- CDP (caption distribution packet, SMPTE 334-2): 0x9669 framing with
  ccdata section 0x72, optional service-info 0x73, footer 0x74 with a
  packet checksum.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# C1 command opcodes (CEA-708 §7.1.4)
CW0 = 0x80  # SetCurrentWindow 0..7 = 0x80..0x87
CLW = 0x88  # ClearWindows
DSW = 0x89  # DisplayWindows
HDW = 0x8A  # HideWindows
TGW = 0x8B  # ToggleWindows
DLW = 0x8C  # DeleteWindows
DLY = 0x8D
DLC = 0x8E
RST = 0x8F
SPA = 0x90  # SetPenAttributes (+2 operands)
SPC = 0x91  # SetPenColor (+3)
SPL = 0x92  # SetPenLocation (+2)
SWA = 0x97  # SetWindowAttributes (+4)
DF0 = 0x98  # DefineWindow 0..7 = 0x98..0x9F (+6)
CR = 0x0D
ETX = 0x03

_C1_OPERANDS = {SPA: 2, SPC: 3, SPL: 2, SWA: 4, CLW: 1, DSW: 1, HDW: 1,
                TGW: 1, DLW: 1, DLY: 1}
for _i in range(8):
    _C1_OPERANDS[DF0 + _i] = 6


# ---------------------------------------------------------------------------
# cc_data triplets
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Extended character sets (CEA-708 §7.1.8: EXT1 0x10 prefix selects G2/G3)
# ---------------------------------------------------------------------------
EXT1 = 0x10

#: G2 (EXT1 + 0x20..0x7F): the "extended miscellaneous" set
G2_MAP = {
    0x20: "\u00a0",  # transparent space (rendered as NBSP)
    0x21: "\u00a0",  # non-breaking transparent space
    0x25: "\u2026",  # …
    0x2A: "\u0160",  # Š
    0x2C: "\u0152",  # Œ
    0x30: "\u2588",  # █ solid block
    0x31: "\u2018",  # '
    0x32: "\u2019",  # '
    0x33: "\u201c",  # "
    0x34: "\u201d",  # "
    0x35: "\u2022",  # •
    0x39: "\u2122",  # ™
    0x3A: "\u0161",  # š
    0x3C: "\u0153",  # œ
    0x3D: "\u2120",  # ℠
    0x3F: "\u0178",  # Ÿ
    0x76: "\u215b",  # ⅛
    0x77: "\u215c",  # ⅜
    0x78: "\u215d",  # ⅝
    0x79: "\u215e",  # ⅞
    0x7A: "\u2502",  # │
    0x7B: "\u2510",  # ┐
    0x7C: "\u2514",  # └
    0x7D: "\u2500",  # ─
    0x7E: "\u2518",  # ┘
    0x7F: "\u250c",  # ┌
}

#: G3 (EXT1 + 0xA0..0xFF): only 0xA0 ("CC" icon) is assigned
G3_MAP = {0xA0: "\u24cd"}  # Ⓜ-style circled; nearest standalone glyph

#: unicode -> EXT1 code for the encoder
EXT_ENCODE = {ch: code for code, ch in list(G2_MAP.items()) + list(G3_MAP.items())
              if ch != "\u00a0"}
EXT_ENCODE["\u00a0"] = 0x20


def cc_data_triplet(cc_type: int, b1: int, b2: int, valid: bool = True) -> bytes:
    return bytes([0xF8 | (0x04 if valid else 0) | cc_type, b1, b2])


def parse_cc_data(data: bytes):
    """-> [(cc_valid, cc_type, b1, b2)] from packed triplets."""
    out = []
    for i in range(0, len(data) - 2, 3):
        marker = data[i]
        out.append((bool(marker & 0x04), marker & 0x03, data[i + 1], data[i + 2]))
    return out


def pack_dtvcc_packet(service_blocks: bytes, sequence: int = 0) -> List[bytes]:
    """DTVCC packet -> cc_data triplets (type 3 start + type 2 continuation).

    packet_size field is in 2-byte words including the header byte pair."""
    size_words = (1 + len(service_blocks) + 1) // 2
    header = ((sequence & 0x3) << 6) | (size_words & 0x3F)
    payload = bytes([header]) + service_blocks
    if len(payload) % 2:
        payload += b"\x00"
    out = []
    for i in range(0, len(payload), 2):
        out.append(cc_data_triplet(3 if i == 0 else 2, payload[i], payload[i + 1]))
    return out


def service_block(service: int, data: bytes) -> bytes:
    if not 0 < service <= 63:
        raise ValueError(f"service number out of range: {service}")
    if service > 6:
        # extended service: header service bits = 7, next byte carries the
        # 6-bit extended service number (CEA-708 §6.2.2)
        if len(data) > 31:
            raise ValueError("service block payload >31 bytes")
        return bytes([(7 << 5) | len(data), service & 0x3F]) + data
    if len(data) > 31:
        raise ValueError("service block limited to 31 bytes")
    return bytes([(service << 5) | len(data)]) + data


def _encode_text(text: str) -> bytes:
    out = bytearray()
    for ch in text:
        o = ord(ch)
        if 0x20 <= o <= 0x7F:
            out.append(o)
        elif ch in EXT_ENCODE:
            out += bytes([EXT1, EXT_ENCODE[ch]])
        else:
            out.append(ord("?"))
    return bytes(out)


def encode_pop_on_text(lines: Sequence[str], service: int = 1,
                       window: int = 0, window_style: int = 0,
                       pen_style: int = 0, anchor_vertical: int = 122,
                       anchor_horizontal: int = 0,
                       row_count: int = 0) -> List[bytes]:
    """Pop-on caption as a list of service blocks (chunked <=31 bytes):
    DLW, DefineWindow (anchor point from anchor_vertical/horizontal,
    row count from the lines or an explicit row_count), per line
    SetPenLocation + G0 text, DSW."""
    stream = bytearray()
    stream.append(DLW)
    stream.append(0xFF)  # delete all windows
    rows = max(row_count - 1 if row_count else len(lines) - 1, 0)
    cols = max((len(l) for l in lines), default=0)
    stream += bytes([
        DF0 + window,
        0x18,  # visible=0, row lock/col lock, priority 0
        anchor_vertical & 0x7F,   # relative=0, anchor vertical
        anchor_horizontal & 0xFF,
        rows & 0x0F,
        min(cols, 41) & 0x3F,
        ((window_style & 0x7) << 3) | (pen_style & 0x7),
    ])
    for i, line in enumerate(lines):
        stream += bytes([SPL, i & 0x0F, 0x00])
        stream += _encode_text(line)
        if i != len(lines) - 1:
            stream.append(CR)
    stream += bytes([DSW, 1 << window])
    blocks = []
    for i in range(0, len(stream), 31):
        blocks.append(service_block(service, bytes(stream[i : i + 31])))
    return blocks


@dataclass
class ServiceDecoder:
    """Minimal DTVCC service decoder: reconstructs window text.

    Tracks the current window's rows; emits captions on DisplayWindows."""

    rows: Dict[int, str] = field(default_factory=dict)
    current_row: int = 0
    captions: List[List[str]] = field(default_factory=list)

    def feed(self, data: bytes) -> None:
        i = 0
        while i < len(data):
            b = data[i]
            if b == 0x00 or b == ETX:
                i += 1
            elif b == CR:
                self.current_row += 1
                i += 1
            elif 0x20 <= b <= 0x7F:
                self.rows[self.current_row] = self.rows.get(self.current_row, "") + chr(b)
                i += 1
            elif b == RST:
                self.rows = {}
                self.current_row = 0
                i += 1
            elif b == DLW:
                self.rows = {}
                self.current_row = 0
                i += 2
            elif b == DSW:
                lines = [self.rows[r] for r in sorted(self.rows) if self.rows[r]]
                if lines:
                    self.captions.append(lines)
                i += 2
            elif b == SPL:
                self.current_row = data[i + 1] & 0x0F
                i += 3
            elif b == EXT1 and i + 1 < len(data):
                e = data[i + 1]
                ch = G2_MAP.get(e) if e < 0x80 else G3_MAP.get(e)
                if ch is not None:
                    self.rows[self.current_row] = self.rows.get(self.current_row, "") + ch
                    i += 2
                elif e <= 0x1F:  # C2: 0x00-07 none, 08-0F +1, 10-17 +2, 18-1F +3
                    i += 2 + (e >> 3)
                elif 0x80 <= e <= 0x9F:  # C3: 0x80-87 +4, 0x88-8F +5
                    i += 2 + 4 + ((e >> 3) & 1)
                else:
                    i += 2
            elif 0x80 <= b <= 0x9F:
                i += 1 + _C1_OPERANDS.get(b, 0)
            else:
                i += 1  # C0/extended: skip

    def take_captions(self) -> List[List[str]]:
        out, self.captions = self.captions, []
        return out


def decode_dtvcc(triplets, decoders: Optional[Dict[int, ServiceDecoder]] = None
                 ) -> Dict[int, ServiceDecoder]:
    """Assemble DTVCC packets from (valid, type, b1, b2) triplets and feed
    per-service decoders."""
    decoders = decoders if decoders is not None else {}
    packet = bytearray()
    for valid, cc_type, b1, b2 in triplets:
        if not valid:
            continue
        if cc_type == 3:
            if packet:
                _dispatch_packet(bytes(packet), decoders)
            packet = bytearray([b1, b2])
        elif cc_type == 2 and packet:
            packet += bytes([b1, b2])
    if packet:
        _dispatch_packet(bytes(packet), decoders)
    return decoders


def _dispatch_packet(packet: bytes, decoders: Dict[int, ServiceDecoder]) -> None:
    pos = 1  # skip sequence/size header
    while pos < len(packet):
        hdr = packet[pos]
        service = hdr >> 5
        size = hdr & 0x1F
        if service == 0 or size == 0:
            break
        if service == 7 and pos + 1 < len(packet):
            # extended service number byte follows the header (§6.2.2)
            service = packet[pos + 1] & 0x3F
            pos += 1
        data = packet[pos + 1 : pos + 1 + size]
        decoders.setdefault(service, ServiceDecoder()).feed(data)
        pos += 1 + size


# ---------------------------------------------------------------------------
# CDP framing (SMPTE 334-2)
# ---------------------------------------------------------------------------
_CDP_RATES = {24: 0x1, 25: 0x2, 30: 0x3, 50: 0x4, 60: 0x5}  # 23.98~24 etc.


def build_cdp(cc_data: bytes, *, sequence: int = 0, fps: int = 30,
              service_info: Optional[bytes] = None) -> bytes:
    cc_count = len(cc_data) // 3
    body = bytearray()
    body += bytes([0x96, 0x69])
    body.append(0)  # length placeholder
    body.append((_CDP_RATES.get(fps, 0x3) << 4) | 0x0F)
    body.append(0x43)  # ccdata_present | caption_service_active | reserved
    body += sequence.to_bytes(2, "big")
    body.append(0x72)
    body.append(0xE0 | cc_count)
    body += cc_data
    if service_info is not None:
        body.append(0x73)
        body += service_info
    body.append(0x74)
    body += sequence.to_bytes(2, "big")
    body.append(0)  # checksum placeholder
    body[2] = len(body)
    checksum = (256 - (sum(body) - body[-1])) & 0xFF
    body[-1] = checksum
    return bytes(body)


def parse_cdp(data: bytes) -> Tuple[bytes, int]:
    """-> (cc_data bytes, sequence); validates framing + checksum."""
    if len(data) < 8 or data[0] != 0x96 or data[1] != 0x69:
        raise ValueError("not a CDP")
    length = data[2]
    if length > len(data):
        raise ValueError("truncated CDP")
    pkt = data[:length]
    if sum(pkt) & 0xFF:
        raise ValueError("CDP checksum mismatch")
    sequence = int.from_bytes(pkt[5:7], "big")
    pos = 7
    cc_data = b""
    while pos < len(pkt):
        section = pkt[pos]
        if section == 0x72:
            count = pkt[pos + 1] & 0x1F
            cc_data = pkt[pos + 2 : pos + 2 + 3 * count]
            pos += 2 + 3 * count
        elif section == 0x73:
            svc_count = pkt[pos + 1] & 0x0F
            pos += 2 + 7 * svc_count
        elif section == 0x74:
            break
        else:
            pos += 1
    return cc_data, sequence


__all__ = [
    "cc_data_triplet", "parse_cc_data", "pack_dtvcc_packet", "service_block",
    "encode_pop_on_text", "ServiceDecoder", "decode_dtvcc",
    "build_cdp", "parse_cdp",
    "RST", "DLW", "DSW", "SPL", "CR", "DF0",
]


def _filter_packet_blocks(packet: bytes, discard) -> bytes:
    """Service blocks of one DTVCC packet with `discard`ed services removed
    (header byte excluded from the result)."""
    pos = 1
    out = bytearray()
    while pos < len(packet):
        hdr = packet[pos]
        service = hdr >> 5
        size = hdr & 0x1F
        if service == 0 or size == 0:
            break
        ext = 0
        if service == 7 and pos + 1 < len(packet):
            service = packet[pos + 1] & 0x3F
            ext = 1
        block = packet[pos:pos + 1 + ext + size]
        if service not in discard:
            out += block
        pos += 1 + ext + size
    return bytes(out)


def filter_dtvcc_services(cc_data: bytes, discard) -> bytes:
    """Drop DTVCC service blocks for the given service numbers from packed
    cc_data triplets (cea708mux sink-pad `discarded-services` property;
    reference GstCea708MuxSinkPad).  608 compatibility triplets (types
    0/1) pass through untouched; surviving DTVCC packets are re-packed
    with their original sequence numbers."""
    discard = set(discard)
    trips = parse_cc_data(cc_data)
    out = bytearray()
    for valid, cc_type, b1, b2 in trips:
        if cc_type in (0, 1):
            out += cc_data_triplet(cc_type, b1, b2, valid)
    packets = []
    packet = bytearray()
    for valid, cc_type, b1, b2 in trips:
        if not valid or cc_type in (0, 1):
            continue
        if cc_type == 3:
            if packet:
                packets.append(bytes(packet))
            packet = bytearray([b1, b2])
        elif cc_type == 2 and packet:
            packet += bytes([b1, b2])
    if packet:
        packets.append(bytes(packet))
    for pkt in packets:
        blocks = _filter_packet_blocks(pkt, discard)
        if blocks:
            for trip in pack_dtvcc_packet(blocks, sequence=pkt[0] >> 6):
                out += trip
    return bytes(out)
