"""AWS event-stream binary framing (vnd.amazon.eventstream).

Parity target: the reference's awstranscriber speaks this through the
AWS SDK (net/aws/src/transcriber); here the codec is in-repo.  Message =
prelude (total_len, headers_len, prelude_crc32) + headers + payload +
message_crc32.  Header value types: only 7 (string) is needed by
Transcribe streaming, but bool/byte/int/long/bytes/timestamp are decoded
for completeness.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple


def encode_headers(headers: Dict[str, str]) -> bytes:
    out = bytearray()
    for name, value in headers.items():
        nb = name.encode()
        vb = value.encode()
        out += bytes([len(nb)]) + nb + bytes([7]) + struct.pack("!H", len(vb)) + vb
    return bytes(out)


def decode_headers(data: bytes) -> Dict[str, object]:
    headers: Dict[str, object] = {}
    off = 0
    while off < len(data):
        nlen = data[off]; off += 1
        name = data[off:off + nlen].decode(); off += nlen
        vtype = data[off]; off += 1
        if vtype == 0:
            headers[name] = True
        elif vtype == 1:
            headers[name] = False
        elif vtype == 2:
            headers[name] = data[off]; off += 1
        elif vtype == 3:
            headers[name] = struct.unpack("!h", data[off:off + 2])[0]; off += 2
        elif vtype == 4:
            headers[name] = struct.unpack("!i", data[off:off + 4])[0]; off += 4
        elif vtype in (5, 8):  # long / timestamp
            headers[name] = struct.unpack("!q", data[off:off + 8])[0]; off += 8
        elif vtype in (6, 7):  # bytes / string
            vlen = struct.unpack("!H", data[off:off + 2])[0]; off += 2
            raw = data[off:off + vlen]; off += vlen
            headers[name] = raw.decode() if vtype == 7 else raw
        elif vtype == 9:  # uuid
            headers[name] = data[off:off + 16]; off += 16
        else:
            raise ValueError(f"unknown header value type {vtype}")
    return headers


def encode_message(headers: Dict[str, str], payload: bytes) -> bytes:
    h = encode_headers(headers)
    total = 12 + len(h) + len(payload) + 4
    prelude = struct.pack("!II", total, len(h))
    prelude_crc = struct.pack("!I", zlib.crc32(prelude) & 0xFFFFFFFF)
    body = prelude + prelude_crc + h + payload
    return body + struct.pack("!I", zlib.crc32(body) & 0xFFFFFFFF)


def decode_message(data: bytes) -> Tuple[Dict[str, object], bytes, int]:
    """Returns (headers, payload, total_length); raises on CRC mismatch."""
    if len(data) < 16:
        raise ValueError("short eventstream message")
    total, hlen = struct.unpack("!II", data[:8])
    if len(data) < total:
        raise ValueError("truncated eventstream message")
    (prelude_crc,) = struct.unpack("!I", data[8:12])
    if zlib.crc32(data[:8]) & 0xFFFFFFFF != prelude_crc:
        raise ValueError("prelude CRC mismatch")
    (msg_crc,) = struct.unpack("!I", data[total - 4:total])
    if zlib.crc32(data[:total - 4]) & 0xFFFFFFFF != msg_crc:
        raise ValueError("message CRC mismatch")
    headers = decode_headers(data[12:12 + hlen])
    payload = data[12 + hlen:total - 4]
    return headers, payload, total
