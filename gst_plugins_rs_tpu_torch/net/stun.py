"""STUN message codec (RFC 5389) — the wire layer under ICE.

Parity target: the reference's webrtc elements delegate ICE/STUN to
webrtc-ice / libnice via webrtcbin (net/webrtc/src/webrtcsink/imp.rs uses
gst webrtcbin); this framework owns the protocol natively.  Covers the
subset ICE needs: Binding request/success/error, attributes USERNAME,
MESSAGE-INTEGRITY (HMAC-SHA1), FINGERPRINT (CRC-32 ^ 0x5354554e),
XOR-MAPPED-ADDRESS, PRIORITY, USE-CANDIDATE, ICE-CONTROLLED/CONTROLLING
(RFC 8445 §7.1), ERROR-CODE.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import socket
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

MAGIC_COOKIE = 0x2112A442

# Message types (class bits folded into method per RFC 5389 §6)
BINDING_REQUEST = 0x0001
BINDING_SUCCESS = 0x0101
BINDING_ERROR = 0x0111
BINDING_INDICATION = 0x0011

# Attributes
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_UNKNOWN_ATTRIBUTES = 0x000A
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_SOFTWARE = 0x8022
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A

FINGERPRINT_XOR = 0x5354554E  # "STUN"


def is_stun(data: bytes) -> bool:
    """Demux test: first two bits 00 + magic cookie (RFC 5764 §5.1.2)."""
    return (
        len(data) >= 20
        and data[0] < 0x40
        and struct.unpack("!I", data[4:8])[0] == MAGIC_COOKIE
    )


@dataclass
class StunMessage:
    msg_type: int
    transaction_id: bytes = field(default_factory=lambda: os.urandom(12))
    attrs: List[Tuple[int, bytes]] = field(default_factory=list)

    # -- attribute helpers -------------------------------------------------
    def get(self, attr_type: int) -> Optional[bytes]:
        for t, v in self.attrs:
            if t == attr_type:
                return v
        return None

    def add(self, attr_type: int, value: bytes) -> "StunMessage":
        self.attrs.append((attr_type, value))
        return self

    def add_username(self, username: str) -> "StunMessage":
        return self.add(ATTR_USERNAME, username.encode())

    @property
    def username(self) -> Optional[str]:
        v = self.get(ATTR_USERNAME)
        return v.decode() if v is not None else None

    def add_priority(self, priority: int) -> "StunMessage":
        return self.add(ATTR_PRIORITY, struct.pack("!I", priority))

    @property
    def priority(self) -> Optional[int]:
        v = self.get(ATTR_PRIORITY)
        return struct.unpack("!I", v)[0] if v is not None else None

    def add_error(self, code: int, reason: str = "") -> "StunMessage":
        return self.add(
            ATTR_ERROR_CODE,
            struct.pack("!HBB", 0, code // 100, code % 100) + reason.encode(),
        )

    @property
    def error_code(self) -> Optional[int]:
        v = self.get(ATTR_ERROR_CODE)
        if v is None or len(v) < 4:
            return None
        return v[2] * 100 + v[3]

    def add_xor_mapped_address(self, host: str, port: int) -> "StunMessage":
        xport = port ^ (MAGIC_COOKIE >> 16)
        raw = socket.inet_aton(host)
        xaddr = bytes(b ^ m for b, m in zip(raw, struct.pack("!I", MAGIC_COOKIE)))
        return self.add(ATTR_XOR_MAPPED_ADDRESS, struct.pack("!BBH", 0, 0x01, xport) + xaddr)

    @property
    def xor_mapped_address(self) -> Optional[Tuple[str, int]]:
        v = self.get(ATTR_XOR_MAPPED_ADDRESS)
        if v is None or len(v) < 8 or v[1] != 0x01:
            return None
        port = struct.unpack("!H", v[2:4])[0] ^ (MAGIC_COOKIE >> 16)
        addr = bytes(b ^ m for b, m in zip(v[4:8], struct.pack("!I", MAGIC_COOKIE)))
        return socket.inet_ntoa(addr), port

    # -- wire --------------------------------------------------------------
    def _encode_attrs(self, attrs: List[Tuple[int, bytes]]) -> bytes:
        out = bytearray()
        for t, v in attrs:
            out += struct.pack("!HH", t, len(v))
            out += v
            out += b"\x00" * (-len(v) % 4)
        return bytes(out)

    def encode(self, integrity_key: Optional[bytes] = None, fingerprint: bool = True) -> bytes:
        """Serialize; MESSAGE-INTEGRITY then FINGERPRINT appended per RFC 5389 §15.4/15.5."""
        attrs = list(self.attrs)
        body = self._encode_attrs(attrs)

        def header(body_len: int) -> bytes:
            return struct.pack("!HHI", self.msg_type, body_len, MAGIC_COOKIE) + self.transaction_id

        if integrity_key is not None:
            # Length field covers up to and including the MI attribute while hashing.
            hash_input = header(len(body) + 24) + body
            mac = hmac.new(integrity_key, hash_input, hashlib.sha1).digest()
            attrs.append((ATTR_MESSAGE_INTEGRITY, mac))
            body = self._encode_attrs(attrs)
        if fingerprint:
            fp_input = header(len(body) + 8) + body
            fp = (zlib.crc32(fp_input) & 0xFFFFFFFF) ^ FINGERPRINT_XOR
            attrs.append((ATTR_FINGERPRINT, struct.pack("!I", fp)))
            body = self._encode_attrs(attrs)
        return header(len(body)) + body

    @classmethod
    def decode(cls, data: bytes) -> "StunMessage":
        if len(data) < 20:
            raise ValueError("short STUN message")
        msg_type, length, cookie = struct.unpack("!HHI", data[:8])
        if cookie != MAGIC_COOKIE:
            raise ValueError("bad magic cookie")
        if len(data) < 20 + length:
            raise ValueError("truncated STUN message")
        tid = data[8:20]
        attrs: List[Tuple[int, bytes]] = []
        off = 20
        end = 20 + length
        while off + 4 <= end:
            t, alen = struct.unpack("!HH", data[off:off + 4])
            v = data[off + 4:off + 4 + alen]
            if len(v) != alen:
                raise ValueError("truncated attribute")
            attrs.append((t, v))
            off += 4 + alen + (-alen % 4)
        return cls(msg_type, tid, attrs)

    def verify_integrity(self, data: bytes, key: bytes) -> bool:
        """Check MESSAGE-INTEGRITY over the original wire bytes (RFC 5389 §15.4)."""
        off = 20
        while off + 4 <= len(data):
            t, alen = struct.unpack("!HH", data[off:off + 4])
            if t == ATTR_MESSAGE_INTEGRITY:
                # Hash covers the header (length rewritten to end at this attr) + preceding attrs.
                hdr = struct.pack(
                    "!HHI", self.msg_type, off - 20 + 24, MAGIC_COOKIE
                ) + self.transaction_id
                expect = hmac.new(key, hdr + data[20:off], hashlib.sha1).digest()
                return hmac.compare_digest(expect, data[off + 4:off + 24])
            off += 4 + alen + (-alen % 4)
        return False
