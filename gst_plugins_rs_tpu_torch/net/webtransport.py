"""WebTransport over HTTP/3 (draft-ietf-webtrans-http3) on the native QUIC.

Parity target: the reference's quinnwtsink/quinnwtsrc ride
web-transport-quinn; here the session layer is in-repo:

- H3 unidirectional stream types: control (0x00) carrying SETTINGS with
  SETTINGS_ENABLE_CONNECT_PROTOCOL / H3_DATAGRAM / ENABLE_WEBTRANSPORT;
  WebTransport uni streams (type 0x54) prefixed with the session id
- session establishment: extended CONNECT (:protocol = webtransport) on
  a client bidi stream; the server answers :status 200; that stream's
  id is the session id
- WT datagrams: quarter-stream-id varint prefix (RFC 9297)

Header blocks use a self-consistent literal-name/literal-value field
encoding (no QPACK static/dynamic table) — both ends are this module, so
the simplification is wire-visible only against foreign stacks
(documented divergence; the reference depends on a full QPACK impl).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from .quic import QuicConnection, decode_varint, encode_varint

H3_STREAM_CONTROL = 0x00
H3_STREAM_WT = 0x54
H3_FRAME_HEADERS = 0x01
H3_FRAME_SETTINGS = 0x04

SETTINGS_QPACK_MAX_TABLE_CAPACITY = 0x01
SETTINGS_ENABLE_CONNECT_PROTOCOL = 0x08
SETTINGS_H3_DATAGRAM = 0x33
SETTINGS_ENABLE_WEBTRANSPORT = 0x2B603742
SETTINGS_WT_MAX_SESSIONS = 0xC671706A


def encode_headers(headers: List[Tuple[str, str]]) -> bytes:
    out = bytearray(b"\x00\x00")  # field section prefix (no dynamic table)
    for name, value in headers:
        nb, vb = name.encode(), value.encode()
        out += encode_varint(len(nb)) + nb + encode_varint(len(vb)) + vb
    return bytes(out)


def decode_headers(data: bytes) -> List[Tuple[str, str]]:
    headers: List[Tuple[str, str]] = []
    off = 2
    while off < len(data):
        nlen, off = decode_varint(data, off)
        name = data[off:off + nlen].decode(); off += nlen
        vlen, off = decode_varint(data, off)
        value = data[off:off + vlen].decode(); off += vlen
        headers.append((name, value))
    return headers


def _h3_frame(ftype: int, payload: bytes) -> bytes:
    return encode_varint(ftype) + encode_varint(len(payload)) + payload


def _settings_payload() -> bytes:
    out = b""
    for k, v in ((SETTINGS_ENABLE_CONNECT_PROTOCOL, 1),
                 (SETTINGS_H3_DATAGRAM, 1),
                 (SETTINGS_ENABLE_WEBTRANSPORT, 1),
                 (SETTINGS_WT_MAX_SESSIONS, 16)):
        out += encode_varint(k) + encode_varint(v)
    return out


class WebTransportSession:
    """One WT session over a QuicConnection (client or server side)."""

    def __init__(self, conn: QuicConnection, is_client: bool,
                 authority: str = "localhost", path: str = "/"):
        self.conn = conn
        self.is_client = is_client
        self.authority = authority
        self.path = path
        self.session_id: Optional[int] = None
        self.established = threading.Event()
        self.on_stream_data: Optional[Callable[[int, bytes, bool], None]] = None
        self.on_datagram: Optional[Callable[[bytes], None]] = None
        self.on_session_request: Optional[Callable[[List[Tuple[str, str]]], bool]] = None
        self._stream_buf: Dict[int, bytearray] = {}
        self._stream_kind: Dict[int, Optional[dict]] = {}
        self._wt_send_streams: Dict[int, int] = {}
        conn.on_stream_data = self._on_quic_stream
        conn.on_datagram = self._on_quic_datagram
        self._control_sent = False

    # -- establishment ----------------------------------------------------------
    def start(self) -> None:
        """Send control stream + (client) the extended CONNECT."""
        ctrl = self.conn.open_uni_stream()
        self.conn.send_stream(ctrl, encode_varint(H3_STREAM_CONTROL)
                              + _h3_frame(H3_FRAME_SETTINGS, _settings_payload()))
        self._control_sent = True
        if self.is_client:
            sid = self.conn.open_bidi_stream()
            self.session_id = sid
            headers = [
                (":method", "CONNECT"),
                (":protocol", "webtransport"),
                (":scheme", "https"),
                (":authority", self.authority),
                (":path", self.path),
            ]
            self.conn.send_stream(sid, _h3_frame(H3_FRAME_HEADERS, encode_headers(headers)))

    def wait_established(self, timeout: float = 5.0) -> bool:
        return self.established.wait(timeout)

    # -- sending -------------------------------------------------------------------
    def open_uni_stream(self) -> int:
        """Returns a local handle; the wire stream carries the WT preamble."""
        qsid = self.conn.open_uni_stream()
        self.conn.send_stream(qsid, encode_varint(H3_STREAM_WT)
                              + encode_varint(self.session_id))
        return qsid

    def send_stream(self, qsid: int, data: bytes, fin: bool = False) -> None:
        self.conn.send_stream(qsid, data, fin=fin)

    def send_datagram(self, data: bytes) -> None:
        # RFC 9297: quarter stream id prefix
        self.conn.send_datagram(encode_varint(self.session_id // 4) + data)

    # -- receive ----------------------------------------------------------------------
    def _on_quic_stream(self, qsid: int, data: bytes, fin: bool) -> None:
        buf = self._stream_buf.setdefault(qsid, bytearray())
        buf += data
        kind = self._stream_kind.get(qsid)
        if kind is None:
            kind = self._classify(qsid, buf)
            if kind is None:
                return  # need more bytes
            self._stream_kind[qsid] = kind
        if kind["type"] == "wt":
            if buf or fin:
                payload = bytes(buf)
                buf.clear()
                if self.on_stream_data and (payload or fin):
                    self.on_stream_data(qsid, payload, fin)
        elif kind["type"] == "request":
            self._handle_request_stream(qsid, buf)
        # control / unknown: frames consumed in _classify / ignored

    def _classify(self, qsid: int, buf: bytearray) -> Optional[dict]:
        uni = (qsid & 0x2) != 0
        if uni:
            remote_uni = (qsid % 4) == (3 if self.is_client else 2)
            if not remote_uni:
                return {"type": "ignore"}
            try:
                stype, off = decode_varint(buf, 0)
            except IndexError:
                return None
            if stype == H3_STREAM_WT:
                try:
                    session, off2 = decode_varint(buf, off)
                except IndexError:
                    return None
                del buf[:off2]
                return {"type": "wt", "session": session}
            if stype == H3_STREAM_CONTROL:
                del buf[:off]
                return {"type": "control"}
            return {"type": "ignore"}
        # bidi: the server sees client request streams; the client sees responses
        return {"type": "request"}

    def _handle_request_stream(self, qsid: int, buf: bytearray) -> None:
        try:
            ftype, off = decode_varint(buf, 0)
            flen, off = decode_varint(buf, off)
        except IndexError:
            return
        if len(buf) < off + flen:
            return
        payload = bytes(buf[off:off + flen])
        del buf[:off + flen]
        if ftype != H3_FRAME_HEADERS:
            return
        headers = dict(decode_headers(payload))
        if not self.is_client:
            if headers.get(":method") == "CONNECT" \
                    and headers.get(":protocol") == "webtransport":
                accept = True
                if self.on_session_request is not None:
                    accept = self.on_session_request(list(headers.items()))
                status = "200" if accept else "403"
                self.conn.send_stream(qsid, _h3_frame(
                    H3_FRAME_HEADERS, encode_headers([(":status", status)])))
                if accept:
                    self.session_id = qsid
                    self.established.set()
        else:
            if headers.get(":status") == "200":
                self.established.set()

    def _on_quic_datagram(self, data: bytes) -> None:
        try:
            _qsid, off = decode_varint(data, 0)
        except IndexError:
            return
        if self.on_datagram:
            self.on_datagram(data[off:])
