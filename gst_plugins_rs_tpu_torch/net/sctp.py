"""Minimal SCTP over DTLS + WebRTC data channels (DCEP).

From-scratch implementation of the subset WebRTC data channels need:

- RFC 9260 (SCTP): association handshake (INIT / INIT-ACK with state
  cookie / COOKIE-ECHO / COOKIE-ACK), ordered-reliable DATA with TSN
  tracking, cumulative SACK, timeout retransmission, HEARTBEAT,
  ABORT/SHUTDOWN, CRC32c checksums.  Single-homed (the one DTLS flow),
  which is all RFC 8261 (SCTP-over-DTLS) uses.
- RFC 8831 (WebRTC data channels): PPIDs 50/51/53/56/57 (DCEP, string,
  binary, empty string/binary).
- RFC 8832 (DCEP): DATA_CHANNEL_OPEN / DATA_CHANNEL_ACK; the DTLS client
  uses even stream ids, the server odd ones.

Reference parity: the reference's webrtcsink drives a `control` channel
and consumes navigation events over an `input` channel
(net/webrtc/src/webrtcsink/imp.rs:5547-5560 enable-control-data-channel /
enable-data-channel-navigation; webrtcsrc/imp.rs consumes/creates the
same channels).  The reference rides webrtc-rs's SCTP stack; this module
is the framework's own.

Messages up to 64 MiB fragment/reassemble via the B/E bits.  Partial
reliability (RFC 3758) is not implemented — DCEP channels negotiated
with reliability parameters fall back to reliable delivery.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# -- CRC32c (Castagnoli, reflected 0x1EDC6F41) --------------------------------
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC32C_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


# -- chunk/type constants ------------------------------------------------------
CT_DATA = 0
CT_INIT = 1
CT_INIT_ACK = 2
CT_SACK = 3
CT_HEARTBEAT = 4
CT_HEARTBEAT_ACK = 5
CT_ABORT = 6
CT_SHUTDOWN = 7
CT_SHUTDOWN_ACK = 8
CT_COOKIE_ECHO = 10
CT_COOKIE_ACK = 11

PARAM_STATE_COOKIE = 7

PPID_DCEP = 50
PPID_STRING = 51
PPID_BINARY = 53
PPID_STRING_EMPTY = 56
PPID_BINARY_EMPTY = 57

DCEP_OPEN = 0x03
DCEP_ACK = 0x02

SCTP_PORT = 5000
MAX_FRAGMENT = 1100  # DATA payload bytes per chunk (fits DTLS records)
RTO = 0.2  # retransmission timeout (s); loopback-friendly
MAX_RETRANS = 10


def _pad4(b: bytes) -> bytes:
    return b + b"\x00" * (-len(b) % 4)


def _chunk(ctype: int, flags: int, value: bytes) -> bytes:
    return struct.pack(">BBH", ctype, flags, 4 + len(value)) + _pad4(value)


def _parse_chunks(body: bytes) -> List[Tuple[int, int, bytes]]:
    out = []
    pos = 0
    while pos + 4 <= len(body):
        ctype, flags, length = struct.unpack_from(">BBH", body, pos)
        if length < 4:
            break
        out.append((ctype, flags, body[pos + 4:pos + length]))
        pos += length + (-length % 4)
    return out


class DataChannel:
    """One WebRTC data channel (RFC 8831) on an SCTP stream."""

    def __init__(self, assoc: "SctpAssociation", sid: int, label: str,
                 protocol: str = ""):
        self.assoc = assoc
        self.sid = sid
        self.label = label
        self.protocol = protocol
        self.ready = threading.Event()
        #: (data, is_binary) -> None
        self.on_message: Optional[Callable[[bytes, bool], None]] = None
        self.on_open: Optional[Callable[[], None]] = None

    def send(self, data, *, binary: Optional[bool] = None) -> None:
        if isinstance(data, str):
            payload, is_bin = data.encode(), False
        else:
            payload, is_bin = bytes(data), True if binary is None else binary
        if not payload:
            ppid = PPID_BINARY_EMPTY if is_bin else PPID_STRING_EMPTY
            payload = b"\x00"  # RFC 8831 §6.6: one zero byte stands in
        else:
            ppid = PPID_BINARY if is_bin else PPID_STRING
        self.assoc.send_data(self.sid, ppid, payload)

    def _deliver(self, ppid: int, data: bytes) -> None:
        if ppid in (PPID_STRING_EMPTY, PPID_BINARY_EMPTY):
            data = b""
        binary = ppid in (PPID_BINARY, PPID_BINARY_EMPTY)
        if self.on_message is not None:
            self.on_message(data, binary)


class SctpAssociation:
    """Single-homed SCTP association over a reliable-ish datagram callback
    (DTLS application data).  `client` selects DCEP stream-id parity."""

    def __init__(self, send_cb: Callable[[bytes], None], *, client: bool,
                 port: int = SCTP_PORT):
        self.send_cb = send_cb
        self.client = client
        self.port = port
        self.local_vtag = struct.unpack(">I", os.urandom(4))[0] or 1
        self.peer_vtag = 0
        self.established = threading.Event()
        self.closed = threading.Event()
        self.on_channel: Optional[Callable[[DataChannel], None]] = None
        self.channels: Dict[int, DataChannel] = {}
        self._next_sid = 0 if client else 1
        self._tsn = struct.unpack(">I", os.urandom(4))[0] & 0x7FFFFFFF
        self._peer_cum_tsn: Optional[int] = None  # highest delivered
        self._rx_buffer: Dict[int, Tuple[int, int, int, int, bytes]] = {}
        self._ssn_tx: Dict[int, int] = {}
        self._reasm: Dict[int, List[Tuple[int, bytes]]] = {}
        #: tsn -> (packet bytes, first-sent time, attempts)
        self._unacked: Dict[int, List] = {}
        self._lock = threading.RLock()
        self._init_pkt: Optional[bytes] = None
        self._cookie_pkt: Optional[bytes] = None

    # -- packet assembly ------------------------------------------------------
    def _send_packet(self, chunks: bytes, vtag: Optional[int] = None) -> None:
        hdr = struct.pack(">HHII", self.port, self.port,
                          self.peer_vtag if vtag is None else vtag, 0)
        pkt = bytearray(hdr + chunks)
        struct.pack_into("<I", pkt, 8, crc32c(bytes(pkt)))
        self.send_cb(bytes(pkt))

    # -- association setup ----------------------------------------------------
    def connect(self) -> None:
        """Client side: start the 4-way handshake."""
        init = struct.pack(">IIHHI", self.local_vtag, 128 * 1024,
                           1024, 1024, self._tsn)
        self._init_pkt = _chunk(CT_INIT, 0, init)
        self._send_packet(self._init_pkt, vtag=0)

    def _handle_init(self, value: bytes) -> None:
        (itag, _arwnd, _os, _is, itsn) = struct.unpack_from(">IIHHI", value, 0)
        self.peer_vtag = itag
        self._peer_cum_tsn = (itsn - 1) & 0xFFFFFFFF
        cookie = os.urandom(16)
        body = struct.pack(">IIHHI", self.local_vtag, 128 * 1024,
                           1024, 1024, self._tsn)
        body += struct.pack(">HH", PARAM_STATE_COOKIE, 4 + len(cookie)) + _pad4(cookie)
        self._send_packet(_chunk(CT_INIT_ACK, 0, body))

    def _handle_init_ack(self, value: bytes) -> None:
        (itag, _arwnd, _os, _is, itsn) = struct.unpack_from(">IIHHI", value, 0)
        self.peer_vtag = itag
        self._peer_cum_tsn = (itsn - 1) & 0xFFFFFFFF
        pos = 16
        cookie = b""
        while pos + 4 <= len(value):
            ptype, plen = struct.unpack_from(">HH", value, pos)
            if ptype == PARAM_STATE_COOKIE:
                cookie = value[pos + 4:pos + plen]
            pos += plen + (-plen % 4)
        self._cookie_pkt = _chunk(CT_COOKIE_ECHO, 0, cookie)
        self._send_packet(self._cookie_pkt)

    # -- data send ----------------------------------------------------------------
    def send_data(self, sid: int, ppid: int, payload: bytes) -> None:
        if self.closed.is_set():
            raise RuntimeError("SCTP association closed")
        with self._lock:
            ssn = self._ssn_tx.get(sid, 0)
            self._ssn_tx[sid] = (ssn + 1) & 0xFFFF
            frags = [payload[i:i + MAX_FRAGMENT]
                     for i in range(0, len(payload), MAX_FRAGMENT)] or [b""]
            now = time.monotonic()
            for i, frag in enumerate(frags):
                flags = 0
                if i == 0:
                    flags |= 0x02  # B
                if i == len(frags) - 1:
                    flags |= 0x01  # E
                tsn = self._tsn
                self._tsn = (self._tsn + 1) & 0xFFFFFFFF
                value = struct.pack(">IHHI", tsn, sid, ssn, ppid) + frag
                chunk = _chunk(CT_DATA, flags, value)
                self._unacked[tsn] = [chunk, now, 0]
                self._send_packet(chunk)

    # -- receive path ---------------------------------------------------------
    def feed(self, packet: bytes) -> None:
        if len(packet) < 12:
            return
        # verify CRC32c (common header checksum field zeroed)
        given = struct.unpack_from("<I", packet, 8)[0]
        zeroed = bytearray(packet)
        struct.pack_into("<I", zeroed, 8, 0)
        if crc32c(bytes(zeroed)) != given:
            return
        with self._lock:
            sack_due = False
            for ctype, flags, value in _parse_chunks(packet[12:]):
                if ctype == CT_INIT:
                    self._handle_init(value)
                elif ctype == CT_INIT_ACK:
                    self._handle_init_ack(value)
                elif ctype == CT_COOKIE_ECHO:
                    self._send_packet(_chunk(CT_COOKIE_ACK, 0, b""))
                    self.established.set()
                elif ctype == CT_COOKIE_ACK:
                    self.established.set()
                elif ctype == CT_DATA:
                    if self._handle_data(flags, value):
                        sack_due = True
                elif ctype == CT_SACK:
                    self._handle_sack(value)
                elif ctype == CT_HEARTBEAT:
                    self._send_packet(_chunk(CT_HEARTBEAT_ACK, 0, value))
                elif ctype in (CT_ABORT, CT_SHUTDOWN):
                    if ctype == CT_SHUTDOWN:
                        self._send_packet(_chunk(CT_SHUTDOWN_ACK, 0, b""))
                    self.closed.set()
            if sack_due:
                self._send_sack()

    def _handle_data(self, flags: int, value: bytes) -> bool:
        if len(value) < 12:
            return False
        tsn, sid, ssn, ppid = struct.unpack_from(">IHHI", value, 0)
        data = value[12:]
        if self._peer_cum_tsn is None:
            self._peer_cum_tsn = (tsn - 1) & 0xFFFFFFFF
        lag = (tsn - self._peer_cum_tsn) & 0xFFFFFFFF
        if lag == 0 or lag > 0x7FFFFFFF:
            return True  # duplicate — still SACK
        self._rx_buffer[tsn] = (flags, sid, ssn, ppid, data)
        # deliver in TSN order from the cumulative point
        while ((self._peer_cum_tsn + 1) & 0xFFFFFFFF) in self._rx_buffer:
            self._peer_cum_tsn = (self._peer_cum_tsn + 1) & 0xFFFFFFFF
            f, s, n, p, d = self._rx_buffer.pop(self._peer_cum_tsn)
            self._deliver_chunk(f, s, n, p, d)
        return True

    def _deliver_chunk(self, flags: int, sid: int, ssn: int, ppid: int,
                       data: bytes) -> None:
        if flags & 0x02:  # B: new message
            self._reasm[sid] = [(ppid, data)]
        else:
            self._reasm.setdefault(sid, []).append((ppid, data))
        if not flags & 0x01:  # not E: wait for more
            return
        parts = self._reasm.pop(sid, [(ppid, data)])
        ppid = parts[0][0]
        msg = b"".join(d for _p, d in parts)
        if ppid == PPID_DCEP:
            self._handle_dcep(sid, msg)
        else:
            ch = self.channels.get(sid)
            if ch is not None:
                ch._deliver(ppid, msg)

    def _send_sack(self) -> None:
        if self._peer_cum_tsn is None:
            return
        value = struct.pack(">IIHH", self._peer_cum_tsn, 128 * 1024, 0, 0)
        self._send_packet(_chunk(CT_SACK, 0, value))

    def _handle_sack(self, value: bytes) -> None:
        cum = struct.unpack_from(">I", value, 0)[0]
        for tsn in list(self._unacked):
            if ((cum - tsn) & 0xFFFFFFFF) <= 0x7FFFFFFF:
                del self._unacked[tsn]
        if self._init_pkt is not None:
            self._init_pkt = None
        self._cookie_pkt = None

    # -- retransmission --------------------------------------------------------
    def tick(self) -> None:
        """Retransmit unacked DATA (and handshake chunks) past their RTO."""
        with self._lock:
            if self.closed.is_set():
                return
            now = time.monotonic()
            if not self.established.is_set():
                if self._init_pkt is not None:
                    self._send_packet(self._init_pkt, vtag=0)
                if self._cookie_pkt is not None:
                    self._send_packet(self._cookie_pkt)
                return
            for tsn, ent in list(self._unacked.items()):
                chunk, sent, attempts = ent
                if now - sent < RTO * (1 + attempts):
                    continue
                if attempts >= MAX_RETRANS:
                    self.closed.set()
                    return
                ent[1], ent[2] = now, attempts + 1
                self._send_packet(chunk)

    def shutdown(self) -> None:
        with self._lock:
            if not self.closed.is_set():
                self._send_packet(_chunk(CT_SHUTDOWN, 0,
                                         struct.pack(">I", self._peer_cum_tsn or 0)))
                self.closed.set()

    # -- DCEP -------------------------------------------------------------------
    def open_channel(self, label: str, protocol: str = "") -> DataChannel:
        with self._lock:
            sid = self._next_sid
            self._next_sid += 2
            ch = DataChannel(self, sid, label, protocol)
            self.channels[sid] = ch
            lb, pb = label.encode(), protocol.encode()
            # channel type 0x00 = reliable ordered (RFC 8832 §5.1)
            msg = struct.pack(">BBHIHH", DCEP_OPEN, 0x00, 0, 0,
                              len(lb), len(pb)) + lb + pb
            self.send_data(sid, PPID_DCEP, msg)
            return ch

    def _handle_dcep(self, sid: int, msg: bytes) -> None:
        if not msg:
            return
        if msg[0] == DCEP_OPEN and len(msg) >= 12:
            _t, _ct, _prio, _rel, llen, plen = struct.unpack_from(">BBHIHH", msg, 0)
            label = msg[12:12 + llen].decode(errors="replace")
            protocol = msg[12 + llen:12 + llen + plen].decode(errors="replace")
            ch = DataChannel(self, sid, label, protocol)
            self.channels[sid] = ch
            self.send_data(sid, PPID_DCEP, bytes([DCEP_ACK]))
            ch.ready.set()
            if ch.on_open:
                ch.on_open()
            if self.on_channel is not None:
                self.on_channel(ch)
        elif msg[0] == DCEP_ACK:
            ch = self.channels.get(sid)
            if ch is not None:
                ch.ready.set()
                if ch.on_open:
                    ch.on_open()


__all__ = ["SctpAssociation", "DataChannel", "crc32c",
           "PPID_STRING", "PPID_BINARY", "SCTP_PORT"]
