"""QUIC v1 (RFC 9000) + packet protection (RFC 9001) — native implementation.

Parity target: the reference's quinn plugin rides the Rust quinn/rustls
stack (net/quinn); here the transport is in-repo, built on the TLS 1.3
engine in net/tls13.py.  Scope covers what the quinn elements need:

- Initial/Handshake/1-RTT packet protection (AES-128-GCM + AES-ECB
  header protection; Initial secrets validated against the RFC 9001
  Appendix A vectors in tests)
- CRYPTO / ACK / STREAM / DATAGRAM / PING / HANDSHAKE_DONE /
  CONNECTION_CLOSE frames; NEW_CONNECTION_ID and friends parsed and
  tolerated
- real flow-control accounting (RFC 9000 §4): send side clamps to the
  peer's MAX_DATA/MAX_STREAM_DATA (emitting STREAM_DATA_BLOCKED and
  releasing on credit); receive side enforces the advertised limits
  (FLOW_CONTROL_ERROR close on violation) and extends credit at half
  a window
- key update (RFC 9001 §6): key-phase bit, per-generation "quic ku"
  secrets, previous-generation keys retained for reordered packets,
  automatic follow when the peer initiates
- bidirectional + unidirectional streams with offset reassembly and
  FIN; unreliable datagrams (RFC 9221) when both sides advertise
  max_datagram_frame_size
- loss recovery (RFC 9002): ACK-driven detection with the
  kPacketThreshold=3 / 9/8-time-threshold rules over an EWMA RTT
  estimator that also feeds the PTO; tick()'s PTO retransmission is
  the backstop (the reference gets the same shape from quinn)
- congestion control (RFC 9002 §7, NewReno): slow start doubling to
  ssthresh, AIMD afterwards, one cwnd halving per recovery epoch;
  ack-eliciting 1-RTT packets beyond cwnd are held and released by
  ACKs (ACK/CLOSE-led packets always flow, so the feedback loop and
  shutdown cannot deadlock); persistent congestion (§7.6) collapses
  cwnd to the minimum window when the lost span exceeds 3x the PTO
  duration with nothing acked inside it.  Pacing is out of scope
- version negotiation (RFC 9000 §6): servers answer unknown-version
  first flights with a VN packet; clients abort on a valid VN and
  ignore spoofs (listed-own-version or wrong dcid)

- session resumption + 0-RTT (RFC 9001 §4.5/§4.6): servers issue
  NewSessionTickets (surfaced as `session_ticket`); a client built with
  `session=` resumes over the PSK and may send stream/datagram data in
  0-RTT packets with the first flight (remembered transport params cap
  it; rejected 0-RTT falls back to PTO-driven 1-RTT retransmission).
  The TLS binder/PSK schedule is validated against openssl s_server
  (tests/test_tls13_openssl_interop.py)
- stateless-style Retry address validation (RFC 9000 §8.1.2): servers
  built with `retry=True` demand a token round-trip before doing any
  handshake work; the RFC 9001 §5.8 integrity tag is produced and
  verified (spoofed Retry packets are ignored)
- connection migration (RFC 9000 §9) on address-aware transports
  (sendto_cb + handle_datagram(..., addr)): an authenticated 1-RTT
  packet from a new source address triggers PATH_CHALLENGE validation
  of that path; the matching PATH_RESPONSE migrates sending and resets
  the RTT estimator (§9.4); challenges are address-pinned with their
  own retransmit timer; probes padded to 1200 (§8.2.1); responses go
  out on the arrival path (§8.2.2).  probe_path() gives the client
  side explicit migration.

Divergences from the JAX package's copy:

- ACK frames of three or more ranges: the JAX receiver reckons the gap
  below a range of more than one packet from that range's low end less its
  length, so the ranges after it claim packets never received (the sender
  then takes them as delivered).  The port reckons every gap from the
  range above it; ACK frames of one or two ranges are the same bytes.
- ACK bookkeeping in time linear in what changed: the receiver keeps its
  received packet numbers as ranges (the JAX copy sorts them all for each
  ACK frame and scans them for each packet's number), and the sender
  walks only the packets in flight that an ACK range covers, in packet
  number order (the JAX copy visits every number a range covers, each
  ACK re-acking the whole connection), so the JAX copy's cost grows with
  the square of a connection's packets.
- Chunks the congestion window holds wait grouped, in order, and are not
  grouped again at every flush (the JAX copy regroups its whole backlog
  at each ACK); a held chunk goes before any newer ack-eliciting one.
- `Keys` keeps one AES-GCM object and one header-protection encryptor a
  key instead of building them for every packet (the same bytes).
- It counts what loss recovery does, for the quinn elements' `stats`:
  `packets_sent` (packets built, every space), `packets_lost`
  (ack-eliciting packets declared lost by the ACK-driven detection) and
  `pto_resends` (ack-eliciting packets sent again after their PTO).
"""
from __future__ import annotations

import collections
import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from .tls13 import (
    LEVEL_APP,
    LEVEL_HANDSHAKE,
    LEVEL_INITIAL,
    QuicTlsClient,
    QuicTlsServer,
    TlsError,
    hkdf_expand_label,
    hkdf_extract,
)

QUIC_VERSION = 0x00000001
INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")
# Retry integrity tag key/nonce for v1 (RFC 9001 §5.8)
RETRY_INTEGRITY_KEY = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
RETRY_INTEGRITY_NONCE = bytes.fromhex("461599d35d632bf2239825bb")


def hmac_compare(a: bytes, b: bytes) -> bool:
    import hmac as _hmac
    return _hmac.compare_digest(a, b)

# long header packet types (RFC 9000 §17.2)
PT_INITIAL = 0
PT_0RTT = 1
PT_HANDSHAKE = 2
PT_RETRY = 3

FRAME_PADDING = 0x00
FRAME_PING = 0x01
FRAME_ACK = 0x02
FRAME_CRYPTO = 0x06
FRAME_NEW_TOKEN = 0x07
FRAME_STREAM_BASE = 0x08  # 0x08..0x0f
FRAME_MAX_DATA = 0x10
FRAME_MAX_STREAM_DATA = 0x11
FRAME_MAX_STREAMS_BIDI = 0x12
FRAME_MAX_STREAMS_UNI = 0x13
FRAME_DATA_BLOCKED = 0x14
FRAME_STREAM_DATA_BLOCKED = 0x15
ERR_FLOW_CONTROL = 0x03  # RFC 9000 §20.1 FLOW_CONTROL_ERROR
FRAME_NEW_CONNECTION_ID = 0x18
FRAME_RETIRE_CONNECTION_ID = 0x19
FRAME_PATH_CHALLENGE = 0x1A
FRAME_PATH_RESPONSE = 0x1B
FRAME_CONNECTION_CLOSE = 0x1C
FRAME_CONNECTION_CLOSE_APP = 0x1D
FRAME_HANDSHAKE_DONE = 0x1E
FRAME_DATAGRAM = 0x30  # 0x30 (no len) / 0x31 (with len)

# transport parameter ids (RFC 9000 §18.2 / RFC 9221)
TP_MAX_IDLE_TIMEOUT = 0x01
TP_INITIAL_MAX_DATA = 0x04
TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL = 0x05
TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE = 0x06
TP_INITIAL_MAX_STREAM_DATA_UNI = 0x07
TP_INITIAL_MAX_STREAMS_BIDI = 0x08
TP_INITIAL_MAX_STREAMS_UNI = 0x09
TP_MAX_DATAGRAM_FRAME_SIZE = 0x20


class QuicError(Exception):
    pass


# ---------------------------------------------------------------------------
# varints


def encode_varint(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return struct.pack("!H", 0x4000 | v)
    if v < 0x40000000:
        return struct.pack("!I", 0x80000000 | v)
    return struct.pack("!Q", 0xC000000000000000 | v)


def decode_varint(data: bytes, off: int) -> Tuple[int, int]:
    first = data[off]
    prefix = first >> 6
    length = 1 << prefix
    v = first & 0x3F
    for i in range(1, length):
        v = (v << 8) | data[off + i]
    return v, off + length


def encode_transport_params(params: Dict[int, int]) -> bytes:
    out = b""
    for k, v in params.items():
        body = encode_varint(v)
        out += encode_varint(k) + encode_varint(len(body)) + body
    return out


def decode_transport_params(data: bytes) -> Dict[int, int]:
    params: Dict[int, int] = {}
    off = 0
    while off < len(data):
        k, off = decode_varint(data, off)
        ln, off = decode_varint(data, off)
        raw = data[off:off + ln]
        off += ln
        try:
            v, _ = decode_varint(raw, 0) if raw else (0, 0)
        except IndexError:
            v = 0
        params[k] = v
    return params


# ---------------------------------------------------------------------------
# packet protection (RFC 9001)


class Keys:
    def __init__(self, secret: bytes):
        self.secret = secret
        self.key = hkdf_expand_label(secret, "quic key", b"", 16)
        self.iv = hkdf_expand_label(secret, "quic iv", b"", 12)
        self.hp = hkdf_expand_label(secret, "quic hp", b"", 16)

    def next_generation(self) -> "Keys":
        """RFC 9001 §6: secret_{n+1} = HKDF-Expand-Label(secret_n,
        "quic ku"); the header-protection key is NOT updated."""
        nxt = Keys(hkdf_expand_label(self.secret, "quic ku", b"", 32))
        nxt.hp = self.hp
        return nxt

    def _nonce(self, pn: int) -> bytes:
        return bytes(a ^ b for a, b in zip(self.iv, pn.to_bytes(12, "big")))

    def _aead(self) -> AESGCM:
        # one AEAD object a key (built again if the key was replaced)
        if getattr(self, "_aead_key", None) != self.key:
            self._aead_obj, self._aead_key = AESGCM(self.key), self.key
        return self._aead_obj

    def seal(self, pn: int, header: bytes, payload: bytes) -> bytes:
        return self._aead().encrypt(self._nonce(pn), payload, header)

    def open(self, pn: int, header: bytes, ciphertext: bytes) -> bytes:
        return self._aead().decrypt(self._nonce(pn), ciphertext, header)

    def hp_mask(self, sample: bytes) -> bytes:
        # ECB holds no state between blocks: one encryptor a key serves
        # every sample
        if getattr(self, "_hp_key", None) != self.hp:
            self._hp_enc = Cipher(algorithms.AES(self.hp), modes.ECB()).encryptor()
            self._hp_key = self.hp
        return self._hp_enc.update(sample)


def initial_keys(dcid: bytes) -> Tuple[Keys, Keys]:
    """(client_keys, server_keys) for the Initial space (RFC 9001 §5.2)."""
    initial_secret = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial_secret, "client in", b"", 32)
    server = hkdf_expand_label(initial_secret, "server in", b"", 32)
    return Keys(client), Keys(server)


def _encode_pn(pn: int) -> bytes:
    return struct.pack("!I", pn & 0xFFFFFFFF)  # always 4 bytes, simple + valid


# ---------------------------------------------------------------------------
# streams


class RecvStream:
    def __init__(self) -> None:
        self.chunks: Dict[int, bytes] = {}
        self.delivered = 0
        self.fin_at: Optional[int] = None
        self.buffer = bytearray()
        self.finished = False

    def push(self, offset: int, data: bytes, fin: bool) -> bytes:
        if data:
            self.chunks[offset] = data
        if fin:
            self.fin_at = offset + len(data)
        out = bytearray()
        progressed = True
        while progressed:
            progressed = False
            if self.delivered in self.chunks:
                chunk = self.chunks.pop(self.delivered)
                out += chunk
                self.delivered += len(chunk)
                progressed = True
                continue
            # Peers (e.g. quinn) may retransmit overlapping ranges: a chunk
            # starting below the watermark but extending past it still
            # carries new bytes — deliver its un-delivered suffix.
            for off in sorted(self.chunks):
                if off > self.delivered:
                    break
                chunk = self.chunks.pop(off)
                if off + len(chunk) > self.delivered:
                    tail = chunk[self.delivered - off:]
                    out += tail
                    self.delivered += len(tail)
                    progressed = True
                    break
                # fully-duplicate chunk: drop
        if self.fin_at is not None and self.delivered >= self.fin_at:
            self.finished = True
        return bytes(out)


def _add_to_ranges(ranges: List[List[int]], pn: int) -> None:
    """Add `pn` (not yet in them) to the ascending disjoint [lo, hi]
    ranges, merging neighbours; packets arrive mostly in order, so the
    search starts at the top."""
    i = len(ranges)
    while i and ranges[i - 1][0] > pn:
        i -= 1
    below = ranges[i - 1] if i and ranges[i - 1][1] == pn - 1 else None
    above = ranges[i] if i < len(ranges) and ranges[i][0] == pn + 1 else None
    if below and above:
        below[1] = above[1]
        del ranges[i]
    elif below:
        below[1] = pn
    elif above:
        above[0] = pn
    else:
        ranges.insert(i, [pn, pn])


@dataclass
class _Space:
    send_pn: int = 0
    recv_pns: Set[int] = field(default_factory=set)
    # the received packet numbers as disjoint [lo, hi] ranges, ascending
    recv_ranges: List[List[int]] = field(default_factory=list)
    acked_recv: Set[int] = field(default_factory=set)
    crypto_send_offset: int = 0
    crypto_recv: RecvStream = field(default_factory=RecvStream)
    tx_keys: Optional[Keys] = None
    rx_keys: Optional[Keys] = None
    # pn -> (frames bytes, ack_eliciting, sent_time)
    unacked: Dict[int, Tuple[bytes, bool, float]] = field(default_factory=dict)
    need_ack: bool = False


class QuicConnection:
    """One QUIC connection over a datagram transport (send_cb/handle_datagram)."""

    MTU = 1350

    def __init__(self, is_client: bool, send_cb: Callable[[bytes], None],
                 alpn: Optional[List[str]] = None,
                 server_name: Optional[str] = None,
                 certificate=None,
                 enable_datagrams: bool = True,
                 verify_peer=None,
                 max_data: int = 1 << 30,
                 max_stream_data: int = 1 << 28,
                 sendto_cb: Optional[Callable[[bytes, object], None]] = None,
                 session: Optional[dict] = None,
                 ticket_key: Optional[bytes] = None,
                 retry: bool = False,
                 idle_timeout_ms: int = 30_000,
                 max_streams_uni: int = 1 << 16,
                 max_streams_bidi: int = 1 << 16,
                 send_window: Optional[int] = None):
        self.is_client = is_client
        self.send_cb = send_cb
        self.scid = os.urandom(8)
        self.dcid = os.urandom(8)  # client: destination for Initial keys
        self.peer_cid: Optional[bytes] = None
        alpn = alpn or ["gstpu"]
        self.idle_timeout_ms = idle_timeout_ms
        params = {
            TP_MAX_IDLE_TIMEOUT: idle_timeout_ms,
            TP_INITIAL_MAX_DATA: max_data,
            TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL: max_stream_data,
            TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE: max_stream_data,
            TP_INITIAL_MAX_STREAM_DATA_UNI: max_stream_data,
            TP_INITIAL_MAX_STREAMS_BIDI: max_streams_bidi,
            TP_INITIAL_MAX_STREAMS_UNI: max_streams_uni,
        }
        if enable_datagrams:
            params[TP_MAX_DATAGRAM_FRAME_SIZE] = 65527
        tp = encode_transport_params(params)
        tls_cls = QuicTlsClient if is_client else QuicTlsServer
        if is_client:
            kwargs = {"server_name": server_name, "session": session}
        else:
            kwargs = {"ticket_key": ticket_key} if ticket_key else {}
        self.tls = tls_cls(alpn, tp, certificate=certificate,
                           verify_peer=verify_peer, **kwargs)
        self.tls.on_secrets = self._on_secrets
        self.tls.on_early_secret = self._on_early_secret
        self.tls.on_new_session = self._on_new_session

        # 0-RTT (RFC 9001 §4.6) + Retry (RFC 9000 §8.1.2)
        self._early_tx = False          # client: sending 0-RTT long packets
        self._early_rx_keys: Optional[Keys] = None  # server: 0-RTT rx keys
        self._token = b""               # client: retry token for Initials
        self._retry = retry             # server: demand address validation
        self._retry_done = False        # client: at most one Retry honored
        self._retry_secret = os.urandom(16)
        self.session_ticket: Optional[dict] = None  # from NewSessionTicket
        self.session_ticket_event = threading.Event()
        self._resume_session = session if is_client else None

        self.spaces = {LEVEL_INITIAL: _Space(), LEVEL_HANDSHAKE: _Space(),
                       LEVEL_APP: _Space()}
        if is_client:
            ck, sk = initial_keys(self.dcid)
            self.spaces[LEVEL_INITIAL].tx_keys = ck
            self.spaces[LEVEL_INITIAL].rx_keys = sk
        self.handshake_done = threading.Event()
        self.closed = threading.Event()
        self.close_reason: Optional[str] = None
        self.peer_params: Dict[int, int] = {}
        self.peer_max_datagram = 0

        self.recv_streams: Dict[int, RecvStream] = {}
        self.on_stream_data: Optional[Callable[[int, bytes, bool], None]] = None
        self.on_datagram: Optional[Callable[[bytes], None]] = None
        self.on_new_stream: Optional[Callable[[int], None]] = None
        self._next_uni = 2 if is_client else 3
        self._next_bidi = 0 if is_client else 1
        self._pending_stream: List[Tuple[int, int, bytes, bool]] = []  # id, off, data, fin
        self._stream_offsets: Dict[int, int] = {}
        self._pending_datagrams: List[bytes] = []
        self._lock = threading.RLock()
        self._hs_done_sent = False
        self._pto = 0.35

        # loss detection (RFC 9002): RTT estimator feeding the PTO plus
        # packet/time reordering thresholds applied on every ACK
        self._srtt: Optional[float] = None
        self._rttvar = 0.0
        self._latest_rtt = 0.0
        self._any_rx = False  # a packet from the peer decrypted OK

        # congestion control (RFC 9002 §7, NewReno): slow start + AIMD
        # with one cwnd halving per recovery epoch; ack-eliciting APP
        # packets over cwnd stay queued until ACKs free the window
        self._cwnd = 10 * self.MTU
        # optional cap on the congestion window (quinn's send-window knob)
        self._send_window = send_window
        self._ssthresh = float("inf")
        self._in_flight = 0
        self.packets_sent = self.packets_lost = self.pto_resends = 0
        self._recovery_start: Optional[float] = None
        self._last_acked_sent: Optional[float] = None

        # idle timeout (RFC 9000 §10.1): effective value is the min of both
        # sides' max_idle_timeout transport params (floored at 3x PTO), the
        # timer restarting on authenticated rx AND on sending an
        # ack-eliciting packet when none was in flight
        self._last_rx = time.monotonic()

        # flow control (RFC 9000 §4) — receive direction: what we allow
        self._fc_window_conn = max_data
        self._fc_window_stream = max_stream_data
        self._fc_local_max_data = max_data  # current advertised conn limit
        self._fc_local_stream_max: Dict[int, int] = {}  # sid -> advertised
        self._fc_recv_hi: Dict[int, int] = {}  # sid -> highest offset seen
        self._fc_recv_total = 0  # sum of highest offsets (conn-level usage)
        # send direction: what the peer allows (from TP + MAX_* frames)
        self._fc_peer_max_data: Optional[int] = None
        self._fc_peer_stream_max: Dict[int, int] = {}
        self._fc_sent_total = 0
        self._fc_blocked: List[Tuple[int, int, bytes, bool]] = []

        # key update (RFC 9001 §6): 1-RTT key phase
        self._key_phase = 0  # our send phase
        self._rx_phase = 0  # expected receive phase
        self._prev_rx_keys: Optional[Keys] = None

        # connection migration (RFC 9000 §9): active only when the transport
        # supplies addresses (sendto_cb + handle_datagram(..., addr=...));
        # the plain send_cb transports never see any of this
        self.sendto_cb = sendto_cb
        self.peer_addr = None  # current validated send path
        self._rx_addr = None  # source address of the packet being processed
        self._path_challenges: Dict[bytes, object] = {}  # data -> probed addr
        self._probed_addrs: Set[object] = set()

        if (self._resume_session and self._resume_session.get("max_early_data")
                and self._resume_session.get("transport_params")):
            # 0-RTT sends are clamped to the REMEMBERED server transport
            # parameters (RFC 9001 §4.6.1)
            self.peer_params = decode_transport_params(
                self._resume_session["transport_params"])
            self._params_remembered = True
            self.peer_max_datagram = self.peer_params.get(
                TP_MAX_DATAGRAM_FRAME_SIZE, 0)
            self._fc_peer_max_data = self.peer_params.get(TP_INITIAL_MAX_DATA, 0)

    # -- keys ------------------------------------------------------------------
    def _on_secrets(self, level: str, client_secret: bytes, server_secret: bytes) -> None:
        space = self.spaces[level]
        if self.is_client:
            space.tx_keys = Keys(client_secret)
            space.rx_keys = Keys(server_secret)
        else:
            space.tx_keys = Keys(server_secret)
            space.rx_keys = Keys(client_secret)
        if level == LEVEL_APP and self.is_client:
            self._early_tx = False  # 1-RTT keys supersede 0-RTT

    def _on_early_secret(self, secret: bytes) -> None:
        """client_early_traffic_secret (RFC 9001 §4.6): the client writes
        0-RTT packets with it; the server reads them.  0-RTT shares the
        1-RTT packet-number space."""
        if self.is_client:
            self.spaces[LEVEL_APP].tx_keys = Keys(secret)
            self._early_tx = True
        else:
            self._early_rx_keys = Keys(secret)

    def _on_new_session(self, session: dict) -> None:
        self.session_ticket = session
        self.session_ticket_event.set()

    # -- public API ----------------------------------------------------------------
    def connect(self) -> None:
        assert self.is_client
        with self._lock:
            self.tls.start()
            self._pump()

    def wait_handshake(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.handshake_done.wait(0.05):
                return True
            if self.closed.is_set():
                raise QuicError(self.close_reason or "connection closed")
            self.tick()
        return self.handshake_done.is_set()

    def open_uni_stream(self) -> int:
        with self._lock:
            sid = self._next_uni
            self._next_uni += 4
            self._stream_offsets[sid] = 0
            return sid

    def open_bidi_stream(self) -> int:
        with self._lock:
            sid = self._next_bidi
            self._next_bidi += 4
            self._stream_offsets[sid] = 0
            return sid

    def send_stream(self, stream_id: int, data: bytes, fin: bool = False) -> None:
        with self._lock:
            if self.closed.is_set():
                raise QuicError(self.close_reason or "connection closed")
            off = self._stream_offsets.setdefault(stream_id, 0)
            self._pending_stream.append((stream_id, off, data, fin))
            self._stream_offsets[stream_id] = off + len(data)
            if self.handshake_done.is_set() or self._early_tx:
                self._pump()

    def send_datagram(self, data: bytes) -> None:
        with self._lock:
            if self.closed.is_set():
                raise QuicError(self.close_reason or "connection closed")
            self._pending_datagrams.append(data)
            if self.handshake_done.is_set() or self._early_tx:
                self._pump()

    def close(self, reason: str = "bye") -> None:
        with self._lock:
            if self.closed.is_set():
                return
            space = self.spaces[LEVEL_APP]
            if space.tx_keys is not None:
                frame = bytes([FRAME_CONNECTION_CLOSE_APP]) + encode_varint(0) \
                    + encode_varint(len(reason)) + reason.encode()
                self._queue_frames(LEVEL_APP, frame)
                self._flush_queued()
            self.closed.set()

    def ping(self) -> None:
        """Queue a PING frame (keep-alive); no-op before 1-RTT keys."""
        with self._lock:
            if self.closed.is_set() or self.spaces[LEVEL_APP].tx_keys is None:
                return
            self._queue_frames(LEVEL_APP, bytes([FRAME_PING]))
            self._flush_queued()

    def initiate_key_update(self) -> None:
        """RFC 9001 §6: roll our 1-RTT send keys to the next generation and
        flip the key-phase bit; the peer follows on first decrypt."""
        with self._lock:
            space = self.spaces[LEVEL_APP]
            assert self.handshake_done.is_set() and space.tx_keys is not None
            space.tx_keys = space.tx_keys.next_generation()
            self._key_phase ^= 1

    def _connection_error(self, code: int, reason: str) -> None:
        frame = (bytes([FRAME_CONNECTION_CLOSE]) + encode_varint(code)
                 + encode_varint(0) + encode_varint(len(reason))
                 + reason.encode())
        level = LEVEL_APP if self.spaces[LEVEL_APP].tx_keys is not None \
            else LEVEL_INITIAL
        self._queue_frames(level, frame)
        self._flush_queued()
        self.close_reason = reason
        self.closed.set()

    def drain(self, timeout: float = 5.0) -> bool:
        """Block until every queued stream byte has been sent AND
        acknowledged (the quinn SendStream::finish/Connection-drain
        analog senders use before teardown): pending, flow-blocked and
        cwnd-held frames flushed, nothing ack-eliciting in flight.
        Returns False on timeout or if the connection closed first."""
        deadline = time.monotonic() + max(timeout, 0.0)
        while True:
            with self._lock:
                queued = self.__dict__.get("_queued_frames", {})
                idle = (not self._pending_stream and not self._fc_blocked
                        and not any(queued.values())
                        and not self.__dict__.get("_held_chunks")
                        and self._in_flight == 0)
                dead = self.closed.is_set()
            if idle:
                return True
            if dead or time.monotonic() >= deadline:
                return False
            self.tick()  # PTO backstop keeps retransmits moving
            time.sleep(0.005)

    def tick(self) -> None:
        """Retransmit ack-eliciting packets past their PTO (the backstop
        behind the ACK-driven loss detection in _detect_lost); enforce the
        idle timeout (RFC 9000 §10.1: close SILENTLY — no packets)."""
        with self._lock:
            if self.closed.is_set():
                return  # a closed connection transmits nothing (§10.1)
            now = time.monotonic()
            # RFC 9000 §10.1 / TP semantics: 0 means "idle timeout
            # disabled" on that side; the effective timeout is the min of
            # the NON-ZERO values, and if both are 0 there is no timeout.
            idle_ms = self.idle_timeout_ms
            peer_ms = self.peer_params.get(TP_MAX_IDLE_TIMEOUT, 0)
            if peer_ms:
                idle_ms = min(idle_ms, peer_ms) if idle_ms else peer_ms
            if idle_ms:
                idle_ms = max(idle_ms, 3 * self._pto * 1000.0)  # §10.1 floor
            if idle_ms and (now - self._last_rx) * 1000.0 > idle_ms:
                self.close_reason = "idle timeout"
                self.closed.set()
                return
            for level, space in self.spaces.items():
                if space.tx_keys is None:
                    continue
                resend = []
                for pn in sorted(space.unacked):
                    frames, eliciting, sent, size = space.unacked[pn]
                    if eliciting and now - sent > self._pto:
                        del space.unacked[pn]
                        self._in_flight = max(0, self._in_flight - size)
                        resend.append(frames)
                self.pto_resends += len(resend)
                for frames in resend:
                    self._queue_frames(level, frames)
            self._tick_path_probes()
            self._flush_queued()

    # -- datagram receive ------------------------------------------------------------
    def handle_datagram(self, datagram: bytes, addr: object = None) -> None:
        with self._lock:
            if self.closed.is_set():
                return  # drained: a closed endpoint neither reads nor replies
            self._rx_addr = addr
            if addr is not None and self.peer_addr is None:
                self.peer_addr = addr  # handshake path is implicitly validated
            off = 0
            while off < len(datagram):
                consumed = self._handle_packet(datagram[off:])
                if consumed <= 0:
                    break
                off += consumed
            self._rx_addr = None
            self._pump()

    def _handle_packet(self, data: bytes) -> int:
        first = data[0]
        if first & 0x80:  # long header
            version = struct.unpack("!I", data[1:5])[0]
            dcil = data[5]
            pos = 6 + dcil
            dcid = data[6:pos]
            scil = data[pos]
            scid = data[pos + 1:pos + 1 + scil]
            pos += 1 + scil
            ptype = (first >> 4) & 0x3
            if version == 0:  # Version Negotiation packet (RFC 9000 §17.2.1)
                self._handle_version_negotiation(dcid, data[pos:])
                return len(data)
            if version != QUIC_VERSION:
                # server answers an unknown-version first flight with a VN
                # packet (RFC 9000 §6.1); the >=1200 floor keeps it from
                # being an amplification vector
                if (not self.is_client and len(data) >= 1200
                        and self.spaces[LEVEL_INITIAL].rx_keys is None):
                    self._send_version_negotiation(dcid, scid)
                return len(data)
            if ptype == PT_RETRY:
                if self.is_client:
                    self._handle_retry(scid, data, pos)
                return len(data)
            keys_override = None
            if ptype == PT_INITIAL:
                token_len, pos = decode_varint(data, pos)
                token = data[pos:pos + token_len]
                pos += token_len
                level = LEVEL_INITIAL
                if not self.is_client and self._retry \
                        and self.spaces[LEVEL_INITIAL].rx_keys is None:
                    # address validation via Retry (RFC 9000 §8.1.2): no
                    # token -> send Retry and process nothing; bad token ->
                    # drop; valid token -> proceed (keys from the new dcid)
                    if not token:
                        self._send_retry(dcid, scid)
                        return len(data)
                    if not self._validate_retry_token(token):
                        return len(data)
            elif ptype == PT_HANDSHAKE:
                level = LEVEL_HANDSHAKE
            elif ptype == PT_0RTT and not self.is_client \
                    and self._early_rx_keys is not None:
                # 0-RTT shares the 1-RTT packet-number space (RFC 9001 §4.6)
                level = LEVEL_APP
                keys_override = self._early_rx_keys
            else:
                return len(data)
            length, pos = decode_varint(data, pos)
            packet_end = pos + length
            if self.peer_cid is None:
                self.peer_cid = scid
            if not self.is_client and self.spaces[LEVEL_INITIAL].rx_keys is None:
                ck, sk = initial_keys(dcid)
                self.spaces[LEVEL_INITIAL].rx_keys = ck
                self.spaces[LEVEL_INITIAL].tx_keys = sk
            self._decrypt_and_process(level, data[:packet_end], pos,
                                      keys_override=keys_override)
            return packet_end
        else:  # short header (1-RTT)
            self._decrypt_and_process(LEVEL_APP, data, 1 + len(self.scid))
            return len(data)

    # -- Retry (RFC 9000 §8.1.2 / RFC 9001 §5.8) -------------------------------------
    def _retry_token(self, odcid: bytes) -> bytes:
        import hmac as _hmac
        import hashlib as _hashlib
        mac = _hmac.new(self._retry_secret, odcid, _hashlib.sha256).digest()[:16]
        return bytes([len(odcid)]) + odcid + mac

    def _validate_retry_token(self, token: bytes) -> bool:
        import hmac as _hmac
        import hashlib as _hashlib
        if not token or len(token) < 1 + token[0] + 16:
            return False
        odcid = token[1:1 + token[0]]
        mac = _hmac.new(self._retry_secret, odcid, _hashlib.sha256).digest()[:16]
        return _hmac.compare_digest(token[1 + token[0]:1 + token[0] + 16], mac)

    def _send_retry(self, odcid: bytes, peer_scid: bytes) -> None:
        """Retry packet: our scid becomes the client's next dcid; the
        integrity tag (RFC 9001 §5.8) covers odcid + the whole packet."""
        pkt = bytearray([0xC0 | (PT_RETRY << 4)])
        pkt += struct.pack("!I", QUIC_VERSION)
        pkt += bytes([len(peer_scid)]) + peer_scid
        pkt += bytes([len(self.scid)]) + self.scid
        pkt += self._retry_token(odcid)
        pseudo = bytes([len(odcid)]) + odcid + bytes(pkt)
        tag = AESGCM(RETRY_INTEGRITY_KEY).encrypt(RETRY_INTEGRITY_NONCE, b"", pseudo)
        self.send_cb(bytes(pkt) + tag)

    def _handle_retry(self, retry_scid: bytes, data: bytes, pos: int) -> None:
        """Client: verify the integrity tag against our ORIGINAL dcid,
        adopt the server's cid + token, recompute Initial keys from the new
        dcid (RFC 9001 §5.2) and resend the first flight."""
        if self._retry_done or self._any_rx or len(data) < pos + 16:
            return
        token, tag = data[pos:-16], data[-16:]
        pseudo = bytes([len(self.dcid)]) + self.dcid + data[:-16]
        expect = AESGCM(RETRY_INTEGRITY_KEY).encrypt(RETRY_INTEGRITY_NONCE, b"", pseudo)
        if not hmac_compare(tag, expect) or not token:
            return
        self._retry_done = True
        self._token = token
        self.peer_cid = retry_scid
        ck, sk = initial_keys(retry_scid)
        space = self.spaces[LEVEL_INITIAL]
        space.tx_keys, space.rx_keys = ck, sk
        # the server discarded our pre-Retry Initial: resend its frames.
        # Reclaim the popped packets' in-flight bytes — the resend will
        # account for itself when _build_packet runs again.
        resend = []
        for pn in sorted(space.unacked):
            ent = space.unacked.pop(pn)
            if ent[1]:
                self._in_flight = max(0, self._in_flight - ent[3])
            resend.append(ent[0])
        for frames in resend:
            self._queue_frames(LEVEL_INITIAL, frames)

    def _send_version_negotiation(self, peer_dcid: bytes, peer_scid: bytes) -> None:
        """RFC 9000 §17.2.1: long header, version 0, CIDs echoed swapped,
        then the list of versions we speak (v1 only)."""
        pkt = bytearray([0x80 | 0x40])
        pkt += b"\x00\x00\x00\x00"
        pkt += bytes([len(peer_scid)]) + peer_scid
        pkt += bytes([len(peer_dcid)]) + peer_dcid
        pkt += struct.pack("!I", QUIC_VERSION)
        self.send_cb(bytes(pkt))

    def _handle_version_negotiation(self, dcid: bytes, versions_blob: bytes) -> None:
        """RFC 9000 §6.2: clients act on a VN packet only before any packet
        from the server has been processed; one listing the version we are
        already using MUST be ignored (it is a spoof or a broken server).
        The dcid must echo our scid — the only off-path defense VN has."""
        if (not self.is_client or self._any_rx or self.handshake_done.is_set()
                or dcid != self.scid):
            return
        versions = [struct.unpack("!I", versions_blob[i:i + 4])[0]
                    for i in range(0, len(versions_blob) - 3, 4)]
        if QUIC_VERSION in versions:
            return
        self.close_reason = ("version negotiation: peer offers none of ours "
                             + f"({[hex(v) for v in versions]})")
        self.closed.set()

    def _decrypt_and_process(self, level: str, packet: bytes, pn_offset: int,
                             keys_override: Optional[Keys] = None) -> None:
        space = self.spaces[level]
        keys = keys_override if keys_override is not None else space.rx_keys
        if keys is None:
            return
        sample = packet[pn_offset + 4:pn_offset + 20]
        if len(sample) < 16:
            return
        mask = keys.hp_mask(sample)
        data = bytearray(packet)
        if data[0] & 0x80:
            data[0] ^= mask[0] & 0x0F
        else:
            data[0] ^= mask[0] & 0x1F
        pn_len = (data[0] & 0x03) + 1
        for i in range(pn_len):
            data[pn_offset + i] ^= mask[1 + i]
        pn = int.from_bytes(data[pn_offset:pn_offset + pn_len], "big")
        # pn decoding vs largest received (RFC 9000 A.3) — 4-byte pns on our
        # side; tolerate peer short encodings via window reconstruction
        expected = space.recv_ranges[-1][1] + 1 if space.recv_ranges else 0
        win = 1 << (pn_len * 8)
        candidate = (expected & ~(win - 1)) | pn
        if candidate + win // 2 <= expected:
            candidate += win
        elif candidate > expected + win // 2 and candidate >= win:
            candidate -= win
        pn = candidate
        header = bytes(data[:pn_offset + pn_len])
        ciphertext = bytes(data[pn_offset + pn_len:])
        if level == LEVEL_APP and not (data[0] & 0x80):
            # 1-RTT: honor the key-phase bit (RFC 9001 §6)
            phase = (data[0] >> 2) & 1
            payload = self._open_1rtt(space, phase, pn, header, ciphertext)
            if payload is None:
                return
        else:
            try:
                payload = keys.open(pn, header, ciphertext)
            except Exception:
                return
        if pn in space.recv_pns:
            return  # duplicate
        self._any_rx = True  # an authenticated peer packet: VN no longer valid
        self._last_rx = time.monotonic()
        space.recv_pns.add(pn)
        _add_to_ranges(space.recv_ranges, pn)
        if (level == LEVEL_APP and self._rx_addr is not None
                and self.peer_addr is not None
                and self._rx_addr != self.peer_addr):
            # authenticated 1-RTT packet from a new source address: the peer
            # migrated — validate the new path (RFC 9000 §9.3)
            self._probe_path_locked(self._rx_addr)
        eliciting = self._process_frames(level, payload)
        if eliciting:
            space.need_ack = True

    def _open_1rtt(self, space: "_Space", phase: int, pn: int,
                   header: bytes, ciphertext: bytes) -> Optional[bytes]:
        """Decrypt a short-header packet honoring key phase (RFC 9001 §6):
        a flipped bit means the peer rolled to the next generation (follow,
        and roll our send keys too) or is a reordered previous-generation
        packet (use the retained old keys)."""
        if phase == self._rx_phase:
            try:
                return space.rx_keys.open(pn, header, ciphertext)
            except Exception:
                return None
        nxt = space.rx_keys.next_generation()
        try:
            payload = nxt.open(pn, header, ciphertext)
        except Exception:
            # reordered packet from the PREVIOUS generation
            if self._prev_rx_keys is not None:
                try:
                    return self._prev_rx_keys.open(pn, header, ciphertext)
                except Exception:
                    return None
            return None
        # peer initiated a key update: adopt the new receive generation and
        # move our send keys with it (§6.2)
        self._prev_rx_keys = space.rx_keys
        space.rx_keys = nxt
        self._rx_phase ^= 1
        if self._key_phase != self._rx_phase:
            space.tx_keys = space.tx_keys.next_generation()
            self._key_phase ^= 1
        return payload

    # -- frames ----------------------------------------------------------------------
    def _process_frames(self, level: str, payload: bytes) -> bool:
        off = 0
        eliciting = False
        while off < len(payload):
            ftype, off = decode_varint(payload, off)
            if ftype == FRAME_PADDING:
                continue
            if ftype == FRAME_PING:
                eliciting = True
                continue
            if ftype in (FRAME_ACK, FRAME_ACK + 1):
                off = self._handle_ack(level, payload, off, ftype == FRAME_ACK + 1)
                continue
            eliciting = True
            if ftype == FRAME_CRYPTO:
                coff, off = decode_varint(payload, off)
                clen, off = decode_varint(payload, off)
                data = payload[off:off + clen]
                off += clen
                complete = self.spaces[level].crypto_recv.push(coff, data, False)
                if complete:
                    try:
                        self.tls.handle(level, complete)
                    except TlsError as e:
                        # RFC 9001 §4.8: a TLS alert becomes a connection
                        # error (0x0100 + alert); binder failures etc. must
                        # abort, not crash the datagram handler
                        self._connection_error(0x0100, f"tls: {e}")
                        return
                    self._after_tls()
            elif FRAME_STREAM_BASE <= ftype <= 0x0F:
                has_off = bool(ftype & 0x04)
                has_len = bool(ftype & 0x02)
                fin = bool(ftype & 0x01)
                sid, off = decode_varint(payload, off)
                soff = 0
                if has_off:
                    soff, off = decode_varint(payload, off)
                if has_len:
                    slen, off = decode_varint(payload, off)
                else:
                    slen = len(payload) - off
                data = payload[off:off + slen]
                off += slen
                self._on_stream_frame(sid, soff, data, fin)
            elif ftype == FRAME_DATAGRAM or ftype == FRAME_DATAGRAM + 1:
                if ftype & 1:
                    dlen, off = decode_varint(payload, off)
                else:
                    dlen = len(payload) - off
                data = payload[off:off + dlen]
                off += dlen
                if self.on_datagram:
                    self.on_datagram(data)
            elif ftype == FRAME_HANDSHAKE_DONE:
                self.handshake_done.set()
            elif ftype in (FRAME_CONNECTION_CLOSE, FRAME_CONNECTION_CLOSE_APP):
                err, off = decode_varint(payload, off)
                if ftype == FRAME_CONNECTION_CLOSE:
                    _ft, off = decode_varint(payload, off)
                rlen, off = decode_varint(payload, off)
                self.close_reason = payload[off:off + rlen].decode("utf-8", "replace")
                off += rlen
                self.closed.set()
            elif ftype == FRAME_NEW_CONNECTION_ID:
                _seq, off = decode_varint(payload, off)
                _ret, off = decode_varint(payload, off)
                cid_len = payload[off]
                off += 1 + cid_len + 16
            elif ftype == FRAME_NEW_TOKEN:
                tlen, off = decode_varint(payload, off)
                off += tlen
            elif ftype == FRAME_MAX_DATA:
                v, off = decode_varint(payload, off)
                if self._fc_peer_max_data is None or v > self._fc_peer_max_data:
                    self._fc_peer_max_data = v
                self._retry_blocked()
            elif ftype == FRAME_MAX_STREAM_DATA:
                sid, off = decode_varint(payload, off)
                v, off = decode_varint(payload, off)
                if v > self._fc_peer_stream_max.get(sid, 0):
                    self._fc_peer_stream_max[sid] = v
                self._retry_blocked()
            elif ftype in (FRAME_MAX_STREAMS_BIDI, FRAME_MAX_STREAMS_UNI,
                           FRAME_RETIRE_CONNECTION_ID, FRAME_DATA_BLOCKED):
                _v, off = decode_varint(payload, off)
            elif ftype == FRAME_STREAM_DATA_BLOCKED:
                _sid, off = decode_varint(payload, off)
                _v, off = decode_varint(payload, off)
            elif ftype in (FRAME_PATH_CHALLENGE, FRAME_PATH_RESPONSE):
                data = payload[off:off + 8]
                off += 8
                if ftype == FRAME_PATH_CHALLENGE:
                    # respond on the path the challenge arrived on (§8.2.2)
                    resp = bytes([FRAME_PATH_RESPONSE]) + data
                    if self.sendto_cb is not None and self._rx_addr is not None:
                        self._send_path_frames(self._rx_addr, resp)
                    else:
                        self._queue_frames(LEVEL_APP, resp)
                else:
                    entry = self._path_challenges.pop(data, None)
                    if entry is not None:
                        addr = entry[0]
                        # new path validated: migrate sending (§9.3), reset
                        # the RTT estimator for the new path (§9.4)
                        self.peer_addr = addr
                        self._probed_addrs.discard(addr)
                        self._srtt = None
                        self._rttvar = 0.0
                        self._pto = 0.35
            else:
                break  # unknown frame: stop parsing this packet
        return eliciting

    K_PACKET_THRESHOLD = 3  # RFC 9002 §6.1.1
    K_TIME_THRESHOLD = 9 / 8  # RFC 9002 §6.1.2
    K_GRANULARITY = 0.001
    K_PERSISTENT_CONGESTION = 3  # RFC 9002 §7.6.1

    def _handle_ack(self, level: str, payload: bytes, off: int, has_ecn: bool) -> int:
        largest, off = decode_varint(payload, off)
        _delay, off = decode_varint(payload, off)
        range_count, off = decode_varint(payload, off)
        first_range, off = decode_varint(payload, off)
        space = self.spaces[level]
        newly: Dict[int, Tuple[bytes, bool, float]] = {}

        def ack(lo: int, hi: int) -> None:
            # the packets in flight are keyed in ascending packet numbers
            covered = []
            for pn in space.unacked:
                if pn > hi:
                    break
                if pn >= lo:
                    covered.append(pn)
            for pn in covered:
                newly[pn] = space.unacked.pop(pn)

        lo = largest - first_range
        ack(lo, largest)
        cur = lo
        for _ in range(range_count):
            gap, off = decode_varint(payload, off)
            rng, off = decode_varint(payload, off)
            hi = cur - gap - 2
            lo = hi - rng
            ack(lo, hi)
            cur = lo
        if has_ecn:
            for _ in range(3):
                _v, off = decode_varint(payload, off)
        now = time.monotonic()
        for _pn, (_fr, _el, _sent, _size) in newly.items():
            if not _el:
                continue
            # persistent-congestion detection needs the send time of the
            # most recent acked ack-eliciting packet (RFC 9002 §7.6.2)
            if self._last_acked_sent is None or _sent > self._last_acked_sent:
                self._last_acked_sent = _sent
            self._in_flight = max(0, self._in_flight - _size)
            if self._recovery_start is not None and _sent <= self._recovery_start:
                continue  # no growth for packets sent before recovery began
            if self._cwnd < self._ssthresh:
                self._cwnd += _size  # slow start
            else:
                self._cwnd += self.MTU * _size / self._cwnd  # AIMD
            if self._send_window is not None:
                self._cwnd = min(self._cwnd, max(self._send_window, 2 * self.MTU))
        if largest in newly and newly[largest][1]:
            # RTT sample only when the largest acked is newly acked and
            # ack-eliciting (RFC 9002 §5.1); §5.3 EWMA
            latest = max(now - newly[largest][2], self.K_GRANULARITY)
            if self._srtt is None:
                self._srtt, self._rttvar = latest, latest / 2
            else:
                self._rttvar = 0.75 * self._rttvar + 0.25 * abs(self._srtt - latest)
                self._srtt = 0.875 * self._srtt + 0.125 * latest
            self._latest_rtt = latest
            self._pto = max(0.05, self._srtt + 4 * self._rttvar + 0.025)
        if newly:
            self._detect_lost(level, space, largest, now)
        return off

    def _detect_lost(self, level: str, space: _Space, largest_acked: int,
                     now: float) -> None:
        """RFC 9002 §6.1: a packet is lost once one sent after it has been
        acked AND it trails by >= kPacketThreshold pns or by the time
        threshold.  Lost ack-eliciting frames retransmit immediately —
        a single lost packet recovers in ~1 RTT instead of a full PTO
        (the reference inherits the same behavior from quinn)."""
        rtt = max(self._srtt or 0.0, self._latest_rtt)
        time_thresh = self.K_TIME_THRESHOLD * rtt if rtt else None
        lost = []
        latest_lost_sent = None
        earliest_lost_sent = None
        older = []
        for pn in space.unacked:  # ascending packet numbers
            if pn >= largest_acked:
                break  # not yet reorderable: nothing after it was acked
            older.append(pn)
        for pn in older:
            frames, eliciting, sent, size = space.unacked[pn]
            if (largest_acked - pn >= self.K_PACKET_THRESHOLD
                    or (time_thresh is not None and now - sent > time_thresh)):
                del space.unacked[pn]
                if eliciting:
                    self._in_flight = max(0, self._in_flight - size)
                    lost.append(frames)
                    if latest_lost_sent is None or sent > latest_lost_sent:
                        latest_lost_sent = sent
                    if earliest_lost_sent is None or sent < earliest_lost_sent:
                        earliest_lost_sent = sent
        if latest_lost_sent is not None and (
                self._recovery_start is None
                or latest_lost_sent > self._recovery_start):
            # RFC 9002 §7.3.2: one cwnd reduction per recovery epoch
            self._recovery_start = now
            self._ssthresh = max(self._cwnd / 2.0, 2 * self.MTU)
            self._cwnd = self._ssthresh
        # RFC 9002 §7.6: persistent congestion — the lost span exceeds
        # 3x the PTO duration with an RTT sample established and nothing
        # acked from inside the span: collapse to the minimum window
        if (latest_lost_sent is not None and self._srtt is not None
                and earliest_lost_sent is not None
                and (self._last_acked_sent is None
                     or self._last_acked_sent < earliest_lost_sent)):
            duration = (self._srtt + max(4 * self._rttvar,
                                         self.K_GRANULARITY) + 0.025)
            if latest_lost_sent - earliest_lost_sent \
                    > self.K_PERSISTENT_CONGESTION * duration:
                self._cwnd = 2 * self.MTU
                self._ssthresh = max(self._ssthresh, self._cwnd)
        self.packets_lost += len(lost)
        for frames in lost:
            self._queue_frames(level, frames)

    def _on_stream_frame(self, sid: int, offset: int, data: bytes, fin: bool) -> None:
        # -- receive-direction flow control (RFC 9000 §4.1): a peer writing
        # past the advertised limits is a FLOW_CONTROL_ERROR
        end = offset + len(data)
        stream_limit = self._fc_local_stream_max.setdefault(
            sid, self._fc_window_stream)
        if end > stream_limit:
            self._connection_error(
                ERR_FLOW_CONTROL,
                f"stream {sid} exceeded MAX_STREAM_DATA ({end} > {stream_limit})")
            return
        prev_hi = self._fc_recv_hi.get(sid, 0)
        if end > prev_hi:
            self._fc_recv_total += end - prev_hi
            self._fc_recv_hi[sid] = end
            if self._fc_recv_total > self._fc_local_max_data:
                self._connection_error(
                    ERR_FLOW_CONTROL,
                    f"connection exceeded MAX_DATA "
                    f"({self._fc_recv_total} > {self._fc_local_max_data})")
                return
        stream = self.recv_streams.get(sid)
        if stream is None:
            stream = self.recv_streams[sid] = RecvStream()
            if self.on_new_stream:
                self.on_new_stream(sid)
        out = stream.push(offset, data, fin)
        # data is delivered to the app immediately, so extend credit once
        # the peer has used half a window (MAX_STREAM_DATA / MAX_DATA)
        if end > stream_limit - self._fc_window_stream // 2:
            new_limit = end + self._fc_window_stream
            self._fc_local_stream_max[sid] = new_limit
            self._queue_frames(LEVEL_APP, bytes([FRAME_MAX_STREAM_DATA])
                               + encode_varint(sid) + encode_varint(new_limit))
        if self._fc_recv_total > self._fc_local_max_data - self._fc_window_conn // 2:
            self._fc_local_max_data = self._fc_recv_total + self._fc_window_conn
            self._queue_frames(LEVEL_APP, bytes([FRAME_MAX_DATA])
                               + encode_varint(self._fc_local_max_data))
        if (out or stream.finished) and self.on_stream_data:
            self.on_stream_data(sid, out, stream.finished)

    def _after_tls(self) -> None:
        if self.tls.handshake_complete and not self.handshake_done.is_set():
            if self.is_client:
                self.handshake_done.set()
            else:
                self.handshake_done.set()
                if not self._hs_done_sent:
                    self._hs_done_sent = True
                    self._queue_frames(LEVEL_APP, bytes([FRAME_HANDSHAKE_DONE]))
        if self.tls.peer_transport_params is not None and (
                not self.peer_params or getattr(self, "_params_remembered", False)):
            # fresh handshake params replace any 0-RTT remembered set
            # (RFC 9001 §4.6.1 remembered values only cap EARLY data)
            self._params_remembered = False
            self.peer_params = decode_transport_params(self.tls.peer_transport_params)
            self.peer_max_datagram = self.peer_params.get(TP_MAX_DATAGRAM_FRAME_SIZE, 0)
            if self._fc_peer_max_data is None:
                self._fc_peer_max_data = self.peer_params.get(
                    TP_INITIAL_MAX_DATA, 0)

    def _peer_stream_limit(self, sid: int) -> int:
        """Peer's current receive limit for this stream (initial TP value
        by stream type, raised by MAX_STREAM_DATA frames)."""
        explicit = self._fc_peer_stream_max.get(sid, 0)
        we_initiated = (sid & 0x1) == (0 if self.is_client else 1)
        if sid & 0x2:
            tp = TP_INITIAL_MAX_STREAM_DATA_UNI
        elif we_initiated:
            tp = TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE
        else:
            tp = TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL
        return max(explicit, self.peer_params.get(tp, 0))

    def _retry_blocked(self) -> None:
        if self._fc_blocked:
            self._pending_stream = self._fc_blocked + self._pending_stream
            self._fc_blocked = []

    # -- send path ----------------------------------------------------------------------
    def _queue_frames(self, level: str, frames: bytes) -> None:
        self.__dict__.setdefault("_queued_frames", {}).setdefault(level, []).append(frames)

    def _pump(self) -> None:
        # 1. TLS output into CRYPTO frames
        for level, data in self.tls.take_output():
            space = self.spaces[level]
            pos = 0
            while pos < len(data):  # keep every frame under the packet budget
                chunk = data[pos:pos + 1000]
                frame = (bytes([FRAME_CRYPTO]) + encode_varint(space.crypto_send_offset)
                         + encode_varint(len(chunk)) + chunk)
                space.crypto_send_offset += len(chunk)
                self._queue_frames(level, frame)
                pos += len(chunk)
        self._after_tls()
        # 2. application data, clamped to the peer's flow-control limits
        # (RFC 9000 §4.1): anything over goes to the blocked queue and is
        # released by MAX_DATA / MAX_STREAM_DATA
        if (self.handshake_done.is_set() or self._early_tx) \
                and self.spaces[LEVEL_APP].tx_keys is not None:
            pending, self._pending_stream = self._pending_stream, []
            for sid, soff, data, fin in pending:
                conn_limit = self._fc_peer_max_data
                conn_avail = (len(data) if conn_limit is None
                              else max(0, conn_limit - self._fc_sent_total))
                stream_avail = max(0, self._peer_stream_limit(sid) - soff) \
                    if self.peer_params else len(data)
                allowed = min(len(data), conn_avail, stream_avail)
                if allowed < len(data):
                    self._fc_blocked.append(
                        (sid, soff + allowed, data[allowed:], fin))
                    blocked_at = soff + allowed
                    self._queue_frames(
                        LEVEL_APP, bytes([FRAME_STREAM_DATA_BLOCKED])
                        + encode_varint(sid) + encode_varint(blocked_at))
                    data = data[:allowed]
                    if not data:
                        continue
                    fin = False
                self._fc_sent_total += len(data)
                pos = 0
                while True:
                    chunk = data[pos:pos + 1100]
                    last = pos + len(chunk) >= len(data)
                    ftype = FRAME_STREAM_BASE | 0x04 | 0x02 | (0x01 if (fin and last) else 0)
                    frame = (bytes([ftype]) + encode_varint(sid)
                             + encode_varint(soff + pos) + encode_varint(len(chunk)) + chunk)
                    self._queue_frames(LEVEL_APP, frame)
                    pos += len(chunk)
                    if last:
                        break
            dgrams, self._pending_datagrams = self._pending_datagrams, []
            for d in dgrams:
                self._queue_frames(LEVEL_APP, bytes([FRAME_DATAGRAM + 1])
                                   + encode_varint(len(d)) + d)
        # 3. ACKs
        for level, space in self.spaces.items():
            if space.need_ack and space.tx_keys is not None:
                self._queue_frames(level, self._ack_frame(space))
                space.need_ack = False
        # 4. emit packets, coalescing levels into datagrams
        self._flush_queued()

    def _ack_frame(self, space: _Space) -> bytes:
        runs = space.recv_ranges[::-1]  # descending, the largest first
        lo, largest = runs[0]
        out = bytes([FRAME_ACK]) + encode_varint(largest) + encode_varint(0)
        out += encode_varint(len(runs) - 1) + encode_varint(largest - lo)
        for lo_below, hi in runs[1:]:
            # RFC 9000 §19.3.1: Gap counts the unreceived numbers below the
            # range above, less one
            out += encode_varint(lo - hi - 2) + encode_varint(hi - lo_below)
            lo = lo_below
        return out

    def _flush_queued(self) -> None:
        queued = self.__dict__.setdefault("_queued_frames", {})
        held = self.__dict__.setdefault("_held_chunks", collections.deque())
        datagram = bytearray()

        def emit(level: str, chunk: bytes) -> None:
            nonlocal datagram
            pkt = self._build_packet(level, chunk)
            if len(datagram) + len(pkt) > self.MTU and datagram:
                self._emit_datagram(bytes(datagram))
                datagram = bytearray()
            datagram += pkt
            if level == LEVEL_APP:
                # short-header packets carry no length: one per datagram,
                # always last (RFC 9000 §12.2)
                self._emit_datagram(bytes(datagram))
                datagram = bytearray()

        for level in (LEVEL_INITIAL, LEVEL_HANDSHAKE, LEVEL_APP):
            frames_list = queued.pop(level, [])
            if not frames_list and not (level == LEVEL_APP and held):
                continue
            space = self.spaces[level]
            if space.tx_keys is None:
                if frames_list:
                    queued[level] = frames_list  # keys not ready yet
                continue
            # pack whole frames into packets — frames never split across
            # packets (RFC 9000 §12.4)
            groups: List[bytes] = []
            cur = bytearray()
            for frame in frames_list:
                if cur and len(cur) + len(frame) > 1180:
                    groups.append(bytes(cur))
                    cur = bytearray()
                cur += frame
            if cur:
                groups.append(bytes(cur))
            # congestion window (RFC 9002 §7): ack-eliciting APP chunks that
            # don't fit wait in order, grouped, and go first once ACKs free
            # the window (the next ACK's _pump); ACK/CLOSE-led chunks always
            # flow
            limited = level == LEVEL_APP and self.handshake_done.is_set()
            while held and (not limited
                            or self._in_flight + len(held[0]) + 64 <= self._cwnd):
                emit(level, held.popleft())
            for chunk in groups:
                first = chunk[0]
                eliciting = first != FRAME_PADDING and not (
                    FRAME_ACK <= first <= FRAME_ACK + 1)
                if limited and eliciting and (
                        held or self._in_flight + len(chunk) + 64 > self._cwnd):
                    held.append(chunk)
                    continue
                emit(level, chunk)
        if datagram:
            self._emit_datagram(bytes(datagram))

    def _emit_datagram(self, datagram: bytes) -> None:
        # client Initial datagrams must be >= 1200 bytes (RFC 9000 §14.1)
        if self.is_client and len(datagram) < 1200 and datagram[0] & 0x80 \
                and ((datagram[0] >> 4) & 3) == PT_INITIAL:
            datagram += b"\x00" * (1200 - len(datagram))
        if self.sendto_cb is not None and self.peer_addr is not None:
            self.sendto_cb(datagram, self.peer_addr)
        else:
            self.send_cb(datagram)

    # -- connection migration (RFC 9000 §9) ------------------------------------------
    def probe_path(self, addr: object) -> None:
        """Validate `addr` as a new peer path (PATH_CHALLENGE); sending
        migrates there when the matching PATH_RESPONSE arrives.  Requires an
        address-aware transport (sendto_cb)."""
        with self._lock:
            self._probe_path_locked(addr)

    def _probe_path_locked(self, addr: object) -> None:
        if self.sendto_cb is None or addr in self._probed_addrs:
            return
        data = os.urandom(8)
        self._probed_addrs.add(addr)
        self._path_challenges[data] = [addr, time.monotonic(), 0]
        self._send_path_frames(addr, bytes([FRAME_PATH_CHALLENGE]) + data)

    def _tick_path_probes(self) -> None:
        """Resend lost PATH_CHALLENGEs on their own timer (they must go to
        the probed address, so the normal PTO retransmit path can't carry
        them); give up after 5 tries so a dead path can be re-probed later."""
        now = time.monotonic()
        for data in list(self._path_challenges):
            entry = self._path_challenges[data]
            addr, sent, attempts = entry
            if now - sent < max(2 * self._pto, 0.2):
                continue
            if attempts >= 5:
                del self._path_challenges[data]
                self._probed_addrs.discard(addr)
                continue
            entry[1], entry[2] = now, attempts + 1
            self._send_path_frames(addr, bytes([FRAME_PATH_CHALLENGE]) + data)

    def _send_path_frames(self, addr: object, frames: bytes) -> None:
        """One immediate 1-RTT packet to a specific address, padded to 1200
        so the probe also validates the path's MTU (§8.2.1)."""
        space = self.spaces[LEVEL_APP]
        if space.tx_keys is None:
            return
        frames = frames + b"\x00" * max(0, 1200 - len(frames) - 64)
        pkt = self._build_packet(LEVEL_APP, frames)
        # keep it off the PTO ledger: a retransmit there would ride the
        # CURRENT path, but these frames are address-pinned.  The ledger
        # entry carried congestion accounting — give those bytes back, or
        # every probe permanently leaks ~1200 bytes of cwnd budget.
        ent = space.unacked.pop(space.send_pn - 1, None)
        if ent is not None and ent[1]:
            self._in_flight = max(0, self._in_flight - ent[3])
        self.sendto_cb(pkt, addr)

    def _build_packet(self, level: str, frames: bytes) -> bytes:
        space = self.spaces[level]
        keys = space.tx_keys
        pn = space.send_pn
        space.send_pn += 1
        self.packets_sent += 1
        pn_bytes = _encode_pn(pn)
        dcid = self.peer_cid if self.peer_cid is not None else self.dcid
        if level == LEVEL_APP and not self._early_tx:
            header = bytearray([0x40 | (self._key_phase << 2) | 0x03]) + dcid
        else:
            if level == LEVEL_APP:
                ptype = PT_0RTT  # 0-RTT rides long headers (RFC 9000 §17.2.3)
            else:
                ptype = PT_INITIAL if level == LEVEL_INITIAL else PT_HANDSHAKE
            header = bytearray([0xC0 | (ptype << 4) | 0x03])
            header += struct.pack("!I", QUIC_VERSION)
            header += bytes([len(dcid)]) + dcid
            header += bytes([len(self.scid)]) + self.scid
            if level == LEVEL_INITIAL:
                header += encode_varint(len(self._token)) + self._token
            header += encode_varint(len(pn_bytes) + len(frames) + 16)
        pn_offset = len(header)
        header += pn_bytes
        ciphertext = keys.seal(pn, bytes(header), frames)
        packet = bytearray(header + ciphertext)
        sample = packet[pn_offset + 4:pn_offset + 20]
        mask = keys.hp_mask(bytes(sample))
        if packet[0] & 0x80:
            packet[0] ^= mask[0] & 0x0F
        else:
            packet[0] ^= mask[0] & 0x1F
        for i in range(4):
            packet[pn_offset + i] ^= mask[1 + i]
        eliciting = any(f not in (FRAME_PADDING,) and not (FRAME_ACK <= f <= FRAME_ACK + 1)
                        for f in [frames[0]])
        now = time.monotonic()
        space.unacked[pn] = (frames, eliciting, now, len(packet))
        if eliciting:
            if self._in_flight == 0:
                self._last_rx = max(self._last_rx, now)  # §10.1 restart
            self._in_flight += len(packet)
        return bytes(packet)
