"""DTLS 1.2 (RFC 6347) — native implementation for WebRTC's DTLS-SRTP leg.

Parity target: the reference's webrtc plugin gets DTLS from webrtcbin
(openssl via gstreamer's dtls plugin); this framework owns the protocol.
Scope (what WebRTC actually uses):

- one cipher suite: TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256 (0xC02B)
- self-signed ECDSA P-256 certificates on both sides, mutual auth
  (CertificateRequest / Certificate / CertificateVerify), peers verified
  by SDP fingerprint (a=fingerprint:sha-256 ...) not by chain
- use_srtp extension (RFC 5764) negotiating SRTP_AES128_CM_HMAC_SHA1_80,
  with the RFC 5705 keying-material exporter ("EXTRACTOR-dtls_srtp")
- HelloVerifyRequest handled client-side (transcript restarted per
  RFC 6347 §4.2.1); our server skips the cookie round (it is optional)
- flight retransmission on a simple timeout; handshake-message
  reassembly for fragmented peers

Crypto primitives come from the `cryptography` package (ECDH, ECDSA,
AES-GCM, HMAC); every protocol byte is produced here.

Divergence from the JAX package's copy: application data goes to `on_data`
outside the connection's lock (see `_handle_record`), so a data channel
can send while the receive loop delivers.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac as hmac_mod
import os
import struct
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from cryptography import x509
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.ciphers.aead import AESGCM
from cryptography.x509.oid import NameOID

DTLS_1_2 = 0xFEFD
DTLS_1_0 = 0xFEFF  # used in ClientHello record header for compat

CT_CHANGE_CIPHER_SPEC = 20
CT_ALERT = 21
CT_HANDSHAKE = 22
CT_APPLICATION_DATA = 23

HT_HELLO_VERIFY_REQUEST = 3
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_CERTIFICATE = 11
HT_SERVER_KEY_EXCHANGE = 12
HT_CERTIFICATE_REQUEST = 13
HT_SERVER_HELLO_DONE = 14
HT_CERTIFICATE_VERIFY = 15
HT_CLIENT_KEY_EXCHANGE = 16
HT_FINISHED = 20

CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256 = 0xC02B

EXT_SUPPORTED_GROUPS = 0x000A
EXT_EC_POINT_FORMATS = 0x000B
EXT_SIGNATURE_ALGORITHMS = 0x000D
EXT_USE_SRTP = 0x000E
EXT_RENEGOTIATION_INFO = 0xFF01

GROUP_SECP256R1 = 23
SIGALG_ECDSA_SECP256R1_SHA256 = 0x0403

SRTP_AES128_CM_HMAC_SHA1_80 = 0x0001


# ---------------------------------------------------------------------------
# certificates / fingerprints


def generate_certificate() -> Tuple[bytes, ec.EllipticCurvePrivateKey]:
    """Self-signed ECDSA P-256 cert, as webrtcbin generates per-session."""
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "gstpu-webrtc")])
    now = datetime.datetime(2024, 1, 1)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=3650))
        .sign(key, hashes.SHA256())
    )
    return cert.public_bytes(serialization.Encoding.DER), key


def certificate_fingerprint(cert_der: bytes) -> str:
    """SDP form: upper-case colon-separated SHA-256 (a=fingerprint value)."""
    dig = hashlib.sha256(cert_der).hexdigest().upper()
    return ":".join(dig[i:i + 2] for i in range(0, len(dig), 2))


# ---------------------------------------------------------------------------
# TLS 1.2 PRF (SHA-256)


def prf(secret: bytes, label: bytes, seed: bytes, length: int) -> bytes:
    seed = label + seed
    out = b""
    a = seed
    while len(out) < length:
        a = hmac_mod.new(secret, a, hashlib.sha256).digest()
        out += hmac_mod.new(secret, a + seed, hashlib.sha256).digest()
    return out[:length]


# ---------------------------------------------------------------------------
# wire helpers


def _hs_header(msg_type: int, length: int, message_seq: int) -> bytes:
    return struct.pack("!B", msg_type) + struct.pack("!I", length)[1:] + struct.pack(
        "!H", message_seq
    ) + b"\x00\x00\x00" + struct.pack("!I", length)[1:]


@dataclass
class HandshakeMsg:
    msg_type: int
    message_seq: int
    body: bytes

    def wire(self) -> bytes:
        """Single-fragment wire form — also the transcript form (RFC 6347 §4.2.6)."""
        return _hs_header(self.msg_type, len(self.body), self.message_seq) + self.body


class _Reassembler:
    """Collects possibly-fragmented handshake messages per message_seq."""

    def __init__(self) -> None:
        self._bufs: Dict[int, Tuple[int, int, bytearray, bytearray]] = {}
        self.next_seq = 0

    def push(self, data: bytes) -> List[HandshakeMsg]:
        out: List[HandshakeMsg] = []
        off = 0
        while off + 12 <= len(data):
            msg_type = data[off]
            total = int.from_bytes(data[off + 1:off + 4], "big")
            mseq = struct.unpack("!H", data[off + 4:off + 6])[0]
            frag_off = int.from_bytes(data[off + 6:off + 9], "big")
            frag_len = int.from_bytes(data[off + 9:off + 12], "big")
            frag = data[off + 12:off + 12 + frag_len]
            off += 12 + frag_len
            if mseq < self.next_seq:
                continue  # retransmission of something we finished
            if frag_len == total and frag_off == 0:
                self._complete(out, HandshakeMsg(msg_type, mseq, bytes(frag)))
                continue
            key = mseq
            if key not in self._bufs:
                self._bufs[key] = (msg_type, total, bytearray(total), bytearray(total))
            _, _, buf, mask = self._bufs[key]
            buf[frag_off:frag_off + frag_len] = frag
            mask[frag_off:frag_off + frag_len] = b"\x01" * frag_len
            if all(mask):
                mt, total, buf, _ = self._bufs.pop(key)
                self._complete(out, HandshakeMsg(mt, mseq, bytes(buf)))
        return out

    def _complete(self, out: List[HandshakeMsg], msg: HandshakeMsg) -> None:
        out.append(msg)
        if msg.message_seq >= self.next_seq:
            self.next_seq = msg.message_seq + 1


# ---------------------------------------------------------------------------


class DtlsError(Exception):
    pass


class _RecordDropped(Exception):
    """Record silently discarded (bad AEAD tag / replay) — not fatal."""


class DtlsConnection:
    """One DTLS association over a datagram transport.

    `send_cb(bytes)` transmits one datagram.  Feed inbound datagrams to
    `handle_packet`.  After the handshake, `send(data)` protects
    application data and `on_data(bytes)` receives the peer's.
    """

    MTU = 1200

    def __init__(
        self,
        is_client: bool,
        send_cb: Callable[[bytes], None],
        certificate: Optional[Tuple[bytes, ec.EllipticCurvePrivateKey]] = None,
        srtp_profiles: Tuple[int, ...] = (SRTP_AES128_CM_HMAC_SHA1_80,),
    ):
        self.is_client = is_client
        self.send_cb = send_cb
        self.cert_der, self.private_key = certificate or generate_certificate()
        self.srtp_profiles = srtp_profiles
        self.srtp_profile: Optional[int] = None
        self.peer_cert_der: Optional[bytes] = None
        self.on_data: Optional[Callable[[bytes], None]] = None

        self._ecdh_priv = ec.generate_private_key(ec.SECP256R1())
        self.client_random = os.urandom(32)
        self.server_random = os.urandom(32)
        if is_client:
            self.server_random = b""
        else:
            self.client_random = b""

        self._transcript = bytearray()
        self._reasm = _Reassembler()
        self._send_msg_seq = 0
        self._epoch = 0
        self._seq: Dict[int, int] = {0: 0, 1: 0}
        self._recv_epoch = 0
        self.master_secret: Optional[bytes] = None
        self._keys: Optional[Dict[str, bytes]] = None
        self._handshake_done = threading.Event()
        self._failed: Optional[str] = None
        self._lock = threading.RLock()
        self._last_flight: List[Tuple[int, int, bytes]] = []  # (content_type, epoch, payload)
        self._session_id = b""
        self._cookie = b""
        self._peer_finished = False
        self._sent_finished = False
        self._pre_master: Optional[bytes] = None
        self._peer_ecdh_point: Optional[bytes] = None
        self._cert_requested = False
        self._cv_verified = False
        # Anti-replay sliding window per epoch (RFC 6347 §4.1.2.6):
        # highest seq seen + 64-bit bitmap of the window below it.
        self._replay: Dict[int, Tuple[int, int]] = {}

    # -- public ---------------------------------------------------------------

    def start_handshake(self) -> None:
        if self.is_client:
            self._send_client_hello()

    def wait_handshake(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        retransmit_at = time.monotonic() + 0.4
        while time.monotonic() < deadline:
            if self._handshake_done.wait(0.05):
                return True
            if self._failed:
                raise DtlsError(self._failed)
            if time.monotonic() >= retransmit_at:
                with self._lock:
                    self._retransmit()
                retransmit_at = time.monotonic() + 0.5
        return self._handshake_done.is_set()

    def send(self, data: bytes) -> None:
        if not self._handshake_done.is_set():
            raise DtlsError("handshake not complete")
        with self._lock:
            self._send_record(CT_APPLICATION_DATA, data, epoch=1)

    def export_srtp_keys(self, key_len: int = 16, salt_len: int = 14) -> Dict[str, bytes]:
        """RFC 5764 §4.2 keying material via the RFC 5705 exporter."""
        if self.master_secret is None:
            raise DtlsError("no master secret")
        material = prf(
            self.master_secret,
            b"EXTRACTOR-dtls_srtp",
            self.client_random + self.server_random,
            2 * (key_len + salt_len),
        )
        ck = material[:key_len]
        sk = material[key_len:2 * key_len]
        cs = material[2 * key_len:2 * key_len + salt_len]
        ss = material[2 * key_len + salt_len:]
        return {
            "client_write_key": ck,
            "server_write_key": sk,
            "client_write_salt": cs,
            "server_write_salt": ss,
        }

    def close(self) -> None:
        if self._handshake_done.is_set():
            with self._lock:
                try:
                    self._send_record(CT_ALERT, bytes([1, 0]), epoch=1)  # close_notify
                except Exception:
                    pass

    # -- record layer -----------------------------------------------------------

    def handle_packet(self, datagram: bytes) -> None:
        off = 0
        while off + 13 <= len(datagram):
            ctype = datagram[off]
            epoch, seqhi = struct.unpack("!HH", datagram[off + 3:off + 7])
            seqlo = struct.unpack("!I", datagram[off + 7:off + 11])[0]
            seq48 = (seqhi << 32) | seqlo
            length = struct.unpack("!H", datagram[off + 11:off + 13])[0]
            payload = datagram[off + 13:off + 13 + length]
            off += 13 + length
            if len(payload) != length:
                return
            try:
                self._handle_record(ctype, epoch, seq48, payload)
            except _RecordDropped:
                # RFC 6347 §4.1.2.7: records that fail authentication (or
                # replay old sequence numbers) are silently discarded — a
                # single spoofed datagram must not abort the association.
                continue
            except DtlsError as e:
                self._failed = str(e)
                return

    def _replay_stale(self, epoch: int, seq48: int) -> bool:
        top, mask = self._replay.get(epoch, (-1, 0))
        if seq48 > top:
            return False
        d = top - seq48
        return d >= 64 or bool(mask >> d & 1)

    def _replay_mark(self, epoch: int, seq48: int) -> None:
        top, mask = self._replay.get(epoch, (-1, 0))
        if seq48 > top:
            shift = seq48 - top
            mask = (mask << shift | 1) & (1 << 64) - 1
            top = seq48
        else:
            mask |= 1 << (top - seq48)
        self._replay[epoch] = (top, mask)

    def _handle_record(self, ctype: int, epoch: int, seq48: int, payload: bytes) -> None:
        # Anti-replay applies only to AEAD-protected epoch-1 records: a
        # cleartext epoch-0 record is unauthenticated, so letting it advance
        # the window would let one off-path spoofed datagram with a large
        # seq48 blackhole every subsequent legitimate handshake record.
        # Epoch-0 dedup is already handled by handshake reassembly (message
        # seq) and the Finished transcript check.
        if epoch == 1:
            if self._replay_stale(epoch, seq48):
                raise _RecordDropped("replayed/duplicate record")
            if self._keys is None:
                return  # too early; peer will retransmit
            payload = self._decrypt(ctype, epoch, seq48, payload)
            # only records whose AEAD tag verified advance the window
            self._replay_mark(epoch, seq48)
        if ctype == CT_APPLICATION_DATA:
            # Delivered outside the lock: the SCTP association above sends
            # through send() (this lock) while it holds its own lock, and
            # takes its own lock to handle what is delivered here; under the
            # lock the two orders deadlock (divergence from the JAX package,
            # whose receive loop and a sender can hang each other).
            if self.on_data:
                self.on_data(payload)
            return
        with self._lock:
            if ctype == CT_HANDSHAKE:
                for msg in self._reasm.push(payload):
                    self._handle_handshake(msg, encrypted=(epoch == 1))
            elif ctype == CT_CHANGE_CIPHER_SPEC:
                self._recv_epoch = 1
            elif ctype == CT_ALERT:
                # An unauthenticated (epoch-0) alert is trivially spoofable;
                # ignore it rather than failing the association (RFC 6347
                # §4.1.2.7 spirit: don't let off-path packets abort).
                if epoch == 1 and len(payload) >= 2 and payload[1] != 0:
                    self._failed = f"peer alert {payload[0]}/{payload[1]}"

    def _send_record(self, ctype: int, payload: bytes, epoch: int) -> None:
        seq = self._seq[epoch]
        self._seq[epoch] = seq + 1
        if epoch == 1:
            payload = self._encrypt(ctype, epoch, seq, payload)
        hdr = struct.pack(
            "!BHHHIH",
            ctype,
            DTLS_1_2,
            epoch,
            (seq >> 32) & 0xFFFF,
            seq & 0xFFFFFFFF,
            len(payload),
        )
        self.send_cb(hdr + payload)

    # -- AEAD (AES-128-GCM, RFC 5288) -------------------------------------------

    def _dir_keys(self, sending: bool) -> Tuple[bytes, bytes]:
        assert self._keys is not None
        we_are_client = self.is_client
        use_client = we_are_client if sending else not we_are_client
        if use_client:
            return self._keys["client_key"], self._keys["client_iv"]
        return self._keys["server_key"], self._keys["server_iv"]

    def _encrypt(self, ctype: int, epoch: int, seq: int, plaintext: bytes) -> bytes:
        key, implicit_iv = self._dir_keys(sending=True)
        explicit = struct.pack("!HHI", epoch, (seq >> 32) & 0xFFFF, seq & 0xFFFFFFFF)
        nonce = implicit_iv + explicit
        aad = explicit + struct.pack("!BHH", ctype, DTLS_1_2, len(plaintext))
        ct = AESGCM(key).encrypt(nonce, plaintext, aad)
        return explicit + ct

    def _decrypt(self, ctype: int, epoch: int, seq: int, payload: bytes) -> bytes:
        if len(payload) < 8 + 16:
            raise _RecordDropped("short AEAD record")
        key, implicit_iv = self._dir_keys(sending=False)
        explicit, ct = payload[:8], payload[8:]
        nonce = implicit_iv + explicit
        # AAD seq is the RECORD's epoch+sequence — peers may choose an
        # explicit nonce that differs from it (RFC 5288 §3: "MAY be the
        # 64-bit sequence number"); OpenSSL does.
        record_seq = struct.pack("!HHI", epoch, (seq >> 32) & 0xFFFF, seq & 0xFFFFFFFF)
        aad = record_seq + struct.pack("!BHH", ctype, DTLS_1_2, len(ct) - 16)
        try:
            return AESGCM(key).decrypt(nonce, ct, aad)
        except Exception as e:  # InvalidTag
            raise _RecordDropped(f"record decrypt failed: {e}")

    # -- handshake construction ---------------------------------------------------

    def _queue_hs(self, msg_type: int, body: bytes, flight: List[Tuple[int, int, bytes]],
                  epoch: int = 0) -> None:
        msg = HandshakeMsg(msg_type, self._send_msg_seq, body)
        self._send_msg_seq += 1
        self._transcript += msg.wire()
        flight.append((CT_HANDSHAKE, epoch, msg.wire()))

    def _send_flight(self, flight: List[Tuple[int, int, bytes]]) -> None:
        self._last_flight = flight
        for ctype, epoch, payload in flight:
            self._send_record(ctype, payload, epoch)

    def _retransmit(self) -> None:
        for ctype, epoch, payload in self._last_flight:
            self._send_record(ctype, payload, epoch)

    def _ecdh_point(self) -> bytes:
        return self._ecdh_priv.public_key().public_bytes(
            serialization.Encoding.X962, serialization.PublicFormat.UncompressedPoint
        )

    def _extensions(self, client: bool) -> bytes:
        exts = []
        if client:
            exts.append((EXT_SUPPORTED_GROUPS, struct.pack("!HH", 2, GROUP_SECP256R1)))
            exts.append((EXT_SIGNATURE_ALGORITHMS, struct.pack("!HH", 2, SIGALG_ECDSA_SECP256R1_SHA256)))
            profs = b"".join(struct.pack("!H", p) for p in self.srtp_profiles)
            exts.append((EXT_USE_SRTP, struct.pack("!H", len(profs)) + profs + b"\x00"))
        elif self.srtp_profile is not None:
            exts.append((EXT_USE_SRTP, struct.pack("!HH", 2, self.srtp_profile) + b"\x00"))
        exts.append((EXT_EC_POINT_FORMATS, b"\x01\x00"))
        exts.append((EXT_RENEGOTIATION_INFO, b"\x00"))
        body = b"".join(struct.pack("!HH", t, len(v)) + v for t, v in exts)
        return struct.pack("!H", len(body)) + body

    def _send_client_hello(self) -> None:
        with self._lock:
            body = struct.pack("!H", DTLS_1_2) + self.client_random
            body += bytes([len(self._session_id)]) + self._session_id
            body += bytes([len(self._cookie)]) + self._cookie
            body += struct.pack("!HH", 2, CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256)
            body += b"\x01\x00"  # compression: null
            body += self._extensions(client=True)
            flight: List[Tuple[int, int, bytes]] = []
            self._queue_hs(HT_CLIENT_HELLO, body, flight)
            self._send_flight(flight)

    # -- handshake state machine -----------------------------------------------

    def _handle_handshake(self, msg: HandshakeMsg, encrypted: bool) -> None:
        t = msg.msg_type
        if t == HT_FINISHED:
            self._on_finished(msg)
            return
        # everything else goes into the transcript as received
        if t == HT_HELLO_VERIFY_REQUEST:
            self._on_hello_verify(msg)
            return
        self._transcript += msg.wire()
        if t == HT_CLIENT_HELLO and not self.is_client:
            self._on_client_hello(msg)
        elif t == HT_SERVER_HELLO and self.is_client:
            self._on_server_hello(msg)
        elif t == HT_CERTIFICATE:
            self._on_certificate(msg)
        elif t == HT_SERVER_KEY_EXCHANGE and self.is_client:
            self._on_server_key_exchange(msg)
        elif t == HT_CERTIFICATE_REQUEST and self.is_client:
            self._cert_requested = True
        elif t == HT_SERVER_HELLO_DONE and self.is_client:
            self._on_server_hello_done()
        elif t == HT_CLIENT_KEY_EXCHANGE and not self.is_client:
            self._on_client_key_exchange(msg)
        elif t == HT_CERTIFICATE_VERIFY and not self.is_client:
            self._on_certificate_verify(msg)

    def _on_hello_verify(self, msg: HandshakeMsg) -> None:
        # RFC 6347 §4.2.1: restart transcript, resend ClientHello with cookie.
        self._cookie = msg.body[3:3 + msg.body[2]]
        self._transcript = bytearray()
        self._reasm = _Reassembler()
        self._send_client_hello()

    def _on_client_hello(self, msg: HandshakeMsg) -> None:
        b = msg.body
        self.client_random = b[2:34]
        off = 34
        sid_len = b[off]; off += 1 + sid_len
        cookie_len = b[off]; off += 1 + cookie_len
        cs_len = struct.unpack("!H", b[off:off + 2])[0]; off += 2
        suites = {struct.unpack("!H", b[off + i:off + i + 2])[0] for i in range(0, cs_len, 2)}
        off += cs_len
        comp_len = b[off]; off += 1 + comp_len
        if CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256 not in suites:
            raise DtlsError("no shared cipher suite")
        # parse use_srtp from extensions
        self.srtp_profile = None
        if off + 2 <= len(b):
            ext_len = struct.unpack("!H", b[off:off + 2])[0]
            off += 2
            end = off + ext_len
            while off + 4 <= end:
                et, el = struct.unpack("!HH", b[off:off + 4])
                ev = b[off + 4:off + 4 + el]
                off += 4 + el
                if et == EXT_USE_SRTP and len(ev) >= 2:
                    plen = struct.unpack("!H", ev[:2])[0]
                    offered = {
                        struct.unpack("!H", ev[2 + i:4 + i])[0] for i in range(0, plen, 2)
                    }
                    for p in self.srtp_profiles:
                        if p in offered:
                            self.srtp_profile = p
                            break
        flight: List[Tuple[int, int, bytes]] = []
        # ServerHello
        sh = struct.pack("!H", DTLS_1_2) + self.server_random + b"\x00"
        sh += struct.pack("!H", CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256) + b"\x00"
        sh += self._extensions(client=False)
        self._queue_hs(HT_SERVER_HELLO, sh, flight)
        # Certificate
        self._queue_hs(HT_CERTIFICATE, self._certificate_body(), flight)
        # ServerKeyExchange
        params = bytes([3]) + struct.pack("!H", GROUP_SECP256R1)
        point = self._ecdh_point()
        params += bytes([len(point)]) + point
        signed = self.client_random + self.server_random + params
        sig = self.private_key.sign(signed, ec.ECDSA(hashes.SHA256()))
        ske = params + struct.pack("!H", SIGALG_ECDSA_SECP256R1_SHA256) + struct.pack("!H", len(sig)) + sig
        self._queue_hs(HT_SERVER_KEY_EXCHANGE, ske, flight)
        # CertificateRequest: ecdsa_sign, our sigalg, no CAs
        cr = b"\x01\x40" + struct.pack("!HH", 2, SIGALG_ECDSA_SECP256R1_SHA256) + b"\x00\x00"
        self._queue_hs(HT_CERTIFICATE_REQUEST, cr, flight)
        self._queue_hs(HT_SERVER_HELLO_DONE, b"", flight)
        self._send_flight(flight)

    def _on_server_hello(self, msg: HandshakeMsg) -> None:
        b = msg.body
        self.server_random = b[2:34]
        off = 34
        sid_len = b[off]; off += 1 + sid_len
        suite = struct.unpack("!H", b[off:off + 2])[0]
        off += 3  # suite + compression
        if suite != CIPHER_ECDHE_ECDSA_AES128_GCM_SHA256:
            raise DtlsError(f"server chose unsupported suite {suite:#x}")
        self.srtp_profile = None
        if off + 2 <= len(b):
            ext_len = struct.unpack("!H", b[off:off + 2])[0]
            off += 2
            end = off + ext_len
            while off + 4 <= end:
                et, el = struct.unpack("!HH", b[off:off + 4])
                ev = b[off + 4:off + 4 + el]
                off += 4 + el
                if et == EXT_USE_SRTP and len(ev) >= 4:
                    self.srtp_profile = struct.unpack("!H", ev[2:4])[0]

    def _certificate_body(self) -> bytes:
        one = struct.pack("!I", len(self.cert_der))[1:] + self.cert_der
        return struct.pack("!I", len(one))[1:] + one

    def _on_certificate(self, msg: HandshakeMsg) -> None:
        b = msg.body
        total = int.from_bytes(b[:3], "big")
        if total >= 3:
            clen = int.from_bytes(b[3:6], "big")
            self.peer_cert_der = b[6:6 + clen]

    def _peer_public_key(self):
        if self.peer_cert_der is None:
            raise DtlsError("no peer certificate")
        return x509.load_der_x509_certificate(self.peer_cert_der).public_key()

    def _on_server_key_exchange(self, msg: HandshakeMsg) -> None:
        b = msg.body
        if b[0] != 3 or struct.unpack("!H", b[1:3])[0] != GROUP_SECP256R1:
            raise DtlsError("unsupported ECDHE group")
        plen = b[3]
        point = b[4:4 + plen]
        off = 4 + plen
        params = b[:off]
        sigalg = struct.unpack("!H", b[off:off + 2])[0]
        siglen = struct.unpack("!H", b[off + 2:off + 4])[0]
        sig = b[off + 4:off + 4 + siglen]
        if sigalg != SIGALG_ECDSA_SECP256R1_SHA256:
            raise DtlsError("unsupported SKE signature algorithm")
        pub = self._peer_public_key()
        try:
            pub.verify(sig, self.client_random + self.server_random + params,
                       ec.ECDSA(hashes.SHA256()))
        except InvalidSignature:
            raise DtlsError("ServerKeyExchange signature invalid")
        self._peer_ecdh_point = point

    def _on_server_hello_done(self) -> None:
        flight: List[Tuple[int, int, bytes]] = []
        if self._cert_requested:
            # mutual auth only when the server asked (WebRTC always does)
            self._queue_hs(HT_CERTIFICATE, self._certificate_body(), flight)
        point = self._ecdh_point()
        self._queue_hs(HT_CLIENT_KEY_EXCHANGE, bytes([len(point)]) + point, flight)
        self._compute_master_secret()
        if self._cert_requested:
            # CertificateVerify over the transcript so far
            sig = self.private_key.sign(bytes(self._transcript), ec.ECDSA(hashes.SHA256()))
            cv = struct.pack("!HH", SIGALG_ECDSA_SECP256R1_SHA256, len(sig)) + sig
            self._queue_hs(HT_CERTIFICATE_VERIFY, cv, flight)
        flight.append((CT_CHANGE_CIPHER_SPEC, 0, b"\x01"))
        self._derive_keys()
        fin = self._finished_body(b"client finished")
        fin_msg = HandshakeMsg(HT_FINISHED, self._send_msg_seq, fin)
        self._send_msg_seq += 1
        self._transcript += fin_msg.wire()
        flight.append((CT_HANDSHAKE, 1, fin_msg.wire()))
        self._send_flight(flight)
        self._sent_finished = True

    def _on_client_key_exchange(self, msg: HandshakeMsg) -> None:
        plen = msg.body[0]
        self._peer_ecdh_point = msg.body[1:1 + plen]
        self._transcript_at_cke = bytes(self._transcript)
        self._compute_master_secret()
        self._derive_keys()

    def _on_certificate_verify(self, msg: HandshakeMsg) -> None:
        # signature covers all handshake messages up to (not incl.) this one
        sigalg = struct.unpack("!H", msg.body[:2])[0]
        siglen = struct.unpack("!H", msg.body[2:4])[0]
        sig = msg.body[4:4 + siglen]
        if sigalg != SIGALG_ECDSA_SECP256R1_SHA256:
            raise DtlsError("unsupported CertificateVerify algorithm")
        transcript_before = bytes(self._transcript[: len(self._transcript) - len(msg.wire())])
        try:
            self._peer_public_key().verify(sig, transcript_before, ec.ECDSA(hashes.SHA256()))
        except InvalidSignature:
            raise DtlsError("CertificateVerify signature invalid")
        self._cv_verified = True

    def _compute_master_secret(self) -> None:
        if self._peer_ecdh_point is None:
            raise DtlsError("missing peer ECDHE point")
        peer_pub = ec.EllipticCurvePublicKey.from_encoded_point(
            ec.SECP256R1(), self._peer_ecdh_point
        )
        pre_master = self._ecdh_priv.exchange(ec.ECDH(), peer_pub)
        self.master_secret = prf(
            pre_master, b"master secret", self.client_random + self.server_random, 48
        )

    def _derive_keys(self) -> None:
        assert self.master_secret is not None
        block = prf(
            self.master_secret,
            b"key expansion",
            self.server_random + self.client_random,
            2 * 16 + 2 * 4,
        )
        self._keys = {
            "client_key": block[0:16],
            "server_key": block[16:32],
            "client_iv": block[32:36],
            "server_iv": block[36:40],
        }

    def _finished_body(self, label: bytes) -> bytes:
        assert self.master_secret is not None
        return prf(self.master_secret, label, hashlib.sha256(bytes(self._transcript)).digest(), 12)

    def _on_finished(self, msg: HandshakeMsg) -> None:
        if self._peer_finished:
            return  # peer retransmitted its final flight; already verified
        label = b"client finished" if not self.is_client else b"server finished"
        transcript_before = bytes(self._transcript)
        expect = prf(self.master_secret, label, hashlib.sha256(transcript_before).digest(), 12)
        if not hmac_mod.compare_digest(expect, msg.body):
            raise DtlsError("Finished verify_data mismatch")
        if not self.is_client and self.peer_cert_der and not self._cv_verified:
            # A client that presented a certificate MUST prove possession of
            # its key (RFC 5246 §7.4.8) — otherwise anyone replaying a
            # victim's public cert DER would pass the SDP fingerprint check.
            raise DtlsError("client Certificate without verified CertificateVerify")
        self._transcript += msg.wire()
        self._peer_finished = True
        if not self.is_client and not self._sent_finished:
            flight: List[Tuple[int, int, bytes]] = [(CT_CHANGE_CIPHER_SPEC, 0, b"\x01")]
            fin = self._finished_body(b"server finished")
            fin_msg = HandshakeMsg(HT_FINISHED, self._send_msg_seq, fin)
            self._send_msg_seq += 1
            self._transcript += fin_msg.wire()
            flight.append((CT_HANDSHAKE, 1, fin_msg.wire()))
            self._send_flight(flight)
            self._sent_finished = True
        if self._peer_finished and self._sent_finished:
            self._handshake_done.set()
