"""TLS 1.3 (RFC 8446) handshake engine for QUIC-TLS (RFC 9001).

Parity target: the reference's quinn plugin rides the Rust `quinn` +
`rustls` stack (net/quinn/Cargo.toml); here the handshake is in-repo.
Scope is exactly what QUIC needs:

- TLS_AES_128_GCM_SHA256, x25519 key share, ECDSA P-256 certificates
  (self-signed, fingerprint-style trust as in WebRTC; a `verify_peer`
  hook allows stricter policies)
- the QUIC interface: handshake bytes in/out per encryption level,
  traffic secrets surfaced per level (RFC 9001 §4.1), ALPN, and the
  quic_transport_parameters extension (0x39) carried opaquely
- HKDF key schedule with hkdf_expand_label, Finished HMAC, ECDSA
  CertificateVerify with the RFC 8446 §4.4.3 context string
- session resumption (§4.6.1): NewSessionTickets sealing the PSK under
  a server ticket key, psk_dhe_ke offers with binders (§4.2.11), the
  early-secret schedule and client_early_traffic_secret for QUIC 0-RTT
  (RFC 9001 §4.6) — binder/PSK math validated against openssl s_server
  in tests/test_tls13_openssl_interop.py

No record layer: QUIC carries raw handshake messages in CRYPTO frames.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct
from typing import Callable, Dict, List, Optional, Tuple

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)

from .dtls import generate_certificate  # same self-signed ECDSA P-256 certs

HASH_LEN = 32

HT_CLIENT_HELLO = 1
HT_NEW_SESSION_TICKET = 4
HT_SERVER_HELLO = 2
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20

EXT_SERVER_NAME = 0x0000
EXT_SUPPORTED_GROUPS = 0x000A
EXT_SIGNATURE_ALGORITHMS = 0x000D
EXT_ALPN = 0x0010
EXT_PRE_SHARED_KEY = 0x0029
EXT_EARLY_DATA = 0x002A
EXT_SUPPORTED_VERSIONS = 0x002B
EXT_PSK_KEY_EXCHANGE_MODES = 0x002D
EXT_KEY_SHARE = 0x0033
EXT_QUIC_TRANSPORT_PARAMETERS = 0x0039

GROUP_X25519 = 0x001D
SIGALG_ECDSA_SECP256R1_SHA256 = 0x0403
TLS13 = 0x0304
CIPHER_AES_128_GCM_SHA256 = 0x1301

LEVEL_INITIAL = "initial"
LEVEL_HANDSHAKE = "handshake"
LEVEL_APP = "app"


# ---------------------------------------------------------------------------
# HKDF (RFC 5869 / RFC 8446 §7.1)


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt or b"\x00" * HASH_LEN, ikm, hashlib.sha256).digest()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: str, context: bytes, length: int) -> bytes:
    lab = b"tls13 " + label.encode()
    info = struct.pack("!H", length) + bytes([len(lab)]) + lab + bytes([len(context)]) + context
    return hkdf_expand(secret, info, length)


def derive_secret(secret: bytes, label: str, transcript: bytes) -> bytes:
    return hkdf_expand_label(secret, label, hashlib.sha256(transcript).digest(), HASH_LEN)


# ---------------------------------------------------------------------------


# 0-RTT anti-replay: ticket-id sets keyed by ticket_key (RFC 8446 §8.1).
# Single-use redemption per process; see _on_client_hello for scope notes.
_redeemed_tickets: Dict[bytes, set] = {}


class TlsError(Exception):
    pass


def _hs(msg_type: int, body: bytes) -> bytes:
    return bytes([msg_type]) + struct.pack("!I", len(body))[1:] + body


def _ext(etype: int, body: bytes) -> bytes:
    return struct.pack("!HH", etype, len(body)) + body


def _parse_extensions(data: bytes) -> Dict[int, bytes]:
    exts: Dict[int, bytes] = {}
    off = 0
    while off + 4 <= len(data):
        t, ln = struct.unpack("!HH", data[off:off + 4])
        exts[t] = data[off + 4:off + 4 + ln]
        off += 4 + ln
    return exts


class QuicTls:
    """Shared client/server machinery.

    Produces (level, bytes) CRYPTO output via `take_output()`, consumes
    peer CRYPTO bytes via `handle(level, data)`.  Secrets callbacks:
    `on_secrets(level, client_secret, server_secret)`.
    """

    def __init__(self, is_client: bool, alpn: List[str],
                 transport_params: bytes,
                 certificate: Optional[Tuple[bytes, ec.EllipticCurvePrivateKey]] = None,
                 verify_peer: Optional[Callable[[bytes], bool]] = None):
        self.is_client = is_client
        # Policy hook: called with the peer's certificate DER after its
        # CertificateVerify proves key possession; return False to reject
        # (pinning / fingerprint checks).  None = accept any self-signed
        # cert (WebRTC-style trust; pair with out-of-band fingerprints).
        self.verify_peer = verify_peer
        self.alpn = alpn
        self.negotiated_alpn: Optional[str] = None
        self.transport_params = transport_params
        self.peer_transport_params: Optional[bytes] = None
        self.cert_der, self.private_key = certificate or generate_certificate()
        self.peer_cert_der: Optional[bytes] = None
        self._x25519 = X25519PrivateKey.generate()
        self._transcript = bytearray()
        self._out: List[Tuple[str, bytes]] = []
        self._buf: Dict[str, bytearray] = {LEVEL_INITIAL: bytearray(),
                                           LEVEL_HANDSHAKE: bytearray()}
        self.on_secrets: Optional[Callable[[str, bytes, bytes], None]] = None
        self.handshake_complete = False
        self._hs_secret: Optional[bytes] = None
        self._master: Optional[bytes] = None
        self._client_hs_secret: Optional[bytes] = None
        self._server_hs_secret: Optional[bytes] = None
        self.client_random = os.urandom(32)

        # session resumption / 0-RTT (RFC 8446 §2.2/§2.3, RFC 9001 §4.5/§4.6)
        self._early_secret: Optional[bytes] = None  # HKDF-Extract(0, PSK)
        self._res_master: Optional[bytes] = None
        self.psk_accepted = False       # this handshake resumed via PSK
        self.early_data_accepted = False
        # called with client_early_traffic_secret when 0-RTT keys exist
        self.on_early_secret: Optional[Callable[[bytes], None]] = None
        # client: filled by NewSessionTicket — pass back as `session=` later
        self.new_session: Optional[Dict[str, object]] = None
        self.on_new_session: Optional[Callable[[Dict[str, object]], None]] = None

    # -- helpers ---------------------------------------------------------------
    def _emit(self, level: str, msg: bytes, transcript: bool = True) -> None:
        if transcript:
            self._transcript += msg
        self._out.append((level, msg))

    def take_output(self) -> List[Tuple[str, bytes]]:
        out, self._out = self._out, []
        return out

    def _give_secrets(self, level: str, client: bytes, server: bytes) -> None:
        if self.on_secrets:
            self.on_secrets(level, client, server)

    # -- key schedule ------------------------------------------------------------
    def _derive_handshake(self, shared: bytes) -> None:
        early = self._early_secret or hkdf_extract(b"", b"\x00" * HASH_LEN)
        self._hs_secret = hkdf_extract(
            derive_secret(early, "derived", b""), shared)
        t = bytes(self._transcript)
        self._client_hs_secret = derive_secret(self._hs_secret, "c hs traffic", t)
        self._server_hs_secret = derive_secret(self._hs_secret, "s hs traffic", t)
        self._give_secrets(LEVEL_HANDSHAKE, self._client_hs_secret, self._server_hs_secret)

    def _derive_app(self) -> None:
        self._master = hkdf_extract(
            derive_secret(self._hs_secret, "derived", b""), b"\x00" * HASH_LEN)
        t = bytes(self._transcript)
        cap = derive_secret(self._master, "c ap traffic", t)
        sap = derive_secret(self._master, "s ap traffic", t)
        self._give_secrets(LEVEL_APP, cap, sap)

    def _finished_mac(self, base_secret: bytes, transcript: bytes) -> bytes:
        finished_key = hkdf_expand_label(base_secret, "finished", b"", HASH_LEN)
        return hmac.new(finished_key, hashlib.sha256(transcript).digest(),
                        hashlib.sha256).digest()

    def _derive_resumption(self) -> None:
        """resumption_master_secret over the transcript through the client
        Finished (RFC 8446 §7.1)."""
        self._res_master = derive_secret(self._master, "res master",
                                         bytes(self._transcript))

    @staticmethod
    def _psk_binder(early_secret: bytes, truncated_transcript: bytes) -> bytes:
        """PSK binder (RFC 8446 §4.2.11.2): Finished-style HMAC over the
        ClientHello truncated before the binders list."""
        binder_key = derive_secret(early_secret, "res binder", b"")
        fk = hkdf_expand_label(binder_key, "finished", b"", HASH_LEN)
        return hmac.new(fk, hashlib.sha256(truncated_transcript).digest(),
                        hashlib.sha256).digest()

    def _derive_early(self, client_hello_transcript: bytes) -> None:
        """client_early_traffic_secret over the full ClientHello (§7.1);
        surfaced via on_early_secret for QUIC 0-RTT packet protection."""
        ets = derive_secret(self._early_secret, "c e traffic",
                            client_hello_transcript)
        if self.on_early_secret:
            self.on_early_secret(ets)

    # -- message input -------------------------------------------------------------
    def handle(self, level: str, data: bytes) -> None:
        buf = self._buf.setdefault(level, bytearray())
        buf += data
        while len(buf) >= 4:
            mlen = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + mlen:
                return
            msg = bytes(buf[:4 + mlen])
            del buf[:4 + mlen]
            self._handle_msg(level, msg)

    def _handle_msg(self, level: str, msg: bytes) -> None:
        raise NotImplementedError

    # -- common message builders -----------------------------------------------------
    def _certificate_msg(self) -> bytes:
        entry = struct.pack("!I", len(self.cert_der))[1:] + self.cert_der + b"\x00\x00"
        body = b"\x00" + struct.pack("!I", len(entry))[1:] + entry
        return _hs(HT_CERTIFICATE, body)

    def _certificate_verify_msg(self, server: bool) -> bytes:
        role = b"server" if server else b"client"
        content = (b" " * 64 + b"TLS 1.3, " + role + b" CertificateVerify\x00"
                   + hashlib.sha256(bytes(self._transcript)).digest())
        sig = self.private_key.sign(content, ec.ECDSA(hashes.SHA256()))
        return _hs(HT_CERTIFICATE_VERIFY,
                   struct.pack("!HH", SIGALG_ECDSA_SECP256R1_SHA256, len(sig)) + sig)

    def _verify_certificate_verify(self, msg_body: bytes, server: bool,
                                   transcript_before: bytes) -> None:
        from cryptography import x509

        sigalg, siglen = struct.unpack("!HH", msg_body[:4])
        sig = msg_body[4:4 + siglen]
        if sigalg != SIGALG_ECDSA_SECP256R1_SHA256:
            raise TlsError(f"unsupported CertificateVerify algorithm {sigalg:#x}")
        role = b"server" if server else b"client"
        content = (b" " * 64 + b"TLS 1.3, " + role + b" CertificateVerify\x00"
                   + hashlib.sha256(transcript_before).digest())
        if self.peer_cert_der is None:
            raise TlsError("CertificateVerify without Certificate")
        pub = x509.load_der_x509_certificate(self.peer_cert_der).public_key()
        try:
            pub.verify(sig, content, ec.ECDSA(hashes.SHA256()))
        except Exception:
            raise TlsError("CertificateVerify signature invalid")
        if self.verify_peer is not None and not self.verify_peer(self.peer_cert_der):
            raise TlsError("peer certificate rejected by verify_peer policy")

    def _parse_certificate(self, body: bytes) -> None:
        ctx_len = body[0]
        off = 1 + ctx_len
        total = int.from_bytes(body[off:off + 3], "big")
        off += 3
        clen = int.from_bytes(body[off:off + 3], "big")
        self.peer_cert_der = body[off + 3:off + 3 + clen]


class QuicTlsClient(QuicTls):
    def __init__(self, *args, server_name: Optional[str] = None,
                 session: Optional[Dict[str, object]] = None, **kwargs):
        super().__init__(True, *args, **kwargs)
        self.server_name = server_name
        self.session = session  # from a previous connection's new_session
        self._offered_psk = False
        self._sent_hello = False

    def start(self) -> None:
        if self._sent_hello:
            return
        self._sent_hello = True
        key_share = self._x25519.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        exts = b""
        if self.server_name:
            sn = self.server_name.encode()
            exts += _ext(EXT_SERVER_NAME,
                         struct.pack("!HBH", len(sn) + 3, 0, len(sn)) + sn)
        exts += _ext(EXT_SUPPORTED_GROUPS, struct.pack("!HH", 2, GROUP_X25519))
        exts += _ext(EXT_SIGNATURE_ALGORITHMS, struct.pack("!HH", 2, SIGALG_ECDSA_SECP256R1_SHA256))
        alpn = b"".join(bytes([len(a)]) + a.encode() for a in self.alpn)
        exts += _ext(EXT_ALPN, struct.pack("!H", len(alpn)) + alpn)
        exts += _ext(EXT_SUPPORTED_VERSIONS, b"\x02" + struct.pack("!H", TLS13))
        ks = struct.pack("!HH", GROUP_X25519, len(key_share)) + key_share
        exts += _ext(EXT_KEY_SHARE, struct.pack("!H", len(ks)) + ks)
        exts += _ext(EXT_QUIC_TRANSPORT_PARAMETERS, self.transport_params)
        if self.session:
            # offer resumption: psk_dhe_ke mode, early_data if the ticket
            # allows it, pre_shared_key MUST be last (RFC 8446 §4.2.11)
            self._offered_psk = True
            exts += _ext(EXT_PSK_KEY_EXCHANGE_MODES, b"\x01\x01")
            if self.session.get("max_early_data"):
                exts += _ext(EXT_EARLY_DATA, b"")
            ticket = self.session["ticket"]
            ident = (struct.pack("!H", len(ticket)) + ticket
                     + struct.pack("!I", int(self.session.get("age_add", 0))))
            psk_body = (struct.pack("!H", len(ident)) + ident
                        + struct.pack("!H", 1 + HASH_LEN))
            exts += _ext(EXT_PRE_SHARED_KEY,
                         psk_body + bytes([HASH_LEN]) + b"\x00" * HASH_LEN)
        body = struct.pack("!H", 0x0303) + self.client_random + b"\x00"
        body += struct.pack("!HH", 2, CIPHER_AES_128_GCM_SHA256) + b"\x01\x00"
        body += struct.pack("!H", len(exts)) + exts
        ch = _hs(HT_CLIENT_HELLO, body)
        if self.session:
            # compute the real binder over the truncated ClientHello and
            # splice it into the placeholder (§4.2.11.2)
            self._early_secret = hkdf_extract(b"", self.session["psk"])
            binders_len = 2 + 1 + HASH_LEN
            binder = self._psk_binder(self._early_secret, ch[:-binders_len])
            ch = ch[:-HASH_LEN] + binder
        self._emit(LEVEL_INITIAL, ch)
        if self.session and self.session.get("max_early_data"):
            self._derive_early(bytes(self._transcript))

    def _handle_msg(self, level: str, msg: bytes) -> None:
        t = msg[0]
        body = msg[4:]
        if t == HT_SERVER_HELLO:
            self._transcript += msg
            off = 2 + 32
            sid_len = body[off]; off += 1 + sid_len
            cipher = struct.unpack("!H", body[off:off + 2])[0]
            off += 3
            if cipher != CIPHER_AES_128_GCM_SHA256:
                raise TlsError(f"unsupported cipher {cipher:#x}")
            ext_len = struct.unpack("!H", body[off:off + 2])[0]
            exts = _parse_extensions(body[off + 2:off + 2 + ext_len])
            ks = exts.get(EXT_KEY_SHARE)
            if ks is None or struct.unpack("!H", ks[:2])[0] != GROUP_X25519:
                raise TlsError("server key_share missing or wrong group")
            if EXT_PRE_SHARED_KEY in exts:
                if not self._offered_psk:
                    raise TlsError("server selected a PSK we never offered")
                self.psk_accepted = True
            elif self._offered_psk:
                # full handshake fallback: forget the PSK early secret so
                # the key schedule starts from zeros (§4.2.11); any 0-RTT
                # data is implicitly rejected
                self._early_secret = None
            peer_pub = X25519PublicKey.from_public_bytes(ks[4:4 + 32])
            shared = self._x25519.exchange(peer_pub)
            self._derive_handshake(shared)
        elif t == HT_ENCRYPTED_EXTENSIONS:
            self._transcript += msg
            exts = _parse_extensions(body[2:])
            if EXT_ALPN in exts:
                alpn = exts[EXT_ALPN]
                n = alpn[2]
                self.negotiated_alpn = alpn[3:3 + n].decode()
            elif self.psk_accepted and self.session and self.session.get("alpn"):
                self.negotiated_alpn = str(self.session["alpn"])
            if EXT_QUIC_TRANSPORT_PARAMETERS in exts:
                self.peer_transport_params = exts[EXT_QUIC_TRANSPORT_PARAMETERS]
            self.early_data_accepted = (self.psk_accepted
                                        and EXT_EARLY_DATA in exts)
        elif t == HT_CERTIFICATE:
            self._transcript += msg
            self._parse_certificate(body)
        elif t == HT_CERTIFICATE_VERIFY:
            before = bytes(self._transcript)
            self._verify_certificate_verify(body, server=True, transcript_before=before)
            self._transcript += msg
        elif t == HT_FINISHED:
            expect = self._finished_mac(self._server_hs_secret, bytes(self._transcript))
            if not hmac.compare_digest(expect, body):
                raise TlsError("server Finished mismatch")
            self._transcript += msg
            # client Finished then app keys
            fin = _hs(HT_FINISHED,
                      self._finished_mac(self._client_hs_secret, bytes(self._transcript)))
            self._derive_app()  # app secrets use transcript through server Finished
            self._transcript += fin
            self._out.append((LEVEL_HANDSHAKE, fin))
            self._derive_resumption()
            self.handshake_complete = True
        elif t == HT_NEW_SESSION_TICKET:
            # post-handshake: lifetime(4) age_add(4) nonce ticket exts
            off = 0
            lifetime, age_add = struct.unpack("!II", body[:8]); off = 8
            nlen = body[off]; nonce = body[off + 1:off + 1 + nlen]
            off += 1 + nlen
            tlen = struct.unpack("!H", body[off:off + 2])[0]
            ticket = body[off + 2:off + 2 + tlen]
            off += 2 + tlen
            exts = _parse_extensions(
                body[off + 2:off + 2 + struct.unpack("!H", body[off:off + 2])[0]])
            max_early = 0
            if EXT_EARLY_DATA in exts:
                max_early = struct.unpack("!I", exts[EXT_EARLY_DATA][:4])[0]
            psk = hkdf_expand_label(self._res_master, "resumption", nonce,
                                    HASH_LEN)
            self.new_session = {
                "psk": psk, "ticket": ticket, "age_add": age_add,
                "lifetime": lifetime, "max_early_data": max_early,
                "alpn": self.negotiated_alpn,
                "transport_params": self.peer_transport_params,
            }
            if self.on_new_session:
                self.on_new_session(self.new_session)


class QuicTlsServer(QuicTls):
    def __init__(self, *args, ticket_key: Optional[bytes] = None, **kwargs):
        super().__init__(False, *args, **kwargs)
        self._client_fin_expected: Optional[bytes] = None
        # static key sealing session tickets (share across server instances
        # to resume over restarts; random = tickets valid per-process)
        self.ticket_key = ticket_key or os.urandom(16)
        self.send_session_tickets = True

    def _handle_msg(self, level: str, msg: bytes) -> None:
        t = msg[0]
        body = msg[4:]
        if t == HT_CLIENT_HELLO:
            self._transcript += msg
            self._on_client_hello(body, msg)
        elif t == HT_FINISHED:
            expect = self._finished_mac(self._client_hs_secret, bytes(self._transcript))
            if not hmac.compare_digest(expect, body):
                raise TlsError("client Finished mismatch")
            self._transcript += msg
            self._derive_resumption()
            self.handshake_complete = True
            if self.send_session_tickets:
                self._emit_session_ticket()

    def _emit_session_ticket(self) -> None:
        """NewSessionTicket (RFC 8446 §4.6.1) with QUIC's early_data
        sentinel 0xffffffff (RFC 9001 §4.6.1); the ticket seals the PSK
        under ticket_key so a fresh server instance can resume it."""
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        nonce = os.urandom(8)
        psk = hkdf_expand_label(self._res_master, "resumption", nonce, HASH_LEN)
        state = psk + struct.pack("!H", len((self.negotiated_alpn or "").encode())) \
            + (self.negotiated_alpn or "").encode()
        tnonce = os.urandom(12)
        ticket = tnonce + AESGCM(self.ticket_key).encrypt(tnonce, state, b"")
        exts = _ext(EXT_EARLY_DATA, struct.pack("!I", 0xFFFFFFFF))
        body = (struct.pack("!II", 7 * 24 * 3600, struct.unpack("!I", os.urandom(4))[0])
                + bytes([len(nonce)]) + nonce
                + struct.pack("!H", len(ticket)) + ticket
                + struct.pack("!H", len(exts)) + exts)
        self._emit(LEVEL_APP, _hs(HT_NEW_SESSION_TICKET, body),
                   transcript=False)

    def _open_ticket(self, ticket: bytes) -> Optional[Tuple[bytes, str]]:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM

        try:
            state = AESGCM(self.ticket_key).decrypt(ticket[:12], ticket[12:], b"")
            psk = state[:HASH_LEN]
            alen = struct.unpack("!H", state[HASH_LEN:HASH_LEN + 2])[0]
            alpn = state[HASH_LEN + 2:HASH_LEN + 2 + alen].decode()
            return psk, alpn
        except Exception:
            return None

    def _on_client_hello(self, body: bytes, raw_msg: bytes) -> None:
        off = 2 + 32
        sid_len = body[off]
        legacy_sid = body[off + 1:off + 1 + sid_len]  # echoed per RFC 8446 §4.1.3
        off += 1 + sid_len
        cs_len = struct.unpack("!H", body[off:off + 2])[0]; off += 2
        suites = {struct.unpack("!H", body[off + i:off + i + 2])[0]
                  for i in range(0, cs_len, 2)}
        off += cs_len
        comp_len = body[off]; off += 1 + comp_len
        ext_len = struct.unpack("!H", body[off:off + 2])[0]
        exts = _parse_extensions(body[off + 2:off + 2 + ext_len])
        if CIPHER_AES_128_GCM_SHA256 not in suites:
            raise TlsError("no common cipher")
        ks = exts.get(EXT_KEY_SHARE)
        if ks is None:
            raise TlsError("client key_share missing")
        # find the x25519 entry
        pos = 2
        peer_pub_bytes = None
        while pos + 4 <= len(ks):
            group, klen = struct.unpack("!HH", ks[pos:pos + 4])
            if group == GROUP_X25519:
                peer_pub_bytes = ks[pos + 4:pos + 4 + klen]
                break
            pos += 4 + klen
        if peer_pub_bytes is None:
            raise TlsError("no x25519 key share")
        if EXT_QUIC_TRANSPORT_PARAMETERS in exts:
            self.peer_transport_params = exts[EXT_QUIC_TRANSPORT_PARAMETERS]
        # ALPN selection
        if EXT_ALPN in exts:
            offered = []
            alpn = exts[EXT_ALPN]
            pos = 2
            while pos < len(alpn):
                n = alpn[pos]
                offered.append(alpn[pos + 1:pos + 1 + n].decode())
                pos += 1 + n
            for a in self.alpn:
                if a in offered:
                    self.negotiated_alpn = a
                    break
            if self.negotiated_alpn is None and offered:
                raise TlsError("no common ALPN")

        # PSK resumption (RFC 8446 §4.2.11): first identity only.  A ticket
        # that fails to OPEN falls back to a full handshake (unknown
        # identity), but a ticket that opens with a WRONG binder is an
        # active attack and MUST abort the handshake (§4.2.11.2).
        psk_alpn = None
        if EXT_PRE_SHARED_KEY in exts:
            pskext = exts[EXT_PRE_SHARED_KEY]
            ids_len = struct.unpack("!H", pskext[:2])[0]
            tlen = struct.unpack("!H", pskext[2:4])[0]
            ticket = pskext[4:4 + tlen]
            binders_off = 2 + ids_len
            blen = struct.unpack("!H", pskext[binders_off:binders_off + 2])[0]
            first_binder = pskext[binders_off + 3:binders_off + 3
                                  + pskext[binders_off + 2]]
            opened = self._open_ticket(ticket)
            if opened is not None:
                early = hkdf_extract(b"", opened[0])
                truncated = raw_msg[:-(2 + blen)]
                if not hmac.compare_digest(self._psk_binder(early, truncated),
                                           first_binder):
                    raise TlsError("PSK binder verification failed")
                self._early_secret = early
                self.psk_accepted = True
                psk_alpn = opened[1] or None
                if self.negotiated_alpn is None:
                    self.negotiated_alpn = psk_alpn
        # Early data (§4.2.10): only with the PSK, and only when the
        # connection's negotiated ALPN equals the one stored in the ticket.
        # Anti-replay: single-use ticket cache (§8.1 first-flight defense) —
        # a replayed CH offering an already-redeemed ticket gets a full
        # handshake and its 0-RTT data is discarded.  The cache is
        # per-process; a multi-instance deployment sharing ticket_key would
        # need a shared store (documented limitation).
        if self.psk_accepted and EXT_EARLY_DATA in exts:
            if self.negotiated_alpn == psk_alpn:
                redeemed = _redeemed_tickets.setdefault(self.ticket_key, set())
                tid = hashlib.sha256(ticket).digest()
                if tid not in redeemed:
                    redeemed.add(tid)
                    if len(redeemed) > 65536:
                        redeemed.clear()  # bound memory; over-rejects, never replays
                    self.early_data_accepted = True
                    self._derive_early(bytes(self._transcript))  # transcript == CH

        # ServerHello
        key_share = self._x25519.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        sh_exts = _ext(EXT_SUPPORTED_VERSIONS, struct.pack("!H", TLS13))
        sh_exts += _ext(EXT_KEY_SHARE,
                        struct.pack("!HH", GROUP_X25519, len(key_share)) + key_share)
        if self.psk_accepted:
            sh_exts += _ext(EXT_PRE_SHARED_KEY, struct.pack("!H", 0))
        sh = struct.pack("!H", 0x0303) + os.urandom(32)
        sh += bytes([len(legacy_sid)]) + legacy_sid
        sh += struct.pack("!H", CIPHER_AES_128_GCM_SHA256) + b"\x00"
        sh += struct.pack("!H", len(sh_exts)) + sh_exts
        self._emit(LEVEL_INITIAL, _hs(HT_SERVER_HELLO, sh))

        peer_pub = X25519PublicKey.from_public_bytes(peer_pub_bytes)
        self._derive_handshake(self._x25519.exchange(peer_pub))

        # EncryptedExtensions
        ee_exts = b""
        if self.negotiated_alpn:
            a = self.negotiated_alpn.encode()
            ee_exts += _ext(EXT_ALPN, struct.pack("!HB", len(a) + 1, len(a)) + a)
        ee_exts += _ext(EXT_QUIC_TRANSPORT_PARAMETERS, self.transport_params)
        if self.early_data_accepted:
            ee_exts += _ext(EXT_EARLY_DATA, b"")
        self._emit(LEVEL_HANDSHAKE, _hs(HT_ENCRYPTED_EXTENSIONS,
                                        struct.pack("!H", len(ee_exts)) + ee_exts))
        if not self.psk_accepted:
            # resumed handshakes authenticate via the PSK (the original
            # connection verified the certificate); §4.4.2
            self._emit(LEVEL_HANDSHAKE, self._certificate_msg())
            self._emit(LEVEL_HANDSHAKE, self._certificate_verify_msg(server=True))
        fin = _hs(HT_FINISHED,
                  self._finished_mac(self._server_hs_secret, bytes(self._transcript)))
        self._emit(LEVEL_HANDSHAKE, fin)
        # app secrets derived over transcript through server Finished
        self._derive_app()
