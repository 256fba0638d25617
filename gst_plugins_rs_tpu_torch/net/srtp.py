"""SRTP / SRTCP (RFC 3711), profile SRTP_AES128_CM_HMAC_SHA1_80.

Parity target: the reference's webrtc media path uses libsrtp through
webrtcbin; this module owns the transform.  Implements the AES-CM
keystream, the AES-CM key-derivation function (§4.3, validated against
the RFC's B.3 test vectors), HMAC-SHA1-80 authentication, ROC tracking
with the §3.3.1 index-estimation algorithm, and SRTCP with the E-bit +
31-bit index.  Session keys normally come from the DTLS-SRTP exporter
(net/dtls.py, RFC 5764 §4.2).
"""
from __future__ import annotations

import hashlib
import hmac
import struct
from typing import Dict, Optional, Tuple

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes


class SrtpError(Exception):
    pass


def _aes_cm_keystream(key: bytes, iv16: bytes, length: int) -> bytes:
    """AES-128 counter mode keystream, counter = iv16 (low 16 bits count)."""
    enc = Cipher(algorithms.AES(key), modes.CTR(iv16)).encryptor()
    return enc.update(b"\x00" * length)


def _aes_cm_xor(key: bytes, iv16: bytes, data: bytes) -> bytes:
    """data XOR keystream == AES-CTR applied to data directly (hot path:
    no keystream materialization, no Python byte loop)."""
    return Cipher(algorithms.AES(key), modes.CTR(iv16)).encryptor().update(data)


def _kdf(master_key: bytes, master_salt: bytes, label: int, length: int) -> bytes:
    """RFC 3711 §4.3.1/§4.3.3 AES-CM key derivation (kdr = 0)."""
    # key_id = label || (index DIV kdr) = label followed by 48 zero bits
    key_id = bytes([label]) + b"\x00" * 6
    x = bytearray(master_salt.ljust(14, b"\x00"))
    for i, b in enumerate(key_id):
        x[7 + i] ^= b
    return _aes_cm_keystream(master_key, bytes(x) + b"\x00\x00", length)


def derive_session_keys(master_key: bytes, master_salt: bytes) -> Dict[str, bytes]:
    """Both RTP and RTCP session keys (labels 0x00-0x05)."""
    return {
        "rtp_key": _kdf(master_key, master_salt, 0x00, 16),
        "rtp_auth": _kdf(master_key, master_salt, 0x01, 20),
        "rtp_salt": _kdf(master_key, master_salt, 0x02, 14),
        "rtcp_key": _kdf(master_key, master_salt, 0x03, 16),
        "rtcp_auth": _kdf(master_key, master_salt, 0x04, 20),
        "rtcp_salt": _kdf(master_key, master_salt, 0x05, 14),
    }


def _rtp_iv(salt: bytes, ssrc: int, index: int) -> bytes:
    """IV = (salt * 2^16) xor (ssrc * 2^64) xor (index * 2^16)  (§4.1.1)."""
    iv = int.from_bytes(salt, "big") << 16
    iv ^= ssrc << 64
    iv ^= index << 16
    return iv.to_bytes(16, "big")


class SrtpSession:
    """One direction (a master key's worth) of SRTP+SRTCP protection."""

    AUTH_TAG_LEN = 10  # HMAC-SHA1-80

    def __init__(self, master_key: bytes, master_salt: bytes):
        k = derive_session_keys(master_key, master_salt)
        self.rtp_key, self.rtp_auth, self.rtp_salt = k["rtp_key"], k["rtp_auth"], k["rtp_salt"]
        self.rtcp_key, self.rtcp_auth, self.rtcp_salt = k["rtcp_key"], k["rtcp_auth"], k["rtcp_salt"]
        # per-SSRC transmit ROC and receive state (roc, s_l)
        self._tx_roc: Dict[int, int] = {}
        self._tx_last_seq: Dict[int, int] = {}
        self._rx: Dict[int, Tuple[int, Optional[int]]] = {}
        self._rtcp_tx_index = 0
        # RFC 3711 §3.3.2 anti-replay: per-SSRC (top 48-bit index, 64-bit
        # window bitmap) for SRTP; per-SSRC equivalent on the SRTCP index.
        self._rx_replay: Dict[int, Tuple[int, int]] = {}
        self._rtcp_rx_replay: Dict[int, Tuple[int, int]] = {}

    @staticmethod
    def _replay_stale(store: Dict[int, Tuple[int, int]], ssrc: int, index: int) -> bool:
        top, mask = store.get(ssrc, (-1, 0))
        if index > top:
            return False
        d = top - index
        return d >= 64 or bool(mask >> d & 1)

    @staticmethod
    def _replay_mark(store: Dict[int, Tuple[int, int]], ssrc: int, index: int) -> None:
        top, mask = store.get(ssrc, (-1, 0))
        if index > top:
            mask = (mask << (index - top) | 1) & (1 << 64) - 1
            top = index
        else:
            mask |= 1 << (top - index)
        store[ssrc] = (top, mask)

    # -- SRTP -----------------------------------------------------------------

    def protect(self, rtp_packet: bytes) -> bytes:
        if len(rtp_packet) < 12:
            raise SrtpError("short RTP packet")
        seq = struct.unpack("!H", rtp_packet[2:4])[0]
        ssrc = struct.unpack("!I", rtp_packet[8:12])[0]
        roc = self._tx_roc.get(ssrc, 0)
        last = self._tx_last_seq.get(ssrc)
        if last is not None and seq < last and last - seq > 0x8000:
            roc += 1
            self._tx_roc[ssrc] = roc
        self._tx_last_seq[ssrc] = seq
        index = (roc << 16) | seq
        header_len = self._header_len(rtp_packet)
        payload = rtp_packet[header_len:]
        enc = _aes_cm_xor(self.rtp_key, _rtp_iv(self.rtp_salt, ssrc, index), payload)
        authed = rtp_packet[:header_len] + enc
        tag = hmac.new(self.rtp_auth, authed + struct.pack("!I", roc), hashlib.sha1).digest()
        return authed + tag[: self.AUTH_TAG_LEN]

    def unprotect(self, srtp_packet: bytes) -> bytes:
        if len(srtp_packet) < 12 + self.AUTH_TAG_LEN:
            raise SrtpError("short SRTP packet")
        authed, tag = srtp_packet[: -self.AUTH_TAG_LEN], srtp_packet[-self.AUTH_TAG_LEN:]
        seq = struct.unpack("!H", authed[2:4])[0]
        ssrc = struct.unpack("!I", authed[8:12])[0]
        roc, index = self._estimate_index(ssrc, seq)
        if self._replay_stale(self._rx_replay, ssrc, index):
            raise SrtpError("SRTP replayed packet")
        expect = hmac.new(self.rtp_auth, authed + struct.pack("!I", roc), hashlib.sha1).digest()
        if not hmac.compare_digest(expect[: self.AUTH_TAG_LEN], tag):
            raise SrtpError("SRTP auth failure")
        self._replay_mark(self._rx_replay, ssrc, index)
        self._commit_index(ssrc, seq, roc)
        header_len = self._header_len(authed)
        payload = authed[header_len:]
        return authed[:header_len] + _aes_cm_xor(
            self.rtp_key, _rtp_iv(self.rtp_salt, ssrc, index), payload)

    def _estimate_index(self, ssrc: int, seq: int) -> Tuple[int, int]:
        """RFC 3711 §3.3.1 packet-index estimation from (roc, s_l)."""
        roc, s_l = self._rx.get(ssrc, (0, None))
        if s_l is None:
            v = roc
        elif s_l < 0x8000:
            v = roc - 1 if (seq - s_l > 0x8000 and roc > 0) else roc
        else:
            v = roc + 1 if s_l - seq > 0x8000 else roc
        return v, ((v << 16) | seq)

    def _commit_index(self, ssrc: int, seq: int, v: int) -> None:
        roc, s_l = self._rx.get(ssrc, (0, None))
        if s_l is None or v > roc:
            self._rx[ssrc] = (v, seq)
        elif v == roc and seq > s_l:
            self._rx[ssrc] = (roc, seq)

    @staticmethod
    def _header_len(pkt: bytes) -> int:
        cc = pkt[0] & 0x0F
        n = 12 + 4 * cc
        if pkt[0] & 0x10:  # extension
            if len(pkt) < n + 4:
                raise SrtpError("truncated RTP extension")
            ext_words = struct.unpack("!H", pkt[n + 2:n + 4])[0]
            n += 4 + 4 * ext_words
        return n

    # -- SRTCP ----------------------------------------------------------------

    def protect_rtcp(self, rtcp_packet: bytes) -> bytes:
        if len(rtcp_packet) < 8:
            raise SrtpError("short RTCP packet")
        ssrc = struct.unpack("!I", rtcp_packet[4:8])[0]
        self._rtcp_tx_index = (self._rtcp_tx_index + 1) & 0x7FFFFFFF
        index = self._rtcp_tx_index
        payload = rtcp_packet[8:]
        enc = rtcp_packet[:8] + _aes_cm_xor(
            self.rtcp_key, _rtp_iv(self.rtcp_salt, ssrc, index), payload)
        e_index = struct.pack("!I", 0x80000000 | index)
        tag = hmac.new(self.rtcp_auth, enc + e_index, hashlib.sha1).digest()
        return enc + e_index + tag[: self.AUTH_TAG_LEN]

    def unprotect_rtcp(self, srtcp_packet: bytes) -> bytes:
        if len(srtcp_packet) < 8 + 4 + self.AUTH_TAG_LEN:
            raise SrtpError("short SRTCP packet")
        tag = srtcp_packet[-self.AUTH_TAG_LEN:]
        e_index_raw = srtcp_packet[-self.AUTH_TAG_LEN - 4: -self.AUTH_TAG_LEN]
        enc = srtcp_packet[: -self.AUTH_TAG_LEN - 4]
        expect = hmac.new(self.rtcp_auth, enc + e_index_raw, hashlib.sha1).digest()
        if not hmac.compare_digest(expect[: self.AUTH_TAG_LEN], tag):
            raise SrtpError("SRTCP auth failure")
        e_index = struct.unpack("!I", e_index_raw)[0]
        index = e_index & 0x7FFFFFFF
        ssrc0 = struct.unpack("!I", enc[4:8])[0]
        if self._replay_stale(self._rtcp_rx_replay, ssrc0, index):
            raise SrtpError("SRTCP replayed packet")
        self._replay_mark(self._rtcp_rx_replay, ssrc0, index)
        if not e_index & 0x80000000:
            return enc  # unencrypted SRTCP
        ssrc = struct.unpack("!I", enc[4:8])[0]
        payload = enc[8:]
        return enc[:8] + _aes_cm_xor(
            self.rtcp_key, _rtp_iv(self.rtcp_salt, ssrc, index), payload)


def sessions_from_dtls(dtls) -> Tuple[SrtpSession, SrtpSession]:
    """(send, recv) SRTP sessions from a completed DTLS-SRTP handshake.

    RFC 5764 §4.2: client_write keys protect client→server traffic.
    """
    mat = dtls.export_srtp_keys()
    client = SrtpSession(mat["client_write_key"], mat["client_write_salt"])
    server = SrtpSession(mat["server_write_key"], mat["server_write_salt"])
    return (client, server) if dtls.is_client else (server, client)
