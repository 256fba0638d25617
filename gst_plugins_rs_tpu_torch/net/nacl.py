"""NaCl crypto_box (X25519 + XSalsa20-Poly1305) — sodium wire parity.

Parity target: generic/sodium uses sodiumoxide's `box_::seal_precomputed`
(encrypter/imp.rs:29,123); this module owns the XSalsa20 construction so
sodiumencrypter/decrypter streams are byte-compatible with the reference
(validated in tests against generic/sodium/tests/encrypted_sample.enc and,
where available, the system libsodium as an oracle).

Implementation notes:
- Salsa20 core is numpy-vectorized across 64-byte blocks (one ndarray of
  round states per call — no per-block Python loop), uint32 wrapping
  arithmetic per the Salsa20 spec (Bernstein, "The Salsa20 family of
  stream ciphers").
- HSalsa20 (no final state addition; words 0,5,10,15,6..9 out) builds the
  crypto_box precomputed key from the X25519 shared secret and the
  XSalsa20 subkey from the first 16 nonce bytes (Bernstein, "Extending
  the Salsa20 nonce").
- X25519 and Poly1305 come from the `cryptography` package, as in the
  JAX package's nacl: its constant-time implementations handle the
  elements' long-term private keys and authenticate every block.
- crypto_box "easy" layout: 16-byte MAC then ciphertext.
"""
from __future__ import annotations

import numpy as np

NONCE_BYTES = 24
MAC_BYTES = 16

_SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    n = np.uint32(n)
    return (x << n) | (x >> np.uint32(32 - int(n)))


_QUARTERS_COL = ((0, 4, 8, 12), (5, 9, 13, 1), (10, 14, 2, 6), (15, 3, 7, 11))
_QUARTERS_ROW = ((0, 1, 2, 3), (5, 6, 7, 4), (10, 11, 8, 9), (15, 12, 13, 14))


def _rounds(x: np.ndarray) -> np.ndarray:
    """20 Salsa20 rounds (10 double rounds) on [n, 16] uint32 states."""
    x = x.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            for quarters in (_QUARTERS_COL, _QUARTERS_ROW):
                for (i0, i1, i2, i3) in quarters:
                    y0, y1, y2, y3 = x[:, i0], x[:, i1], x[:, i2], x[:, i3]
                    y1 ^= _rotl(y0 + y3, 7)
                    y2 ^= _rotl(y1 + y0, 9)
                    y3 ^= _rotl(y2 + y1, 13)
                    y0 ^= _rotl(y3 + y2, 18)
                    x[:, i0], x[:, i1], x[:, i2], x[:, i3] = y0, y1, y2, y3
    return x


def _words(b: bytes) -> np.ndarray:
    return np.frombuffer(b, "<u4").astype(np.uint32)


def hsalsa20(key: bytes, inp: bytes) -> bytes:
    """32-byte key, 16-byte input -> 32-byte output (no final addition)."""
    k = _words(key)
    n = _words(inp)
    state = np.empty((1, 16), np.uint32)
    state[0, 0] = _SIGMA[0]
    state[0, 1:5] = k[:4]
    state[0, 5] = _SIGMA[1]
    state[0, 6:10] = n
    state[0, 10] = _SIGMA[2]
    state[0, 11:15] = k[4:]
    state[0, 15] = _SIGMA[3]
    z = _rounds(state)[0]
    out = z[[0, 5, 10, 15, 6, 7, 8, 9]]
    return out.astype("<u4").tobytes()


def salsa20_keystream(key: bytes, nonce8: bytes, length: int,
                      counter: int = 0) -> bytes:
    """Salsa20/20 keystream: 32-byte key, 8-byte nonce, 64-bit block counter."""
    nblocks = (length + 63) // 64
    k = _words(key)
    n = _words(nonce8)
    ctr = counter + np.arange(nblocks, dtype=np.uint64)
    state = np.empty((nblocks, 16), np.uint32)
    state[:, 0] = _SIGMA[0]
    state[:, 1:5] = k[:4]
    state[:, 5] = _SIGMA[1]
    state[:, 6] = n[0]
    state[:, 7] = n[1]
    state[:, 8] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[:, 9] = (ctr >> np.uint64(32)).astype(np.uint32)
    state[:, 10] = _SIGMA[2]
    state[:, 11:15] = k[4:]
    state[:, 15] = _SIGMA[3]
    with np.errstate(over="ignore"):
        out = _rounds(state) + state
    return out.astype("<u4").tobytes()[:length]


def xsalsa20_keystream(key: bytes, nonce24: bytes, length: int) -> bytes:
    subkey = hsalsa20(key, nonce24[:16])
    return salsa20_keystream(subkey, nonce24[16:24], length)


def _xor(a: bytes, b: bytes) -> bytes:
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).tobytes()


def x25519_public_key(private32: bytes) -> bytes:
    """The public key of a 32-byte X25519 private key."""
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

    return X25519PrivateKey.from_private_bytes(private32).public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw)


def crypto_box_beforenm(private32: bytes, public32: bytes) -> bytes:
    """Precomputed crypto_box key: HSalsa20(X25519 shared secret, 0)."""
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )

    shared = X25519PrivateKey.from_private_bytes(private32).exchange(
        X25519PublicKey.from_public_bytes(public32))
    return hsalsa20(shared, b"\x00" * 16)


def secretbox_easy(message: bytes, nonce24: bytes, key: bytes) -> bytes:
    """XSalsa20-Poly1305 seal, easy layout: MAC(16) || ciphertext."""
    from cryptography.hazmat.primitives.poly1305 import Poly1305

    ks = xsalsa20_keystream(key, nonce24, 32 + len(message))
    ct = _xor(message, ks[32:])
    return Poly1305.generate_tag(ks[:32], ct) + ct


def secretbox_open_easy(boxed: bytes, nonce24: bytes, key: bytes) -> bytes:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.poly1305 import Poly1305

    if len(boxed) < MAC_BYTES:
        raise ValueError("boxed message too short")
    mac, ct = boxed[:MAC_BYTES], boxed[MAC_BYTES:]
    ks = xsalsa20_keystream(key, nonce24, 32 + len(ct))
    try:
        Poly1305.verify_tag(ks[:32], ct, mac)
    except InvalidSignature:
        raise ValueError("crypto_box MAC verification failed") from None
    return _xor(ct, ks[32:])


def increment_le(nonce: bytes) -> bytes:
    """sodium_increment / Nonce::increment_le_inplace (little-endian +1)."""
    n = int.from_bytes(nonce, "little") + 1
    return (n % (1 << (8 * len(nonce)))).to_bytes(len(nonce), "little")


__all__ = [
    "NONCE_BYTES",
    "MAC_BYTES",
    "hsalsa20",
    "salsa20_keystream",
    "xsalsa20_keystream",
    "x25519_public_key",
    "crypto_box_beforenm",
    "secretbox_easy",
    "secretbox_open_easy",
    "increment_le",
]
