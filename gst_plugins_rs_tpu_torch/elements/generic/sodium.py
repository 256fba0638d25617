"""sodiumencrypter / sodiumdecrypter: asymmetric stream encryption.

Parity target: generic/sodium (encrypter/imp.rs, decrypter/imp.rs).  The
stream format is byte-compatible with the reference: "gst-sodium10"
typefind magic, the 24-byte crypto_box stream nonce and the block size
(u32 LE) up front (lib.rs:31-38, encrypter/imp.rs:176-181), then
fixed-size crypto_box-sealed blocks (16-byte MAC + ciphertext) with the
nonce incremented little-endian per block (encrypter/imp.rs:123-124);
default block-size 32768 (encrypter/imp.rs:56).

Cipher: NaCl crypto_box (X25519 + XSalsa20-Poly1305) from net/nacl.py,
plain Python and numpy, so the elements need no crypto package.  A payload
on the device is read back to the host once and the elements emit host
numpy uint8 buffers.

Keys: 32-byte X25519 keys, passed hex-encoded via sender-key/receiver-key
(encrypter takes the sender's private + receiver's public key; decrypter
the receiver's private + sender's public key, like crypto_box).
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    Prop,
    TransformMode,
    register,
)
from ...core.payload import host_bytes
from ...net.nacl import (
    MAC_BYTES,
    NONCE_BYTES,
    crypto_box_beforenm,
    secretbox_easy,
    secretbox_open_easy,
    x25519_public_key,
)

MAGIC = b"gst-sodium10"  # 12 bytes (reference lib.rs:31)
NONCE_SIZE = NONCE_BYTES  # 24
HEADERS_SIZE = len(MAGIC) + NONCE_SIZE + 4
TAG_SIZE = MAC_BYTES
ENC_CAPS = Caps.builder("application/x-sodium-encrypted")


class _BoxCipher:
    """crypto_box with the precomputed key (seal_precomputed analog)."""

    def __init__(self, priv_hex: str, pub_hex: str):
        self.key = crypto_box_beforenm(bytes.fromhex(priv_hex),
                                       bytes.fromhex(pub_hex))

    def encrypt(self, nonce: bytes, message: bytes, _aad=None) -> bytes:
        return secretbox_easy(message, nonce, self.key)

    def decrypt(self, nonce: bytes, boxed: bytes, _aad=None) -> bytes:
        return secretbox_open_easy(boxed, nonce, self.key)


def _shared_cipher(priv_hex: str, pub_hex: str) -> _BoxCipher:
    return _BoxCipher(priv_hex, pub_hex)


def generate_keypair():
    """(private_hex, public_hex) convenience for tests/tools."""
    import os

    priv_bytes = os.urandom(32)
    return priv_bytes.hex(), x25519_public_key(priv_bytes).hex()


def _nonce_at(base: bytes, counter: int) -> bytes:
    """Little-endian increment of the stream nonce, like
    nonce.increment_le_inplace() per block (encrypter/imp.rs:124)."""
    n = int.from_bytes(base, "little") + counter
    return (n % (1 << (8 * NONCE_SIZE))).to_bytes(NONCE_SIZE, "little")


@register
class SodiumEncrypter(BaseTransform):
    ELEMENT_NAME = "sodiumencrypter"
    ELEMENT_CLASS = "Generic/Filter"
    ELEMENT_DESCRIPTION = "Encrypts a stream (X25519 + ChaCha20-Poly1305 blocks)"
    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = ENC_CAPS
    PROPERTIES = [
        Prop("sender-key", None, type="str", doc="sender X25519 private key (hex)"),
        Prop("receiver-key", None, type="str", doc="receiver X25519 public key (hex)"),
        Prop("block-size", 32768, type="uint", minimum=1024, maximum=1 << 22),
        Prop("nonce", None, type="str", doc="hex stream nonce ('' = random); "
             "the reference's GST_SODIUM_ENCRYPT_NONCE test hook analog"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._cipher = None
        self._nonce = b""
        self._counter = 0
        self._acc = bytearray()
        self._wrote_headers = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        import os

        self._cipher = _shared_cipher(
            self.get_property("sender-key"), self.get_property("receiver-key")
        )
        nonce_hex = self.get_property("nonce")
        self._nonce = bytes.fromhex(nonce_hex) if nonce_hex else os.urandom(NONCE_SIZE)
        self._counter = 0
        self._acc = bytearray()
        self._wrote_headers = False

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (ENC_CAPS if direction == PadDirection.SINK else Caps.new_any()).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _encrypt_block(self, block: bytes) -> bytes:
        ct = self._cipher.encrypt(_nonce_at(self._nonce, self._counter), block, None)
        self._counter += 1
        return ct

    def _emit(self, final: bool) -> Optional[bytes]:
        out = bytearray()
        if not self._wrote_headers:
            self._wrote_headers = True
            out += MAGIC + self._nonce + struct.pack("<I", self.get_property("block-size"))
        bs = self.get_property("block-size")
        while len(self._acc) >= bs:
            out += self._encrypt_block(bytes(self._acc[:bs]))
            del self._acc[:bs]
        if final and self._acc:
            out += self._encrypt_block(bytes(self._acc))
            self._acc.clear()
        return bytes(out) if out else None

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        d = inbuf.data
        self._acc += d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
        data = self._emit(final=False)
        return Buffer(np.frombuffer(data, np.uint8)) if data else None

    def drain(self) -> Optional[Buffer]:
        data = self._emit(final=True)
        return Buffer(np.frombuffer(data, np.uint8)) if data else None


@register
class SodiumDecrypter(BaseTransform):
    ELEMENT_NAME = "sodiumdecrypter"
    ELEMENT_CLASS = "Generic/Filter"
    ELEMENT_DESCRIPTION = "Decrypts a sodiumencrypter stream"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = ENC_CAPS
    PROPERTIES = [
        Prop("sender-key", None, type="str", doc="sender X25519 public key (hex)"),
        Prop("receiver-key", None, type="str", doc="receiver X25519 private key (hex)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._cipher = None
        self._acc = bytearray()
        self._nonce = b""
        self._block_size = 0
        self._counter = 0
        self._headers_read = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._cipher = _shared_cipher(
            self.get_property("receiver-key"), self.get_property("sender-key")
        )
        self._acc = bytearray()
        self._headers_read = False
        self._counter = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        # payload caps are unknowable here (downstream typefind's job in the
        # reference); expose a byte stream
        out = (
            Caps.builder("application/octet-stream")
            if direction == PadDirection.SINK
            else ENC_CAPS
        ).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _decrypt_block(self, block: bytes) -> bytes:
        pt = self._cipher.decrypt(_nonce_at(self._nonce, self._counter), block, None)
        self._counter += 1
        return pt

    def _drain_blocks(self, final: bool) -> Optional[bytes]:
        if not self._headers_read:
            if len(self._acc) < HEADERS_SIZE:
                return None
            if bytes(self._acc[: len(MAGIC)]) != MAGIC:
                raise ValueError("not a gstpu-sodium stream (bad magic)")
            self._nonce = bytes(self._acc[len(MAGIC) : len(MAGIC) + NONCE_SIZE])
            (self._block_size,) = struct.unpack_from("<I", self._acc, len(MAGIC) + NONCE_SIZE)
            del self._acc[:HEADERS_SIZE]
            self._headers_read = True
        out = bytearray()
        enc_bs = self._block_size + TAG_SIZE
        while len(self._acc) >= enc_bs:
            out += self._decrypt_block(bytes(self._acc[:enc_bs]))
            del self._acc[:enc_bs]
        if final and self._acc:
            out += self._decrypt_block(bytes(self._acc))
            self._acc.clear()
        return bytes(out) if out else None

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        self._acc += host_bytes(inbuf.data, np.uint8)
        data = self._drain_blocks(final=False)
        return Buffer(np.frombuffer(data, np.uint8)) if data else None

    def drain(self) -> Optional[Buffer]:
        data = self._drain_blocks(final=True)
        return Buffer(np.frombuffer(data, np.uint8)) if data else None


__all__ = ["SodiumEncrypter", "SodiumDecrypter", "generate_keypair"]
