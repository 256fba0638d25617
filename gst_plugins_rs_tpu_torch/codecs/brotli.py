"""Brotli (RFC 7932).

Parity target: generic/compress's brotlicompress/brotlidecompress.  The
reference outsources the format to the Rust `brotli` crate
(generic/compress/Cargo.toml); here the system libbrotlienc/libbrotlidec
C libraries are bound via ctypes (the same pattern as codecs/avlib.py for
dav1d/rav1e), giving full RFC 7932 wire parity in both directions —
entropy-coded meta-blocks, context modeling, and the static dictionary.

A pure-Python fallback covering the uncompressed-meta-block subset
(ISUNCOMPRESSED=1, §9.2) keeps the elements functional if the C
libraries are ever absent: its encoder output is readable by any
conforming decoder, and its decoder raises BrotliSubsetError on
entropy-coded input.

Brotli bit order: LSB-first within each byte (§2).
"""
from __future__ import annotations

import ctypes

_DEC = None
_ENC = None
_TRIED = False


def _load_libs() -> bool:
    global _DEC, _ENC, _TRIED
    if _TRIED:
        return _DEC is not None and _ENC is not None
    _TRIED = True
    for dec_name, enc_name in (("libbrotlidec.so.1", "libbrotlienc.so.1"),
                               ("libbrotlidec.so", "libbrotlienc.so")):
        try:
            dec = ctypes.CDLL(dec_name)
            enc = ctypes.CDLL(enc_name)
        except OSError:
            continue
        enc.BrotliEncoderMaxCompressedSize.restype = ctypes.c_size_t
        enc.BrotliEncoderMaxCompressedSize.argtypes = [ctypes.c_size_t]
        enc.BrotliEncoderCompress.restype = ctypes.c_int
        enc.BrotliEncoderCompress.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p]
        dec.BrotliDecoderCreateInstance.restype = ctypes.c_void_p
        dec.BrotliDecoderCreateInstance.argtypes = [ctypes.c_void_p] * 3
        dec.BrotliDecoderDestroyInstance.argtypes = [ctypes.c_void_p]
        dec.BrotliDecoderDecompressStream.restype = ctypes.c_int
        dec.BrotliDecoderDecompressStream.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t)]
        _DEC, _ENC = dec, enc
        return True
    return False


def _c_compress(data: bytes, quality: int = 9, lgwin: int = 22) -> bytes:
    max_size = _ENC.BrotliEncoderMaxCompressedSize(len(data)) or len(data) + 1024
    out = ctypes.create_string_buffer(max_size)
    out_len = ctypes.c_size_t(max_size)
    ok = _ENC.BrotliEncoderCompress(quality, lgwin, 0, len(data), data,
                                    ctypes.byref(out_len), out)
    if not ok:
        raise ValueError("brotli encode failed")
    return out.raw[:out_len.value]


def _c_decompress(data: bytes) -> bytes:
    st = _DEC.BrotliDecoderCreateInstance(None, None, None)
    if not st:
        raise MemoryError("BrotliDecoderCreateInstance failed")
    try:
        avail_in = ctypes.c_size_t(len(data))
        next_in = ctypes.c_char_p(data)
        chunks = []
        BUF = 1 << 18
        while True:
            buf = ctypes.create_string_buffer(BUF)
            avail_out = ctypes.c_size_t(BUF)
            next_out = ctypes.c_char_p(ctypes.addressof(buf))
            res = _DEC.BrotliDecoderDecompressStream(
                st, ctypes.byref(avail_in), ctypes.byref(next_in),
                ctypes.byref(avail_out), ctypes.byref(next_out), None)
            chunks.append(buf.raw[:BUF - avail_out.value])
            if res == 1:  # SUCCESS
                return b"".join(chunks)
            if res == 3:  # NEEDS_MORE_OUTPUT
                continue
            if res == 2:  # NEEDS_MORE_INPUT: truncated stream
                raise TruncatedStream("truncated brotli stream")
            raise ValueError("corrupt brotli stream")
    finally:
        _DEC.BrotliDecoderDestroyInstance(st)


class _BitWriter:
    def __init__(self) -> None:
        self.out = bytearray()
        self._bit = 0

    def write(self, value: int, nbits: int) -> None:
        for i in range(nbits):
            if self._bit == 0:
                self.out.append(0)
            if (value >> i) & 1:
                self.out[-1] |= 1 << self._bit
            self._bit = (self._bit + 1) & 7

    def align_byte(self) -> None:
        self._bit = 0

    def raw(self, data: bytes) -> None:
        assert self._bit == 0
        self.out += data


class _BitReader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        for i in range(nbits):
            byte = self.data[self.pos >> 3]
            v |= ((byte >> (self.pos & 7)) & 1) << i
            self.pos += 1
        return v

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def raw(self, n: int) -> bytes:
        assert self.pos & 7 == 0
        start = self.pos >> 3
        self.pos += n * 8
        return self.data[start:start + n]


_MAX_BLOCK = (1 << 24) - 1  # 6 nibbles


def backend() -> str:
    """Which implementation this host runs: "libbrotli" (the system C
    libraries, full RFC 7932) or "stored-subset" (the uncompressed
    meta-block encoder and decoder of this module)."""
    return "libbrotli" if _load_libs() else "stored-subset"


def compress(data: bytes, quality: int = 9) -> bytes:
    """RFC 7932 encode via libbrotlienc; stored-block fallback without it."""
    if _load_libs():
        return _c_compress(data, quality=quality)
    return _compress_stored(data)


def decompress(data: bytes) -> bytes:
    """RFC 7932 decode via libbrotlidec; subset fallback without it."""
    if _load_libs():
        return _c_decompress(data)
    return _decompress_subset(data)


class TruncatedStream(ValueError):
    """The input ends before the stream's ISLAST block — more input may
    complete it (vs plain ValueError = structural corruption)."""


def decompress_stream(data: bytes):
    """Decode ONE brotli stream from the front of `data`; returns
    (decoded_bytes, consumed_bytes) so concatenated streams can be split.
    Raises TruncatedStream when the stream is incomplete."""
    if not _load_libs():
        # subset fallback decodes a single whole-buffer stream
        return _decompress_subset(data), len(data)
    st = _DEC.BrotliDecoderCreateInstance(None, None, None)
    if not st:
        raise MemoryError("BrotliDecoderCreateInstance failed")
    try:
        avail_in = ctypes.c_size_t(len(data))
        next_in = ctypes.c_char_p(data)
        chunks = []
        BUF = 1 << 18
        while True:
            buf = ctypes.create_string_buffer(BUF)
            avail_out = ctypes.c_size_t(BUF)
            next_out = ctypes.c_char_p(ctypes.addressof(buf))
            res = _DEC.BrotliDecoderDecompressStream(
                st, ctypes.byref(avail_in), ctypes.byref(next_in),
                ctypes.byref(avail_out), ctypes.byref(next_out), None)
            chunks.append(buf.raw[:BUF - avail_out.value])
            if res == 1:  # SUCCESS
                return b"".join(chunks), len(data) - avail_in.value
            if res == 3:  # NEEDS_MORE_OUTPUT
                continue
            if res == 2:
                raise TruncatedStream("truncated brotli stream")
            raise ValueError("corrupt brotli stream")
    finally:
        _DEC.BrotliDecoderDestroyInstance(st)


def _compress_stored(data: bytes) -> bytes:
    """Valid brotli stream of uncompressed meta-blocks (WBITS=16)."""
    w = _BitWriter()
    w.write(0, 1)  # WBITS code '0' => 16 (§9.1)
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + _MAX_BLOCK]
        pos += len(chunk)
        w.write(0, 1)  # ISLAST = 0
        mlen = len(chunk) - 1
        if mlen < (1 << 16):
            w.write(0b00, 2)  # MNIBBLES = 4
            w.write(mlen, 16)
        elif mlen < (1 << 20):
            w.write(0b01, 2)  # MNIBBLES = 5
            w.write(mlen, 20)
        else:
            w.write(0b10, 2)  # MNIBBLES = 6
            w.write(mlen, 24)
        w.write(1, 1)  # ISUNCOMPRESSED
        w.align_byte()
        w.raw(chunk)
    # final empty meta-block: ISLAST=1, ISLASTEMPTY=1
    w.write(1, 1)
    w.write(1, 1)
    return bytes(w.out)


class BrotliSubsetError(ValueError):
    pass


def _decompress_subset(data: bytes) -> bytes:
    r = _BitReader(data)
    if r.read(1) != 0:
        # multi-bit WBITS codes imply arbitrary windows; the uncompressed
        # subset always emits '0' (16). Larger windows are fine to accept:
        code = r.read(3)
        if code == 0:
            r.read(3)  # large window / 17 family — skip extension bits
    out = bytearray()
    while True:
        islast = r.read(1)
        if islast:
            if r.read(1):  # ISLASTEMPTY
                break
        mnibbles_code = r.read(2)
        if mnibbles_code == 0b11:
            # metadata meta-block (§9.2): skip
            if r.read(1) != 0:
                raise BrotliSubsetError("reserved bit set")
            msknib = r.read(2)
            skip = r.read(8 * msknib) if msknib else 0
            r.align_byte()
            r.raw(skip + 1 if msknib else 0)
            continue
        nibbles = 4 + mnibbles_code
        mlen = r.read(4 * nibbles) + 1
        if islast:
            raise BrotliSubsetError(
                "entropy-coded final block: full RFC 7932 decoding not supported "
                "(this decoder handles the uncompressed-meta-block subset)")
        if r.read(1) != 1:  # ISUNCOMPRESSED
            raise BrotliSubsetError(
                "entropy-coded meta-block: full RFC 7932 decoding not supported "
                "(this decoder handles the uncompressed-meta-block subset)")
        r.align_byte()
        out += r.raw(mlen)
    return bytes(out)
