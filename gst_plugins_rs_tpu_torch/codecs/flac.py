"""FLAC decoder (and a test-vector encoder), implemented from the format
specification.

Parity target: the claxon crate behind the reference's claxondec
(audio/claxon, claxondec/imp.rs:26).  The decoder covers the full subframe
set — CONSTANT, VERBATIM, FIXED (orders 0-4), LPC (orders 1-32) — wasted
bits, rice partitions (both 4- and 5-bit parameter variants with escape
codes), all four channel assignments (independent, left/side, right/side,
mid/side), UTF-8 frame numbers, and CRC-8/CRC-16 verification.

Frames decode through the repository's native decoder
(native/flacdec.cpp, `libgstpu_flacdec.so`) when it loads, and through the
Python reference otherwise; `native_available()` says which, and the
counters `native_frames` / `python_frames` count the frames each decoded.
The loader builds only its own target (`make -C native
libgstpu_flacdec.so`), so a machine that cannot link another native
library (libavcodec's shim) still gets the native decoder.

The encoder generates conformant streams for the tests and the card's
FLAC path: constant/verbatim/fixed subframes, an LPC subframe carrying the
fixed order-2 coefficients, and left-side or mid-side stereo.  It packs the
bit fields of a frame with numpy at once (the bytes equal a bit-at-a-time
writer's), so long 192 kHz streams encode without a loop over bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..utils import native_build


# ---------------------------------------------------------------------------
# Bit I/O
# ---------------------------------------------------------------------------
class BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits

    def read(self, n: int) -> int:
        out = 0
        try:
            for _ in range(n):
                byte = self.data[self.pos >> 3]
                out = (out << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
                self.pos += 1
        except IndexError:
            raise ValueError("truncated FLAC data") from None
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= 1 << (n - 1) else v

    def read_unary(self) -> int:
        n = 0
        while self.read(1) == 0:
            n += 1
        return n

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos >> 3


class BitWriter:
    """Big-endian bit fields, gathered as (value, width) arrays and packed
    at once by `to_bytes`.  A field wider than 64 bits must be zero (a
    unary code's run of zeros)."""

    def __init__(self) -> None:
        self._vals: List[np.ndarray] = []
        self._lens: List[np.ndarray] = []
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        self.write_fields(np.array([value], np.uint64), np.array([n], np.int64))

    def write_fields(self, vals: np.ndarray, lens: np.ndarray) -> None:
        """Many fields at once: vals[i] in lens[i] bits, in order."""
        self._vals.append(np.asarray(vals, np.uint64))
        self._lens.append(np.asarray(lens, np.int64))
        self.nbits += int(self._lens[-1].sum())

    def to_bytes(self) -> bytes:
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals)
        lens = np.concatenate(self._lens)
        starts = np.cumsum(lens) - lens
        field = np.repeat(np.arange(len(lens)), lens)
        shift = lens[field] - 1 - (np.arange(self.nbits) - starts[field])
        bits = (vals[field] >> np.minimum(shift, 63).astype(np.uint64)) & np.uint64(1)
        return np.packbits(bits.astype(np.uint8)).tobytes()  # zero-padded to a byte


# ---------------------------------------------------------------------------
# CRCs (polynomials from the FLAC spec), table-driven
# ---------------------------------------------------------------------------
def _crc_table(poly: int, width: int) -> List[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
        table.append(crc)
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc = _CRC8[crc ^ byte]
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    table = _CRC16
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ table[(crc >> 8) ^ byte]
    return crc


# ---------------------------------------------------------------------------
# Stream info
# ---------------------------------------------------------------------------
@dataclass
class StreamInfo:
    min_block: int
    max_block: int
    rate: int
    channels: int
    bps: int
    total_samples: int


FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}

_BLOCK_SIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                     256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                     8192: 13, 16384: 14, 32768: 15}
_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
               24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def _utf8_number(n: int) -> bytes:
    """FLAC's extended UTF-8 coding for frame numbers."""
    if n < 0x80:
        return bytes([n])
    out = []
    bits = n.bit_length()
    nbytes = 2
    while bits > 6 * (nbytes - 1) + (7 - nbytes):
        nbytes += 1
    lead = (0xFF << (8 - nbytes)) & 0xFF
    out.append(lead | (n >> (6 * (nbytes - 1))))
    for i in range(nbytes - 2, -1, -1):
        out.append(0x80 | ((n >> (6 * i)) & 0x3F))
    return bytes(out)


def _read_utf8_number(r: BitReader) -> int:
    first = r.read(8)
    if first < 0x80:
        return first
    nbytes = 0
    mask = 0x80
    while first & mask:
        nbytes += 1
        mask >>= 1
    n = first & (mask - 1)
    for _ in range(nbytes - 1):
        n = (n << 6) | (r.read(8) & 0x3F)
    return n


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------
def parse_header(data: bytes) -> Tuple[StreamInfo, int]:
    """(StreamInfo, offset of first frame)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    info: Optional[StreamInfo] = None
    while True:
        if pos >= len(data):
            raise ValueError("truncated FLAC metadata")
        hdr = data[pos]
        last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        size = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + size]
        if btype == 0:  # STREAMINFO
            r = BitReader(body)
            min_block = r.read(16)
            max_block = r.read(16)
            r.read(24)  # min frame size
            r.read(24)  # max frame size
            rate = r.read(20)
            channels = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
            info = StreamInfo(min_block, max_block, rate, channels, bps, total)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise ValueError("missing STREAMINFO")
    return info, pos


def _decode_residuals(r: BitReader, block_size: int, predictor_order: int) -> List[int]:
    method = r.read(2)  # 0 = 4-bit rice, 1 = 5-bit rice
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    partition_order = r.read(4)
    n_partitions = 1 << partition_order
    residuals: List[int] = []
    for part in range(n_partitions):
        count = block_size >> partition_order
        if part == 0:
            count -= predictor_order
        param = r.read(plen)
        if param == escape:
            bits = r.read(5)
            for _ in range(count):
                residuals.append(r.read_signed(bits) if bits else 0)
        else:
            for _ in range(count):
                q = r.read_unary()
                rem = r.read(param) if param else 0
                val = (q << param) | rem
                residuals.append((val >> 1) ^ -(val & 1))  # zigzag
    return residuals


def _predict(warmup: List[int], coefs: List[int], shift: int, residuals: List[int]) -> List[int]:
    out = list(warmup)
    for res in residuals:
        pred = sum(c * out[-1 - i] for i, c in enumerate(coefs))
        out.append(res + (pred >> shift))
    return out


def _decode_subframe(r: BitReader, block_size: int, bps: int) -> List[int]:
    if r.read(1):
        raise ValueError("invalid subframe padding bit")
    stype = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = 1 + r.read_unary()
        bps -= wasted
    if stype == 0:  # CONSTANT
        v = r.read_signed(bps)
        samples = [v] * block_size
    elif stype == 1:  # VERBATIM
        samples = [r.read_signed(bps) for _ in range(block_size)]
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        warmup = [r.read_signed(bps) for _ in range(order)]
        residuals = _decode_residuals(r, block_size, order)
        samples = _predict(warmup, FIXED_COEFS[order], 0, residuals)
    elif stype >= 32:  # LPC order 1-32
        order = stype - 31
        warmup = [r.read_signed(bps) for _ in range(order)]
        precision = r.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = r.read_signed(5)
        coefs = [r.read_signed(precision) for _ in range(order)]
        residuals = _decode_residuals(r, block_size, order)
        samples = _predict(warmup, coefs, shift, residuals)
    else:
        raise ValueError(f"reserved subframe type {stype}")
    if wasted:
        samples = [s << wasted for s in samples]
    return samples


_BLOCK_SIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                     8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                     13: 8192, 14: 16384, 15: 32768}
_RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
               7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# frames decoded by each decoder since import (set them to 0 to count a run)
native_frames = 0
python_frames = 0


def decode_frame(data: bytes, pos: int, info: StreamInfo) -> Tuple[np.ndarray, int]:
    """Decode one frame at byte offset pos -> ([block, channels] int32, next pos)."""
    global python_frames
    start = pos
    r = BitReader(data, pos * 8)
    sync = r.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"bad frame sync at {pos}")
    r.read(1)  # reserved
    r.read(1)  # blocking strategy
    bs_code = r.read(4)
    rate_code = r.read(4)
    ch_code = r.read(4)
    bps_code = r.read(3)
    r.read(1)  # reserved
    _frame_no = _read_utf8_number(r)
    if bs_code == 6:
        block_size = r.read(8) + 1
    elif bs_code == 7:
        block_size = r.read(16) + 1
    else:
        block_size = _BLOCK_SIZE_TABLE[bs_code]
    if rate_code == 12:
        r.read(8)
    elif rate_code in (13, 14):
        r.read(16)
    bps = _BPS_TABLE[bps_code] if bps_code else info.bps
    header_crc = r.read(8)
    if crc8(data[start : r.byte_pos() - 1]) != header_crc:
        raise ValueError("frame header CRC mismatch")

    if ch_code < 8:
        n_channels = ch_code + 1
        assignment = "independent"
    else:
        n_channels = 2
        assignment = {8: "left-side", 9: "right-side", 10: "mid-side"}[ch_code]

    channels = []
    for ch in range(n_channels):
        ch_bps = bps
        # the side channel carries one extra bit
        if (assignment == "left-side" and ch == 1) or (
            assignment == "right-side" and ch == 0
        ) or (assignment == "mid-side" and ch == 1):
            ch_bps += 1
        channels.append(_decode_subframe(r, block_size, ch_bps))
    r.align()
    frame_crc = r.read(16)
    if crc16(data[start : r.byte_pos() - 2]) != frame_crc:
        raise ValueError("frame CRC-16 mismatch")

    a = np.asarray(channels, np.int64)
    if assignment == "left-side":
        left, side = a[0], a[1]
        a = np.stack([left, left - side])
    elif assignment == "right-side":
        side, right = a[0], a[1]
        a = np.stack([right + side, right])
    elif assignment == "mid-side":
        # stored: mid = (l+r)>>1, side = l-r; the dropped LSB of l+r is
        # recoverable from side's parity
        mid, side = a[0], a[1]
        mid2 = (mid << 1) | (side & 1)
        a = np.stack([(mid2 + side) >> 1, (mid2 - side) >> 1])
    python_frames += 1
    return a.T.astype(np.int32), r.byte_pos()


# -- native fast path (native/flacdec.cpp via ctypes) ------------------------
NATIVE_DIR = native_build.NATIVE_DIR  # the loader reads it at its first call
_native_lib = None
_native_tried = False


def _native():
    global _native_lib, _native_tried
    if _native_lib is not None or _native_tried:
        return _native_lib
    _native_tried = True
    import ctypes

    # no toolchain, or no library: the pure-Python path
    lib = native_build.load(NATIVE_DIR, "FLACDEC", "libgstpu_flacdec.so")
    if lib is None:
        return None
    lib.flac_decode_frame.restype = ctypes.c_long
    lib.flac_decode_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    _native_lib = lib
    return lib


def native_available() -> bool:
    """Whether frames decode through the native decoder (built and loaded
    at the first call)."""
    return _native() is not None


def decode_frame_native(data: bytes, pos: int, info: StreamInfo
                        ) -> Optional[Tuple[np.ndarray, int]]:
    """C++ frame decode; None when the native library is unavailable.
    Raises ValueError on the same corruption classes as decode_frame."""
    global native_frames
    import ctypes

    lib = _native()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    cap = info.max_block * info.channels if info.max_block else 65536 * info.channels
    out = np.empty(max(cap, 1), np.int32)
    bs = ctypes.c_int(0)
    ch = ctypes.c_int(0)
    ret = lib.flac_decode_frame(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data), pos,
        info.bps, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size,
        ctypes.byref(bs), ctypes.byref(ch),
    )
    if ret < 0:
        raise ValueError(f"native FLAC frame decode failed at {pos} (code {ret})")
    frame = out[: bs.value * ch.value].reshape(bs.value, ch.value).copy()
    native_frames += 1
    return frame, int(ret)


def decode(data: bytes, *, native: bool = True) -> Tuple[StreamInfo, np.ndarray]:
    """Full-stream decode -> (StreamInfo, [samples, channels] int32).

    Uses the C++ frame decoder when built; pass native=False to force the
    Python reference."""
    info, pos = parse_header(data)
    use_native = native and _native() is not None
    frames = []
    total = 0
    while pos < len(data) and (info.total_samples == 0 or total < info.total_samples):
        if use_native:
            frame, pos = decode_frame_native(data, pos, info)
        else:
            frame, pos = decode_frame(data, pos, info)
        frames.append(frame)
        total += frame.shape[0]
    out = np.concatenate(frames, axis=0) if frames else np.zeros((0, info.channels), np.int32)
    if info.total_samples:
        out = out[: info.total_samples]
    return info, out


# ---------------------------------------------------------------------------
# Encoder (test-vector generator)
# ---------------------------------------------------------------------------
def _write_samples(w: BitWriter, samples: np.ndarray, bps: int) -> None:
    """Each sample's low bps bits (two's complement)."""
    s = np.asarray(samples, np.int64)
    w.write_fields((s & ((1 << bps) - 1)).astype(np.uint64), np.full(s.shape, bps, np.int64))


def _write_rice(w: BitWriter, residuals: np.ndarray, param: int) -> None:
    w.write(0, 2)  # 4-bit rice method
    w.write(0, 4)  # partition order 0
    w.write(param, 4)
    zz = (np.abs(residuals) << 1) - (residuals < 0)  # zigzag
    # per residual: the quotient in unary (its zeros, then a 1) and the
    # param-bit remainder, as two fields: zeros, then 1 << param | rem
    vals = np.zeros((len(zz), 2), np.uint64)
    vals[:, 1] = ((zz & ((1 << param) - 1)) | (1 << param)).astype(np.uint64)
    lens = np.empty((len(zz), 2), np.int64)
    lens[:, 0] = zz >> param
    lens[:, 1] = param + 1
    w.write_fields(vals.ravel(), lens.ravel())


def _encode_subframe(w: BitWriter, samples: np.ndarray, bps: int, mode: str) -> None:
    w.write(0, 1)
    if mode == "constant":
        w.write(0, 6)
        w.write(0, 1)
        _write_samples(w, samples[:1], bps)
        return
    if mode == "verbatim":
        w.write(1, 6)
        w.write(0, 1)
        _write_samples(w, samples, bps)
        return
    # order-2 predictor; "lpc" writes the same coefficients through the LPC
    # subframe type (coefs [2,-1], precision 5, shift 0) so decoders hit the
    # LPC path with bit-exact expectations
    order = 2
    if mode == "lpc":
        w.write(32 + order - 1, 6)
        w.write(0, 1)
        _write_samples(w, samples[:order], bps)
        w.write(5 - 1, 4)  # precision
        w.write(0, 5)  # shift
        for c in (2, -1):
            w.write(c & 0x1F, 5)
    else:
        w.write(8 + order, 6)
        w.write(0, 1)
        _write_samples(w, samples[:order], bps)
    s = np.asarray(samples, np.int64)
    res = s[order:] - (2 * s[order - 1:-1] - s[:-order]) if len(s) > order else s[:0]
    maxr = int(np.abs(res).max()) if len(res) else 0
    param = min(max(maxr.bit_length() - 1, 0), 14)
    _write_rice(w, res, param)


def encode(
    pcm: np.ndarray,
    rate: int = 44100,
    bps: int = 16,
    *,
    block_size: int = 4096,
    mode: str = "fixed",
    stereo_mode: str = "independent",
) -> bytes:
    """Encode [samples, channels] ints -> FLAC bytes.

    mode: constant|verbatim|fixed|lpc (per subframe); stereo_mode:
    independent|left-side|mid-side (the last two for 2-channel input)."""
    pcm = np.atleast_2d(np.asarray(pcm, np.int64))
    n, channels = pcm.shape
    out = bytearray(b"fLaC")
    si = BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(rate, 20)
    si.write(channels - 1, 3)
    si.write(bps - 1, 5)
    si.write(n, 36)
    body = si.to_bytes() + b"\x00" * 18  # md5 unset
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    use_ls = stereo_mode == "left-side" and channels == 2
    use_ms = stereo_mode == "mid-side" and channels == 2
    frame_no = 0
    for start in range(0, n, block_size):
        block = pcm[start : start + block_size]
        bs = block.shape[0]
        w = BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)
        w.write(0, 1)  # fixed blocksize strategy
        if bs in _BLOCK_SIZE_CODES:
            bs_code, bs_extra = _BLOCK_SIZE_CODES[bs], None
        else:
            bs_code, bs_extra = 7, bs - 1
        w.write(bs_code, 4)
        w.write(_RATE_CODES.get(rate, 0), 4)
        w.write(8 if use_ls else (10 if use_ms else channels - 1), 4)
        w.write(_BPS_CODES[bps], 3)
        w.write(0, 1)
        for byte in _utf8_number(frame_no):
            w.write(byte, 8)
        if bs_extra is not None:
            w.write(bs_extra, 16)
        # the header CRC covers the byte-aligned header written so far
        header = w.to_bytes()
        if use_ls:
            subframes = [(block[:, 0], bps), (block[:, 0] - block[:, 1], bps + 1)]
        elif use_ms:
            subframes = [((block[:, 0] + block[:, 1]) >> 1, bps),
                         (block[:, 0] - block[:, 1], bps + 1)]
        else:
            subframes = [(block[:, ch], bps) for ch in range(channels)]
        w = BitWriter()
        for samples, sbps in subframes:
            _encode_subframe(w, samples, sbps, mode)
        frame = header + bytes([crc8(header)]) + w.to_bytes()
        out += frame + crc16(frame).to_bytes(2, "big")
        frame_no += 1
    return bytes(out)


__all__ = ["decode", "encode", "parse_header", "decode_frame",
           "decode_frame_native", "native_available", "StreamInfo",
           "BitReader", "BitWriter", "crc8", "crc16"]
