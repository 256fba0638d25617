"""QR code encode/decode (ISO/IEC 18004 subset) for the validate action.

Parity target: utils/validate's check-last-frame-qrcode action
(utils/validate/src/check_last_frame_qrcode.rs) uses image QR detection;
this module owns both directions:

- encode(text): byte-mode QR, versions 1-4, EC level L, mask chosen by
  the standard penalty rules, Reed-Solomon EC over GF(256) poly 0x11D
- decode(image): scans a clean, axis-aligned frame for the three finder
  patterns, derives the module grid, reads + unmasks format info and
  data, verifies the RS syndromes (clean-frame decoder: corrupted
  codewords are reported, not corrected — rendered test frames are
  noise-free)

Both directions interoperate with standard tooling (the encoder follows
the spec bit-for-bit); tests round-trip encode->rasterize->decode.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# GF(256) with the QR polynomial x^8+x^4+x^3+x^2+1 (0x11D)
_EXP = [0] * 512
_LOG = [0] * 256
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return _EXP[_LOG[a] + _LOG[b]]


def _rs_generator(n: int) -> List[int]:
    g = [1]
    for i in range(n):
        g2 = [0] * (len(g) + 1)
        for j, c in enumerate(g):
            g2[j] ^= _gf_mul(c, _EXP[i])
            g2[j + 1] ^= c
        g = g2
    return g


def _rs_encode(data: List[int], n_ec: int) -> List[int]:
    gen = _rs_generator(n_ec)[::-1]  # descending: gen[0] = 1 (leading term)
    rem = [0] * n_ec
    for d in data:
        factor = d ^ rem[0]
        rem = rem[1:] + [0]
        for j in range(n_ec):
            rem[j] ^= _gf_mul(gen[j + 1], factor) if factor else 0
    return rem


def _rs_syndromes_ok(codewords: List[int], n_ec: int) -> bool:
    for i in range(n_ec):
        s = 0
        for c in codewords:
            s = _gf_mul(s, _EXP[i]) ^ c
        if s != 0:
            return False
    return True


# version -> (total codewords, ec codewords, data codewords) at level L
_VERSIONS = {1: (26, 7, 19), 2: (44, 10, 34), 3: (70, 15, 55), 4: (100, 20, 80)}
_ALIGN_CENTER = {2: 18, 3: 22, 4: 26}  # single alignment pattern position


def _size(version: int) -> int:
    return 17 + 4 * version


def _function_mask(version: int) -> np.ndarray:
    """True where modules are function patterns (not data)."""
    n = _size(version)
    f = np.zeros((n, n), bool)
    for r, c in ((0, 0), (0, n - 7), (n - 7, 0)):
        f[max(r - 1, 0):r + 8, max(c - 1, 0):c + 8] = True
    f[6, :] = True
    f[:, 6] = True
    f[8, :9] = True      # format info areas
    f[:9, 8] = True
    f[n - 8:, 8] = True
    f[8, n - 8:] = True
    if version in _ALIGN_CENTER:
        a = _ALIGN_CENTER[version]
        f[a - 2:a + 3, a - 2:a + 3] = True
    return f


def _place_function_patterns(m: np.ndarray, version: int) -> None:
    n = m.shape[0]

    def finder(r, c):
        for i in range(7):
            for j in range(7):
                ring = max(abs(i - 3), abs(j - 3))
                m[r + i, c + j] = ring != 2 and not (ring == 3 and False)
                m[r + i, c + j] = 1 if ring in (0, 1, 3) else 0
        # correct pattern: solid 3x3 center, white ring, black border
        for i in range(7):
            for j in range(7):
                ring = max(abs(i - 3), abs(j - 3))
                m[r + i, c + j] = 1 if ring != 2 else 0

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    for i in range(8, n - 8):
        m[6, i] = m[i, 6] = (i % 2 == 0)
    m[n - 8, 8] = 1  # dark module
    if version in _ALIGN_CENTER:
        a = _ALIGN_CENTER[version]
        for i in range(-2, 3):
            for j in range(-2, 3):
                ring = max(abs(i), abs(j))
                m[a + i, a + j] = 1 if ring != 1 else 0


_MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _format_bits(mask: int, ecl_bits: int = 0b01) -> int:
    """15-bit format info (EC level L = 0b01) with BCH(15,5)."""
    data = (ecl_bits << 3) | mask
    rem = data << 10
    g = 0b10100110111
    for i in range(14, 9, -1):
        if rem & (1 << i):
            rem ^= g << (i - 10)
    return ((data << 10) | rem) ^ 0b101010000010010


def _place_format(m: np.ndarray, bits: int) -> None:
    n = m.shape[0]
    vals = [(bits >> (14 - i)) & 1 for i in range(15)]
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
                (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    for (r, c), v in zip(coords_a, vals):
        m[r, c] = v
    coords_b = [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
                (n - 6, 8), (n - 7, 8), (8, n - 8), (8, n - 7), (8, n - 6),
                (8, n - 5), (8, n - 4), (8, n - 3), (8, n - 2), (8, n - 1)]
    for (r, c), v in zip(coords_b, vals):
        m[r, c] = v


def _data_coords(version: int) -> List[Tuple[int, int]]:
    n = _size(version)
    f = _function_mask(version)
    coords = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not f[r, c]:
                    coords.append((r, c))
        upward = not upward
        col -= 2
    return coords


def _build_codewords(text: bytes, version: int) -> List[int]:
    total, n_ec, n_data = _VERSIONS[version]
    bits = []

    def push(value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            bits.append((value >> i) & 1)

    push(0b0100, 4)  # byte mode
    push(len(text), 8)
    for b in text:
        push(b, 8)
    push(0, min(4, n_data * 8 - len(bits)))  # terminator
    while len(bits) % 8:
        bits.append(0)
    data = [sum(bit << (7 - i) for i, bit in enumerate(bits[k:k + 8]))
            for k in range(0, len(bits), 8)]
    pad = [0xEC, 0x11]
    i = 0
    while len(data) < n_data:
        data.append(pad[i % 2])
        i += 1
    return data + _rs_encode(data, n_ec)


def encode(text, version: Optional[int] = None) -> np.ndarray:
    """Byte-mode QR at EC level L; returns a [n, n] uint8 matrix (1 = dark)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    if version is None:
        for v, (_, _, n_data) in sorted(_VERSIONS.items()):
            if len(text) + 3 <= n_data:
                version = v
                break
        else:
            raise ValueError(f"text too long for versions 1-4 ({len(text)} bytes)")
    codewords = _build_codewords(text, version)
    n = _size(version)
    coords = _data_coords(version)
    base = np.zeros((n, n), np.uint8)
    _place_function_patterns(base, version)

    bitstream = []
    for cw in codewords:
        for i in range(7, -1, -1):
            bitstream.append((cw >> i) & 1)
    while len(bitstream) < len(coords):
        bitstream.append(0)

    best = None
    for mask in range(8):
        m = base.copy()
        fn = _MASKS[mask]
        for (r, c), bit in zip(coords, bitstream):
            m[r, c] = bit ^ (1 if fn(r, c) else 0)
        _place_format(m, _format_bits(mask))
        score = _penalty(m)
        if best is None or score < best[0]:
            best = (score, m)
    return best[1]


def _penalty(m: np.ndarray) -> int:
    n = m.shape[0]
    score = 0
    for arr in (m, m.T):
        for row in arr:
            run = 1
            for i in range(1, n):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + run - 5
                    run = 1
            if run >= 5:
                score += 3 + run - 5
    dark = int(m.sum())
    k = abs(dark * 100 // (n * n) - 50) // 5
    score += k * 10
    return score


# ---------------------------------------------------------------------------
# decode


def _find_modules(img: np.ndarray) -> Optional[Tuple[int, int, float, int]]:
    """Locate an axis-aligned QR: returns (row0, col0, module_px, n_modules)."""
    dark = img < 128
    rows = np.where(dark.any(axis=1))[0]
    cols = np.where(dark.any(axis=0))[0]
    if rows.size == 0:
        return None
    r0, r1 = rows[0], rows[-1]
    c0, c1 = cols[0], cols[-1]
    # finder pattern is 7 modules: measure its run length at the top-left
    row = dark[r0]
    start = np.where(row)[0][0]
    run = 0
    while start + run < img.shape[1] and row[start + run]:
        run += 1
    module = run / 7.0
    if module <= 0:
        return None
    n = int(round((c1 - c0 + 1) / module))
    if n < 21:
        return None
    return r0, c0, module, n


def decode(img: np.ndarray) -> str:
    """Decodes a clean, axis-aligned QR image (grayscale or RGB array)."""
    if img.ndim == 3:
        img = img[..., :3].mean(axis=2)
    img = np.asarray(img, np.float32)
    found = _find_modules(img)
    if found is None:
        raise ValueError("no QR code found")
    r0, c0, module, n = found
    version = (n - 17) // 4
    if version not in _VERSIONS:
        raise ValueError(f"unsupported QR size {n}")
    # sample module centers
    m = np.zeros((n, n), np.uint8)
    for r in range(n):
        for c in range(n):
            y = int(r0 + (r + 0.5) * module)
            x = int(c0 + (c + 0.5) * module)
            m[r, c] = 1 if img[y, x] < 128 else 0
    # format info (copy A at (8, x)/(y, 8))
    coords_a = [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
                (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]
    bits = 0
    for r, c in coords_a:
        bits = (bits << 1) | int(m[r, c])
    bits ^= 0b101010000010010
    mask = (bits >> 10) & 0x7
    fn = _MASKS[mask]
    coords = _data_coords(version)
    stream = [int(m[r, c]) ^ (1 if fn(r, c) else 0) for r, c in coords]
    total, n_ec, n_data = _VERSIONS[version]
    codewords = [sum(bit << (7 - i) for i, bit in enumerate(stream[k:k + 8]))
                 for k in range(0, total * 8, 8)]
    if not _rs_syndromes_ok(codewords, n_ec):
        raise ValueError("QR RS check failed (noisy frame?)")
    data = codewords[:n_data]
    # byte mode header
    bitpos = 0

    def take(nbits):
        nonlocal bitpos
        v = 0
        for _ in range(nbits):
            v = (v << 1) | ((data[bitpos // 8] >> (7 - bitpos % 8)) & 1)
            bitpos += 1
        return v

    mode = take(4)
    if mode != 0b0100:
        raise ValueError(f"unsupported QR mode {mode:#x}")
    count = take(8)
    return bytes(take(8) for _ in range(count)).decode("utf-8")


def rasterize(matrix: np.ndarray, module_px: int = 8, quiet: int = 4) -> np.ndarray:
    """[n,n] matrix -> grayscale image with quiet zone (0=dark, 255=light)."""
    n = matrix.shape[0]
    img = np.full(((n + 2 * quiet) * module_px,) * 2, 255, np.uint8)
    for r in range(n):
        for c in range(n):
            if matrix[r, c]:
                y = (quiet + r) * module_px
                x = (quiet + c) * module_px
                img[y:y + module_px, x:x + module_px] = 0
    return img
