"""Systematic fountain FEC over GF(256) for RTP repair streams.

Functional equivalent of the raptorq crate behind the reference's
raptorqenc/raptorqdec (net/raptorq, RFC 6330 + RFC 6681 FECFRAME): from K
source symbols produce R repair symbols such that ANY K of the K+R
received symbols reconstruct the block.

Divergence (documented): RFC 6330's precomputed systematic tables are
replaced by a seeded random-linear code over the same GF(256) — identical
recovery property and overhead, not wire-compatible with RFC 6330
decoders.  Why gated rather than implemented: RFC 6330 wire parity
requires the spec's literal constant tables — V0..V3 (4x256 random 32-bit
words, §5.6) and the systematic index table J(K') (477 rows, §5.8 Table
2).  Like trained model weights, these are published data, not derivable
math: J(K') came from an unspecified offline search and V0..V3 are
arbitrary constants.  Neither the zero-egress environment nor the
reference checkout carries them (the reference pulls the external
`raptorq` crate at build time, net/raptorq/Cargo.toml:15).  If the tables
ever land in-repo, only `_coefficients` and the symbol-id mapping below
need swapping for the §5.3 Tuple/LTEnc generators.

Encoding is vectorized numpy (table-driven GF multiply); decoding is
Gaussian elimination over GF(256).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

# GF(256) with the RFC 6330 polynomial x^8+x^4+x^3+x^2+1 (0x11D)
_EXP = np.zeros(512, np.uint8)
_LOG = np.zeros(256, np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
_EXP[255:510] = _EXP[:255]


def gf_mul_vec(c: int, v: np.ndarray) -> np.ndarray:
    """Scalar*vector over GF(256)."""
    if c == 0:
        return np.zeros_like(v)
    if c == 1:
        return v.copy()
    lc = _LOG[c]
    out = np.zeros_like(v)
    nz = v != 0
    out[nz] = _EXP[lc + _LOG[v[nz]]]
    return out


def _coefficients(seed: int, row: int, k: int) -> np.ndarray:
    rng = np.random.default_rng((seed * 0x9E3779B1 + row) & 0xFFFFFFFF)
    # ensure at least one nonzero coefficient
    while True:
        c = rng.integers(0, 256, k, dtype=np.uint8)
        if c.any():
            return c


def encode_repair(source: Sequence[bytes], n_repair: int, seed: int) -> List[bytes]:
    """source: K equal-length symbols -> R repair symbols."""
    k = len(source)
    mat = np.stack([np.frombuffer(s, np.uint8) for s in source])
    out = []
    for r in range(n_repair):
        coef = _coefficients(seed, r, k)
        acc = np.zeros(mat.shape[1], np.uint8)
        for j in range(k):
            acc ^= gf_mul_vec(int(coef[j]), mat[j])
        out.append(acc.tobytes())
    return out


def decode_block(
    k: int,
    symbol_len: int,
    source: Dict[int, bytes],
    repair: Dict[int, bytes],
    seed: int,
) -> Optional[List[bytes]]:
    """Recover all K source symbols from any >=K received symbols.

    source: {index: data}, repair: {repair row: data}.  Returns None when
    underdetermined."""
    if len(source) >= k:
        return [source[i] for i in range(k)]
    if len(source) + len(repair) < k:
        return None
    rows: List[np.ndarray] = []
    rhs: List[np.ndarray] = []
    for idx, data in source.items():
        row = np.zeros(k, np.uint8)
        row[idx] = 1
        rows.append(row)
        rhs.append(np.frombuffer(data, np.uint8).copy())
    for ridx, data in repair.items():
        rows.append(_coefficients(seed, ridx, k))
        rhs.append(np.frombuffer(data, np.uint8).copy())
    a = np.stack(rows)  # [n, k]
    b = np.stack(rhs)  # [n, L]
    n = a.shape[0]
    # Gaussian elimination over GF(256)
    piv_row = 0
    for col in range(k):
        sel = None
        for r in range(piv_row, n):
            if a[r, col]:
                sel = r
                break
        if sel is None:
            return None
        a[[piv_row, sel]] = a[[sel, piv_row]]
        b[[piv_row, sel]] = b[[sel, piv_row]]
        inv = _EXP[255 - _LOG[a[piv_row, col]]]
        a[piv_row] = gf_mul_vec(int(inv), a[piv_row])
        b[piv_row] = gf_mul_vec(int(inv), b[piv_row])
        for r in range(n):
            if r != piv_row and a[r, col]:
                c = int(a[r, col])
                a[r] ^= gf_mul_vec(c, a[piv_row])
                b[r] ^= gf_mul_vec(c, b[piv_row])
        piv_row += 1
        if piv_row == k:
            break
    return [b[i].tobytes() for i in range(k)]


__all__ = ["encode_repair", "decode_block", "gf_mul_vec"]
