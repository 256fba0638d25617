"""Low-rank separable 3D-LUT sampling (colorlut precision=approx).

Reference math: video/colorlut/src/colorlut/imp.rs:493-526 (trilinear
8-corner interpolation).  Decompose the LUT tensor T[z,y,x,c] (size S^3 x 3)
by CP/PARAFAC:

    T[z,y,x,c] ~= sum_k  W[z,k] * V[y,k] * U[x,k] * C[c,k]

Trilinear interpolation is multilinear in each axis, so sampling the
reconstruction at continuous (x,y,z) factorizes EXACTLY:

    out(x,y,z)[c] = sum_k (hat(x)@U)_k (hat(y)@V)_k (hat(z)@W)_k C[c,k]

where hat(x) is the [S]-vector of linear-interpolation hat weights (two
nonzeros).  Because hat weights are non-negative and sum to 1, the
interpolated error is a convex combination of node errors:

    max_{continuous xyz} |exact - lowrank| = max_{grid nodes} |T - T_hat|

so validating the fit on the S^3 grid nodes bounds the error everywhere.
The fit (ALS, numpy, at LUT-load time) escalates rank until the node-space
max error clears the caller's tolerance.

The port of gst_plugins_rs_tpu/ops/colorlut_lowrank.py: the fit is the same
numpy code (same seed, so both packages fit the same factors from one .cube
file); `lut3d_apply_lowrank` is the dense form in plain PyTorch.  The
element runs the fused kernels of ops/colorlut_lowrank_fused.py instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .._device import no_tf32
from .colorlut import grid_coord, quantize
from .pixels import restack


@dataclass
class CpLut:
    """CP factors of a 3D LUT; axis factors indexed grid-node x rank."""

    U: np.ndarray  # [S, K] x-axis (R input component)
    V: np.ndarray  # [S, K] y-axis (G)
    W: np.ndarray  # [S, K] z-axis (B)
    C: np.ndarray  # [3, K] output-channel mixing
    max_node_err: float  # max |T - reconstruction| over all S^3 nodes


def _reconstruct(W, V, U, C):
    """Dense T[z,y,x,c] from factors in (axis0=z, axis1=y, axis2=x, chan)
    order — the same order cp_als returns."""
    return np.einsum("zk,yk,xk,ck->zyxc", W, V, U, C)


def _khatri_rao(mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[1])
    return out


def cp_als(
    t: np.ndarray,
    rank: int,
    iters: int = 60,
    seed: int = 0,
    tol: float = 1e-12,
    init: Optional[Tuple[np.ndarray, ...]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Alternating least squares CP fit of t [S,S,S,3] at the given rank.

    Standard 4-way ALS with khatri-rao products; f64 throughout.  The
    tensor is tiny (33^3*3 ~ 108k values), so each sweep runs in
    milliseconds.  `init` warm-starts from smaller-rank factors: existing
    columns are kept and the remaining columns are random — this is how
    fit_lowrank escalates rank without refitting from scratch.
    """
    rng = np.random.default_rng(seed)
    s = t.shape[0]
    t = t.astype(np.float64)
    mats = []
    for dim in (s, s, s, 3):
        m = rng.standard_normal((dim, rank)) * 0.3
        mats.append(m)
    if init is not None:
        for m, w in zip(mats, init):
            k = min(rank, w.shape[1])
            m[:, :k] = w[:, :k]

    # mode-n unfoldings of t with axis order (z, y, x, c)
    unfolds = [
        np.moveaxis(t, i, 0).reshape(t.shape[i], -1) for i in range(4)
    ]
    prev_err = np.inf
    for _ in range(iters):
        for n in range(4):
            others = [mats[i] for i in range(4) if i != n]
            kr = _khatri_rao(others)
            gram = np.ones((rank, rank))
            for m in others:
                gram *= m.T @ m
            sol = np.linalg.lstsq(gram, (unfolds[n] @ kr).T, rcond=None)[0]
            mats[n] = sol.T
        rec = _reconstruct(*mats)
        err = float(np.abs(rec - t).max())
        if abs(prev_err - err) < tol:
            break
        prev_err = err
    return tuple(mats)  # type: ignore[return-value]


def fit_lowrank(
    table: np.ndarray,
    size: int,
    tolerance: float,
    max_rank: int = 128,
    start_rank: int = 16,
) -> Optional[CpLut]:
    """Fit CP factors for a flat [S^3, 3] .cube table until the max node
    error <= tolerance (in the LUT's output units, typically [0,1] where a
    u8 LSB is 1/255).  Escalates rank with warm-started ALS (new columns
    fit the residual of the previous rank).  Returns None if max_rank
    doesn't reach the tolerance."""
    t = table.reshape(size, size, size, 3).astype(np.float64)
    best: Optional[CpLut] = None
    rank = min(start_rank, max_rank)
    prev: Optional[Tuple[np.ndarray, ...]] = None
    while True:
        mats = cp_als(t, rank, iters=40 if prev is None else 30,
                      init=prev)
        err = float(np.abs(_reconstruct(*mats) - t).max())
        W, V, U, C = mats
        if best is None or err < best.max_node_err:
            best = CpLut(
                U=U.astype(np.float32), V=V.astype(np.float32),
                W=W.astype(np.float32), C=C.astype(np.float32),
                max_node_err=err)
        if err <= tolerance:
            return best
        if rank >= max_rank or rank * 2 >= size * size:
            return None
        prev = mats
        rank = min(rank * 2, max_rank)


def compute_type(name: str) -> torch.dtype:
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"compute_dtype must be 'bfloat16' or 'float32', got {name!r}")
    return getattr(torch, name)


def _hat_weights(x, size: int, dtype):
    """[..., S] linear-interpolation hat weights for continuous index x in
    [0, S-1]: w_i = max(0, 1 - |x - i|).  Two nonzeros per row; exactly the
    reference's (1-t, t) lerp pair."""
    grid = torch.arange(size, dtype=torch.float32, device=x.device)
    w = torch.clamp(1.0 - torch.abs(x[..., None] - grid), min=0.0)
    return w.to(dtype)


def lut3d_apply_lowrank(
    frame,
    U, V, W, C,
    scale, offset,
    *,
    size: int,
    offsets: Tuple[int, int, int],
    bits: int,
    compute_dtype: str = "bfloat16",
):
    """Gather-free 3D LUT grade via CP factors (see module docstring), in
    the dense form: three [P,S]@[S,K] products and one [P,K]@[K,3].

    frame: [..., C] uint8/uint16; U/V/W [S,K], C [3,K].  Products take
    operands rounded to `compute_dtype` and accumulate in f32."""
    maxval = float(2**bits - 1)
    cdt = compute_type(compute_dtype)
    fi = frame.to(torch.int32)
    shp = fi.shape[:-1]

    def mm(a, b):
        return a.to(cdt).to(torch.float32) @ b.to(cdt).to(torch.float32)

    coords = [grid_coord(fi, off, scale[comp], offset[comp], size, maxval).reshape(-1)
              for comp, off in enumerate(offsets)]
    with no_tf32():
        u, v, w = (mm(_hat_weights(x, size, cdt), F)
                   for x, F in zip(coords, (U, V, W)))  # [P, K] f32 accum
        prod = (u * v * w).to(cdt)
        cc = mm(prod, C.T).reshape(shp + (3,))
    return restack(fi, offsets, [quantize(cc[..., comp], maxval) for comp in range(3)],
                   frame.dtype)


__all__ = ["CpLut", "compute_type", "cp_als", "fit_lowrank", "lut3d_apply_lowrank"]
