"""Sequence parallelism: one long stream's time axis sharded over a mesh.

The port of gst_plugins_rs_tpu/parallel/timeshard.py (SURVEY.md sections
2.3 and 5: the reference's "long context" is unbounded streaming time; the
device scale-out for one very long stream shards the time axis and
exchanges halos for the window overlaps).  Mesh, sharded values and
collectives are parallel/mesh.py's: every function takes a signal as one
tensor (sharded here) or as its per-shard parts, and returns what the JAX
function returns sharded as a list of parts (`mesh.gather` joins them).

- `sharded_fir`: a causal FIR whose shards fetch the previous shard's
  (taps - 1)-sample tail by ppermute: the unsharded convolution.
- `_shard_biquad`: an exact biquad over time shards.  Two local blocked-IIR
  passes (ops/ebur128.py::biquad_apply) bracket an all_gather of the
  shards' exit states; the true entry state of shard k is rebuilt from
  host-precomputed float64 powers of the state matrix (linearity of the
  recurrence).  The 2x2 products run as explicit elementwise sums in the
  signal's dtype (no TF32 path), where the JAX package asks for
  Precision.HIGHEST.
- `sharded_kweight_frame_analysis`: the input analysis of a chunk of the
  streaming loudnorm (phase A; ops/loudnorm.py::inner_frames_scan_pre runs
  phase B).
- `sharded_loudnorm_linear`: whole-stream linear normalisation, with a
  3-energy ppermute halo for the 400 ms gating overlap (an all_gather when a
  shard holds fewer than 3 subblocks), a psum of the gating histograms and a
  pmax of the sample peak.
- `sharded_block_loudness`: per-100 ms energies of one long mono stream.

A shard's biquad runs over pieces of at most `_PIECE` samples, the filter
state handed from piece to piece: the closed form of biquad_apply builds a
block-triangular matrix of ~(2 L / 500)^2 entries for L samples, which a
shard of a minute at 192 kHz could not hold.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import no_tf32
from .mesh import Mesh, all_gather, pmax, ppermute, psum, replicate, shard

_PIECE = 192_000  # samples a biquad_apply call (1 s at 192 kHz, 10 subblocks)


def _parts(x, mesh: Mesh) -> List[torch.Tensor]:
    return list(x) if isinstance(x, (list, tuple)) else shard(x, mesh)


def _next_perm(S: int):
    return [(i, (i + 1) % S) for i in range(S)]


def sharded_fir(x, h, mesh: Mesh, axis: str = "time"):
    """Causal FIR of a time-sharded signal with a halo exchange.

    x: [N] (N divisible by the mesh size) or its parts, h: [T] taps.
    Returns the parts of y[n] = sum_k h[k] * x[n-k] (zeros before the
    stream start)."""
    T = int(h.shape[0])
    S = mesh.shape[axis]
    parts = _parts(x, mesh)
    tails = [p[p.shape[0] - (T - 1):] if T > 1 else p[:0] for p in parts]
    halos = ppermute(tails, _next_perm(S))
    taps = replicate(h.flip(0)[None, None], mesh)
    out = []
    with no_tf32():
        for k, (p, halo, w) in enumerate(zip(parts, halos, taps)):
            ext = torch.cat([torch.zeros_like(halo) if k == 0 else halo, p])
            out.append(F.conv1d(ext[None, None], w)[0, 0])
    return out


def _entry_powers(a, L: int, n_shards: int) -> np.ndarray:
    """Host-precomputed A^(L*k) for k in [0, S) (f64), A the biquad's state
    matrix: the entry-state propagation matrices of a chunk that continues
    a longer stream."""
    _, a1, a2 = np.asarray(a, np.float64)
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    AL = np.linalg.matrix_power(A, L)
    pows = [np.eye(2)]
    for _ in range(n_shards - 1):
        pows.append(AL @ pows[-1])
    return np.stack(pows)


def _entry_state_weights(a, L: int, n_shards: int) -> np.ndarray:
    """Host-precomputed W[k, j] = A^(L*(k-1-j)) for j < k, else 0 (f64)."""
    pows = _entry_powers(a, L, n_shards)
    W = np.zeros((n_shards, n_shards, 2, 2))
    for k in range(n_shards):
        for j in range(k):
            W[k, j] = pows[k - 1 - j]
    return W


_ENTRY_MATS = {}


def _entry_mats(a, L: int, n_shards: int, dtype, dev):
    """(W [S, S, 2, 2], powers [S, 2, 2]) of `_entry_state_weights` and
    `_entry_powers` as tensors of dtype on dev, cached (a streaming chunk
    asks for the same ones every time)."""
    a = np.asarray(a, np.float64)
    key = (a.tobytes(), L, n_shards, dtype, str(dev))
    hit = _ENTRY_MATS.get(key)
    if hit is None:
        hit = tuple(torch.as_tensor(m, dtype=dtype).to(dev)
                    for m in (_entry_state_weights(a, L, n_shards),
                              _entry_powers(a, L, n_shards)))
        _ENTRY_MATS[key] = hit
    return hit


def _biquad(x, b, a, zi):
    """ops/ebur128.py::biquad_apply in the K-weighting's rotation basis
    (as `k_filter_apply` runs it), over pieces of at most _PIECE samples."""
    from ..ops.ebur128 import biquad_apply

    if x.shape[0] <= _PIECE:
        return biquad_apply(x, b, a, zi, rotation=True)
    ys = []
    for i in range(0, x.shape[0], _PIECE):
        y, zi = biquad_apply(x[i:i + _PIECE], b, a, zi, rotation=True)
        ys.append(y)
    return torch.cat(ys), zi


def _matvec(M, v):
    """M [2, 2] @ v [2, ch] as elementwise products and sums."""
    return (M[:, :, None] * v[None, :, :]).sum(1)


def _shard_biquad(parts, b, a, s0: Optional[list] = None):
    """An exact biquad over the shards of a time-sharded signal, L samples a
    shard.

    Pass 1 filters every shard from a zero state; the all_gather shares the
    exit states ([S, 2, ch]); shard k's entry state is sum_j W[k, j] @
    exit_j (W[k, j] = A^(L*(k-1-j)) for j < k), plus A^(L*k) @ s0 when the
    chunk continues a stream whose state s0 [2, ch] (one a shard) was
    carried.  Pass 2 filters with the true entry state.  Returns (the
    output parts, the pass-2 exit states, one a shard: the last shard's is
    the chunk's exit state)."""
    S, L = len(parts), int(parts[0].shape[0])
    first = [_biquad(p, b, a, p.new_zeros((2,) + tuple(p.shape[1:])))[1] for p in parts]
    gathered = all_gather(first)
    entries = []
    for k, (p, g) in enumerate(zip(parts, gathered)):
        W, powers = _entry_mats(a, L, S, p.dtype, p.device)
        s_in = (W[k][:, :, :, None] * g[:, None, :, :]).sum((0, 2))
        if s0 is not None:
            s_in = s_in + _matvec(powers[k], s0[k])
        entries.append(s_in)
    done = [_biquad(p, b, a, s) for p, s in zip(parts, entries)]
    return [d[0] for d in done], [d[1] for d in done]


def _weighted_energies(ys, weights, n100: int):
    """Per-subblock sums of the channel-weighted squares, one a shard."""
    return [((y * y) @ w).reshape(-1, n100).sum(1) for y, w in zip(ys, weights)]


def sharded_kweight_frame_analysis(x, filt_z0, params, mesh: Mesh, n_frames: int,
                                   axis: str = "time"):
    """Phase A of the time-sharded streaming loudnorm: the input analysis of
    one chunk of `n_frames` 100 ms frames, parallel across the mesh.

    The gain chain itself cannot be sharded without changing the output:
    frame i's limiter output feeds r128_out, whose loudness feeds frame
    i+1's delta (imp.rs:526-608).  What is parallel is what the chain reads
    of the input: the K-weighting cascade (exact, continuing the carried
    filter state `filt_z0` through A^(L*k)), the per-frame K-weighted energy
    sums and the per-frame sample peaks.  Phase B
    (ops/loudnorm.py::inner_frames_scan_pre) runs the rest.

    x: [n_frames * FRAME, ch] (or its parts) with n_frames divisible by the
    mesh size; filt_z0: [2, 2, ch].  Returns (energies parts [n_frames / S],
    peaks parts [n_frames / S, ch], the exit filter state [2, 2, ch] on the
    last shard's device)."""
    rp = params.r128
    n100 = rp.n100
    S = mesh.shape[axis]
    N = sum(int(p.shape[0]) for p in x) if isinstance(x, (list, tuple)) else int(x.shape[0])
    if n_frames % S or N != n_frames * n100:
        raise ValueError(f"chunk of {n_frames} frames not shardable over {S}")
    parts = _parts(x, mesh)
    z0 = replicate(filt_z0, mesh)
    y1, z1 = _shard_biquad(parts, rp.coeffs_b[0], rp.coeffs_a[0], s0=[z[0] for z in z0])
    y2, z2 = _shard_biquad(y1, rp.coeffs_b[1], rp.coeffs_a[1], s0=[z[1] for z in z0])
    e = _weighted_energies(y2, replicate(rp.weights, mesh), n100)
    sp = [p.abs().reshape(-1, n100, p.shape[-1]).amax(1) for p in parts]
    return e, sp, torch.stack([z1[-1], z2[-1]])


def sharded_loudnorm_linear(x, params, mesh: Mesh, n_valid_sb: int, axis: str = "time"):
    """Whole-stream linear loudness normalisation, time-sharded over a mesh.

    Every stage maps to the collective it needs: the K-weighting cascade to
    the exact sharded biquad (an all_gather of exit states); the 400 ms
    gating blocks (75 % overlap) to a ppermute of each shard's last three
    100 ms energies to the next shard (an all_gather of the whole energy
    sequence when shards hold fewer than 3 subblocks); the gating histogram
    to a psum; the sample peak to a masked local maximum and a pmax; the
    gain to a product on every shard.

    Semantics: the audioloudnorm LINEAR frame type (imp.rs:323-366,
    781-816): one gain to the target unless the scaled sample peak would
    exceed max-true-peak; ops/loudnorm.py::linear_gain_from_global.

    x: [Npad, ch] (or its parts), zero-padded so that Npad % (mesh size *
    n100) == 0.  n_valid_sb: the measured 100 ms subblocks (padded and
    partial subblocks are left out of the histogram and the peak).  Returns
    (y parts, gain, loudness), the last two 0-d tensors on shard 0."""
    from ..ops.ebur128 import HIST_BINS, _hist_index, gated_loudness

    rp = params.r128
    n100 = rp.n100
    S = mesh.shape[axis]
    Npad = sum(int(p.shape[0]) for p in x) if isinstance(x, (list, tuple)) else int(x.shape[0])
    if Npad % (S * n100):
        raise ValueError(f"Npad={Npad} not a multiple of mesh*{n100}")
    parts = _parts(x, mesh)
    L = Npad // S
    B = L // n100
    y1, _ = _shard_biquad(parts, rp.coeffs_b[0], rp.coeffs_a[0])
    y2, _ = _shard_biquad(y1, rp.coeffs_b[1], rp.coeffs_a[1])
    e = _weighted_energies(y2, replicate(rp.weights, mesh), n100)
    g_idx = [k * B + torch.arange(B, device=p.device) for k, p in enumerate(parts)]
    if B >= 3:
        halos = ppermute([ek[-3:] for ek in e], _next_perm(S))
        me = []
        for k, (ek, halo) in enumerate(zip(e, halos)):
            ext = torch.cat([torch.zeros_like(halo) if k == 0 else halo, ek])
            me.append((ext[0:B] + ext[1:B + 1] + ext[2:B + 2] + ext[3:B + 3]) / (4.0 * n100))
    else:
        flats = [f.reshape(-1) for f in all_gather(e)]
        me = [sum(flat[(gi - d).clamp(0, S * B - 1)] for d in (3, 2, 1, 0)) / (4.0 * n100)
              for flat, gi in zip(flats, g_idx)]
    boundaries = replicate(rp.boundaries, mesh)
    hists = []
    for m, gi, bnd in zip(me, g_idx, boundaries):
        valid = (gi >= 3) & (gi < n_valid_sb) & (m >= bnd[0])
        hists.append(m.new_zeros(HIST_BINS).index_add(0, _hist_index(m), valid.to(m.dtype)))
    block_hist = psum(hists)  # the gated-histogram psum
    energies = replicate(rp.energies, mesh)
    r128_on = [rp._replace(energies=en, boundaries=bd) for en, bd in zip(energies, boundaries)]
    loud = [gated_loudness(h, r) for h, r in zip(block_hist, r128_on)]

    # the sample peak over the measured samples only
    peaks = pmax([(p.abs() * (k * L + torch.arange(L, device=p.device)
                              < n_valid_sb * n100)[:, None]).amax()
                  for k, p in enumerate(parts)])
    ys, gains = [], []
    for p, pk, gl in zip(parts, peaks, loud):
        offset = 10.0 ** ((params.target_i - gl) / 20.0)
        safe = torch.where(pk > 0, pk, torch.ones_like(pk))
        gain = torch.where(pk * offset < params.target_tp, offset, params.target_tp / safe)
        gains.append(gain)
        ys.append(p * gain)
    return ys, gains[0], loud[0]


def sharded_block_loudness(x, mesh: Mesh, n100: int, axis: str = "time"):
    """Per-100 ms-subblock energy sums of one long mono stream, time-sharded
    (shards hold whole subblocks: N / devices divisible by n100).  Returns
    the parts of the [N // n100] sums."""
    parts = _parts(x, mesh)
    if any(p.shape[0] % n100 for p in parts):
        raise ValueError(f"shards of {parts[0].shape[0]} samples do not hold whole "
                         f"subblocks of {n100}")
    return [(p * p).reshape(-1, n100).sum(1) for p in parts]


__all__ = ["sharded_block_loudness", "sharded_fir", "sharded_kweight_frame_analysis",
           "sharded_loudnorm_linear"]
