"""HRTF binaural rendering: the HRIR sphere and block FFT convolution, in PyTorch.

The port of gst_plugins_rs_tpu/ops/hrtf.py, which reimplements the `hrtf`
crate (0.8.1) the reference uses: the HRIR sphere file format (magic
"HRIR", rate, hrir_len, vertex and index counts, triangle indices, vertices
as xyz + left/right IRs) and block convolution with positional
interpolation (a block of `interpolation_steps` segments; each segment is
convolved with the HRIR sampled on the sphere at the position lerped from
the previous to the new one, the distance gain lerped alongside).

The sphere is host numpy (a copy of the JAX package's parser; HRIR
interpolation is a handful of ray-triangle tests per block).  The segmented
convolution runs on the device as batched real-pair FFT products
(ops/rfft.py); the overlap-add is one `index_add_` over every segment of the
call, where the JAX function adds segment by segment.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .rfft import cmul_pair, irfft_pair, rfft_pair


@dataclass
class HrirSphere:
    rate: int
    length: int  # HRIR taps
    vertices: np.ndarray  # [V, 3]
    faces: np.ndarray  # [F, 3] int
    left: np.ndarray  # [V, L]
    right: np.ndarray  # [V, L]

    @staticmethod
    def parse(data: bytes, target_rate: int) -> "HrirSphere":
        if data[:4] != b"HRIR":
            raise ValueError("not an HRIR sphere file (bad magic)")
        rate, length, vcount, icount = struct.unpack_from("<IIII", data, 4)
        if icount % 3 != 0:
            raise ValueError("index count not a multiple of 3")
        off = 20
        faces = np.frombuffer(data, "<u4", icount, off).reshape(-1, 3).astype(np.int64)
        off += icount * 4
        verts = np.zeros((vcount, 3), np.float32)
        left = np.zeros((vcount, length), np.float32)
        right = np.zeros((vcount, length), np.float32)
        stride = 12 + 2 * length * 4
        for v in range(vcount):
            verts[v] = np.frombuffer(data, "<f4", 3, off)
            left[v] = np.frombuffer(data, "<f4", length, off + 12)
            right[v] = np.frombuffer(data, "<f4", length, off + 12 + length * 4)
            off += stride
        sphere = HrirSphere(rate, length, verts, faces, left, right)
        if rate != target_rate:
            sphere = sphere.resampled(target_rate)
        return sphere

    @staticmethod
    def from_file(path: str, target_rate: int) -> "HrirSphere":
        with open(path, "rb") as f:
            return HrirSphere.parse(f.read(), target_rate)

    def resampled(self, new_rate: int) -> "HrirSphere":
        """Linear-resample the IRs to the device rate (the crate resamples on
        load as well; linear is a documented approximation)."""
        new_len = max(1, int(round(self.length * new_rate / self.rate)))
        t_old = np.arange(self.length) * (1.0 / self.rate)
        t_new = np.arange(new_len) * (1.0 / new_rate)
        left = np.stack([np.interp(t_new, t_old, ir) for ir in self.left]).astype(np.float32)
        right = np.stack([np.interp(t_new, t_old, ir) for ir in self.right]).astype(np.float32)
        return HrirSphere(new_rate, new_len, self.vertices, self.faces, left, right)

    def sample_bilinear(self, direction: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Interpolate (left, right) HRIRs at a direction via ray-triangle
        barycentric blending over the sphere mesh; nearest vertex fallback."""
        d = np.asarray(direction, np.float64)
        n = np.linalg.norm(d)
        if n < 1e-9:
            d = np.array([0.0, 0.0, 1.0])
        else:
            d = d / n
        a = self.vertices[self.faces[:, 0]].astype(np.float64)
        b = self.vertices[self.faces[:, 1]].astype(np.float64)
        c = self.vertices[self.faces[:, 2]].astype(np.float64)
        # Moller-Trumbore, ray from origin along d
        e1 = b - a
        e2 = c - a
        p = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, p)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
            t0 = -a  # origin - a
            u = np.einsum("ij,ij->i", t0, p) * inv
            q = np.cross(t0, e1)
            v = np.einsum("j,ij->i", d, q) * inv
            t = np.einsum("ij,ij->i", e2, q) * inv
        eps = 1e-6
        hit = (np.abs(det) > 1e-12) & (u >= -eps) & (v >= -eps) & (u + v <= 1 + eps) & (t > 0)
        if not np.any(hit):
            # fallback: nearest vertex
            iv = int(np.argmax(self.vertices @ d))
            return self.left[iv], self.right[iv]
        fi = int(np.argmax(hit))
        w1, w2 = u[fi], v[fi]
        w0 = 1.0 - w1 - w2
        f = self.faces[fi]
        l = w0 * self.left[f[0]] + w1 * self.left[f[1]] + w2 * self.left[f[2]]
        r = w0 * self.right[f[0]] + w1 * self.right[f[1]] + w2 * self.right[f[2]]
        return l.astype(np.float32), r.astype(np.float32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _convolve_segments(segs, hrirs, tails, block_len: int):
    """segs [C, S, B] (gains applied), hrirs [C, S, 2, L], tails [C, 2, L-1]
    -> (out [S*B, 2] mixed over channels, tails'): each segment convolved
    with its HRIRs and overlap-added at offset s*B, the tails in front."""
    C, S, B = segs.shape
    L = hrirs.shape[-1]
    n = S * B
    seg_len = B + L - 1
    fft_len = _next_pow2(seg_len)
    Xr, Xi = rfft_pair(segs, fft_len)  # [C, S, F]
    Hr, Hi = rfft_pair(hrirs, fft_len)  # [C, S, 2, F]
    Yr, Yi = cmul_pair(Xr[:, :, None, :], Xi[:, :, None, :], Hr, Hi)
    y = irfft_pair(Yr, Yi, fft_len)[..., :seg_len]  # [C, S, 2, B+L-1]
    # overlap-add: sample j of segment s lands at s*B + j
    pos = (torch.arange(S, device=y.device)[:, None] * B
           + torch.arange(seg_len, device=y.device)[None, :]).reshape(-1)
    full = torch.zeros((C, 2, n + L - 1), dtype=y.dtype, device=y.device)
    full.index_add_(2, pos, y.permute(0, 2, 1, 3).reshape(C, 2, S * seg_len))
    if L > 1:
        full[:, :, :L - 1] += tails
    return full[:, :, :n].sum(0).T, full[:, :, n:]


def hrtf_convolve_block(x, hrirs, gains, tails, *, block_len: int, steps: int):
    """Convolve one multi-channel block with per-step interpolated HRIRs.

    x:     [C, steps*block_len] deinterleaved input
    hrirs: [C, steps, 2, L] left/right IRs per channel per step
    gains: [C, steps] distance gains (applied to the input segment)
    tails: [C, 2, L-1] overlap-add carry per channel
    Returns (out [steps*block_len, 2] mixed over channels, new tails)."""
    C = x.shape[0]
    segs = x.reshape(C, steps, block_len) * gains[:, :, None]
    return _convolve_segments(segs, hrirs, tails, block_len)


def hrtf_convolve_blocks(x, hrirs, gains, tails, *, block_len: int, steps: int):
    """K blocks with the same HRIR tables in one call, the overlap-add tails
    chained through: equal, to float rounding, to K hrtf_convolve_block calls.

    x: [C, K, steps*block_len] -> (out [K, steps*block_len, 2], tails)."""
    C, K, _ = x.shape
    segs = x.reshape(C, K, steps, block_len) * gains[:, None, :, None]
    tiled = hrirs[:, None].expand(C, K, *hrirs.shape[1:]).reshape(C, K * steps, 2, -1)
    out, tails = _convolve_segments(segs.reshape(C, K * steps, block_len), tiled, tails,
                                    block_len)
    return out.reshape(K, steps * block_len, 2), tails


__all__ = ["HrirSphere", "hrtf_convolve_block", "hrtf_convolve_blocks"]
