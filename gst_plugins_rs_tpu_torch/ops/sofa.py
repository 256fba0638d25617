"""SOFA (AES69) HRTF files and uniformly partitioned convolution, in PyTorch.

The port of gst_plugins_rs_tpu/ops/sofa.py, which reimplements the `sofar`
crate the reference uses (audio/hrtf/src/sofa/imp.rs): SOFA files are
netCDF4/HDF5 containers with Data.IR [measurements, receivers=2, taps],
SourcePosition [measurements, 3] (azimuth deg, elevation deg, radius m) and
Data.SamplingRate.  Filters are chosen by the nearest measurement; the
rendering is uniformly partitioned overlap-save convolution (UPOLS: a
frequency-domain delay line of partition spectra, one FFT per input
partition, one complex multiply-accumulate over partitions, one inverse
FFT), the reference's partition-length 64.

The file and the partition spectra are host numpy (copies of the JAX
module's; `h5py` is imported inside `from_file`, as there).  `upols_block`
runs on the device of its inputs, with any leading batch dimensions (the
element passes its channels as one), where the JAX element `vmap`s it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .rfft import cmul_pair, irfft_pair, rfft_pair


@dataclass
class SofaFile:
    rate: float
    ir: np.ndarray  # [M, 2, N]
    positions: np.ndarray  # [M, 3] az(deg), el(deg), r(m)

    @staticmethod
    def from_file(path: str) -> "SofaFile":
        import h5py

        with h5py.File(path, "r") as f:
            ir = np.asarray(f["Data.IR"], np.float32)
            rate = float(np.asarray(f["Data.SamplingRate"]).ravel()[0])
            pos = np.asarray(f["SourcePosition"], np.float64)
        if ir.ndim != 3:
            raise ValueError(f"unexpected Data.IR shape {ir.shape}")
        if ir.shape[1] < 2:
            raise ValueError("SOFA file must have 2 receivers (ears)")
        return SofaFile(rate, ir[:, :2, :], pos)

    def _cartesian(self) -> np.ndarray:
        az = np.deg2rad(self.positions[:, 0])
        el = np.deg2rad(self.positions[:, 1])
        r = self.positions[:, 2]
        x = r * np.cos(el) * np.cos(az)
        y = r * np.cos(el) * np.sin(az)
        z = r * np.sin(el)
        return np.stack([x, y, z], axis=1)

    def nearest(self, point_xyz) -> int:
        """Index of the measurement nearest to a cartesian point."""
        c = self._cartesian()
        d = np.sum((c - np.asarray(point_xyz, np.float64)) ** 2, axis=1)
        return int(np.argmin(d))

    def hrir(self, idx: int) -> np.ndarray:
        return self.ir[idx]  # [2, N]


def partition_filter(h: np.ndarray, part_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """h: [2, N] -> partition spectra (re, im) each [P, 2, part_len+1]
    (rfft of 2 * part_len)."""
    n = h.shape[-1]
    P = max(1, math.ceil(n / part_len))
    padded = np.zeros((2, P * part_len), np.float32)
    padded[:, :n] = h
    parts = padded.reshape(2, P, part_len).transpose(1, 0, 2)  # [P, 2, L]
    H = np.fft.rfft(parts, 2 * part_len, axis=-1)
    return H.real.astype(np.float32), H.imag.astype(np.float32)


def upols_block(fdl_re, fdl_im, prev_block, x_block, H_re, H_im):
    """One partition step of UPOLS (real-pair spectra, see ops/rfft.py).

    fdl_re/fdl_im: [..., P, L+1] frequency-domain delay line (newest first)
    prev_block: [..., L] previous input block; x_block: [..., L] new samples
    H_re/H_im: [..., P, 2, L+1] partition spectra
    Returns (fdl_re', fdl_im', prev', out [..., L, 2])."""
    L = x_block.shape[-1]
    seg = torch.cat([prev_block, x_block], dim=-1)  # [..., 2L] overlap-save input
    Xr, Xi = rfft_pair(seg, 2 * L)  # [..., L+1]
    fdl_re = torch.cat([Xr[..., None, :], fdl_re[..., :-1, :]], dim=-2)
    fdl_im = torch.cat([Xi[..., None, :], fdl_im[..., :-1, :]], dim=-2)
    Yr, Yi = cmul_pair(fdl_re[..., :, None, :], fdl_im[..., :, None, :], H_re, H_im)
    Yr = Yr.sum(-3)  # [..., 2, L+1]
    Yi = Yi.sum(-3)
    y = irfft_pair(Yr, Yi, 2 * L)[..., L:]  # overlap-save: keep the last L
    return fdl_re, fdl_im, x_block, y.transpose(-1, -2)  # [..., L, 2]


__all__ = ["SofaFile", "partition_filter", "upols_block"]
