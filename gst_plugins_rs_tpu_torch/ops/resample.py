"""Rational audio resampling (audioresample), in PyTorch.

The port of gst_plugins_rs_tpu/ops/resample.py.  For a reduced ratio L/M
the polyphase resampler is a strided correlation over the zero-stuffed
input: upsample by L, anti-alias FIR, decimate by M.  The JAX package runs
it as one dilated XLA convolution (`conv_general_dilated` with
lhs_dilation=L, stride M); here the input is zero-stuffed and
`torch.nn.functional.conv1d` runs it with stride M, in full f32 (cuDNN's
TF32 turned off, or the card misses the CPU by ~1e-3).  The sub-sample
output phase becomes a delayed copy of the prototype (a row of a table),
and the linear-phase delay is compensated in the output indexing.  The
prototype is a Kaiser-windowed sinc with each polyphase leg normalised to
unit DC gain.

Streaming: `Resampler` carries the FIR history and the output counter
across buffers, so chunked processing equals one-shot processing.

Output n reads the window starting at s_n = n*M - D (D = (T-1)//2) of the
upsampled grid, where input x[i] sits at position i*L.  A buffer whose
first sample is input b covers s_n >= b*L; the offset s_n - b*L splits as
q*L + r: q whole samples dropped from the buffer head, r the phase row.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .._device import no_tf32


@lru_cache(maxsize=64)
def design_filter(L: int, M: int, taps_per_phase: int = 24, beta: float = 8.6) -> np.ndarray:
    """Kaiser-windowed sinc prototype at the upsampled rate, length
    taps_per_phase*L + 1 (odd), cutoff pi/max(L, M), polyphase legs
    DC-normalised.  f32."""
    T = taps_per_phase * L + 1
    n = np.arange(T, dtype=np.float64) - (T - 1) / 2.0
    cutoff = 1.0 / max(L, M)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(T, beta)
    for p in range(L):
        leg = h[p::L]
        s = leg.sum()
        if abs(s) > 1e-12:
            h[p::L] = leg / s
    return h.astype(np.float32)


def _resample_block(x, h_row, L: int, M: int, n_out: int):
    """x [n_in, ch] f32 -> [n_out, ch] f32; h_row [T + L] is the prototype
    delayed by the phase r."""
    n_in, ch = x.shape
    Tp = h_row.shape[0]
    up = torch.zeros((ch, 1, (n_in - 1) * L + 1 + Tp + M), dtype=x.dtype, device=x.device)
    up[:, 0, 0:(n_in - 1) * L + 1:L] = x.t()
    with no_tf32():
        out = torch.nn.functional.conv1d(up, h_row.reshape(1, 1, Tp), stride=M)
    return out[:, 0, :n_out].t().contiguous()


class Resampler:
    """Streaming rational resampler for [n, ch] f32 interleaved blocks."""

    def __init__(self, rate_in: int, rate_out: int, taps_per_phase: int = 24, device=None):
        from .._device import device as _default_device

        g = math.gcd(rate_in, rate_out)
        self.L = rate_out // g
        self.M = rate_in // g
        self.identity = self.L == self.M
        self.device = _default_device() if device is None else torch.device(device)
        h = design_filter(self.L, self.M, taps_per_phase)
        self.T = int(h.shape[0])
        self.delay = (self.T - 1) // 2
        # row r = the prototype delayed by r upsampled taps
        table = np.zeros((self.L, self.T + self.L), np.float32)
        for r in range(self.L):
            table[r, r:r + self.T] = h
        self._h_table = torch.from_numpy(table).to(self.device)
        self.reset()

    def reset(self) -> None:
        self._hist = None    # input samples [i0, total_in)
        self._i0 = 0         # input index of _hist[0] (may be negative)
        self._total_in = 0   # real input samples consumed
        self._produced = 0   # outputs emitted

    def process(self, x) -> torch.Tensor:
        """[n, ch] f32 in -> [m, ch] f32 out (m varies from block to block)."""
        x = torch.as_tensor(x).to(self.device, torch.float32)
        if self.identity:
            return x
        if self._hist is None:
            # virtual zeros covering the filter's look-back before t = 0
            self._i0 = (-self.delay) // self.L
            self._hist = torch.zeros((-self._i0, x.shape[1]), dtype=torch.float32,
                                     device=self.device)
        buf = torch.cat([self._hist, x], 0)
        total_in = self._total_in + int(x.shape[0])
        # every n whose window [s_n, s_n + T) has all inputs:
        # s_n + T <= total_in * L with s_n = n*M - D
        n_max = (total_in * self.L - self.T + self.delay) // self.M
        n_out = int(n_max - self._produced + 1)
        if n_out > 0:
            s0 = self._produced * self.M - self.delay
            q, r = divmod(s0 - self._i0 * self.L, self.L)
            assert q >= 0, (s0, self._i0)
            y = _resample_block(buf[q:] if q else buf, self._h_table[int(r)], self.L, self.M,
                                n_out)
            self._produced += n_out
        else:
            y = torch.zeros((0, x.shape[1]), dtype=torch.float32, device=self.device)
        self._total_in = total_in
        # keep from the next output's window start (floored to a whole input)
        s_next = self._produced * self.M - self.delay
        i0_new = min(s_next // self.L, total_in)
        self._hist = buf[i0_new - self._i0:]
        self._i0 = i0_new
        return y

    def drain(self) -> torch.Tensor:
        """Flush the filter tail with silence (about delay/M outputs)."""
        if self.identity or self._hist is None:
            return torch.zeros((0, 1), dtype=torch.float32, device=self.device)
        flush = (self.T + self.M) // self.L + 2
        return self.process(torch.zeros((flush, self._hist.shape[1]), dtype=torch.float32,
                                        device=self.device))


__all__ = ["Resampler", "design_filter"]
