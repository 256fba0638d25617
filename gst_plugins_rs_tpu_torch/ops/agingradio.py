"""The agingradio distortion chain, in PyTorch.

The port of gst_plugins_rs_tpu/ops/agingradio.py.  Reference behaviour
(audio/audiofx/src/agingradio/imp.rs:94-133): per 2-frame chunk a random
click (the whole chunk = 1.0, bypassing the filter chain and its state);
otherwise per sample: add uniform white noise, clamp to [-1, 1], a
first-order lowpass (RC single pole, per channel), quantize to 2^bits steps,
N passes of cubic distortion x -= d * x^3.

The random draws are inputs here: the JAX function draws them from a
`jax.random` key, which torch cannot reproduce, so the element draws them
from a `torch.Generator` and the tests hand both functions the same draws.

The lowpass recurrence y[n] = a[n] y[n-1] + b[n] x[n] (clicked samples are
identity steps, a = 1, b = 0, so the filter state skips them) runs as a
Hillis-Steele inclusive scan over the pairs (a, b x): ceil(log2 N)
vectorised combine steps, where the JAX function runs `associative_scan`.
The running products of a underflow to 0 where they should (the start
state's weight), and nothing divides by them.
"""
from __future__ import annotations

import math

import torch


def lowpass_alpha(rate: int, freq: float) -> float:
    """Single-pole RC alpha: dt/(RC+dt), RC = 1/(2*pi*fc)."""
    dt = 1.0 / rate
    rc = 1.0 / (2.0 * math.pi * freq)
    return dt / (rc + dt)


def first_order_scan(x, a, b, y0):
    """y[n] = a[n] * y[n-1] + b[n] * x[n] along axis 0 from y[-1] = y0.
    x, a, b: [N, ch]; y0: [ch]."""
    A, B = a, b * x
    d = 1
    while d < A.shape[0]:
        # (A, B)[i] <- (A, B)[i-d] then (A, B)[i], for i >= d
        A, B = (torch.cat([A[:d], A[d:] * A[:-d]]),
                torch.cat([B[:d], A[d:] * B[:-d] + B[d:]]))
        d *= 2
    return A * y0 + B


def agingradio_process(x, clicks, noise, filt_state, noise_ampl: float, alpha: float,
                       bits: float, distortion: float, *, passes: int, use_lowpass: bool):
    """x: [N, ch]; clicks: [ceil(N/2)] bool, one decision per 2-frame chunk;
    noise: [N, ch] uniform in [-1, 1) (scaled by noise_ampl here);
    filt_state: [ch] lowpass memory.  Returns (out [N, ch], filt_state')."""
    N = x.shape[0]
    dtype = x.dtype
    if tuple(clicks.shape) != ((N + 1) // 2,) or tuple(noise.shape) != tuple(x.shape):
        raise ValueError("agingradio_process: clicks must be [ceil(N/2)], noise [N, ch]")
    click_mask = clicks.repeat_interleave(2)[:N][:, None]  # [N, 1]
    y = x + noise * noise_ampl
    if use_lowpass:
        y = torch.clamp(y, -1.0, 1.0)
        one = torch.ones_like(y)
        a = torch.where(click_mask, one, one * (1.0 - alpha))
        b = torch.where(click_mask, torch.zeros_like(y), one * alpha)
        y = first_order_scan(y, a, b, filt_state[None, :])
        new_state = y[-1]
    else:
        new_state = filt_state
    if bits > 0:
        factor = 2.0 ** bits
        y = torch.round(y * factor) / factor
    if distortion > 0:
        for _ in range(passes):
            y = y - distortion * (y * y * y)  # x**3 as XLA's integer power: (x*x)*x
    out = torch.where(click_mask, torch.ones((), dtype=dtype, device=x.device), y)
    return out, new_state


__all__ = ["agingradio_process", "first_order_scan", "lowpass_alpha"]
