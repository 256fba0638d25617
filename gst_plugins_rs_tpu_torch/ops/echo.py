"""Delay-line echo (the rsaudioecho compute path), in PyTorch.

The port of gst_plugins_rs_tpu/ops/echo.py.  Reference behaviour
(audio/audiofx/src/audioecho/imp.rs:69-85, ring_buffer.rs:59-76): per
interleaved sample, with delay line w and lag d,

    delayed = w[n - d]      (zeros before the stream starts)
    out[n]  = in[n] + intensity * delayed
    w[n]    = in[n] + feedback  * delayed

The ring walk becomes a history tail of the last S written samples and
chunks of at most `lag` samples: within a chunk nothing depends on the
chunk itself, so each chunk is a few vector ops.  The JAX package scans the
chunks with `lax.scan`; here a Python loop walks them (one or two a buffer
at usual delays).
"""
from __future__ import annotations

import torch


def echo_apply_flat(x, hist, intensity: float, feedback: float, *, lag: int):
    """Echo over a flat interleaved vector x [N] with history hist [S]
    (S >= lag >= 1).  Returns (out [N], new_hist [S]).  Leading axes are
    independent streams (x [B, N], hist [B, S]: the bank's batched step)."""
    N = x.shape[-1]
    S = hist.shape[-1]
    if not 1 <= lag <= S:
        raise ValueError(f"echo_apply_flat: need 1 <= lag <= S, got lag {lag}, S {S}")
    chunk = min(lag, N)
    outs = []
    for start in range(0, N, chunk):
        xc = x[..., start:start + chunk]
        c = xc.shape[-1]
        delayed = hist[..., S - lag:S - lag + c]
        outs.append(xc + intensity * delayed)
        wr = xc + feedback * delayed
        hist = torch.cat([hist[..., c:], wr], -1) if c < S else wr[..., -S:]
    return (outs[0] if len(outs) == 1 else torch.cat(outs, -1)), hist


def echo_lag_samples(delay_ns: int, max_delay_ns: int, rate: int, channels: int) -> int:
    """Reference lag (imp.rs:74-77, delay clamped to max-delay):
    floor(min(delay, max_delay) * channels * rate / 1e9) interleaved samples."""
    d = min(delay_ns, max_delay_ns)
    return (d * channels * rate) // 1_000_000_000


def echo_ring_size(max_delay_ns: int, rate: int, channels: int) -> int:
    """Reference ring size (imp.rs:248-259): floor(max_delay*rate/1e9)*channels."""
    return ((max_delay_ns * rate) // 1_000_000_000) * channels


__all__ = ["echo_apply_flat", "echo_lag_samples", "echo_ring_size"]
