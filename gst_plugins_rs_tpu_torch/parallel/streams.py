"""Multi-stream batching: many independent streams per device launch.

The port of gst_plugins_rs_tpu/parallel/streams.py, the device analog of the
reference's threadshare runtime ("many elements, few threads",
generic/threadshare/src/runtime/mod.rs:9-49) and of analyticscombiner's
batch-across-streams strategy (SURVEY.md section 2.3): a StreamBank keeps N
streams' element state on a leading batch axis and advances every stream by
one buffer in one batched step.

Only hand-batched steps: the JAX bank can `vmap` a single-stream step, but
`torch.func.vmap` cannot go through a ctypes kernel, and a vmapped step
would run the limiter's slow path for every stream (PERF_NOTES' loudnorm
bank rule); loudnorm_bank's step runs kernel L1 once a tick for all N
streams, each block deciding its stream's idle case.

The mesh paths (a bank whose stream axis is sharded over several devices,
`make_stream_mesh`, `mesh=`) wait for the port's torch.distributed layer
(ROADMAP queue A, item 6) and raise NotImplementedError.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

MESH_TODO = ("the stream mesh waits for the port's torch.distributed layer "
             "(ROADMAP queue A, item 6)")


def make_stream_mesh(n_devices: Optional[int] = None, axis: str = "stream"):
    raise NotImplementedError(f"make_stream_mesh: {MESH_TODO}")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"mesh=: {MESH_TODO}")


class StreamBank:
    """N parallel instances of a streaming step, one batched step per tick.

    batched_step: (states, xs) -> (states, ys) over all N streams at once,
    every state leaf and xs / ys with a leading [N] axis.
    states: the bank's initial states (already batched)."""

    def __init__(self, batched_step: Callable, states: Any, n_streams: int, mesh=None):
        _no_mesh(mesh)
        self.n = n_streams
        self.states = states
        self._step = batched_step

    def process(self, x):
        """x [n_streams, ...], one buffer a stream -> [n_streams, ...]."""
        self.states, y = self._step(self.states, x)
        return y

    def process_many(self, xs):
        """xs [n_streams, k, ...]: k queued buffers a stream, advanced one
        tick after the other; equal to k process() calls.  Returns
        [n_streams, k, ...]."""
        return torch.stack([self.process(xs[:, k]) for k in range(xs.shape[1])], 1)


def loudnorm_bank(n_streams: int, channels: int = 2, mesh=None, loudness_target: float = -24.0,
                  dtype=torch.float32, dev=None) -> StreamBank:
    """A bank of audioloudnorm engines: after the 3 s first frame
    (`first_frame`), every tick consumes one 100 ms frame a stream."""
    from .._device import device
    from ..ops import loudnorm as LN

    _no_mesh(mesh)
    dev = device() if dev is None else torch.device(dev)
    params = LN.loudnorm_params(loudness_target, 7.0, -2.0, channels, dtype, dev)
    bank = StreamBank(lambda states, frames: LN.inner_frame_step(states, params, frames),
                      LN.loudnorm_init_batched(params, channels, 0.0, n_streams), n_streams)

    def first_frame(first3s):
        """The 3 s first frame of every stream in one step.
        first3s [n_streams, 3 s, ch] -> [n_streams, 100 ms, ch]."""
        bank.states, outs = LN.first_frame_step(bank.states, params, first3s)
        return outs

    def drain(padded, steps: int = LN.DRAIN_FRAMES):
        """The final drain of every stream: padded [n_streams, 100 ms, ch]
        (each stream's partial input, zero-padded) -> [n_streams, steps x
        100 ms, ch]."""
        bank.states, outs = LN.drain(bank.states, params, padded, steps)
        return outs

    bank.first_frame = first_frame  # type: ignore[attr-defined]
    bank.drain = drain  # type: ignore[attr-defined]
    return bank


def r128_bank(n_streams: int, channels: int = 2, rate: int = 48000, mesh=None,
              dtype=torch.float32, dev=None) -> StreamBank:
    """A bank of EBU R-128 analysers (one a stream) with a merged integrated
    loudness query: the per-stream gating histograms summed over the stream
    axis (SURVEY.md section 2.3's shared histogram)."""
    from .._device import device
    from ..core.audio import default_channel_positions
    from ..ops.ebur128 import (
        loudness_global,
        merged_loudness_global,
        r128_add_full_subblocks,
        r128_init_batched,
        r128_params,
    )

    _no_mesh(mesh)
    dev = device() if dev is None else torch.device(dev)
    params = r128_params(rate, default_channel_positions(channels), dtype, dev)
    bank = StreamBank(lambda s, x: (r128_add_full_subblocks(s, params, x), x),
                      r128_init_batched(params, channels, n_streams), n_streams)

    def add_frames(x):
        """x [n_streams, k * n100, ch]: whole 100 ms subblocks a stream."""
        bank.process(x)

    def merged_loudness() -> float:
        return float(merged_loudness_global(bank.states, params))

    def per_stream_loudness() -> np.ndarray:
        return loudness_global(bank.states, params).cpu().numpy()

    bank.add_frames = add_frames  # type: ignore[attr-defined]
    bank.merged_loudness = merged_loudness  # type: ignore[attr-defined]
    bank.per_stream_loudness = per_stream_loudness  # type: ignore[attr-defined]
    return bank


def echo_bank(n_streams: int, rate: int = 48000, channels: int = 2,
              delay_ns: int = 250_000_000, intensity: float = 0.5, feedback: float = 0.4,
              mesh=None, dev=None) -> StreamBank:
    """A bank of rsaudioecho delay lines over flat interleaved buffers
    [n_streams, n]."""
    from .._device import device
    from ..ops.echo import echo_apply_flat, echo_lag_samples, echo_ring_size

    _no_mesh(mesh)
    dev = device() if dev is None else torch.device(dev)
    S = echo_ring_size(1_000_000_000, rate, channels)
    lag = echo_lag_samples(delay_ns, 1_000_000_000, rate, channels)

    def step(hist, x):
        out, hist = echo_apply_flat(x, hist, intensity, feedback, lag=lag)
        return hist, out

    return StreamBank(step, torch.zeros((n_streams, S), dtype=torch.float32, device=dev),
                      n_streams)


__all__ = ["StreamBank", "echo_bank", "loudnorm_bank", "make_stream_mesh", "r128_bank"]
