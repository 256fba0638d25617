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

With `mesh=` (a parallel/mesh.py Mesh, e.g. `make_stream_mesh()`) the stream
axis of the state and of every input is sharded over the mesh: each shard
advances its own N / S streams with the same batched step on its device, so
a sharded loudnorm_bank launches L1 once per shard a tick.  As in the JAX
package, a stream count that the mesh does not divide raises ValueError.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .mesh import Mesh, canonical, gather, shard


def make_stream_mesh(n_devices: Optional[int] = None, axis: str = "stream") -> Mesh:
    """A mesh over the first n of `visible_devices()` (all by default)."""
    from .._device import visible_devices

    devs = visible_devices()
    return Mesh(devs[:n_devices or len(devs)], (axis,))


def per_device(make: Callable[[torch.device], Any]) -> Callable[[torch.device], Any]:
    """make(dev), built once per device: a shard's step finds its
    parameters by the device its input lies on."""
    cache: Dict[torch.device, Any] = {}

    def get(dev):
        key = canonical(dev)
        if key not in cache:
            cache[key] = make(key)
        return cache[key]

    return get


def _split_tree(tree, n: int, devices) -> List[Any]:
    """n copies of a state tree, every tensor leaf cut into n slices along
    its leading (stream) axis and slice k cloned onto devices[k]; other
    leaves (host ints) are shared."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        fields = [_split_tree(v, n, devices) for v in tree]
        return [type(tree)._make(f[k] for f in fields) for k in range(n)]
    if isinstance(tree, torch.Tensor):
        return [p.to(d).clone() for p, d in zip(tree.chunk(n, 0), devices)]
    return [tree] * n


class StreamBank:
    """N parallel instances of a streaming step, one batched step per tick.

    batched_step: (states, xs) -> (states, ys) over all streams at once,
    every state leaf and xs / ys with a leading stream axis.
    states: the bank's initial states (already batched over N streams).
    With a mesh, `states` is a list of per-shard states and every step runs
    once per shard on its slice of the streams."""

    def __init__(self, batched_step: Callable, states: Any, n_streams: int,
                 mesh: Optional[Mesh] = None, axis: str = "stream"):
        self.n = n_streams
        self.mesh = mesh
        self.axis = axis
        self._step = batched_step
        if mesh is None:
            self.states = states
            return
        S = mesh.size
        if n_streams % S:
            raise ValueError(f"a bank of {n_streams} streams sharded over {S} devices: the "
                             f"stream axis should be divisible by {S}")
        self.states = _split_tree(states, S, mesh.devices)

    def shard(self, x):
        """x [n_streams, ...] with the bank's stream sharding: the per-shard
        slices (x itself without a mesh)."""
        return x if self.mesh is None else shard(x, self.mesh)

    def run(self, step: Callable, x):
        """states, y = step(states, x) for every shard (x a [n_streams, ...]
        tensor or its shards); returns y [n_streams, ...] on the first
        shard's device."""
        if self.mesh is None:
            self.states, y = step(self.states, x)
            return y
        parts = x if isinstance(x, list) else self.shard(x)
        done = [step(s, p) for s, p in zip(self.states, parts)]
        self.states = [d[0] for d in done]
        return gather([d[1] for d in done])

    def process(self, x):
        """x [n_streams, ...], one buffer a stream -> [n_streams, ...]."""
        return self.run(self._step, x)

    def process_many(self, xs):
        """xs [n_streams, k, ...]: k queued buffers a stream, advanced one
        tick after the other; equal to k process() calls.  Returns
        [n_streams, k, ...]."""
        return torch.stack([self.process(xs[:, k]) for k in range(xs.shape[1])], 1)


def _first_device(mesh: Optional[Mesh], dev) -> torch.device:
    from .._device import device

    if mesh is not None:
        return mesh.devices[0]
    return device() if dev is None else torch.device(dev)


def loudnorm_bank(n_streams: int, channels: int = 2, mesh: Optional[Mesh] = None,
                  loudness_target: float = -24.0, dtype=torch.float32, dev=None) -> StreamBank:
    """A bank of audioloudnorm engines: after the 3 s first frame
    (`first_frame`), every tick consumes one 100 ms frame a stream."""
    from ..ops import loudnorm as LN

    params = per_device(lambda d: LN.loudnorm_params(loudness_target, 7.0, -2.0, channels,
                                                     dtype, d))
    first = params(_first_device(mesh, dev))
    bank = StreamBank(lambda states, frames: LN.inner_frame_step(states, params(frames.device),
                                                                 frames),
                      LN.loudnorm_init_batched(first, channels, 0.0, n_streams), n_streams, mesh)

    def first_frame(first3s):
        """The 3 s first frame of every stream in one step.
        first3s [n_streams, 3 s, ch] -> [n_streams, 100 ms, ch]."""
        return bank.run(lambda s, x: LN.first_frame_step(s, params(x.device), x), first3s)

    def drain(padded, steps: int = LN.DRAIN_FRAMES):
        """The final drain of every stream: padded [n_streams, 100 ms, ch]
        (each stream's partial input, zero-padded) -> [n_streams, steps x
        100 ms, ch]."""
        return bank.run(lambda s, x: LN.drain(s, params(x.device), x, steps), padded)

    bank.first_frame = first_frame  # type: ignore[attr-defined]
    bank.drain = drain  # type: ignore[attr-defined]
    return bank


def r128_bank(n_streams: int, channels: int = 2, rate: int = 48000, mesh: Optional[Mesh] = None,
              dtype=torch.float32, dev=None) -> StreamBank:
    """A bank of EBU R-128 analysers (one a stream) with a merged integrated
    loudness query: the per-stream gating histograms summed over the stream
    axis, a psum over the shards when the axis is sharded (SURVEY.md
    section 2.3's shared histogram)."""
    from ..core.audio import default_channel_positions
    from ..ops.ebur128 import (
        loudness_global,
        merged_loudness_global,
        r128_add_full_subblocks,
        r128_init_batched,
        r128_params,
    )

    params = per_device(lambda d: r128_params(rate, default_channel_positions(channels),
                                              dtype, d))
    first = params(_first_device(mesh, dev))
    bank = StreamBank(lambda s, x: (r128_add_full_subblocks(s, params(x.device), x), x),
                      r128_init_batched(first, channels, n_streams), n_streams, mesh)

    def add_frames(x):
        """x [n_streams, k * n100, ch]: whole 100 ms subblocks a stream."""
        bank.process(x)

    def merged_loudness() -> float:
        return float(merged_loudness_global(bank.states, first))

    def per_stream_loudness() -> np.ndarray:
        shards = bank.states if mesh is not None else [bank.states]
        return np.concatenate([
            loudness_global(s, params(s.block_hist.device)).cpu().numpy() for s in shards])

    bank.add_frames = add_frames  # type: ignore[attr-defined]
    bank.merged_loudness = merged_loudness  # type: ignore[attr-defined]
    bank.per_stream_loudness = per_stream_loudness  # type: ignore[attr-defined]
    return bank


def echo_bank(n_streams: int, rate: int = 48000, channels: int = 2,
              delay_ns: int = 250_000_000, intensity: float = 0.5, feedback: float = 0.4,
              mesh: Optional[Mesh] = None, dev=None) -> StreamBank:
    """A bank of rsaudioecho delay lines over flat interleaved buffers
    [n_streams, n]."""
    from ..ops.echo import echo_apply_flat, echo_lag_samples, echo_ring_size

    S = echo_ring_size(1_000_000_000, rate, channels)
    lag = echo_lag_samples(delay_ns, 1_000_000_000, rate, channels)

    def step(hist, x):
        out, hist = echo_apply_flat(x, hist, intensity, feedback, lag=lag)
        return hist, out

    return StreamBank(step, torch.zeros((n_streams, S), dtype=torch.float32,
                                        device=_first_device(mesh, dev)), n_streams, mesh)


__all__ = ["StreamBank", "echo_bank", "loudnorm_bank", "make_stream_mesh", "per_device",
           "r128_bank"]
