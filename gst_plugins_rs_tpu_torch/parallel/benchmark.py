"""Multi-stream throughput benchmark of the stream banks.

The port of gst_plugins_rs_tpu/parallel/benchmark.py, the analog of the
reference's threadshare benchmark (generic/threadshare/examples/
benchmark.rs: buffers/sec over wall-clock windows for N streams): runs N
parallel streams through a batched effects chain (echo_bank, loudnorm_bank)
and prints buffers/sec and realtime-x per window, each line with the device
it ran on.  It runs on the card (the selected device: CUDA unless the
caller chose the CPU).

Usage:
    python -m gst_plugins_rs_tpu_torch.parallel.benchmark --streams 16 \
        --chain echo,loudnorm --seconds 10 --window 2

`--mesh` (the streams sharded over every device) waits for the port's
torch.distributed layer and raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(streams: int, chain: str, seconds: float, window: float, use_mesh: bool,
        emit: Optional[Callable[[str], None]] = print) -> List[dict]:
    """Run the chain for `seconds`, one report a `window`; returns the
    windows' numbers (buffers_per_s, realtime_x, seconds, buffers)."""
    from .._device import device
    from ..ops import loudnorm as LN
    from .streams import MESH_TODO, echo_bank, loudnorm_bank

    if use_mesh:
        raise NotImplementedError(f"--mesh: {MESH_TODO}")
    dev = device()
    rng = np.random.RandomState(0)

    banks = []
    for name in (n.strip() for n in chain.split(",")):
        if name == "echo":
            banks.append(("echo", echo_bank(streams, dev=dev)))
        elif name == "loudnorm":
            b = loudnorm_bank(streams, channels=2, dev=dev)
            b.first_frame(torch.from_numpy(
                rng.uniform(-0.5, 0.5, (streams, LN.GAIN_LOOKAHEAD, 2)).astype(np.float32)).to(dev))
            banks.append(("loudnorm", b))
        else:
            raise SystemExit(f"unknown chain element {name!r}")

    # one buffer = 100 ms a stream: 192 kHz with loudnorm in the chain, else 48 kHz
    n = LN.FRAME if any(k == "loudnorm" for k, _ in banks) else 4800
    frame = torch.from_numpy(rng.uniform(-0.5, 0.5, (streams, n, 2)).astype(np.float32)).to(dev)
    buffer_secs = 0.1

    def tick():
        x = frame
        for name, bank in banks:
            if name == "echo":
                x = bank.process(x.reshape(streams, -1)).reshape(x.shape)
            else:
                x = bank.process(x)
        return x

    tick()  # warm-up: kernel builds, allocator
    _sync(dev)
    label = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if emit:
        emit(f"# streams={streams} chain={chain} device={label}")
    rows = []
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        n_bufs = 0
        while time.perf_counter() - t0 < window:
            tick()
            n_bufs += streams
        _sync(dev)
        dt = time.perf_counter() - t0
        row = dict(buffers_per_s=n_bufs / dt, realtime_x=n_bufs * buffer_secs / dt, seconds=dt,
                   buffers=n_bufs)
        rows.append(row)
        if emit:
            emit(f"buffers/sec: {row['buffers_per_s']:10.1f}   realtime-x: "
                 f"{row['realtime_x']:8.1f}   ({streams} streams, {label})")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--streams", type=int, default=64)
    ap.add_argument("--chain", default="echo")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--window", type=float, default=2.0)
    ap.add_argument("--mesh", action="store_true", help="shard streams over all devices")
    args = ap.parse_args()
    run(args.streams, args.chain, args.seconds, args.window, args.mesh)


if __name__ == "__main__":
    main()
