"""Times the low-rank colorlut kernels B2 and B3 of one checkout of the port.

    python gst_plugins_rs_tpu_torch/utils/lowrank_timing.py [--root DIR]

Imports gst_plugins_rs_tpu_torch from DIR (default: the checkout this file
lies in) and calls only the public wrappers lowrank_sample_packed (B2) and
lowrank_sample_fused (B3), so the same script times an older checkout of
the port: unpack it with `git archive` and run parent and change in turn in
one session on the card.  On 8 frames of 1080p (random pixels, synthetic
factors, as chip_smoke.py phase 3b) it checks each kernel bit-equal to its
plain version, then prints one JSON line with the card and the median
CUDA-event time of each kernel at ranks 64 and 128 in f32 and bf16.  Needs
a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

FRAMES, H, W, S = 8, 1080, 1920, 33
RANKS = (64, 128)
COMPUTE_DTYPES = ("float32", "bfloat16")
SPIN_CYCLES = 2_000_000


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, each run timed by events
    behind a spin of the card, as chip_smoke.py times its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def factors(torch, np, K, dev):
    """chip_smoke.py's synthetic factors at rank K (seed K)."""
    rng = np.random.RandomState(K)
    ops = []
    for _ in range(3):
        f = np.zeros((K, 48), np.float32)
        f[:, :S] = rng.uniform(0.0, 1.0, (K, S))
        ops.append(f)
    c = np.zeros((8, K), np.float32)
    c[:3] = rng.uniform(0.0, 8.0 / K, (3, K))
    return [torch.from_numpy(a).to(dev) for a in ops + [c]]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank

    if not torch.cuda.is_available():
        raise SystemExit("lowrank_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P = FRAMES * H * W
    px = torch.randint(-2**31, 2**31 - 1, (P,), generator=gen, device=dev, dtype=torch.int32)
    xyz = torch.rand(3, P, generator=gen, device=dev) * (S - 1)
    params = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 255.0, 0.0], device=dev)
    rows = []
    for K in RANKS:
        ops = factors(torch, np, K, dev)
        for cdt in COMPUTE_DTYPES:
            kw = dict(compute_dtype=cdt)
            cases = {"b2": (lambda: lowrank.lowrank_sample_packed(px, params, *ops, size=S, **kw),
                            lambda: lowrank.lowrank_sample_packed_plain(px, params, *ops, size=S,
                                                                        **kw)),
                     "b3": (lambda: lowrank.lowrank_sample_fused(xyz, *ops, **kw),
                            lambda: lowrank.lowrank_sample_fused_plain(xyz, *ops, **kw))}
            row = dict(K=K, compute_dtype=cdt)
            for name, (fn, plain) in cases.items():
                if not torch.equal(fn(), plain()):
                    raise AssertionError(f"{name} at rank {K} {cdt} differs from its plain "
                                         f"version")
                row[f"{name}_ms"] = cuda_ms(torch, fn)
            rows.append(row)
    print(json.dumps({"root": args.root, "card": card, "frames": FRAMES, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
