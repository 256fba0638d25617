"""Times the colorlut kernels B2, B3 and B5 of one checkout of the port.

    python gst_plugins_rs_tpu_torch/utils/lut_timing.py [--root DIR]

Imports gst_plugins_rs_tpu_torch from DIR (default: the checkout this file
lies in) and calls only public functions, so the same script times an older
checkout of the port: unpack it with `git archive` and run parent and
change in turn in one run on the card.  On 8 frames of 1080p (random
pixels; synthetic factors for B2/B3, as chip_smoke.py phase 3b) it checks
each kernel bit-equal to its plain version, then prints one JSON line with
the card and
- the median CUDA-event time of lowrank_sample_packed (B2) and
  lowrank_sample_fused (B3) at ranks 64 and 128 in f32 and bf16;
- B5 on a random 33^3 table: lut3d_positions_mxu on the 8 frames' grid
  coordinates in one call (median CUDA-event ms), and lut3d_apply_mxu
  called on each of the 8 RGBA frames (CUDA-event ms a frame, and the
  device ms a frame that torch.profiler sums, host-to-device copies left
  out), its output checked equal to the TPU signature's route with the
  glue in torch.
Needs a card.
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


def device_ms(torch, fn) -> float:
    """Device ms of one call of fn under torch.profiler: the sum of the
    device events' own times, host-to-device copies left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not e.key.startswith("Memcpy HtoD")) / 1e3


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


def lowrank_rows(torch, np, dev, gen):
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank

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
    return rows


def b5_row(torch, np, dev, gen):
    from gst_plugins_rs_tpu_torch.ops import colorlut_mxu
    from gst_plugins_rs_tpu_torch.ops.colorlut import grid_coord, quantize
    from gst_plugins_rs_tpu_torch.ops.pixels import restack

    table = np.random.RandomState(S).uniform(0.0, 1.0, (S**3, 3)).astype(np.float32)
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(table, S)).to(dev, torch.bfloat16)
    frames = [torch.randint(0, 256, (H, W, 4), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.uint8) for _ in range(FRAMES)]
    one, zero = [1.0] * 3, [0.0] * 3

    def glue(f):
        fi = f.to(torch.int32)
        pos = [grid_coord(fi, c, 1.0, 0.0, S, 255.0).reshape(-1) for c in range(3)]
        rgb = colorlut_mxu.lut3d_positions_mxu(*pos, t2, size=S)
        return restack(fi, (0, 1, 2), [quantize(c.reshape(H, W), 255.0) for c in rgb],
                       torch.uint8)

    def apply():
        return [colorlut_mxu.lut3d_apply_mxu(f, t2, one, zero, size=S) for f in frames]

    lanes = torch.stack(frames).to(torch.int32)
    pos = [grid_coord(lanes, c, 1.0, 0.0, S, 255.0).reshape(-1).contiguous() for c in range(3)]
    got = colorlut_mxu.lut3d_positions_mxu(*pos, t2, size=S)
    ref = colorlut_mxu.lut3d_positions_mxu_plain(*pos, t2, size=S)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError("lut3d_positions_mxu differs from its plain version")
    if not all(torch.equal(o, glue(f)) for o, f in zip(apply(), frames)):
        raise AssertionError("lut3d_apply_mxu differs from its TPU-signature route")
    del got, ref
    apply()  # warm-up
    return dict(positions_ms=cuda_ms(torch, lambda: colorlut_mxu.lut3d_positions_mxu(
                    *pos, t2, size=S)),
                apply_ms_per_frame=cuda_ms(torch, apply) / FRAMES,
                apply_device_ms_per_frame=device_ms(torch, apply) / FRAMES)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("lut_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = lowrank_rows(torch, np, dev, gen)
    b5 = b5_row(torch, np, dev, gen)
    print(json.dumps({"root": args.root, "card": card, "frames": FRAMES, "rows": rows,
                      "b5": b5}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
