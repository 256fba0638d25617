"""Times the GRU-stack kernel R1 and the denoising path it serves, for one checkout of the port.

    python gst_plugins_rs_tpu_torch/utils/rnnoise_timing.py [--root DIR]

Imports gst_plugins_rs_tpu_torch from DIR (default: the checkout this file
lies in) and calls only public functions, so the same script times an
older checkout of the port: unpack it with `git archive` and run parent and
change in turn in one run on the card.

Prints one JSON line with the card and:
- R1 (`rnn_frames`) at 10 x 2 and 100 x 2 frames x channels on the path's
  front-end features (chip_smoke.py phase 3d: a harmonic-plus-noise stereo
  signal, five silent frames), and at 16 x 16 and 100 x 16 on bench.py's
  input (phase 3d': 16 streams of uniform +-0.3 full-scale noise, stream 5
  silent for its first two frames): the median CUDA-event ms, each result
  first held to the plain version (within 1e-5, or on bench.py's input
  within twice the plain f32 version's own error against float64), and the
  plain version's ms for reference only;
- audiornnoise (chip_smoke.py's path: two sources through audiomixer into
  audiornnoise, 100 ms buffers of 48 kHz stereo, 60 s): audio seconds per
  wall second, and over 6 s under torch.profiler the device ms and device
  ops per 100 ms buffer and the device's busy share of the wall.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SPIN_CYCLES = 2_000_000
R1_TOL = 1e-5
PATH_FRAMES, PATH_CHANNELS = 100, 2
BANK_STREAMS = 16
AUDIO_SECONDS, PROFILE_BUFFERS, SPB = 60, 60, 4800


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


def path_features(np, torch, dev):
    """chip_smoke.py's _rnn_buffer: 100 frames x 2 channels of front-end
    features of a harmonic-plus-noise signal, frames 40-44 silent."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    rng = np.random.RandomState(11)
    n = PATH_FRAMES * rn.FRAME_SIZE
    t = np.arange(n) / 48000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * 150 * t) + 0.1 * np.sin(2 * np.pi * 300 * t)
                    + 0.05 * rng.randn(n),
                    0.2 * np.sin(2 * np.pi * 233 * t) + 0.1 * rng.randn(n)])
    sig[:, 40 * rn.FRAME_SIZE:45 * rn.FRAME_SIZE] = 0.0
    frames = (sig * 32767).astype(np.float32).reshape(PATH_CHANNELS, PATH_FRAMES, -1)
    frames = torch.from_numpy(frames.transpose(1, 0, 2).copy()).to(dev)
    state = rn.denoise_init(PATH_CHANNELS, dev)
    _, feats, _, _, _, sil = rn.analysis_frames_batch(state, frames)
    return feats, sil, state.rnn


def bank_features(np, torch, dev):
    """chip_smoke.py's rnn_bank_frames(100) through the front end: 100
    frames x 16 streams of bench.py's noise, stream 5 silent first."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    a = (np.random.RandomState(21).uniform(-0.3, 0.3, (100, BANK_STREAMS, rn.FRAME_SIZE))
         * 32767).astype(np.float32)
    a[:2, 5] = 0.0
    state = rn.denoise_init(BANK_STREAMS, dev)
    _, feats, _, _, _, sil = rn.analysis_frames_batch(state, torch.from_numpy(a).to(dev))
    return feats, sil, state.rnn


def errors(torch, got, ref):
    (g, v, s), (rg, rv, rs) = got, ref
    state = max(float(((a.double() - b.double()) / (1 + b.double().abs())).abs().max())
                for a, b in zip(s, rs))
    return max(float((g.double() - rg.double()).abs().max()),
               float((v.double() - rv.double()).abs().max()), state)


def kernel_rows(np, torch, dev):
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    w = rn.weights_to(rn.default_weights(), dev)
    w64 = {k: v.double() for k, v in w.items()}
    pf, ps, pr = path_features(np, torch, dev)
    bf, bs, br = bank_features(np, torch, dev)
    cases = {"10x2 path": (pf[:10], ps[:10], pr, False),
             "100x2 path": (pf, ps, pr, False),
             "16x16 bench": (bf[:16], bs[:16], br, True),
             "100x16 bench": (bf, bs, br, True)}
    out = {}
    for name, (f, s, r, bench) in cases.items():
        f, s = f.contiguous(), s.contiguous()
        got = gru.rnn_frames(f, s, r, w)
        torch.cuda.synchronize()
        ref = gru.rnn_frames_plain(f, s, r, w)
        err = errors(torch, got, ref)
        gate = R1_TOL
        if bench:  # phase 3d''s rule: within twice the plain version's error against float64
            ref64 = gru.rnn_frames_plain(f.double(), s, rn.RnnState(*(h.double() for h in r)),
                                         w64)
            gate = max(R1_TOL, 2 * errors(torch, ref, ref64))
            err = errors(torch, got, ref64)
        if not err <= gate:
            raise AssertionError(f"R1 {name}: error {err:.3e} above its gate {gate:.3e}")
        out[name] = dict(kernel_ms=cuda_ms(torch, lambda: gru.rnn_frames(f, s, r, w)),
                         plain_ms=cuda_ms(torch, lambda: gru.rnn_frames_plain(f, s, r, w),
                                          iters=5, warmup=1),
                         max_err=err, gate=gate)
    return out


def denoise_row(torch):
    """The audiornnoise path of chip_smoke.py phases 4d and 6d."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    def run(seconds):
        caps = "audio/x-raw,format=F32,rate=48000,channels=2"
        n = seconds * 10
        g.parse_launch(
            f"audiotestsrc wave=sine freq=180 volume=0.3 num-buffers={n} samplesperbuffer={SPB} "
            f"! {caps} ! audiomixer name=mix output-buffer-duration=100000000 ! audiornnoise "
            f"! fakesink audiotestsrc wave=white-noise volume=0.08 num-buffers={n} "
            f"samplesperbuffer={SPB} ! {caps} ! mix.").play_until_eos()
        torch.cuda.synchronize()

    run(6)  # warm-up: builds, caches
    t0 = time.perf_counter()
    run(AUDIO_SECONDS)
    rate = AUDIO_SECONDS / (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(PROFILE_BUFFERS // 10)
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if not events:
        raise AssertionError("torch.profiler recorded no device events")
    ms = sum(e.self_device_time_total for e in events) / 1e3 / PROFILE_BUFFERS
    ops = sum(e.count for e in events if not e.key.startswith("Memcpy")) / PROFILE_BUFFERS
    r1 = sum(e.self_device_time_total for e in events if "rnnoise" in e.key) / 1e3
    return dict(audio_s_per_s=rate, device_ms_per_buffer=ms, ops_per_buffer=ops,
                r1_device_ms_per_buffer=r1 / PROFILE_BUFFERS, busy_share=ms * rate / 100.0)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("rnnoise_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    import gst_plugins_rs_tpu_torch as g

    g.set_device("cuda")
    dev = torch.device("cuda")
    print(json.dumps({"root": args.root, "card": card, "r1": kernel_rows(np, torch, dev),
                      "audiornnoise": denoise_row(torch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
