"""Times the limiter kernel L1 and the two audio paths it serves, for one checkout of the port.

    python gst_plugins_rs_tpu_torch/utils/limiter_timing.py [--root DIR]

Imports gst_plugins_rs_tpu_torch from DIR (default: the checkout this file
lies in) and calls only public functions, so the same script times an
older checkout of the port: unpack it with `git archive` and run parent and
change in turn in one run on the card.  Checkouts whose `limiter_frame`
takes the peak flags (pk, pv, future) get them from `precompute_peaks`;
the kernel is then timed alone and with the detection before it.

Prints one JSON line with the card and:
- L1 on chip_smoke.py's frames (192 kHz stereo): the peaky f64 frame (a
  tick burst and two close peaks), the idle f64 frame, the clipped f64
  frame (a +-1.2 square wave: every sample a peak) and the bank of 16
  streams in f32 (8 peaky, 8 idle): median CUDA-event ms, each result first
  checked bit-equal to the plain twin;
- audioloudnorm (chip_smoke.py's 60 s of ticks, 192 kHz stereo F64): audio
  seconds per wall second, and over 6 s under torch.profiler the device ms
  and device ops per 100 ms frame and the device's busy share of the wall;
- loudnormbank (16 x 30 s, 192 kHz stereo F32, 8 tick streams and 8 sines):
  stream-seconds per wall second, device ms and ops a tick over 5 s, and the
  busy share.
Needs a card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SPIN_CYCLES = 2_000_000
FRAME, LOOKAHEAD, WINDOW = 19_200, 1920, 40_320
TICKS = "wave=ticks volume=0.8 sine-periods-per-tick=1 tick-interval=500000000"
AUDIO_SECONDS, PROFILE_FRAMES = 60, 60
BANK_STREAMS, BANK_SECONDS, BANK_PROFILE_SECONDS = 16, 30, 5


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


def window(np, torch, kind, dtype, dev):
    """chip_smoke.py's limiter windows: quiet noise, with (peaky) a tick
    burst and a pair of close peaks, (clipped) a +-1.2 square wave."""
    x = np.random.RandomState(7).uniform(-0.3, 0.3, (WINDOW, 2))
    if kind == "peaky":
        t = np.arange(2000) / 192000
        x[4000:6000] = 1.2 * np.sin(2 * np.pi * 440 * t)[:, None]
        x[12000, 0], x[13700, 1] = 0.95, 1.0
    elif kind == "clipped":
        x[:] = np.where((np.arange(WINDOW) // 218) % 2 == 0, 1.2, -1.2)[:, None]
    return torch.from_numpy(x).to(dev, dtype).contiguous()


def kernel_rows(np, torch, dev):
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    takes_flags = "pk" in inspect.signature(lim.limiter_frames).parameters
    quiet = np.random.RandomState(40).uniform(-0.5, 0.5, (BANK_STREAMS, WINDOW, 2))
    cases = {}
    tp64 = float(np.float64(10 ** (-2 / 20)))
    tp32 = float(np.float32(10 ** (-2 / 20)))
    for kind in ("peaky", "idle", "clipped"):
        w = window(np, torch, kind, torch.float64, dev)[None]
        ci = torch.tensor([[0, 0, -1]], dtype=torch.int32, device=dev)
        cf = torch.zeros((1, 2), dtype=torch.float64, device=dev)
        cases[f"{kind} f64"] = (w, ci, cf, tp64)
    carries = [(0, 0, -1, 0.0, 0.0), (1, 500, -1, 0.9, 0.6), (2, 0, 100, 0.7, 0.5),
               (3, 3000, -1, 0.5, 1.0)]
    rows, ci, cf = [], [], []
    for n in range(BANK_STREAMS):
        peaky = n < BANK_STREAMS // 2
        rows.append(window(np, torch, "peaky", torch.float32, dev) if peaky
                    else torch.from_numpy(quiet[n]).to(dev, torch.float32))
        c = carries[n % 4] if peaky else carries[0]
        ci.append(c[:3])
        cf.append(c[3:])
    cases["bank16 f32"] = (torch.stack(rows).contiguous(),
                           torch.tensor(ci, dtype=torch.int32, device=dev),
                           torch.tensor(cf, dtype=torch.float32, device=dev), tp32)
    out = {}
    for name, (w, ci, cf, tp) in cases.items():
        ref = lim.limiter_frames_plain(w.cpu(), ci.cpu(), cf.cpu(), tp,
                                       *lim.precompute_peaks(w.cpu(), tp))
        if takes_flags:
            flags = lim.precompute_peaks(w, tp)
            kernel = lambda w=w, ci=ci, cf=cf, tp=tp, f=flags: lim.limiter_frames(w, ci, cf, tp, *f)
            with_detection = lambda w=w, ci=ci, cf=cf, tp=tp: lim.limiter_frames(
                w, ci, cf, tp, *lim.precompute_peaks(w, tp))
        else:
            kernel = with_detection = lambda w=w, ci=ci, cf=cf, tp=tp: lim.limiter_frames(
                w, ci, cf, tp)
        got = with_detection()
        torch.cuda.synchronize()
        if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
            raise AssertionError(f"L1 {name} differs from its plain twin")
        row = dict(kernel_ms=cuda_ms(torch, kernel))
        if takes_flags:
            row["with_detection_ms"] = cuda_ms(torch, with_detection)
        out[name] = row
    return dict(takes_flags=takes_flags, cases=out)


def profiled(torch, run):
    """(device ms, device ops) of run() under torch.profiler, host-to-device
    copies in the ms as chip_smoke.py phase 6c counts them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    if not events:
        raise AssertionError("torch.profiler recorded no device events")
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events if not e.key.startswith("Memcpy"))
    return busy, ops


def loudnorm_row(torch):
    import gst_plugins_rs_tpu_torch as g

    def run(n_buffers):
        p = g.parse_launch(
            f"audiotestsrc {TICKS} num-buffers={n_buffers} samplesperbuffer=4800 "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! audioresample "
            f"! audio/x-raw,rate=192000 ! audioconvert "
            f"! audio/x-raw,format=F64,rate=192000,channels=2 ! audioloudnorm ! fakesink")
        p.play_until_eos()
        torch.cuda.synchronize()

    run(60)  # warm-up: builds, caches
    t0 = time.perf_counter()
    run(AUDIO_SECONDS * 10)
    rate = AUDIO_SECONDS / (time.perf_counter() - t0)
    busy, ops = profiled(torch, lambda: run(PROFILE_FRAMES))
    ms = busy / PROFILE_FRAMES
    return dict(audio_s_per_s=rate, device_ms_per_frame=ms, ops_per_frame=ops / PROFILE_FRAMES,
                busy_share=ms * rate / 100.0)


def bank_pipeline(seconds: int):
    """chip_smoke.py's bank: 8 tick streams and 8 sines, 192 kHz stereo F32."""
    import gst_plugins_rs_tpu_torch as g

    p = g.Pipeline()
    bank = g.element_factory_make("loudnormbank")
    p.add(bank)
    for i in range(BANK_STREAMS):
        if i < BANK_STREAMS // 2:
            props = {"wave": "ticks", "volume": 0.8, "sine-periods-per-tick": 1,
                     "tick-interval": 500_000_000 + 10_000_000 * i}
        else:
            props = {"wave": "sine", "freq": 220.0 + 55 * i,
                     "volume": 0.05 + ((i - BANK_STREAMS // 2) % 8) * (0.45 / 7)}
        src = g.element_factory_make("audiotestsrc")
        for k, v in {**props, "samplesperbuffer": FRAME, "num-buffers": seconds * 10}.items():
            src.set_property(k, v)
        cf = g.element_factory_make("capsfilter")
        cf.set_property("caps", g.parse_caps("audio/x-raw,format=F32,rate=192000,channels=2"))
        sink = g.element_factory_make("fakesink")
        for e in (src, cf, sink):
            p.add(e)
        src.link(cf)
        cf.pad("src").link(bank.request_sink_pad())
        bank.pad(f"src_{i}").link(sink.pad("sink"))
    return p


def bank_row(torch):
    def run(seconds):
        bank_pipeline(seconds).play_until_eos()
        torch.cuda.synchronize()

    run(4)  # warm-up
    t0 = time.perf_counter()
    run(BANK_SECONDS)
    rate = BANK_STREAMS * BANK_SECONDS / (time.perf_counter() - t0)
    busy, ops = profiled(torch, lambda: run(BANK_PROFILE_SECONDS))
    ticks = 1 + (BANK_PROFILE_SECONDS * 10 - 30) + 29  # first frame, inner ticks, drain steps
    ms = busy / ticks
    # a tick is 100 ms of every stream: wall ms a tick = 100 * streams / rate
    return dict(stream_s_per_s=rate, device_ms_per_tick=ms, ops_per_tick=ops / ticks,
                busy_share=ms * rate / (100.0 * BANK_STREAMS))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("limiter_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    import gst_plugins_rs_tpu_torch as g

    g.set_device("cuda")
    dev = torch.device("cuda")
    kernels = kernel_rows(np, torch, dev)
    print(json.dumps({"root": args.root, "card": card, "l1": kernels,
                      "audioloudnorm": loudnorm_row(torch), "loudnormbank": bank_row(torch)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
