"""Times the BiGRU kernel T1 and the speech path it serves, for one checkout of the port.

    python gst_plugins_rs_tpu_torch/utils/asr_timing.py [--root DIR]

Imports gst_plugins_rs_tpu_torch from DIR (default: the checkout this file
lies in) and calls only public functions, so the same script times an
older checkout of the port: unpack it with `git archive` and run parent and
change in turn in one run on the card.

Prints one JSON line with the card and:
- T1 (`bigru`) on chip_smoke.py's speech chunks (six seeded 5 s sentences,
  log-mel features padded to 500 frames): one utterance at T = 500, layer 0
  on the first chunk's features and layer 1 on the plain layer 0's states;
  the first 0.5 s of that chunk (T = 50, the shortest bucket); and the six
  chunks in one call (B = 6).  Each result is first held to `bigru_plain`
  within 1e-5 of 1 + |ref|, then timed: the median CUDA-event ms, the
  cycles a step at the card's max SM clock, and the plain version's ms at
  B = 1, T = 500 for reference only;
- whispertranscriber (chip_smoke.py's path: appsrc, 100 ms buffers of 16
  kHz mono F32, 5 s chunks, the 30 s of the six chunks): audio seconds per
  wall second, and over one run under torch.profiler the device ms and
  device ops a chunk (host-to-device copies left out), T1's device ms a
  chunk and the device's busy share of the wall.
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
T1_TOL = 1e-5
RATE, CHUNK, SPB = 16000, 5 * 16000, 1600
# chip_smoke.py's SPEECH_CHUNKS: (leading words, seed) of each 5 s chunk
SPEECH_CHUNKS = ((["open", "door"], 70_000_000), (["volume", "up"], 70_001_000),
                 (["seven", "three", "zero"], 70_002_000), (["hello", "world"], 70_003_005),
                 (["stop"], 70_004_001), ([], 70_005_004))


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


def speech_chunks(np):
    """chip_smoke.py's speech_chunks: [(audio [CHUNK] f32, words)]."""
    from gst_plugins_rs_tpu_torch.ops.speechsynth import LEXICON, synth_sentence

    vocab = sorted(LEXICON)
    out = []
    for prefix, seed in SPEECH_CHUNKS:
        rng = np.random.default_rng(seed)
        words = prefix + [vocab[int(rng.integers(len(vocab)))] for _ in range(16)]
        best = None
        for n in range(max(1, len(prefix)), len(words) + 1):
            a = synth_sentence(words[:n], seed=seed, noise_snr_db=30)
            if a.size > CHUNK:
                break
            best = (a, words[:n])
        a, ws = best
        level = np.sqrt(float((a ** 2).mean()) / 10 ** 3)
        pad = np.random.default_rng(seed + 1).standard_normal(CHUNK - a.size) * level
        out.append((np.concatenate([a, pad.astype(np.float32)]), " ".join(ws)))
    return out


def clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def kernel_rows(np, torch, dev, chunks):
    from gst_plugins_rs_tpu_torch.ops import asr, asr_gru

    w = asr.load_weights(dev=dev)

    def feats(audio):
        return asr.padded_features(torch.from_numpy(audio).to(dev))[0]

    first = feats(chunks[0][0])
    W0, W1 = asr.layer_mats(w, 0), asr.layer_mats(w, 1)
    X0 = asr.input_projections(first[None], W0[0], W0[1])
    h0 = asr_gru.bigru_plain(X0, W0[2])
    X1 = asr.input_projections(torch.cat([h0[:, 0], h0[:, 1]], -1), W1[0], W1[1])
    short = feats(chunks[0][0][:RATE // 2])
    six = torch.stack([feats(a) for a, _ in chunks])
    cases = {"B1 T500 layer0": (X0, W0[2]),
             "B1 T500 layer1": (X1, W1[2]),
             "B1 T50 layer0": (asr.input_projections(short[None], W0[0], W0[1]), W0[2]),
             "B6 T500 layer0": (asr.input_projections(six, W0[0], W0[1]), W0[2])}
    hz = clock_hz()
    out = {}
    for name, (X, U) in cases.items():
        got = asr_gru.bigru(X, U)
        torch.cuda.synchronize()
        ref = asr_gru.bigru_plain(X, U)
        err = float(((got - ref).abs() / (1 + ref.abs())).max())
        if not err <= T1_TOL:
            raise AssertionError(f"T1 {name}: error {err:.3e} above its gate {T1_TOL}")
        ms = cuda_ms(torch, lambda: asr_gru.bigru(X, U))
        out[name] = dict(shape=list(X.shape), kernel_ms=ms,
                         cycles_a_step=ms * 1e-3 * hz / X.shape[2], max_err=err)
    X, U = cases["B1 T500 layer0"]
    out["B1 T500 layer0"]["plain_ms"] = cuda_ms(torch, lambda: asr_gru.bigru_plain(X, U),
                                                iters=3, warmup=1)
    return out


def speech_row(np, torch, chunks):
    """The speech path of chip_smoke.py phases 4g and 6g."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import Buffer
    from torch.profiler import ProfilerActivity, profile

    audio = np.concatenate([a for a, _ in chunks])

    def run(n):
        p = g.parse_launch(f"appsrc name=src caps=audio/x-raw,format=F32,rate={RATE},channels=1 "
                           f"! whispertranscriber chunk-duration={5 * 10**9} ! appsink name=sink")
        src = p.by_name("src")
        for i in range(0, n, SPB):
            src.push_buffer(Buffer(torch.from_numpy(audio[i:i + SPB, None]),
                                   pts=i * 10**9 // RATE, duration=SPB * 10**9 // RATE))
        src.end_of_stream()
        p.play_until_eos()
        torch.cuda.synchronize()
        return [s.buffer.data for s in p.by_name("sink").samples]

    run(CHUNK)  # warm-up: builds, caches
    t0 = time.perf_counter()
    texts = run(audio.size)
    rate = audio.size / RATE / (time.perf_counter() - t0)
    if texts != [words for _, words in chunks]:
        raise AssertionError(f"transcripts differ from the spoken words: {texts}")
    n = len(chunks)
    for _ in range(3):  # a session now and then records no device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(audio.size)
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
        if events:
            break
    else:
        raise AssertionError("torch.profiler recorded no device events")
    events = [e for e in events if not e.key.startswith("Memcpy HtoD")]
    ms = sum(e.self_device_time_total for e in events) / 1e3 / n
    ops = sum(e.count for e in events if not e.key.startswith("Memcpy")) / n
    t1 = sum(e.self_device_time_total for e in events if "asr_gru" in e.key) / 1e3 / n
    return dict(audio_s_per_s=rate, device_ms_per_chunk=ms, ops_per_chunk=ops,
                t1_device_ms_per_chunk=t1, busy_share=ms * rate / (1e3 * CHUNK / RATE))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("asr_timing: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()[0]
    import gst_plugins_rs_tpu_torch as g

    g.set_device("cuda")
    dev = torch.device("cuda")
    chunks = speech_chunks(np)
    print(json.dumps({"root": args.root, "card": card, "t1": kernel_rows(np, torch, dev, chunks),
                      "whispertranscriber": speech_row(np, torch, chunks)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
