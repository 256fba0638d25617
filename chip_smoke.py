#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gst_plugins_rs_tpu_torch).

Drives the port's paths on one CUDA card through the elements a user would
call, and holds every kernel of those paths against its plain PyTorch
version.  The paths: YOLOX-tiny detection at 640x640 (kernel B1), and the
per-pixel video effects at 1920x1080 with a 33^3 grade: colorlut
precision=approx (B2 for RGBA, packed64, B3's chain with the glue in the
kernel, for RGBA64LE), hsvfilter (B4), and the public functions that no
element calls: lut3d_apply_lowrank_fused (B3 with its TPU signature) and
lut3d_apply_mxu (B5: its packed entries for RGBA and RGBA64 frames, its
TPU signature with the glue in torch for other layouts); the EBU R-128
audio path (audioloudnorm, kernel L1); and the denoising and spatial audio
path (audiomixer ! audiornnoise, the GRU stack as kernel R1; hrtfrender,
agingradio, sofalizer's UPOLS step); the 1080p video composition path
(videoscale, skiacompositor, roundedcorners, colordetect, videocompare,
videoconvertscale) and Demucs at its published width (model-name=demucs,
265 646 728 parameters), which run no hand kernel.  Run from the repository
root:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):
  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every csrc/*.cu with nvcc for sm_90a, one nvcc per source;
  3. kernels: each kernel against its plain version at its path's shapes
     (and, for B2/B3/packed64, at 8 frames of 1080p over ranks 16, 64, 128,
     bit for bit, with B2 == B3 and packed64 == quantize(B3)), then timed
     (CUDA events, median) beside its plain version, the library yardstick
     and its bound; B1 (compact operands) also beside the s2d cuDNN chain,
     and over its tile sides; B2/B3/packed64 also at compute_dtype float32
     over the ranks, bit for bit; B5 and its packed entries bit for bit,
     the packed entries also equal to quantize(B5);
  4. pipelines: videotestsrc ! yoloxinference ! yoloxtensordec ! appsink at
     640x640 (engine=fast, fast-bf16), 4 streams through analyticscombiner
     / analyticssplitter, videotestsrc RGBA 1080p ! colorlut approx !
     hsvfilter ! appsink, videotestsrc RGBA64LE 1080p ! colorlut approx !
     appsink, lut3d_apply_lowrank_fused over 1080p frames, and
     lut3d_apply_mxu over 1080p RGBA, RGBA64LE and BGRA frames; the launch
     counters are set to 0 just before each path and read just after;
  5. card against CPU: one frame through apply_fast with the fused C3, and
     one seeded 1080p frame through colorlut approx (RGBA and RGBA64LE),
     hsvfilter and lut3d_apply_mxu (RGBA, RGBA64LE, BGRA), on the card
     (kernels) and on the CPU (plain versions);
  6. timing: apply_fast frames per second at batch 1 and 8, and the element
     pipelines end to end, with their device time per frame, and
     lut3d_apply_mxu's device time per frame on both of its routes.
The audio phases follow the same steps: 3c/4c/5c/6c the R-128 path (L1,
which detects the peaks and walks the limiter from peak to peak in one
launch: against its plain twin on a peaky, an idle and a clipped frame
from four carries and every boundary carry, with the peaks and segments
walked, and timed beside its bound and its event floor; 6c adds the busy
share of the wall),
3d/4d/5d/6d the denoising and spatial path: R1 against its plain version on
100 frames x 2 channels and on the path's 10-frame buffer; 60 s of two
sources through audiomixer into audiornnoise (R1 launches = buffers), 10 s
of hrtfrender (a synthetic HRIR sphere) and agingradio; card against CPU;
audio seconds per wall second with device busy time per 100 ms.
4e/5e/6e the composition path: three 1080p sources into skiacompositor (one
through videoscale to 720p and placed at 480x270 with alpha 0.7, one partly
out of bounds), tee'd into videoconvert ! I420 ! roundedcorners, colordetect
! videocompare and an appsink, and a second videocompare on identical input;
a videoconvertscale chain I420 1080p -> RGB 720p; frame counts, PTS, caps,
the A420 alpha plane, the messages; card against CPU within 1 LSB; frames per
second and device ms a frame.  4f/5f/6f Demucs: 30 s of 48 kHz stereo through
model-name=demucs in 1 s segments (four stems each, the parameter count),
demucs-lite with the packaged weights (an 80 Hz sine routes to src_bass);
one full-width segment card against CPU; seconds of audio per second and
device ms a segment.  3g/4g/5g/6g speech transcription: T1 (asr-lite's BiGRU
recurrence) against its plain version at T = 500, at T = 1, 2 and 50, with
saturated gates and on the six chunks in one call; 30 s of synthesised
speech through appsrc ! whispertranscriber chunk-duration=5 s (T1 launches =
2 x chunks, every chunk's words); card against CPU (transcripts, logits);
seconds of audio per second and device ms a chunk.  4i/5i hand detection:
30 buffers of a 1920x1080 stream through handdetectiontensordec, each with a
seeded 2 016-row palm-detection-out tensor on the card, the boxes equal to
the element's decode of the same rows on the CPU.  3h/4h/5h/6h the stream
bank: L1 over 16 streams a launch against its plain twin (a mixed bank of
idle, peaky and clipped streams, f32 and f64) and timed beside one stream;
16 streams x 30 s of 192 kHz stereo F32 (8 ticks, 8 sines)
through loudnormbank (L1 launches = ticks, every stream at -24 LUFS, peaks
<= -2 dBFS); card against CPU; stream-seconds per second, device ms and ops
a tick, and parallel/benchmark.py --chain echo,loudnorm.  3d'/4d'/5d' the
denoiser over 16 mono streams as the channels of one denoise_frames_fast
call (bench.py's rnnoise_bank16_realtime_x): R1 at C = 16 x 16 and x 100
frames against its plain version; 60 calls of 16 frames (R1 launches =
calls) and one call timed; card against CPU.  4j/5j/6j chain fusion
(parallel/fuse.py, one CUDA graph a fused run): 32 differing seeded 1080p
RGBA frames through appsrc ! hsvfilter hue-shift=120 ! colorlut approx, and
through hsvfilter ! videoscale ! capsfilter (720p) ! videoflip
method=rotate-180, fused against unfused bit for bit on every buffer (B4
and B2 launches = frames, graph replays included), and I420 -> NV12 through
videoscale ! videoconvert (an output plane that is an input plane) equal
to unfused on every buffer; card against CPU; frames
per second (median of 3), device ms, device ops and host launch calls a
frame, fused against unfused.
3k/4k/5k/6k the mesh paths (parallel/mesh.py) under four logical shards of
cuda:0 (set_virtual_devices(4)): the C3 route of every zoo model in both
dtypes and B1's shared memory as the engine reckons it against the
library's, the collectives; loudnormbank shard=true over phase 4h's bank
against shard=false (L1 launches = 4 a tick), audioloudnorm time-shard=true
over phase 4c's 60 s against time-shard=false (L1 launches = frames) and
time-shard-mode=linear against the unsharded linear gain, yoloxinference
shard=true over phase 4's four streams against shard=false (B1 launches = 4
a window), shard-mode=tensor with YOLOX-s at 64x64 and YOLOX-l at 640x640
against the reference graph (and planted faults its gate must catch), the
R-128 histogram psum, parallel/benchmark.py --mesh; YOLOX-x in bf16 by both
routes (per-conv C3, no B1), dark2's C3 and the element card against CPU;
device ms and
ops a tick and a frame, sharded against unsharded.  The sharded paths'
launches are added to L1's and B1's counts.
4l/5l/6l the recording and failover path (the host-only elements with
their payloads on the card): 32 seeded 1080p RGBA frames through
appsrc ! hsvfilter ! colorlut approx ! togglerecord (record off and on at
two seeded frames, a test tone as its audio track, clipped at the video's
end) ! fallbackswitch (a videotestsrc on its second input) ! intersink,
then intersrc ! ts-queue ! livesync ! appsink; 60 s of 192 kHz F64 through
audioloudnorm ! togglerecord is-live=true (a seeded stop) ! intersink, then
intersrc ! livesync (its silence fill) ! appsink; every payload on cuda:0,
shared (data_ptr) from the kernels' output to the appsink, no device-to-host
copy beyond the kernels' own (torch.profiler, against the same chains
without the recording stages), B4 and B2 launches = frames, L1 launches =
100 ms frames (added to their counts); 8 frames through rsfilesink /
rsfilesrc and the compress, brotli and sodium round trips, bit-equal, one
device-to-host copy a buffer; card against CPU (4 frames, 6 s); frames per
second against appsrc ! hsvfilter ! colorlut ! appsink, the host ms a frame
the recording stages add, the busy share.
5k' (ROADMAP C.1) reads YOLOX-x with precision=bf16 stage by stage (stem and
dark2, dark3-dark5, the FPN/PAN convs and C3s, the head's convs, the
scores) in f32 and bf16 on the card and on the CPU: a stage where the card's
bf16 drift outgrows the CPU's by more than 2x fails, and the whole net's
bf16 scores, card against CPU, are held to a fixed gate that three planted
one-layer faults must break.
4m/5m/6m live captioning recorded to fragmented MP4: the spoken sentence
of tests/test_asr_quality.py (F32 16 kHz, 100 ms buffers on the card) into
transcriberbin (builtin asr-lite, 4 s chunks, pop-on captions: T1), beside
150 seeded 1080p RGBA frames through appsrc ! hsvfilter hue-shift=120 !
colorlut approx (B4, B2) into its video pad; src_video ! cea608overlay !
cmafmux and src_audio ! cmafmux (one track a file), 1 s fragments; the
captions decode to both words, the overlay changes pixels only inside its
caption boxes, the files (parsed by the port's mux/reader.py) hold an uncv
1920x1080 track and an fpcm 16 kHz track, one sample a frame and a buffer
with their decode times and durations, equal to the overlay's output, every
payload on cuda:0 up to the muxers and exactly one Memcpy DtoH a frame and a
buffer there beyond the graded chain's and the transcriber's own; card
against CPU at 6 frames (pairs, boxes outside mdat, 1 LSB, audio bit-equal);
frames per second against the graded chain into an appsink, the host ms a
frame the captioning stages add, device ms and ops a frame, the busy share
and the muxers' read-back rate.
4n/5n/6n the ONVIF camera: 60 seeded 640x640 RGB frames at 30/1 on cuda:0
through appsrc ! yoloxinference (YOLOX-tiny, engine=fast, f32: B1) !
yoloxtensordec ! relationmeta2onvifmeta ! onvifmetadataextractor, whose XML
goes onvifmetadatapay ! rtpsend ! rtprecv (RTCP both ways) !
onvifmetadatadepay ! onvifmetadataparse into onvifmetadatacombiner, which
takes the frames through a queue, then onvifmeta2relationmeta !
onvifmetadataoverlay ! appsink; beside it 60 buffers of 20 ms S16 8 kHz
through mulawenc ! rtppcmupay2 ! rtpsend ! rtprecv ! rtppcmudepay2 !
mulawdec; the XML that came back carries each frame's detections, every
frame stays on cuda:0 to the appsink, the overlay changes exactly the box
edges, B1 launches = 60 (added to its count), the ONVIF stages add no
device-to-host copy (torch.profiler, against appsrc ! yoloxinference !
yoloxtensordec ! appsink), the audio one a buffer at the payloader and
decodes bit-equal to the plain G.711 round trip; card against CPU (3
frames: detections within YOLOX's gates, yolox-out within CPU_TOL; from the
same relation metas equal XML, RTP packets and frames; the audio's packets
and samples equal); frames per second against the plain YOLOX stream, the
host ms a frame the ONVIF stages add, the busy share, the audio's buffers
per second.
Prints a JSON line of the kernels, the card's name and power limit, then,
last, {"ok": true, "device": ...}.  It imports nothing of JAX and nothing of
the JAX package.
"""
from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
PEAK_F32 = 67e12      # FLOP/s, CUDA cores: the kernel's f32 path may not use TF32
PEAK_F64 = 34e12      # FLOP/s, CUDA cores
PEAK_BF16 = 989e12    # FLOP/s, tensor cores
PEAK_BYTES = 3.35e12  # B/s, HBM3

SIZE = 640
C3_PREFIX = "backbone.backbone.dark2.c3"
F32_TOL = 1e-4        # kernel vs plain, max abs error over the output's scale
BF16_TOL = 0.05       # kernel vs plain, |d| / (|ref| + 0.1)
CPU_TOL = 1e-3        # card vs CPU, |d| / (|ref| + 1e-2), the engine's gate
C3_TILE_SWEEP = (6, 8, 10, 12, 14, 16, 20)  # B1 tile sides timed in phase 3

# The per-pixel effects: 1080p frames and a 33^3 grade (written by write_grade).
HD_H, HD_W = 1080, 1920
LUT_SIZE = 33
SWEEP_FRAMES = 8             # B2/B3 also at 8 frames of 1080p ...
SWEEP_RANKS = (16, 64, 128)  # ... over these ranks, with synthetic factors
EFFECT_FRAMES = 8            # frames per effects pipeline in phase 4
TIMING_FRAMES = 64           # ... and in phase 6
HSV_PROPS = "hue-shift=30 saturation-mul=1.2 value-off=0.02"
HSV_PARAMS = [30.0, 1.2, 0.0, 1.0, 0.02]  # the same, as the kernel's params
LSB_TOL = 1                  # u8 LSBs: kernel vs plain, card vs CPU
EFFECT_F32_TOL = 1e-5        # raw f32 outputs and B4 planes, kernel vs plain
# colorlut approx vs the exact grade, a sanity gate: the fit's node error
# (<= 2 LSB) and the final rounding (1 LSB) are the documented 3 LSB, but the
# bf16 rounding of the factors and hat weights comes on top (5 LSB seen on
# random 1080p frames, on the card and on the CPU alike)
APPROX_TOL = 8
# lut3d_apply_mxu (B5) vs the exact grade: the bf16 table rounds entries
# near 1.0 to steps of 2^-8, and the bf16 row weights add their own
# rounding, so a 1080p frame reads 2 LSB (PERF.md section 7); the JAX
# docstring's "<= 1 LSB" holds on small frames only
MXU_EXACT_TOL = 2
# f32 operations per pixel (selects and integer work not counted): B2/B3 per
# rank: 3 x (2 products + 1 sum) for u, v, w, 2 products, 3 x (product +
# sum) into r, g, b; B4 and B5 counted from their sources; B5's packed
# entries add per channel 6 for the grid coordinate (reciprocal product,
# scale, offset, two clamps, * (S-1)) and 4 for the rounding (two clamps,
# * maxval, rint).
LOWRANK_OPS_PER_RANK = 17
HSV_OPS = 45
MXU_OPS = 88
MXU_PACKED_OPS = MXU_OPS + 3 * (6 + 4)


def phase(name):
    print(f"== {name}", flush=True)


# Cycles the card spins before each timed call (~1 ms): the host enqueues
# the start event, fn's launches and the end event while the card is busy,
# so the events time the device work of fn, not the host's time to launch it
# (which is most of a sub-0.1 ms kernel's single-launch time otherwise).
SPIN_CYCLES = 2_000_000


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, each run timed by events
    behind a spin of the card (an eager fn that launches faster than the
    card runs is timed as device time; one that launches slower, as the
    host's launch time)."""
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


def card() -> str:
    phase("1 card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return line


def build():
    phase("2 build")
    from gst_plugins_rs_tpu_torch.utils.build import build_all

    t0 = time.perf_counter()
    secs = build_all(verbose=True)
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")


def tiny_model(dev):
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights

    return init_weights(Yolox.from_variant("tiny"), seed=0).to(dev)


# B1's bound counts the compact work (the original convs in the normal
# domain): the TPU kernel's dense s2d products are three quarters zero
# blocks, so a count of them is four times the work the function needs.
def c3_bound(B, H, W, C, h, n, dtype, dense=False):
    """(ms, 'operations'|'bytes', flop, bytes) for one fused C3 call on an
    s2d input [B,H,W,4C]: the compact products over the 4HW normal-domain
    pixels, each input read once and the output written once; with
    dense=True the TPU kernel's dense s2d products over HW pixels."""
    P = B * 4 * H * W
    if dense:
        P, C, h = B * H * W, 4 * C, 4 * h
    wmacs = 2 * C * h + n * h * h + 9 * n * h * h + 2 * h * C
    flop = 2 * P * wmacs
    isz = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * P * C * isz + wmacs * isz + (2 * h + 2 * n * h + C) * 4
    t_ops = flop / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flop, nbytes


def rel_err(got, ref):
    return float(((got.float() - ref).abs() / (ref.abs() + 0.1)).max())


def kernels(card_line):
    """Phase 3: yolox_c3 against its plain version at the main path's
    shapes (dark2 of YOLOX-tiny at 640: s2d [B,80,80,192], compact C=48,
    h=24, n=1), timed beside both cuDNN chains, then over tile sides."""
    phase("3 kernels against their plain versions")
    from gst_plugins_rs_tpu_torch.models.yolox_fast import (
        _c3_compact_weights, _c3_normal, _c3_normal_weights, _c3_s2d, _c3_s2d_weights, _prep)
    from gst_plugins_rs_tpu_torch.ops import yolox_c3

    dev = torch.device("cuda")
    state = tiny_model(dev).state_dict()
    n = 1
    compact = _c3_compact_weights(state, C3_PREFIX, n)
    per_conv = {"normal": (_c3_normal, _c3_normal_weights(state, C3_PREFIX, n)),
                "s2d": (_c3_s2d, _c3_s2d_weights(state, C3_PREFIX, n))}
    gen = torch.Generator(device=dev).manual_seed(0)
    cases, inputs = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        ops = {k: v.to(dtype=torch.float32 if k[0] == "b" else dtype).contiguous()
               for k, v in compact.items()}
        chains = {k: (fn, {c: _prep(W, b, dtype, dev) for c, (W, b) in w.items()})
                  for k, (fn, w) in per_conv.items()}
        name = "f32" if dtype == torch.float32 else "bf16"
        for B in (1, 8):
            # dark2's conv output feeds the C3: SiLU activations, ~N(0,1) pre-activation
            y = torch.nn.functional.silu(
                torch.randn(B, SIZE // 8, SIZE // 8, 192, generator=gen, device=dev)).to(dtype)
            H, Wd, C, h = y.shape[1], y.shape[2], y.shape[3] // 4, ops["W1"].shape[1]
            inputs[name, B] = (y, ops)
            got = yolox_c3.c3_s2d_fused_compact(y, **ops, width=Wd, n=n)
            torch.cuda.synchronize()
            ref = yolox_c3.c3_s2d_fused_plain(y, **ops, width=Wd, n=n).float()
            g = got.float()
            if not torch.isfinite(g).all():
                raise AssertionError(f"yolox_c3 {dtype} B={B}: non-finite output")
            max_abs = float((g - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            rel = rel_err(g, ref)
            chain_rel = {k: rel_err(conv_chain_c3(*c, y, n), ref) for k, c in chains.items()}
            ok = (max_abs / scale <= F32_TOL) if dtype == torch.float32 else (rel < BF16_TOL)
            print(f"yolox_c3 {name} B={B}: max_abs_err {max_abs:.3e} (scale {scale:.3f}), "
                  f"rel {rel:.3e}; cuDNN chains vs plain rel: normal-domain "
                  f"{chain_rel['normal']:.3e}, s2d {chain_rel['s2d']:.3e}")
            if not ok:
                raise AssertionError(f"yolox_c3 {name} B={B} disagrees with its plain version")
            ms = cuda_ms(lambda: yolox_c3.c3_s2d_fused_compact(y, **ops, width=Wd, n=n))
            plain_ms = cuda_ms(lambda: yolox_c3.c3_s2d_fused_plain(y, **ops, width=Wd, n=n),
                               iters=10)
            library_ms = cuda_ms(lambda: conv_chain_c3(*chains["normal"], y, n))
            s2d_chain_ms = cuda_ms(lambda: conv_chain_c3(*chains["s2d"], y, n))
            bound_ms, bound_by, flop, nbytes = c3_bound(B, H, Wd, C, h, n, dtype)
            dense_ms, dense_by, dense_flop, _ = c3_bound(B, H, Wd, C, h, n, dtype, dense=True)
            cases.append(dict(dtype=name, batch=B, ms=ms, plain_ms=plain_ms,
                              library_ms=library_ms, s2d_chain_ms=s2d_chain_ms,
                              bound_ms=bound_ms, bound_by=bound_by, dense_bound_ms=dense_ms,
                              max_abs_err=max_abs, rel_err=rel, flop=flop, bytes=nbytes))
            print(f"yolox_c3 {name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"normal-domain cuDNN chain {library_ms:.4f} ms, s2d cuDNN chain "
                  f"{s2d_chain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB; s2d dense {dense_ms:.4f} ms, "
                  f"{dense_flop / 1e9:.3f} GFLOP) [{card_line}]")
    # the path's tile side (the first of yolox_c3._TILES) against its
    # neighbours, at both batches: the kernel takes each as the only choice
    path_tiles = yolox_c3._TILES
    try:
        for (name, B), (y, ops) in inputs.items():
            times = {}
            for ts in C3_TILE_SWEEP:
                yolox_c3._TILES = (ts,)
                times[ts] = cuda_ms(lambda: yolox_c3.c3_s2d_fused_compact(
                    y, **ops, width=y.shape[2], n=n))
            print(f"yolox_c3 {name} B={B} by tile side: "
                  + ", ".join(f"{ts}: {ms:.4f} ms" for ts, ms in times.items())
                  + f" (the path takes {path_tiles[0]}) [{card_line}]")
    finally:
        yolox_c3._TILES = path_tiles
    print('kernels: ["yolox_c3"]')
    return cases


def conv_chain_c3(chain, weights, y, n):
    """The library yardsticks of B1, one cuDNN conv per layer, TF32 off:
    `_c3_normal` runs the original convs in the normal domain (un_s2d, 5
    convs at n=1, s2d), `_c3_s2d` the dense s2d convs (the unfused engine's
    path).  The port never calls either in B1's place."""
    from gst_plugins_rs_tpu_torch import no_tf32

    with torch.no_grad(), no_tf32():
        return chain(weights, y, n)


def _tensor_meta(buf):
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import TensorMeta

    ts = [t for m in buf.iter_meta(TensorMeta) for t in m.tensors if t.id == "yolox-out"]
    if len(ts) != 1:
        raise AssertionError(f"expected one yolox-out tensor, got {len(ts)}")
    return ts[0]


def _check_outputs(samples, n_frames):
    """Every buffer carries a finite [1,8400,85] yolox-out tensor on cuda
    and an AnalyticsRelationMeta; returns the number of distinct forward
    passes (batched tensors share one storage)."""
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import AnalyticsRelationMeta

    if len(samples) != n_frames:
        raise AssertionError(f"expected {n_frames} buffers, got {len(samples)}")
    storages = set()
    for s in samples:
        t = _tensor_meta(s.buffer)
        if tuple(t.dims) != (1, 8400, 85) or tuple(t.data.shape) != (1, 8400, 85):
            raise AssertionError(f"yolox-out dims {t.dims}, shape {tuple(t.data.shape)}")
        if t.data.device.type != "cuda":
            raise AssertionError(f"yolox-out lies on {t.data.device}")
        if not torch.isfinite(t.data).all():
            raise AssertionError("yolox-out holds non-finite values")
        if s.buffer.get_meta(AnalyticsRelationMeta) is None:
            raise AssertionError("yoloxtensordec attached no AnalyticsRelationMeta")
        storages.add(t.data.untyped_storage().data_ptr())
    return len(storages)


def single_stream(engine: str, frames: int):
    import gst_plugins_rs_tpu_torch as g

    p = g.parse_launch(
        f"videotestsrc pattern=smpte num-buffers={frames} "
        f"! video/x-raw,format=RGB,width={SIZE},height={SIZE} "
        f"! yoloxinference engine={engine} ! yoloxtensordec ! appsink name=sink")
    p.play_until_eos()
    return p.by_name("sink").samples


def multi_stream(n_streams: int, frames: int, engine: str = "fast", props: str = ""):
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import element_factory_make

    patterns = ["smpte", "checkers-8", "gradient", "red", "green", "blue", "white", "black"]
    # one frame per stream per window: batch-duration = one frame at 30/1
    launch = []
    for i in range(n_streams):
        launch.append(
            f"videotestsrc pattern={patterns[i % len(patterns)]} num-buffers={frames} "
            f"! video/x-raw,format=RGB,width={SIZE},height={SIZE},framerate=30/1 "
            + ("! analyticscombiner name=comb batch-duration=33333333 "
               f"! yoloxinference engine={engine} {props} ! analyticssplitter name=split"
               if i == 0 else "! comb."))
    p = g.parse_launch(" ".join(launch))
    split = p.by_name("split")
    sinks = []
    for i in range(n_streams):
        dec = element_factory_make("yoloxtensordec", f"dec{i}")
        sink = element_factory_make("appsink", f"out{i}")
        p.add(dec, sink)
        split._get_src(i).link(dec.sinkpad)
        dec.link(sink)
        sinks.append(sink)
    p.play_until_eos()
    return [s.samples for s in sinks]


def pipelines():
    phase("4 pipelines on the card")
    from gst_plugins_rs_tpu_torch.ops import yolox_c3

    launches = 0
    for engine in ("fast", "fast-bf16"):
        yolox_c3.launches = 0
        samples = single_stream(engine, 8)
        torch.cuda.synchronize()
        counted = yolox_c3.launches
        forwards = _check_outputs(samples, 8)
        print(f"single stream engine={engine}: {len(samples)} buffers, {forwards} forward "
              f"passes, yolox_c3 launches {counted}")
        if counted != forwards or forwards != 8:
            raise AssertionError("yolox_c3 launches != forward passes")
        launches += counted
    n_streams, frames = 4, 8
    yolox_c3.launches = 0
    per_stream = multi_stream(n_streams, frames)
    torch.cuda.synchronize()
    counted = yolox_c3.launches
    forwards = len(set().union(*[
        {_tensor_meta(s.buffer).data.untyped_storage().data_ptr() for s in samples}
        for samples in per_stream]))
    for samples in per_stream:
        _check_outputs(samples, frames)
    for i in range(frames):
        batch = {_tensor_meta(samples[i].buffer).data.untyped_storage().data_ptr()
                 for samples in per_stream}
        if len(batch) != 1:
            raise AssertionError(f"frame {i} of the {n_streams} streams was not one batch")
    print(f"{n_streams} streams through analyticscombiner: {forwards} batched forward passes "
          f"of {n_streams} frames, yolox_c3 launches {counted}")
    if counted != forwards or forwards != frames:
        raise AssertionError("yolox_c3 launches != forward passes")
    return launches + counted


def card_vs_cpu():
    """One frame through apply_fast on the card (dark2's C3 by kernel B1)
    against the same path on the CPU (B1's plain version), gated; the
    per-conv path (no B1) on both devices is printed beside it."""
    phase("5 card against CPU")
    from gst_plugins_rs_tpu_torch.models.yolox_fast import apply_fast

    cpu_model = tiny_model(torch.device("cpu"))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, SIZE, SIZE, 3)).astype(np.uint8))
    out = {}
    for fuse in (True, False):
        ref = apply_fast(cpu_model, cpu_model.state_dict(), x, fuse_c3=fuse)
        got = apply_fast(gpu_model, gpu_model.state_dict(), x.cuda(), fuse_c3=fuse).cpu()
        if got.shape != (1, 8400, 85) or not torch.isfinite(got).all():
            raise AssertionError(f"card output {tuple(got.shape)} not finite [1,8400,85]")
        r = (ref - got).abs() / (ref.abs() + 1e-2)
        at = int(r.argmax())
        out[fuse] = (float(r.max()), at, float(ref.flatten()[at]), float((ref - got).abs().max()))
    rel, at, val, max_abs = out[True]
    print(f"apply_fast f32, card (fused C3 kernel) vs CPU (the same path, B1's plain version): "
          f"max rel {rel:.3e} at output {at} (value {val:.4g}), max abs {max_abs:.3e} "
          f"(gate {CPU_TOL}); per-conv C3 (no B1), card vs CPU: max rel {out[False][0]:.3e} at "
          f"output {out[False][1]} (value {out[False][2]:.4g}), max abs {out[False][3]:.3e}")
    if not rel < CPU_TOL:
        raise AssertionError("card and CPU disagree")


def timing(card_line):
    phase("6 timing")
    from gst_plugins_rs_tpu_torch.models.yolox_fast import FastEngine

    model = tiny_model(torch.device("cuda"))
    state = model.state_dict()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for label, s2d_dtype, fuse in (("fast", None, True), ("fast-bf16", torch.bfloat16, True),
                                   ("fast, per-conv cuDNN C3", None, False)):
        engine = FastEngine(model, state, s2d_dtype=s2d_dtype, fuse_c3=fuse,
                            device=torch.device("cuda"))
        for B in (1, 8):
            x = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=gen, device="cuda",
                              dtype=torch.uint8)
            ms = cuda_ms(lambda: engine(x), iters=10)
            print(f"apply_fast engine={label} B={B}: {ms:.3f} ms per forward, "
                  f"{B * 1e3 / ms:.1f} frames/s [{card_line}]")
    for label, run, frames in (
            ("single stream engine=fast", lambda: single_stream("fast", 64), 64),
            ("single stream engine=fast-bf16", lambda: single_stream("fast-bf16", 64), 64),
            ("4 streams batched engine=fast", lambda: multi_stream(4, 16), 64)):
        run()  # warm-up: weights, cuDNN plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"pipeline {label}, 640x640: {frames} frames in {secs:.3f} s, "
              f"{frames / secs:.1f} frames/s end to end [{card_line}]")


def bound(flop, nbytes):
    """(ms, 'operations'|'bytes'): the larger of the f32 operations over the
    CUDA cores' peak and the bytes over the memory rate."""
    t_ops, t_bytes = flop / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def write_grade() -> Path:
    """The .cube the effects pipelines load: a 33^3 saturation-and-tint grade
    (5% saturation boost, +0.01 green, +0.02 blue, clipped), the form of
    tests/test_colorlut.py's grade, mild enough to fit at rank 16 in about a
    second.  Written next to the kernel builds (git-ignored)."""
    from gst_plugins_rs_tpu_torch.utils.build import BUILD_DIR

    g = np.linspace(0, 1, LUT_SIZE)
    Bz, Gy, Rx = np.meshgrid(g, g, g, indexing="ij")
    Y = 0.299 * Rx + 0.587 * Gy + 0.114 * Bz
    table = np.stack([np.clip(Y + 1.05 * (Rx - Y), 0, 1),
                      np.clip(Y + 1.05 * (Gy - Y) + 0.01, 0, 1),
                      np.clip(Y + 1.05 * (Bz - Y) + 0.02, 0, 1)], -1).reshape(-1, 3)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "smoke_grade33.cube"
    path.write_text(f'TITLE "smoke grade"\nLUT_3D_SIZE {LUT_SIZE}\n'
                    + "\n".join(f"{r:.6f} {gg:.6f} {b:.6f}" for r, gg, b in table) + "\n")
    return path


def hd_frame(seed: int) -> np.ndarray:
    """A seeded random 1080p RGBA u8 frame (no two neighbours alike: the
    hardest case for the kernels' caches and shared-memory banks)."""
    return np.random.RandomState(seed).randint(0, 256, (HD_H, HD_W, 4)).astype(np.uint8)


def synthetic_factors(K, seed, dev):
    """CP factors in the kernel layout at rank K: ut/vt/wt [K,48] with rows
    >= 33 zero, c [8,K] with rows >= 3 zero, outputs mostly inside [0,1]."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(3):
        f = np.zeros((K, 48), np.float32)
        f[:, :LUT_SIZE] = rng.uniform(0.0, 1.0, (K, LUT_SIZE))
        ops.append(f)
    c = np.zeros((8, K), np.float32)
    c[:3] = rng.uniform(0.0, 8.0 / K, (3, K))
    return [torch.from_numpy(a).to(dev) for a in ops + [c]]


def lut_grid(xyz, S):
    """grid_sample's grid for grid coordinates xyz [3,P] in [0,S-1]:
    [1,1,1,P,3] as (x,y,z) in [-1,1] (align_corners=True)."""
    return (xyz.t() * (2.0 / (S - 1)) - 1.0).reshape(1, 1, 1, -1, 3).contiguous()


def grid_sample_lut(lut5, grid):
    """The library yardstick of B2, B3 and B5: trilinear sampling of the
    5-D LUT [1,3,S,S,S] (c, z, y, x) in f32 in one PyTorch call.  It leaves
    out the kernels' normalisation, rounding and packing (B2), the bf16
    rounding of weights and factors, and the low-rank sum (it samples a
    dense table).  The port never calls it."""
    return torch.nn.functional.grid_sample(lut5, grid, mode="bilinear", padding_mode="border",
                                           align_corners=True)


def hd_frame16(seed: int) -> np.ndarray:
    """A seeded random 1080p RGBA64 frame (4 x u16), as hd_frame."""
    return np.random.RandomState(seed).randint(0, 65536, (HD_H, HD_W, 4)).astype(np.uint16)


MXU_DOMAIN = ([1.0] * 3, [0.0] * 3)  # lut3d_apply_mxu's scale and offset: the grade's domain


def mxu_frames(n):
    """The n seeded 1080p RGBA frames lut3d_apply_mxu grades in phases 4b
    and 6b, on the card."""
    return [torch.from_numpy(hd_frame(100 + i)).to("cuda") for i in range(n)]


def random_px64(P, gen, dev):
    """P random RGBA64 pixels as int64 bit patterns (4 x u16, R low)."""
    return torch.randint(0, 65536, (P, 4), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint16).view(torch.int64).reshape(P)


def packed_coords(px, bits, scale, offset, S):
    """The element's grid coordinates [3,P] of packed pixels (int32 RGBA or
    int64 RGBA64), computed by torch: B3's input on the same pixels."""
    from gst_plugins_rs_tpu_torch.ops.colorlut import grid_coord

    lanes = px.view(torch.uint8 if bits == 8 else torch.uint16).reshape(-1, 4).to(torch.int32)
    return torch.stack([grid_coord(lanes, c, scale[c], offset[c], S, float(2**bits - 1))
                        for c in range(3)]).contiguous()


def repack(q, px, bits):
    """Quantized outputs q [3,P] repacked with px's alpha, as B2 and
    packed64 pack them."""
    q = q.to(px.dtype)
    return (q[0] | (q[1] << bits) | (q[2] << 2 * bits)
            | torch.bitwise_and(px, -(1 << 3 * bits)))


def max_lane_err(a, b, bits):
    lane = torch.uint8 if bits == 8 else torch.uint16
    return int((a.view(lane).int() - b.view(lane).int()).abs().max())


def effect_kernels(card_line, grade):
    """Phase 3 for B2-B5: each kernel against its plain version, timed.
    Returns the cases per kernel and the grade's packed factors."""
    phase("3b effect kernels against their plain versions")
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
    from gst_plugins_rs_tpu_torch.ops import hsv_planes
    from gst_plugins_rs_tpu_torch.ops.colorlut import CubeLut, quantize
    from gst_plugins_rs_tpu_torch.ops.colorlut_lowrank import fit_lowrank
    from gst_plugins_rs_tpu_torch.ops.hsv import quantize_u8
    from gst_plugins_rs_tpu_torch.ops.pixels import to_unit

    dev, S = torch.device("cuda"), LUT_SIZE
    lut = CubeLut.parse_file(str(grade))
    scale = [float(v) for v in lut.domain_scale]
    offset = [float(v) for v in lut.domain_offset]
    t0 = time.perf_counter()
    fit = fit_lowrank(lut.table, S, tolerance=2.0 / 255.0)
    if fit is None:
        raise AssertionError("the smoke grade does not factor within 2 LSB")
    path_ops = [torch.from_numpy(a).to(dev)
                for a in lowrank.pack_factors(fit.U, fit.V, fit.W, fit.C)]
    print(f"grade {S}^3 fits at rank {fit.U.shape[1]} (Kp {path_ops[0].shape[0]}), max node "
          f"error {fit.max_node_err * 255:.3f} LSB, in {time.perf_counter() - t0:.2f} s")
    frame = torch.from_numpy(hd_frame(0)).to(dev)
    frame_px = frame.view(torch.int32).reshape(-1)
    frame_px64 = torch.from_numpy(hd_frame16(0)).to(dev).view(torch.int64).reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(0)
    P8 = SWEEP_FRAMES * HD_H * HD_W
    sweep_px = torch.randint(-2**31, 2**31 - 1, (P8,), generator=gen, device=dev,
                             dtype=torch.int32)
    sweep_px64 = random_px64(P8, gen, dev)
    params = {8: torch.tensor(scale + offset + [255.0, 0.0], dtype=torch.float32, device=dev),
              16: torch.tensor(scale + offset + [65535.0, 0.0], dtype=torch.float32,
                               device=dev)}
    b2, b3, b64 = [], [], []
    runs = [("path: 1 frame, the grade's factors", frame_px, frame_px64, path_ops)]
    runs += [(f"{SWEEP_FRAMES} frames, rank {k}", sweep_px, sweep_px64,
              synthetic_factors(k, k, dev)) for k in SWEEP_RANKS]
    f32_runs = []
    for i, (label, px, px64, ops) in enumerate(runs):
        P, K = px.numel(), ops[0].shape[0]
        xyz, xyz16 = packed_coords(px, 8, scale, offset, S), packed_coords(px64, 16, scale,
                                                                          offset, S)
        got2 = lowrank.lowrank_sample_packed(px, params[8], *ops, size=S)
        got3 = lowrank.lowrank_sample_fused(xyz, *ops)
        got64 = lowrank.lowrank_sample_packed64(px64, params[16], *ops, size=S)
        got3_16 = lowrank.lowrank_sample_fused(xyz16, *ops)
        torch.cuda.synchronize()
        ref2 = lowrank.lowrank_sample_packed_plain(px, params[8], *ops, size=S)
        ref3 = lowrank.lowrank_sample_fused_plain(xyz, *ops)
        ref64 = lowrank.lowrank_sample_packed_plain(px64, params[16], *ops, size=S, bits=16)
        err2, err64 = max_lane_err(got2, ref2, 8), max_lane_err(got64, ref64, 16)
        err3 = float((got3 - ref3).abs().max())
        same = torch.equal(repack(quantize(got3, 255.0), px, 8), got2)
        same64 = torch.equal(repack(quantize(got3_16, 65535.0), px64, 16), got64)
        exact = torch.equal(got2, ref2) and torch.equal(got3, ref3) and torch.equal(got64, ref64)
        # the yardstick samples the dense reconstruction of the same factors
        U, V, W = (f[:, :S].t() for f in ops[:3])
        lut5 = torch.einsum("zk,yk,xk,ck->czyx", W, V, U, ops[3][:3])[None].contiguous()
        grid, grid16 = lut_grid(xyz, S), lut_grid(xyz16, S)
        print(f"B2/B3 {label}: P={P}, K={K}: B2 max err {err2} LSB, B3 max abs err {err3:.3e}, "
              f"packed64 max err {err64} u16 LSB; all bit-equal to plain: {exact}; B2 == B3 "
              f"bit for bit: {same}; packed64 == quantize(B3): {same64}")
        if not (exact and same and same64):
            raise AssertionError(f"B2/B3/packed64 {label} disagree with their plain versions "
                                 f"or each other")
        if i > 0:  # the sweep
            f32_runs.append((K, px, px64, xyz, ops))
        flop = LOWRANK_OPS_PER_RANK * K * P
        factor_bytes = 4 * (3 * K * 48 + 8 * K)
        for out, name, fn, plain, g, nbytes, err in (
                (b2, "B2 colorlut_lowrank_packed",
                 lambda: lowrank.lowrank_sample_packed(px, params[8], *ops, size=S),
                 lambda: lowrank.lowrank_sample_packed_plain(px, params[8], *ops, size=S),
                 grid, 8 * P + factor_bytes + 32, err2),
                (b3, "B3 colorlut_lowrank_fused",
                 lambda: lowrank.lowrank_sample_fused(xyz, *ops),
                 lambda: lowrank.lowrank_sample_fused_plain(xyz, *ops),
                 grid, 24 * P + factor_bytes, err3),
                (b64, "B3 packed64 colorlut_lowrank_packed64",
                 lambda: lowrank.lowrank_sample_packed64(px64, params[16], *ops, size=S),
                 lambda: lowrank.lowrank_sample_packed_plain(px64, params[16], *ops, size=S,
                                                             bits=16),
                 grid16, 16 * P + factor_bytes + 32, err64)):
            ms = cuda_ms(fn)
            plain_ms = cuda_ms(plain, iters=2, warmup=1)
            library_ms = cuda_ms(lambda: grid_sample_lut(lut5, g))
            bound_ms, bound_by = bound(flop, nbytes)
            # -fmad=false: 17 separate f32 instructions a rank, at half the
            # peak that counts an FMA as two operations
            ceiling_ms = 2 * flop / PEAK_F32 * 1e3
            out.append(dict(case=label, P=P, K=K, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, no_fma_ceiling_ms=ceiling_ms,
                            max_abs_err=err, flop=flop, bytes=nbytes))
            print(f"{name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, grid_sample "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{flop / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB), -fmad=false ceiling "
                  f"{ceiling_ms:.4f} ms [{card_line}]")
        del xyz16, grid, grid16, got3_16
    b2[0]["float32"] = lowrank_f32(card_line, f32_runs, params, S)
    del f32_runs

    # B4 at [1080, 1920], the hsvfilter element's planes
    P = HD_H * HD_W
    planes = [to_unit(frame[..., c], 255.0).contiguous() for c in range(3)]
    hp = torch.tensor(HSV_PARAMS, dtype=torch.float32, device=dev)
    got = hsv_planes.hsv_filter_planes(*planes, hp)
    torch.cuda.synchronize()
    ref = hsv_planes.hsv_filter_planes_plain(*planes, hp)
    err4 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    lsb4 = max(int((quantize_u8(g).int() - quantize_u8(r).int()).abs().max())
               for g, r in zip(got, ref))
    print(f"B4 hsv_planes [{HD_H},{HD_W}]: max abs err {err4:.3e}, {lsb4} LSB after quantization")
    if err4 > EFFECT_F32_TOL or lsb4 > LSB_TOL:
        raise AssertionError("B4 disagrees with its plain version")
    flop, nbytes = HSV_OPS * P, 24 * P + 20
    bound_ms, bound_by = bound(flop, nbytes)
    b4 = [dict(case="[1080,1920]", P=P, ms=cuda_ms(lambda: hsv_planes.hsv_filter_planes(*planes, hp)),
               plain_ms=cuda_ms(lambda: hsv_planes.hsv_filter_planes_plain(*planes, hp)),
               library_ms=None, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err4,
               flop=flop, bytes=nbytes)]
    print(f"B4 hsv_planes: kernel {b4[0]['ms']:.4f} ms, plain {b4[0]['plain_ms']:.4f} ms, "
          f"library none, bound {bound_ms:.4f} ms ({bound_by}) [{card_line}]")

    return {"colorlut_lowrank_packed": b2, "colorlut_lowrank_fused": b3,
            "colorlut_lowrank_packed64": b64, "hsv_planes": b4,
            **mxu_kernels(card_line, lut, scale, offset, frame_px, frame_px64, params)}, path_ops


def mxu_kernels(card_line, lut, scale, offset, px, px64, params):
    """Phase 3b for B5 at 1080p with the 33^3 grade: the TPU signature on
    the RGBA frame's grid coordinates, and the packed entries on the RGBA
    and RGBA64 frames, each bit-equal to its plain version, the packed
    entries also to quantize-and-repack of the TPU signature's output;
    each timed beside its plain version, grid_sample and its bound."""
    from gst_plugins_rs_tpu_torch.ops import colorlut_mxu
    from gst_plugins_rs_tpu_torch.ops.colorlut import quantize

    dev, S = torch.device("cuda"), LUT_SIZE
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(lut.table, S)).to(dev, torch.bfloat16)
    lut5 = torch.from_numpy(lut.table.reshape(S, S, S, 3)).to(dev).permute(3, 0, 1, 2)[None]
    lut5 = lut5.contiguous()
    out = {}
    xyz = packed_coords(px, 8, scale, offset, S)
    pos = list(xyz)  # rows of a contiguous [3, P]
    P = px.numel()
    got = colorlut_mxu.lut3d_positions_mxu(*pos, t2, size=S)
    torch.cuda.synchronize()
    ref = colorlut_mxu.lut3d_positions_mxu_plain(*pos, t2, size=S)
    err5 = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    same5 = all(torch.equal(g, r) for g, r in zip(got, ref))
    print(f"B5 colorlut_mxu 1080p S={S}: max abs err {err5:.3e}, bit-equal to plain: {same5}")
    if not same5:
        raise AssertionError("B5 disagrees with its plain version")
    flop, nbytes = MXU_OPS * P, 24 * P + 2 * t2.numel()
    bound_ms, bound_by = bound(flop, nbytes)
    grid = lut_grid(xyz, S)
    out["colorlut_mxu"] = [dict(
        case="1080p, S=33", P=P, ms=cuda_ms(lambda: colorlut_mxu.lut3d_positions_mxu(
            *pos, t2, size=S)),
        plain_ms=cuda_ms(lambda: colorlut_mxu.lut3d_positions_mxu_plain(*pos, t2, size=S)),
        library_ms=cuda_ms(lambda: grid_sample_lut(lut5, grid)), bound_ms=bound_ms,
        bound_by=bound_by, max_abs_err=err5, flop=flop, bytes=nbytes)]
    c = out["colorlut_mxu"][0]
    print(f"B5 colorlut_mxu: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, grid_sample "
          f"{c['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) [{card_line}]")
    del got, ref, grid
    for name, entry, t, bits in (
            ("colorlut_mxu_packed", colorlut_mxu.lut3d_sample_mxu_packed, px, 8),
            ("colorlut_mxu_packed64", colorlut_mxu.lut3d_sample_mxu_packed64, px64, 16)):
        maxval = float(2**bits - 1)
        xyz = packed_coords(t, bits, scale, offset, S)
        got = entry(t, params[bits], t2, size=S)
        torch.cuda.synchronize()
        ref = colorlut_mxu.lut3d_sample_mxu_packed_plain(t, params[bits], t2, size=S, bits=bits)
        sig = repack(torch.stack([quantize(o, maxval) for o in
                                  colorlut_mxu.lut3d_positions_mxu(*xyz, t2, size=S)]), t, bits)
        err = max_lane_err(got, ref, bits)
        same, same_sig = torch.equal(got, ref), torch.equal(got, sig)
        print(f"B5 {name} 1080p S={S}: max err {err} LSB, bit-equal to plain: {same}, to "
              f"quantize(lut3d_positions_mxu): {same_sig}")
        if not (same and same_sig):
            raise AssertionError(f"B5 {name} disagrees with its plain version or with B5")
        flop, nbytes = MXU_PACKED_OPS * P, 2 * t.element_size() * P + 2 * t2.numel() + 32
        bound_ms, bound_by = bound(flop, nbytes)
        grid = lut_grid(xyz, S)
        out[name] = [dict(
            case="1080p, S=33", P=P,
            ms=cuda_ms(lambda: entry(t, params[bits], t2, size=S)),
            plain_ms=cuda_ms(lambda: colorlut_mxu.lut3d_sample_mxu_packed_plain(
                t, params[bits], t2, size=S, bits=bits)),
            library_ms=cuda_ms(lambda: grid_sample_lut(lut5, grid)), bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=err, flop=flop, bytes=nbytes)]
        c = out[name][0]
        print(f"B5 {name}: kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, grid_sample "
              f"{c['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"{nbytes / 1e6:.2f} MB) [{card_line}]")
    return out


def lowrank_f32(card_line, runs, params, S):
    """B2, B3 and packed64 at compute_dtype float32 (the public functions'
    other type; its factors are single f32 words, two loads an axis) on the
    8-frame rank sweep: each bit-equal to its plain version, and timed
    (CUDA events, median)."""
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank

    rows, kw = [], dict(compute_dtype="float32")
    for K, px, px64, xyz, ops in runs:
        cases = ((lambda: lowrank.lowrank_sample_packed(px, params[8], *ops, size=S, **kw),
                  lambda: lowrank.lowrank_sample_packed_plain(px, params[8], *ops, size=S, **kw)),
                 (lambda: lowrank.lowrank_sample_fused(xyz, *ops, **kw),
                  lambda: lowrank.lowrank_sample_fused_plain(xyz, *ops, **kw)),
                 (lambda: lowrank.lowrank_sample_packed64(px64, params[16], *ops, size=S, **kw),
                  lambda: lowrank.lowrank_sample_packed_plain(px64, params[16], *ops, size=S,
                                                              bits=16, **kw)))
        if not all(torch.equal(fn(), plain()) for fn, plain in cases):
            raise AssertionError(f"B2/B3/packed64 float32 at rank {K} differ from their plain "
                                 f"versions")
        ms = [cuda_ms(fn) for fn, _ in cases]
        plain_ms = [cuda_ms(plain, iters=2, warmup=1) for _, plain in cases]
        rows.append(dict(K=K, b2_ms=ms[0], b3_ms=ms[1], packed64_ms=ms[2],
                         b2_plain_ms=plain_ms[0], b3_plain_ms=plain_ms[1],
                         packed64_plain_ms=plain_ms[2]))
        print(f"float32 rank {K}, {SWEEP_FRAMES} frames: B2 {ms[0]:.4f} ms, B3 {ms[1]:.4f} ms, "
              f"packed64 {ms[2]:.4f} ms, bit-equal to plain; plain "
              + " / ".join(f"{t:.2f}" for t in plain_ms) + f" ms [{card_line}]")
    return rows


def effects_rgba(grade, frames):
    import gst_plugins_rs_tpu_torch as g

    return g.parse_launch(
        f"videotestsrc num-buffers={frames} "
        f"! video/x-raw,format=RGBA,width={HD_W},height={HD_H},framerate=30/1 "
        f"! colorlut location={grade} precision=approx ! hsvfilter {HSV_PROPS} "
        f"! appsink name=sink")


def effects_rgba64(grade, frames):
    import gst_plugins_rs_tpu_torch as g

    return g.parse_launch(
        f"videotestsrc num-buffers={frames} "
        f"! video/x-raw,format=RGBA64LE,width={HD_W},height={HD_H},framerate=30/1 "
        f"! colorlut location={grade} precision=approx ! appsink name=sink")


def _check_frames(samples, n, dtype, alpha):
    if len(samples) != n:
        raise AssertionError(f"expected {n} buffers, got {len(samples)}")
    for s in samples:
        d = s.buffer.data
        if not isinstance(d, torch.Tensor) or d.device.type != "cuda":
            raise AssertionError(f"output frame lies on {getattr(d, 'device', type(d))}")
        if tuple(d.shape) != (HD_H, HD_W, 4) or d.dtype != dtype:
            raise AssertionError(f"output frame {tuple(d.shape)} {d.dtype}")
        if not bool((d[..., 3].to(torch.int32) == alpha).all()):
            raise AssertionError("alpha did not pass through unchanged")


def effect_pipelines(grade, path_ops):
    """Phase 4 for the effects: each path with its counters set to 0 just
    before it and read just after.  Returns the launches per kernel."""
    phase("4b effect pipelines on the card")
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
    from gst_plugins_rs_tpu_torch.ops import colorlut_mxu, hsv_planes
    from gst_plugins_rs_tpu_torch.ops.colorlut import CubeLut

    def zero():
        lowrank.packed_launches = lowrank.packed64_launches = lowrank.fused_launches = 0
        hsv_planes.launches = 0

    def counts():
        return {"packed": lowrank.packed_launches, "packed64": lowrank.packed64_launches,
                "fused": lowrank.fused_launches, "hsv": hsv_planes.launches}

    n = EFFECT_FRAMES
    zero()
    p = effects_rgba(grade, n)
    p.play_until_eos()
    torch.cuda.synchronize()
    got = counts()
    _check_frames(p.by_name("sink").samples, n, torch.uint8, 255)
    print(f"RGBA {HD_W}x{HD_H} ! colorlut approx ! hsvfilter: {n} frames, launches {got}")
    if got != {"packed": n, "packed64": 0, "fused": 0, "hsv": n}:
        raise AssertionError("B2 and B4 launches != RGBA frames")
    launches = {"colorlut_lowrank_packed": got["packed"], "hsv_planes": got["hsv"]}

    zero()
    p = effects_rgba64(grade, n)
    p.play_until_eos()
    torch.cuda.synchronize()
    got = counts()
    _check_frames(p.by_name("sink").samples, n, torch.uint16, 65535)
    print(f"RGBA64LE {HD_W}x{HD_H} ! colorlut approx: {n} frames, launches {got}")
    if got != {"packed": 0, "packed64": n, "fused": 0, "hsv": 0}:
        raise AssertionError("packed64 launches != RGBA64LE frames")
    launches["colorlut_lowrank_packed64"] = got["packed64"]

    # B3 with its TPU signature, through its public function (the route of
    # channel layouts other than the element's), as the JAX package offers it
    lut = CubeLut.parse_file(str(grade))
    scale = [float(v) for v in lut.domain_scale]
    offset = [float(v) for v in lut.domain_offset]
    kw = dict(size=LUT_SIZE, offsets=(0, 1, 2), bits=16)
    frames = [torch.from_numpy(hd_frame16(200 + i)).to("cuda") for i in range(n)]
    zero()
    outs = [lowrank.lut3d_apply_lowrank_fused(f, *path_ops, scale, offset, **kw) for f in frames]
    torch.cuda.synchronize()
    counted = lowrank.fused_launches
    for f, o in zip(frames, outs):
        if not torch.equal(o, lowrank.lut3d_apply_lowrank_packed(f, *path_ops, scale, offset,
                                                                 **kw)):
            raise AssertionError("lut3d_apply_lowrank_fused (B3) != packed64 on RGBA64 frames")
    print(f"lut3d_apply_lowrank_fused over {n} 1080p RGBA64 frames: launches {counted}, "
          f"bit-equal to packed64")
    if counted != n:
        raise AssertionError("B3 launches != frames")
    launches["colorlut_lowrank_fused"] = counted

    # B5 through its public function, as the JAX package offers it: RGBA and
    # RGBA64LE frames take the packed entries, BGRA offsets the TPU signature
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(lut.table, LUT_SIZE)).to(
        "cuda", torch.bfloat16)
    rgba = mxu_frames(n)
    runs = (("RGBA", rgba, (0, 1, 2), 8, "colorlut_mxu_packed", "packed"),
            ("RGBA64LE", [torch.from_numpy(hd_frame16(300 + i)).to("cuda") for i in range(n)],
             (0, 1, 2), 16, "colorlut_mxu_packed64", "packed"),
            ("BGRA", [f[..., [2, 1, 0, 3]].contiguous() for f in rgba], (2, 1, 0), 8,
             "colorlut_mxu", "positions"))
    outs = {}
    for label, frames, offsets, bits, name, route in runs:
        colorlut_mxu.launches = colorlut_mxu.packed_launches = 0
        outs[label] = [colorlut_mxu.lut3d_apply_mxu(f, t2, *MXU_DOMAIN, size=LUT_SIZE,
                                                    offsets=offsets, bits=bits) for f in frames]
        torch.cuda.synchronize()
        got = {"packed": colorlut_mxu.packed_launches, "positions": colorlut_mxu.launches}
        for f, o in zip(frames, outs[label]):
            if o.device.type != "cuda" or o.shape != f.shape or o.dtype != f.dtype \
                    or not torch.equal(o[..., 3].to(torch.int32), f[..., 3].to(torch.int32)):
                raise AssertionError(f"lut3d_apply_mxu {label}: device, shape, dtype or alpha")
        print(f"lut3d_apply_mxu over {n} 1080p {label} frames: launches {got}")
        if got != {"packed": 0, "positions": 0, route: n}:
            raise AssertionError(f"B5 {label}: launches != frames on the {route} route")
        launches[name] = got[route]
    # the TPU-signature route against the CPU, and against the packed route
    t2_cpu = t2.cpu()
    for f, o, p in zip(runs[2][1], outs["BGRA"], outs["RGBA"]):
        host = colorlut_mxu.lut3d_apply_mxu(f.cpu(), t2_cpu, *MXU_DOMAIN, size=LUT_SIZE,
                                            offsets=(2, 1, 0))
        if not (torch.equal(o.cpu(), host) and torch.equal(o[..., [2, 1, 0, 3]], p)):
            raise AssertionError("lut3d_apply_mxu BGRA differs from the CPU or the RGBA route")
    print(f"lut3d_apply_mxu BGRA: equal to the CPU run and to the RGBA (packed) route on all "
          f"{n} frames")
    return launches


def _through_element(factory, props, frame, fmt, dev):
    """One frame through one element on `dev` ("cuda" or "cpu"), as numpy."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import Buffer, Caps, Fraction, Harness

    g.set_device(dev)
    try:
        elem = g.element_factory_make(factory)
        for k, v in props.items():
            elem.set_property(k, v)
        h = Harness(elem)
        h.set_src_caps(Caps.builder("video/x-raw", format=fmt, width=frame.shape[1],
                                    height=frame.shape[0], framerate=Fraction(30, 1)))
        h.push(Buffer(torch.from_numpy(frame), pts=0))
        out = h.pull().data
        if out.device.type != dev:
            raise AssertionError(f"{factory} on {dev} returned a frame on {out.device}")
        h.teardown()
        return out.cpu().numpy()
    finally:
        g.set_device("cuda")


def _lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def effects_card_vs_cpu(grade):
    phase("5b effects, card against CPU")
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
    from gst_plugins_rs_tpu_torch.ops import colorlut_mxu, hsv_planes
    from gst_plugins_rs_tpu_torch.ops.colorlut import CubeLut

    frame = hd_frame(1)
    approx = {"location": str(grade), "precision": "approx"}
    before = (lowrank.packed_launches, hsv_planes.launches)
    card = _through_element("colorlut", approx, frame, "RGBA", "cuda")
    host = _through_element("colorlut", approx, frame, "RGBA", "cpu")
    exact = _through_element("colorlut", {"location": str(grade)}, frame, "RGBA", "cuda")
    hsv_props = {"hue-shift": HSV_PARAMS[0], "saturation-mul": HSV_PARAMS[1],
                 "value-off": HSV_PARAMS[4]}
    hcard = _through_element("hsvfilter", hsv_props, frame, "RGBA", "cuda")
    hhost = _through_element("hsvfilter", hsv_props, frame, "RGBA", "cpu")
    if (lowrank.packed_launches, hsv_planes.launches) != (before[0] + 1, before[1] + 1):
        raise AssertionError("the card runs did not launch B2 and B4 once each")
    d_lut, d_exact, d_hsv = _lsb(card, host), _lsb(card[..., :3], exact[..., :3]), _lsb(hcard, hhost)
    alpha = np.array_equal(card[..., 3], frame[..., 3]) and np.array_equal(hcard[..., 3],
                                                                          frame[..., 3])
    print(f"colorlut approx 1080p, card (B2) vs CPU (plain): max {d_lut} LSB; vs exact grade: "
          f"max {d_exact} LSB (gate {APPROX_TOL}); hsvfilter card (B4) vs CPU: max {d_hsv} LSB; "
          f"alpha unchanged: {alpha}")
    lut = CubeLut.parse_file(str(grade))
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(lut.table, LUT_SIZE)).to(torch.bfloat16)
    frame16 = hd_frame16(1)
    d_mxu, d_mxu_exact = {}, {}
    # the packed route (RGBA, RGBA64), then the TPU signature's (BGRA: the
    # same pixels with R and B swapped, offsets (2, 1, 0))
    for label, f, offsets, bits in (("RGBA", frame, (0, 1, 2), 8),
                                    ("RGBA64LE", frame16, (0, 1, 2), 16),
                                    ("BGRA", frame[..., [2, 1, 0, 3]], (2, 1, 0), 8)):
        f = torch.from_numpy(np.ascontiguousarray(f))
        kw = dict(size=LUT_SIZE, offsets=offsets, bits=bits)
        mcard = colorlut_mxu.lut3d_apply_mxu(f.cuda(), t2.cuda(), *MXU_DOMAIN, **kw).cpu()
        mhost = colorlut_mxu.lut3d_apply_mxu(f, t2, *MXU_DOMAIN, **kw)
        d_mxu[label] = _lsb(mcard.numpy(), mhost.numpy())
        if bits == 8:  # the exact grade of the same pixels, in RGB order
            d_mxu_exact[label] = _lsb(mcard.numpy()[..., list(offsets)], exact[..., :3])
    print(f"lut3d_apply_mxu 1080p, card (B5) vs CPU (plain), max LSB: {d_mxu}; vs exact grade: "
          f"max {d_mxu_exact} LSB (gate {MXU_EXACT_TOL})")
    before = lowrank.packed64_launches
    card16 = _through_element("colorlut", approx, frame16, "RGBA64LE", "cuda")
    host16 = _through_element("colorlut", approx, frame16, "RGBA64LE", "cpu")
    if lowrank.packed64_launches != before + 1:
        raise AssertionError("the RGBA64LE card run did not launch packed64 once")
    d_lut16 = _lsb(card16, host16)
    alpha16 = np.array_equal(card16[..., 3], frame16[..., 3])
    print(f"colorlut approx RGBA64LE 1080p, card (packed64) vs CPU (plain): max {d_lut16} u16 "
          f"LSB; alpha unchanged: {alpha16}")
    if max(d_lut, d_hsv, d_lut16, *d_mxu.values()) > LSB_TOL or d_exact > APPROX_TOL \
            or max(d_mxu_exact.values()) > MXU_EXACT_TOL or not alpha or not alpha16:
        raise AssertionError("the effects on the card and on the CPU disagree")


def effects_timing(card_line, grade):
    phase("6b effects timing")
    from gst_plugins_rs_tpu_torch.core import State

    # device ms per frame of the RGBA64LE chain when its glue ran as torch
    # ops around B3, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section
    # 5): the yardstick of packed64, which took the glue into the kernel
    before = {"RGBA64LE colorlut approx": 0.354}
    for label, make in (("RGBA colorlut approx ! hsvfilter", effects_rgba),
                        ("RGBA64LE colorlut approx", effects_rgba64)):
        make(grade, EFFECT_FRAMES).play_until_eos()  # warm-up
        torch.cuda.synchronize()
        p = make(grade, TIMING_FRAMES)
        t0 = time.perf_counter()
        p.set_state(State.PLAYING)  # start(): parse the .cube, fit the factors
        t1 = time.perf_counter()
        p.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        p.set_state(State.NULL)
        if len(p.by_name("sink").samples) != TIMING_FRAMES:
            raise AssertionError(f"{label}: expected {TIMING_FRAMES} frames")
        print(f"pipeline {label}, {HD_W}x{HD_H}: {TIMING_FRAMES} frames in {secs:.3f} s, "
              f"{TIMING_FRAMES / secs:.1f} frames/s end to end (set-up {t1 - t0:.3f} s) "
              f"[{card_line}]")
        device_ms, upload_ms, top = profile_pipeline(lambda: make(grade, EFFECT_FRAMES))
        per_frame = device_ms / EFFECT_FRAMES
        was = f"glue in torch around B3: {before[label]} ms; " if label in before else ""
        print(f"pipeline {label}: device busy {per_frame:.4f} ms per frame ({was}torch.profiler, "
              f"{EFFECT_FRAMES} frames, host-to-device copies left out: {upload_ms:.4f} ms in "
              f"all, the source's one upload of its pattern and the per-frame parameters), "
              f"{100 * per_frame * TIMING_FRAMES / (secs * 1e3):.1f}% of the unprofiled wall "
              f"time; ms per frame by device op: "
              + ", ".join(f"{name} {ms / EFFECT_FRAMES:.4f}" for name, ms in top))
    mxu_timing(card_line, grade)


# device ms per frame of lut3d_apply_mxu on an RGBA 1080p frame when its
# glue ran as torch ops around the first B5 (the tree before the packed
# entries, timed by utils/lut_timing.py on an NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md section 5)
MXU_APPLY_BEFORE_MS = 0.3846


def mxu_timing(card_line, grade):
    """Device ms per frame of lut3d_apply_mxu over EFFECT_FRAMES 1080p
    frames (torch.profiler), on the packed route (RGBA) and on the TPU
    signature's route with its glue in torch (BGRA)."""
    from gst_plugins_rs_tpu_torch.ops import colorlut_mxu
    from gst_plugins_rs_tpu_torch.ops.colorlut import CubeLut

    lut = CubeLut.parse_file(str(grade))
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(lut.table, LUT_SIZE)).to(
        "cuda", torch.bfloat16)
    rgba = mxu_frames(EFFECT_FRAMES)
    for label, frames, offsets in (("RGBA (packed)", rgba, (0, 1, 2)),
                                   ("BGRA (TPU signature + torch glue)",
                                    [f[..., [2, 1, 0, 3]].contiguous() for f in rgba],
                                    (2, 1, 0))):
        def run():
            for f in frames:
                colorlut_mxu.lut3d_apply_mxu(f, t2, *MXU_DOMAIN, size=LUT_SIZE, offsets=offsets)

        run()  # warm-up
        device_ms, upload_ms, top = profile_device(run)
        per_frame = device_ms / EFFECT_FRAMES
        was = (f"; glue in torch around the first B5: {MXU_APPLY_BEFORE_MS} ms"
               if label.startswith("RGBA") else "")
        print(f"lut3d_apply_mxu {label} 1080p: device {per_frame:.4f} ms per frame{was} "
              f"(torch.profiler, {EFFECT_FRAMES} frames, host-to-device copies left out: "
              f"{upload_ms:.4f} ms in all); ms per frame by device op: "
              + ", ".join(f"{name} {ms / EFFECT_FRAMES:.4f}" for name, ms in top)
              + f" [{card_line}]")


# Each card-only profiling session starts and ends with PROFILE_PAD small
# kernels of their own (an xor on an int16), left out of what device_events
# returns: on the H100 machine a session lost the first or last few device
# events now and then, for tens of seconds at a time, which emptied a
# session of 8 kernels (6b's RGBA64LE chain) ten times in a row.  The pads
# take that loss.
PROFILE_PAD = 128
PAD_KERNEL = "BitwiseXorFunctor<short>"


def device_events(run, sessions: int = 10, cuda_only: bool = True, around: bool = False,
                  complete=None, retry_wait_s: float = 1.0):
    """(key averages, device events) of one call of `run` under
    torch.profiler.  `cuda_only` (the default) records the card's activity
    alone, between the pads above (a session with the host's ops over the
    60 s audio path left the next sessions empty); the host's launch calls
    need cuda_only=False, which has no pads.  Now and then a session hands
    back no device activity at all, several sessions in a row: `run` is
    then profiled again, `retry_wait_s` seconds later, up to `sessions`
    times, and only a session with device events counts (and, if
    `complete` is given, whose device events it accepts).  With `around`,
    `run` is called with a function that profiles the call it is given, so
    that only that part of `run` is recorded."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if cuda_only else \
        [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(sessions):
        if attempt:
            time.sleep(retry_wait_s)
        box = {}

        def profiled(fn):
            pad = torch.zeros(1, dtype=torch.int16, device="cuda")
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                for _ in range(PROFILE_PAD if cuda_only else 0):
                    pad.bitwise_xor_(1)
                fn()
                torch.cuda.synchronize()
                for _ in range(PROFILE_PAD if cuda_only else 0):
                    pad.bitwise_xor_(1)
                torch.cuda.synchronize()
            box["prof"] = prof

        run(profiled) if around else profiled(run)
        avgs = box["prof"].key_averages()
        events = [e for e in avgs
                  if str(e.device_type).endswith("CUDA") and PAD_KERNEL not in e.key]
        if events and (complete is None or complete(events)):
            if attempt:
                print(f"  (torch.profiler: {attempt} incomplete session(s) discarded)")
            return avgs, events
    raise AssertionError(f"torch.profiler recorded no (complete) device events in {sessions} "
                         f"sessions")


def profile_device(run, top: int = 6, around: bool = False):
    """(device ms, host-to-device copy ms, [(op, device ms)] of the `top`
    largest) over one call of `run` under torch.profiler (`around` as in
    device_events): the sum of the device events' own times, which is busy
    time as long as one stream runs at a time, without the host-to-device
    copies."""
    _, events = device_events(run, around=around)
    uploads = [e for e in events if e.key.startswith("Memcpy HtoD")]
    events = sorted((e for e in events if e not in uploads),
                    key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in events) / 1e3
    upload = sum(e.self_device_time_total for e in uploads) / 1e3
    return total, upload, [(e.key[:48], e.self_device_time_total / 1e3) for e in events[:top]]


def profile_pipeline(make):
    """profile_device over the streaming of a pipeline that make() builds,
    its start (weights, a LUT fit) outside the profiling session; a session
    that comes back empty is tried again on a fresh pipeline."""
    from gst_plugins_rs_tpu_torch.core import State

    def run(profiled):
        p = make()
        p.set_state(State.PLAYING)
        try:
            profiled(p.run)
        finally:
            p.set_state(State.NULL)

    return profile_device(run, around=True)


# ---------------------------------------------------------------------------
# The EBU R-128 audio path: audioloudnorm (the limiter kernel), ebur128level,
# rsaudioecho, and the plumbing in front of them
# ---------------------------------------------------------------------------
AUDIO_SECONDS = 60           # the full-width audioloudnorm run: 600 frames of 100 ms
AUDIO_CPU_SECONDS = 6        # card against CPU
AUDIO_SPB = 4800             # samples per 48 kHz source buffer (100 ms)
LN_FRAME = 19_200            # audioloudnorm's frame at 192 kHz
LN_LOOKAHEAD = 1920          # the limiter's lookahead: output n reads window row n + 1920
LN_SAMPLE_TOL = 1e-9         # F64 samples, card vs CPU on the same input
LN_LOUDNESS_TOL = 1e-6       # LU, card vs CPU
RESAMPLE_TOL = 1e-5          # f32 resampler, card vs CPU (cuDNN sums in another order)
ECHO_TOL = 1e-6              # f32 echo, card vs CPU
# the path's output loudness, the smoke's own bar: the reference's is +-1 LU
# of -24 LUFS on its test signals (tests/test_torch_loudnorm.py holds the
# port to it); on the tick signal below the limiter clamps every tick to -2
# dBTP, and the JAX element reads -25.25 LUFS on 6 s of it, as the port does
# (tests/test_torch_audio.py, the test named for the smoke signal)
LN_LOUDNESS_BAR = 2.0
# the test signal: one-period 440 Hz ticks every 0.5 s at full-scale 0.8, the
# reference's limiter signal (audio/audiofx/tests/audioloudnorm.rs) without
# its quiet sine: normalised to -24 LUFS the ticks cross -2 dBTP, so every
# tick's frames run the limiter and the frames between them are idle
TICKS = "wave=ticks volume=0.8 sine-periods-per-tick=1 tick-interval=500000000"
# an estimate, not a measurement, of the limiter walk's floor: the
# loop-carried chain of one event of the kernel's walk (a peak's top
# compares, its state branch and the envelope count's add, or one ballot
# of the walking warp over 32 peaks, or a segment's stores; no division),
# ~40 cycles at the SM's maximum clock, times the events the kernel counted
# (walk steps plus segments); printed beside the kernel's time, not in the
# kernels line
LIMITER_EVENT_CYCLES = 40
# the walk's hard carries: every state at the envelope and sustain counts
# where a gap turns (Attack -> Sustain at 1,920, Release -> Out at 19,200,
# a Sustain's count at 1, 0 and none)
LIMITER_BOUNDARY = [(st, env, sus, 0.8, 0.6) for st in range(4)
                    for env in (1919, 1920, 19199, 19200) for sus in (0, 1, -1)]
LIMITER_CARRIES = [(0, 0, -1, 0.0, 0.0), (1, 500, -1, 0.9, 0.6), (2, 0, 100, 0.7, 0.5),
                   (3, 3000, -1, 0.5, 1.0)]


def loudnorm_launch(seconds: int, tail: str = "audioloudnorm ! appsink name=sink") -> str:
    """The full-width path: 48 kHz F32 stereo test source, resampled to 192
    kHz and converted to F64, into audioloudnorm.  (audioresample takes F32
    only, so it comes before audioconvert: `audioconvert ! audioresample !
    F64` fails to negotiate in both packages.)"""
    return (f"audiotestsrc {TICKS} num-buffers={seconds * 10} samplesperbuffer={AUDIO_SPB} "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! audioresample "
            f"! audio/x-raw,rate=192000 ! audioconvert "
            f"! audio/x-raw,format=F64,rate=192000,channels=2 ! {tail}")


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def limiter_window(kind: str, dtype, dev):
    """A [40320, 2] 192 kHz limiter window of the path's signal: quiet noise,
    with (peaky) a tick burst and a pair of close peaks, (idle) nothing above
    -2 dBTP, or (clipped) a +-1.2 square wave over the whole window, so
    every sample is a peak."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-0.3, 0.3, (40320, 2))
    if kind == "peaky":
        t = np.arange(2000) / 192000
        x[4000:6000] = 1.2 * np.sin(2 * np.pi * 440 * t)[:, None]
        x[12000, 0], x[13700, 1] = 0.95, 1.0
    elif kind == "clipped":
        x[:] = np.where((np.arange(40320) // 218) % 2 == 0, 1.2, -1.2)[:, None]
    return torch.from_numpy(x).to(dev, dtype).contiguous()


def _limiter_plain(lim, w, ci, cf, tp):
    """L1's plain twin on the CPU copies, after the vectorised detection."""
    w, ci, cf = w.cpu(), ci.cpu(), cf.cpu()
    run = lim.limiter_frame_plain if w.dim() == 2 else lim.limiter_frames_plain
    return run(w, ci, cf, tp, *lim.precompute_peaks(w, tp))


def _limiter_bytes_flop(w, tp, peaks):
    """What L1 needs on window(s) w: each stream's window rows 0 .. L +
    FRAME + 10 read once, the output written, the carry read and written;
    operations: each window sample's abs and compare with the target, the
    12 neighbour compares where it is above, at each peak the division and
    its compare, and each output sample's scale and two-sided clamp."""
    ch, isz = w.shape[-1], w.element_size()
    n = 1 if w.dim() == 2 else w.shape[0]
    rows = LN_LOOKAHEAD + LN_FRAME + 11
    nbytes = n * ((rows + LN_FRAME) * ch * isz + (3 * 4 + 2 * isz) * 2)
    above = int((w[..., LN_LOOKAHEAD:LN_LOOKAHEAD + LN_FRAME, :].abs() > tp).sum())
    flop = n * LN_FRAME * ch * (2 + 3) + above * 24 + peaks * 2
    return nbytes, flop


def limiter_kernel(card_line):
    """Phase 3c: the limiter kernel against its plain version at 192 kHz
    stereo, bit for bit in f64 and f32, on a peaky, an idle and a clipped
    frame from four carries and from every boundary carry, with the peaks
    segments and walk steps each walk took; then timed (f64, the path's
    type) beside its bound and the walk's event floor."""
    phase("3c audio: the limiter kernel against its plain version")
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    dev = torch.device("cuda")
    cases, max_err = {}, 0.0
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    for dtype, np_dtype in ((torch.float64, np.float64), (torch.float32, np.float32)):
        tp = float(np_dtype(10 ** (-2 / 20)))
        for kind in ("peaky", "idle", "clipped"):
            w = limiter_window(kind, dtype, dev)
            walked = []
            for carry in LIMITER_CARRIES + LIMITER_BOUNDARY:
                ci = torch.tensor(carry[:3], dtype=torch.int32, device=dev)
                cf = torch.tensor(carry[3:], dtype=dtype, device=dev)
                out, ni, nf = lim.limiter_frame(w, ci, cf, tp, walk_stats=stats)
                torch.cuda.synchronize()
                ref, ri, rf = _limiter_plain(lim, w, ci, cf, tp)
                err = float((out.cpu() - ref).abs().max())
                max_err = max(max_err, err)
                same = torch.equal(out.cpu(), ref) and torch.equal(ni.cpu(), ri) \
                    and torch.equal(nf.cpu(), rf)
                if not same or not torch.isfinite(out).all():
                    raise AssertionError(f"limiter {dtype} {kind} carry={carry}: kernel != plain "
                                         f"(max abs err {err:.3e}; carries {ni.tolist()} "
                                         f"{ri.tolist()}, {nf.tolist()} {rf.tolist()})")
                walked.append(tuple(stats.tolist()))
            label = f"{'f64' if dtype == torch.float64 else 'f32'} {kind}"
            segs = sorted({w_[1] for w_ in walked})
            steps = sorted({w_[2] for w_ in walked})
            print(f"limiter {label}: {walked[0][0]} peaks, from Out {walked[0][1]} segments in "
                  f"{walked[0][2]} walk steps ({segs[0]}-{segs[-1]} segments, {steps[0]}-"
                  f"{steps[-1]} steps over the {len(walked)} carries), bit-equal to plain from "
                  f"{len(LIMITER_CARRIES)} carries and {len(LIMITER_BOUNDARY)} boundary carries")
            cases[label] = (w, tp, walked[0])
    # timed on the path's type (F64) from the Out carry
    ci = torch.tensor([0, 0, -1], dtype=torch.int32, device=dev)
    cf = torch.zeros(2, dtype=torch.float64, device=dev)
    times = {kind: cuda_ms(lambda w=cases[f"f64 {kind}"][0], tp=cases[f"f64 {kind}"][1]:
                           lim.limiter_frame(w, ci, cf, tp))
             for kind in ("peaky", "idle", "clipped")}
    w, tp, (npk, nseg, _) = cases["f64 peaky"]
    args = [t.cpu() for t in (w, ci, cf)] + [tp] + [t.cpu() for t in lim.precompute_peaks(w, tp)]
    t0 = time.perf_counter()
    for _ in range(3):
        lim.limiter_frame_plain(*args)
    plain_ms = (time.perf_counter() - t0) / 3 * 1e3
    nbytes, flop = _limiter_bytes_flop(w, tp, npk)
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flop / PEAK_F64 * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    hz = _sm_clock_hz()
    events = {kind: cases[f"f64 {kind}"][2][1] + cases[f"f64 {kind}"][2][2]
              for kind in ("peaky", "clipped")}
    floors = {kind: n * LIMITER_EVENT_CYCLES / hz * 1e3 for kind, n in events.items()}
    clipped_peaks = cases["f64 clipped"][2][0]
    print(f"limiter f64 stereo frame: kernel {times['peaky']:.4f} ms peaky ({npk} peaks, {nseg} "
          f"segments), {times['idle']:.4f} ms idle, {times['clipped']:.4f} ms clipped "
          f"({clipped_peaks} peaks); plain (host loop, CPU) {plain_ms:.2f} ms; bound "
          f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flop} f64 operations); event floor, "
          f"estimated: {floors['peaky']:.6f} ms peaky ({events['peaky']} events), "
          f"{floors['clipped']:.6f} ms clipped ({events['clipped']} events) (events x "
          f"~{LIMITER_EVENT_CYCLES} cycles at the max SM clock) [{card_line}]")
    return dict(case="192 kHz stereo f64, peaky frame", ms=times["peaky"], idle_ms=times["idle"],
                clipped_ms=times["clipped"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=max_err, library_ms=None, flop=flop,
                bytes=nbytes, peaks=npk, segments=nseg)


def _r128_of(data, channels, rate):
    """(integrated loudness, sample peaks) of host samples, on the card."""
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    r = EbuR128(channels, rate, device="cuda")
    r.add_frames(torch.from_numpy(np.ascontiguousarray(data)))
    return r.loudness_global(), [r.sample_peak(c) for c in range(channels)]


def audio_pipelines():
    """Phase 4c: the full-width audioloudnorm path over AUDIO_SECONDS with the
    limiter's counter set to 0 just before and read just after, checked
    against the smoke's bar (LN_LOUDNESS_BAR); then ebur128level and
    rsaudioecho at 48 kHz and videotestsrc ! videoconvert I420 <-> RGBA at
    1080p."""
    phase("4c audio pipelines on the card")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import MessageType
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    p = g.parse_launch(loudnorm_launch(AUDIO_SECONDS))
    lim.launches = 0
    p.play_until_eos()
    torch.cuda.synchronize()
    counted = lim.launches
    samples = p.by_name("sink").samples
    if any(s.buffer.data.device.type != "cuda" or s.buffer.data.dtype != torch.float64
           for s in samples):
        raise AssertionError("audioloudnorm output is not F64 on the card")
    out = p.by_name("sink").concat_audio()
    frames = -(-out.shape[0] // LN_FRAME)
    loud, peaks = _r128_of(out, 2, 192000)
    pts_ok = all(abs(b.buffer.pts - a.buffer.pts - a.buffer.data.shape[0] * 10**9 // 192000) <= 1
                 for a, b in zip(samples, samples[1:]))
    print(f"audioloudnorm {AUDIO_SECONDS} s, 192 kHz stereo F64: {out.shape[0]} samples "
          f"({frames} frames of 100 ms), limiter launches {counted}; output {loud:.3f} LUFS, "
          f"sample peaks {[round(20 * np.log10(v), 3) for v in peaks]} dBFS; PTS continuous: "
          f"{pts_ok}")
    if not (np.isfinite(out).all() and abs(out.shape[0] - AUDIO_SECONDS * 192000) < 192000):
        raise AssertionError("audioloudnorm output not finite or of the wrong length")
    if counted != frames:
        raise AssertionError("limiter launches != 100 ms output frames")
    if abs(loud + 24.0) >= LN_LOUDNESS_BAR or max(peaks) > 10 ** (-2 / 20) + 1e-9 \
            or not pts_ok:
        raise AssertionError(f"audioloudnorm misses the smoke's bar (+-{LN_LOUDNESS_BAR} LU of "
                             f"-24, peak <= -2 dBFS, PTS within 1 ns)")
    launches = {"loudnorm_limiter": counted}

    # ebur128level at 48 kHz stereo (the 4x true peak on)
    p = g.parse_launch(f"audiotestsrc wave=white-noise volume=0.3 num-buffers=100 "
                       f"samplesperbuffer={AUDIO_SPB} ! audio/x-raw,format=F32,rate=48000,"
                       f"channels=2 ! ebur128level ! fakesink")
    p.play_until_eos()
    msgs = [m.structure for m in p.bus.messages(MessageType.ELEMENT)
            if m.structure is not None and m.structure.name == "ebur128-level"]
    last = msgs[-1] if msgs else None
    print(f"ebur128level 10 s 48 kHz stereo: {len(msgs)} messages, last: M "
          f"{last['momentary-loudness']:.3f}, I {last['global-loudness']:.3f} LUFS, true peak "
          f"{[round(v, 4) for v in last['true-peak']]}" if last else "no messages")
    if len(msgs) != 10 or not all(np.isfinite(last[k]) for k in ("momentary-loudness",
                                                                 "global-loudness")):
        raise AssertionError("ebur128level did not post 10 finite messages")

    # rsaudioecho at 48 kHz stereo
    p = g.parse_launch(f"audiotestsrc wave=ticks num-buffers=20 samplesperbuffer={AUDIO_SPB} "
                       f"! audio/x-raw,format=F32,rate=48000,channels=2 ! rsaudioecho "
                       f"delay=250000000 intensity=0.6 feedback=0.3 ! appsink name=sink")
    p.play_until_eos()
    echo = p.by_name("sink").concat_audio()
    print(f"rsaudioecho 2 s 48 kHz stereo: {echo.shape}, max |x| {np.abs(echo).max():.3f}")
    if echo.shape != (20 * AUDIO_SPB, 2) or not np.isfinite(echo).all():
        raise AssertionError("rsaudioecho output")

    # videotestsrc ! videoconvert: RGBA -> I420 -> RGBA at 1080p
    p = g.parse_launch(video_convert_launch(4))
    p.play_until_eos()
    frames_out = p.by_name("sink").samples
    if len(frames_out) != 4 or any(s.buffer.data.device.type != "cuda" or
                                   tuple(s.buffer.data.shape) != (HD_H, HD_W, 4)
                                   for s in frames_out):
        raise AssertionError("videoconvert I420 round trip: frames")
    print(f"videotestsrc RGBA 1080p ! videoconvert ! I420 ! videoconvert ! RGBA: 4 frames on "
          f"the card")
    return launches


def video_convert_launch(frames: int) -> str:
    return (f"videotestsrc pattern=gradient num-buffers={frames} "
            f"! video/x-raw,format=RGBA,width={HD_W},height={HD_H},framerate=30/1 "
            f"! videoconvert ! video/x-raw,format=I420 ! videoconvert "
            f"! video/x-raw,format=RGBA ! appsink name=sink")


def _on(dev, fn):
    import gst_plugins_rs_tpu_torch as g

    g.set_device(dev)
    try:
        return fn()
    finally:
        g.set_device("cuda")


def _capture_loudnorm_input(seconds):
    """The F64 192 kHz input of audioloudnorm in the path (tee'd off) and its
    output, on the current device."""
    import gst_plugins_rs_tpu_torch as g

    p = g.parse_launch(loudnorm_launch(
        seconds, "tee name=t t. ! queue ! audioloudnorm ! appsink name=out "
                 "t. ! queue ! appsink name=in"))
    p.play_until_eos()
    return p.by_name("in").samples, p.by_name("out").concat_audio()


def _loudnorm_from(samples):
    """audioloudnorm over the given buffers, pushed through appsrc on the
    current device."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import Buffer

    p = g.parse_launch("appsrc name=src ! audioloudnorm ! appsink name=sink")
    src = p.by_name("src")
    src.set_property("caps", samples[0].caps)
    for s in samples:
        b = s.buffer
        src.push_buffer(Buffer(b.data.cpu(), pts=b.pts, duration=b.duration, offset=b.offset))
    src.end_of_stream()
    p.play_until_eos()
    return p.by_name("sink").concat_audio()


def audio_card_vs_cpu():
    """Phase 5c: on AUDIO_CPU_SECONDS of the path, the card against the CPU:
    audioloudnorm on the same F64 input (the card's, tee'd off) within 1e-9
    a sample and 1e-6 LU; the F32 resampler front within 1e-5; ebur128level's
    values, rsaudioecho and the I420 round trip."""
    phase("5c audio, card against CPU")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import MessageType

    ins, card_out = _capture_loudnorm_input(AUDIO_CPU_SECONDS)
    host_out = _on("cpu", lambda: _loudnorm_from(ins))
    d = float(np.abs(card_out - host_out).max())
    l_card, _ = _r128_of(card_out, 2, 192000)
    l_host, _ = _r128_of(host_out, 2, 192000)
    host_in = _on("cpu", lambda: _capture_loudnorm_input(AUDIO_CPU_SECONDS)[0])
    card_in = np.concatenate([s.buffer.data.cpu().numpy() for s in ins])
    d_in = float(np.abs(card_in - np.concatenate([s.buffer.data.numpy() for s in host_in])).max())
    print(f"audioloudnorm {AUDIO_CPU_SECONDS} s, card (kernel) vs CPU (plain) on the same F64 "
          f"input: max abs {d:.3e} (gate {LN_SAMPLE_TOL}), loudness {l_card:.9f} vs "
          f"{l_host:.9f} LUFS (gate {LN_LOUDNESS_TOL} LU); resampled F32 front, card vs CPU: "
          f"max abs {d_in:.3e} (gate {RESAMPLE_TOL})")
    if card_out.shape != host_out.shape or d > LN_SAMPLE_TOL \
            or abs(l_card - l_host) > LN_LOUDNESS_TOL or d_in > RESAMPLE_TOL:
        raise AssertionError("audioloudnorm or the resampler: card and CPU disagree")

    def level():
        p = g.parse_launch(f"audiotestsrc wave=white-noise volume=0.3 num-buffers=30 "
                           f"samplesperbuffer={AUDIO_SPB} ! audio/x-raw,format=F32,rate=48000,"
                           f"channels=2 ! ebur128level ! fakesink")
        p.play_until_eos()
        m = [x.structure for x in p.bus.messages(MessageType.ELEMENT)
             if x.structure is not None and x.structure.name == "ebur128-level"][-1]
        return np.array([m["momentary-loudness"], m["shortterm-loudness"],
                         m["global-loudness"], *m["true-peak"]])

    def echo():
        p = g.parse_launch(f"audiotestsrc wave=ticks num-buffers=20 samplesperbuffer={AUDIO_SPB} "
                           f"! audio/x-raw,format=F32,rate=48000,channels=2 ! rsaudioecho "
                           f"delay=250000000 intensity=0.6 feedback=0.3 ! appsink name=sink")
        p.play_until_eos()
        return p.by_name("sink").concat_audio()

    def video():
        p = g.parse_launch(video_convert_launch(1))
        p.play_until_eos()
        return p.by_name("sink").samples[0].buffer.data.cpu().numpy()

    d_level = float(np.abs(level() - _on("cpu", level)).max())
    d_echo = float(np.abs(echo() - _on("cpu", echo)).max())
    same_video = np.array_equal(video(), _on("cpu", video))
    # a seeded random frame through the I420 and NV12 round trips
    from gst_plugins_rs_tpu_torch.core.video import VideoInfo
    from gst_plugins_rs_tpu_torch.elements.generic.convert import build_format_converter

    frame = torch.from_numpy(hd_frame(3))
    rgba = VideoInfo("RGBA", HD_W, HD_H)
    same_rand = True
    for fmt in ("I420", "NV12"):
        to_yuv = build_format_converter(rgba, VideoInfo(fmt, HD_W, HD_H))
        back = build_format_converter(VideoInfo(fmt, HD_W, HD_H), rgba)
        card_planes, host_planes = to_yuv(frame.to("cuda")), to_yuv(frame)
        same_rand &= all(torch.equal(a.cpu(), b) for a, b in zip(card_planes, host_planes))
        same_rand &= torch.equal(back(card_planes).cpu(), back(host_planes))
    print(f"ebur128level 3 s 48 kHz, card vs CPU: max |d| {d_level:.3e} (LU and true peak; "
          f"gate {LN_LOUDNESS_TOL}); rsaudioecho: max abs {d_echo:.3e} (gate {ECHO_TOL}); "
          f"videoconvert RGBA -> I420 -> RGBA 1080p bit-equal: {same_video}; a random 1080p frame "
          f"through I420 and NV12 and back bit-equal: {same_rand}")
    if d_level > LN_LOUDNESS_TOL or d_echo > ECHO_TOL or not (same_video and same_rand):
        raise AssertionError("ebur128level, rsaudioecho or videoconvert: card and CPU disagree")


def audio_timing(card_line):
    """Phase 6c: seconds of audio per wall second of the full-width
    audioloudnorm path over AUDIO_SECONDS (after a warm-up run), device busy
    time and kernel launches per frame from torch.profiler over 6 s, and the
    same for ebur128level and rsaudioecho at 48 kHz."""
    phase("6c audio timing")
    import gst_plugins_rs_tpu_torch as g

    def run(launch):
        p = g.parse_launch(launch)
        p.play_until_eos()
        torch.cuda.synchronize()

    level = (f"audiotestsrc wave=white-noise volume=0.3 num-buffers={{n}} "
             f"samplesperbuffer={AUDIO_SPB} ! audio/x-raw,format=F32,rate=48000,channels=2 "
             f"! ebur128level ! fakesink")
    echo = (f"audiotestsrc wave=ticks num-buffers={{n}} samplesperbuffer={AUDIO_SPB} "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! rsaudioecho delay=250000000 "
            f"intensity=0.6 feedback=0.3 ! fakesink")
    rows = {}
    for label, make in (("audioloudnorm 192 kHz stereo F64 (with its source, resampler and "
                         "converter)", lambda n: loudnorm_launch(n // 10, "audioloudnorm ! "
                                                                        "fakesink")),
                        ("ebur128level 48 kHz stereo", lambda n: level.format(n=n)),
                        ("rsaudioecho 48 kHz stereo", lambda n: echo.format(n=n))):
        run(make(60))  # warm-up: builds, caches
        t0 = time.perf_counter()
        run(make(AUDIO_SECONDS * 10))
        secs = time.perf_counter() - t0
        n_prof = 60  # 6 s, 60 frames of 100 ms
        _, events = device_events(lambda: run(make(n_prof)))
        busy = sum(e.self_device_time_total for e in events) / 1e3
        kernels = sum(e.count for e in events if not e.key.startswith("Memcpy"))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        # 100 ms of audio takes 100 / rate wall ms
        share = busy / n_prof * (AUDIO_SECONDS / secs) / 100.0
        rows[label] = dict(audio_s_per_s=AUDIO_SECONDS / secs, busy_ms_per_frame=busy / n_prof,
                           launches_per_frame=kernels / n_prof, busy_share=share)
        print(f"{label}: {AUDIO_SECONDS} s of audio in {secs:.3f} s, "
              f"{AUDIO_SECONDS / secs:.2f} s of audio per second; device busy "
              f"{busy / n_prof:.4f} ms and {kernels / n_prof:.1f} device ops per 100 ms frame "
              f"(torch.profiler, {n_prof} frames), {100 * share:.1f}% of the wall; "
              f"ms per frame by op: "
              + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n_prof:.4f}"
                          for e in top) + f" [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# Denoising and spatial audio: audiornnoise (kernel R1, the GRU stack),
# audiomixer in front of it, hrtfrender, sofalizer's UPOLS step, agingradio
# ---------------------------------------------------------------------------
RNN_SECONDS = 60           # the main path: 600 buffers of 4800 samples (100 ms)
RNN_CPU_SECONDS = 6        # card against CPU
RNN_FRAMES = 100           # R1's buffer in phase 3d: 100 frames of 10 ms
RNN_CHANNELS = 2
# R1 against its plain version (the frame loop of rnn_frame, on the card):
# the same products summed in another order, expf / tanhf against torch's
# sigmoid and tanh; gains and VAD (in [0, 1]) absolutely, the states
# relative to 1 + |ref| (the ReLU GRUs' states are not bounded by 1)
R1_TOL = 1e-5
# the denoised path, card (cuFFT, R1) against CPU (pocketfft, the plain
# frame loop), a sample in float units (1e-4 = 3.3 s16 units): the gains
# move by ~1e-5, which a full-scale spectrum carries into the output
RNN_PATH_TOL = 1e-4
VAD_PATH_TOL = 1e-4
# hrtf_convolve_blocks, upols_block and agingradio's op, card against CPU:
# f32 FFTs of two libraries (cuFFT, pocketfft), relative to max(1, scale)
SPATIAL_CPU_TOL = 1e-5
AGING_CPU_TOL = 1e-6
# multiply-adds of the GRU stack a frame and channel: dense 42x24, the GRUs'
# W and U (24x72 + 24x72, 90x144 + 48x144, 114x288 + 96x288), the outputs
# 96x22 + 24x1
R1_MACS = 86_952
R1_WEIGHTS = 87_503        # f32 parameters
# an estimate, not a measurement, of R1's floor a frame (the recurrence of
# csrc/rnnoise_gru.cu, its header's reckoning): ~1,680 shared-memory
# wavefronts at 128 B a cycle (the shared chain weights, the float4
# broadcasts of the states, the gate buffers), five barriers (~30 cycles)
# and three gate updates on the chain (~100 cycles); the 24-FMA register
# chain runs under the wavefronts; printed beside the kernel's time only
R1_FRAME_CYCLES = 1_680 + 5 * 30 + 3 * 100
# the mix into audiornnoise: a 180 Hz tone and white noise at 48 kHz stereo
RNN_SINE = "wave=sine freq=180 volume=0.3"
RNN_NOISE = "wave=white-noise volume=0.08"


def rnnoise_launch(seconds: int, sink: str = "appsink name=sink") -> str:
    """The main path of the denoising slice: two 48 kHz F32 stereo sources
    summed by audiomixer into 100 ms buffers, then audiornnoise (the
    packaged weights)."""
    caps = "audio/x-raw,format=F32,rate=48000,channels=2"
    n = seconds * 10
    return (f"audiotestsrc {RNN_SINE} num-buffers={n} samplesperbuffer={AUDIO_SPB} ! {caps} "
            f"! audiomixer name=mix output-buffer-duration=100000000 ! audiornnoise ! {sink} "
            f"audiotestsrc {RNN_NOISE} num-buffers={n} samplesperbuffer={AUDIO_SPB} ! {caps} "
            f"! mix.")


def hrtf_launch(seconds: int, sink: str = "appsink name=sink") -> str:
    return (f"audiotestsrc {RNN_SINE} num-buffers={seconds * 10} samplesperbuffer={AUDIO_SPB} "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! hrtfrender name=h ! {sink}")


def aging_launch(seconds: int, sink: str = "appsink name=sink") -> str:
    return (f"audiotestsrc {RNN_SINE} num-buffers={seconds * 10} samplesperbuffer={AUDIO_SPB} "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! agingradio ! {sink}")


def hrir_sphere(rate: int = 48000, length: int = 128) -> bytes:
    """A synthetic HRIR sphere file: an icosahedron (faces = the triples of
    mutually adjacent vertices), each vertex's left/right IRs a panned
    impulse with a decaying seeded tail, as tests/test_hrtfrender.py builds
    its sphere (128 taps here, an HRIR's usual length)."""
    import struct

    phi = (1 + 5 ** 0.5) / 2
    verts = [(0, a, b) for a in (-1, 1) for b in (-phi, phi)] + \
        [(a, b, 0) for a in (-1, 1) for b in (-phi, phi)] + \
        [(b, 0, a) for a in (-1, 1) for b in (-phi, phi)]
    v = np.asarray(verts, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    adj = np.abs(d - d[d > 1e-9].min()) < 1e-6
    faces = np.asarray([(i, j, k) for i in range(12) for j in range(i + 1, 12)
                        for k in range(j + 1, 12) if adj[i, j] and adj[j, k] and adj[i, k]],
                       np.uint32)
    rng = np.random.RandomState(5)
    tail = rng.uniform(-1, 1, (12, 2, length)) * 0.05 * 0.97 ** np.arange(length)
    out = b"HRIR" + struct.pack("<IIII", rate, length, 12, faces.size) + faces.tobytes()
    for i, (x, _, _) in enumerate(v.astype(np.float32)):
        lr = tail[i].astype(np.float32)
        lr[0, 0], lr[1, 0] = 0.5 * (1.0 - x), 0.5 * (1.0 + x)
        out += struct.pack("<fff", *v[i].astype(np.float32)) + lr[0].tobytes() + lr[1].tobytes()
    return out


def _play(launch, props=None):
    """Run a launch line to EOS; props {element name: {property: value}} are
    set first.  Returns the pipeline."""
    import gst_plugins_rs_tpu_torch as g

    p = g.parse_launch(launch)
    for name, kv in (props or {}).items():
        for k, v in kv.items():
            p.by_name(name).set_property(k, v)
    p.play_until_eos()
    return p


def _rnn_buffer(dev, seed: int = 11):
    """R1's inputs at the path's shapes from the port's front end: 100 frames
    of a stereo harmonic-plus-noise signal (5 silent frames among them)."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    rng = np.random.RandomState(seed)
    n = RNN_FRAMES * rn.FRAME_SIZE
    t = np.arange(n) / 48000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * 150 * t) + 0.1 * np.sin(2 * np.pi * 300 * t)
                    + 0.05 * rng.randn(n),
                    0.2 * np.sin(2 * np.pi * 233 * t) + 0.1 * rng.randn(n)])
    sig[:, 40 * rn.FRAME_SIZE:45 * rn.FRAME_SIZE] = 0.0
    frames = (sig * 32767).astype(np.float32).reshape(RNN_CHANNELS, RNN_FRAMES, -1)
    frames = torch.from_numpy(frames.transpose(1, 0, 2).copy()).to(dev)
    state = rn.denoise_init(RNN_CHANNELS, dev)
    _, feats, _, _, _, sil = rn.analysis_frames_batch(state, frames)
    return feats, sil, state.rnn


def _r1_errs(got, ref):
    (g, v, s), (rg, rv, rs) = got, ref
    state = max(float(((a - b) / (1 + b.abs())).abs().max()) for a, b in zip(s, rs))
    return max(float((g - rg).abs().max()), float((v - rv).abs().max()), state)


def _rnn_wide_buffer(dev, C: int = 33, K: int = 16, seed: int = 13):
    """R1's inputs at C = 33 channels from the port's front end: K frames of
    the path's mix a channel (a tone, 110 + 7c Hz at 0.3, and white noise at
    0.08, as the two sources of rnnoise_launch sum), no gaps.  Onsets after
    silence, the least-conditioned input, are 3d''s cases."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    rng = np.random.RandomState(seed)
    n = K * rn.FRAME_SIZE
    t = np.arange(n) / 48000.0
    f0 = 110.0 + 7.0 * np.arange(C)
    sig = 0.3 * np.sin(2 * np.pi * f0[:, None] * t) + 0.08 * rng.uniform(-1, 1, (C, n))
    frames = (sig * 32767).astype(np.float32).reshape(C, K, -1)
    frames = torch.from_numpy(frames.transpose(1, 0, 2).copy()).to(dev)
    state = rn.denoise_init(C, dev)
    _, feats, _, _, _, sil = rn.analysis_frames_batch(state, frames)
    return feats, sil, state.rnn


def _r1_row(label, f, s, ms, card_line):
    """Prints a timed R1 case: the kernel's ms and cycles a frame beside the
    floor's estimate."""
    K, C = f.shape[0], f.shape[1]
    cycles = ms * 1e-3 * _sm_clock_hz() / K
    print(f"R1 {label}, {K} frames x {C} channels ({int(s.sum())} silent): kernel {ms:.4f} ms, "
          f"{cycles:.0f} cycles a frame at the max SM clock; floor estimated ~{R1_FRAME_CYCLES} "
          f"cycles a frame [{card_line}]")


def _r1_bound(f, s):
    """(bound ms, bound_by, flop, bytes) of R1 on these inputs: the weights
    read once, the features and silence flags, the gains and VADs written,
    the states read and written; the operations of the frames and channels
    not silent."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    K, C = f.shape[0], f.shape[1]
    active = K * C - int(s.sum())
    nbytes = R1_WEIGHTS * 4 + K * C * (rn.NB_FEATURES * 4 + 1 + rn.NB_BANDS * 4 + 4) \
        + 2 * C * (24 + 48 + 96) * 4
    flop = 2 * R1_MACS * active
    return (*bound(flop, nbytes), flop, nbytes)


def rnnoise_kernel(card_line):
    """Phase 3d: R1 against its plain version (the frame loop of rnn_frame,
    on the card) on 100 frames x 2 channels of front-end features from a
    harmonic-plus-noise signal and of random features, on the main path's
    buffer (10 frames x 2), and on the edge cases: one frame, a buffer
    whose frames are all silent, channels silent first that then speak,
    one channel, 33 channels.  Every case is timed beside the floor's
    estimate; the 100-frame case and the path's also beside the plain
    version and the bound.  Returns those two."""
    phase("3d denoising: the GRU-stack kernel R1 against its plain version")
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    dev = torch.device("cuda")
    w = rn.weights_to(rn.default_weights(), dev)
    rng = np.random.RandomState(3)
    feats, sil, rnn = _rnn_buffer(dev)
    h = [torch.from_numpy(np.abs(rng.uniform(-1, 1, (RNN_CHANNELS, n))).astype(np.float32))
         .to(dev) for n in (24, 48, 96)]
    wide = _rnn_wide_buffer(dev)
    cases = {
        "front end": (feats, sil, rnn),
        "random": (torch.from_numpy(rng.randn(RNN_FRAMES, RNN_CHANNELS, rn.NB_FEATURES)
                                    .astype(np.float32) * 2).to(dev),
                   torch.from_numpy(rng.rand(RNN_FRAMES, RNN_CHANNELS) < 0.1).to(dev),
                   rn.RnnState(*h)),
        "front end (the path's buffer)": (feats[:10], sil[:10], rnn),
        "front end, one frame": (feats[:1], sil[:1], rnn),
        "front end, every frame silent": (feats[:10], torch.ones_like(sil[:10]), rnn),
        "front end, silent first, then speaking": (feats[40:52], sil[40:52], rnn),
        "front end, one channel": (feats[:, :1], sil[:, :1],
                                   rn.RnnState(*(x[:1] for x in rnn))),
        "front end, 33 channels": wide,
    }
    max_err = 0.0
    for label, (f, s, r) in cases.items():
        f, s = f.contiguous(), s.contiguous()
        r = rn.RnnState(*(x.contiguous() for x in r))
        got = gru.rnn_frames(f, s, r, w)
        torch.cuda.synchronize()
        ref = gru.rnn_frames_plain(f, s, r, w)
        err = _r1_errs(got, ref)
        max_err = max(max_err, err)
        print(f"R1 {label} features, {f.shape[0]} frames x {f.shape[1]} channels "
              f"({int(s.sum())} silent): max error {err:.3e} (gate {R1_TOL})")
        if err > R1_TOL or not all(bool(torch.isfinite(t).all()) for t in (*got[:2], *got[2])):
            raise AssertionError(f"R1 against its plain version on {label} features: {err:.3e}")
        if bool(s.all()) and not all(torch.equal(a, b) for a, b in zip(got[2], r)):
            raise AssertionError("R1 moved the states on a buffer whose frames are all silent")
        _r1_row(label, f, s, cuda_ms(lambda: gru.rnn_frames(f, s, r, w)), card_line)
    timed = []
    for f, s in ((feats, sil), (feats[:10], sil[:10])):
        ms = cuda_ms(lambda: gru.rnn_frames(f, s, rnn, w))
        plain_ms = cuda_ms(lambda: gru.rnn_frames_plain(f, s, rnn, w), iters=5, warmup=1)
        bound_ms, bound_by, flop, nbytes = _r1_bound(f, s)
        K, C = f.shape[0], f.shape[1]
        print(f"R1 {K} frames x {C} channels ({K * C - int(s.sum())} not silent): kernel "
              f"{ms:.4f} ms, plain (torch ops on the card) {plain_ms:.3f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flop} f32 operations); floor "
              f"estimated {K * R1_FRAME_CYCLES / _sm_clock_hz() * 1e3:.4f} ms ({K} frames x "
              f"~{R1_FRAME_CYCLES} cycles at the max SM clock) [{card_line}]")
        timed.append(dict(case=f"{K} frames x {C} channels of front-end features", ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=max_err, library_ms=None, flop=flop, bytes=nbytes))
    return timed


def denoise_pipelines():
    """Phase 4d: the main path (two sources, audiomixer, audiornnoise) over
    RNN_SECONDS with R1's counter set to 0 just before and read just after:
    one R1 call per buffer (the counter counts a call, its two kernel
    launches once), the exact sample count and PTS, finite output;
    then hrtfrender (a synthetic sphere) and agingradio over 10 s."""
    phase("4d denoising and spatial audio pipelines on the card")
    from gst_plugins_rs_tpu_torch.elements.audiofx.audiornnoise import AudioLevelMeta
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    gru.launches = 0
    p = _play(rnnoise_launch(RNN_SECONDS))
    torch.cuda.synchronize()
    counted = gru.launches
    samples = p.by_name("sink").samples
    out = p.by_name("sink").concat_audio()
    n_buf = len(samples)
    pts = [s.buffer.pts for s in samples]
    want_pts = [i * AUDIO_SPB * 10**9 // 48000 for i in range(n_buf)]
    metas = [s.buffer.get_meta(AudioLevelMeta) for s in samples]
    voiced = sum(m.voice_activity for m in metas if m is not None)
    print(f"audiomixer ! audiornnoise {RNN_SECONDS} s 48 kHz stereo: {n_buf} buffers, "
          f"{out.shape[0]} samples, R1 launches {counted}; PTS exact: {pts == want_pts}; "
          f"levels {min(m.level for m in metas)}..{max(m.level for m in metas)} dB, "
          f"{voiced} buffers with voice; output rms {float(np.sqrt((out ** 2).mean())):.4f}")
    if any(s.buffer.data.device.type != "cuda" for s in samples):
        raise AssertionError("audiornnoise output is not on the card")
    if out.shape != (RNN_SECONDS * 48000, 2) or not np.isfinite(out).all() or pts != want_pts \
            or any(m is None for m in metas):
        raise AssertionError("audiornnoise: sample count, PTS, level meta or finiteness")
    if counted != n_buf:
        raise AssertionError("R1 launches != buffers processed")
    launches = {"rnnoise_gru": counted}

    sphere = hrir_sphere()
    p = _play(hrtf_launch(10), {"h": {"hrir-raw": sphere}})
    hout = p.by_name("sink").concat_audio()
    hs = p.by_name("sink").samples
    print(f"hrtfrender 10 s 48 kHz stereo -> binaural (12-vertex sphere, 128 taps): "
          f"{len(hs)} buffers, {hout.shape[0]} samples, rms L/R "
          f"{[round(float(v), 4) for v in np.sqrt((hout ** 2).mean(0))]}")
    if hout.shape != (480_000, 2) or not np.isfinite(hout).all() \
            or any(s.buffer.data.device.type != "cuda" for s in hs):
        raise AssertionError("hrtfrender output")
    p = _play(aging_launch(10))
    aout = p.by_name("sink").concat_audio()
    print(f"agingradio 10 s 48 kHz stereo: {aout.shape[0]} samples, max |x| "
          f"{float(np.abs(aout).max()):.4f}")
    if aout.shape != (480_000, 2) or not np.isfinite(aout).all() \
            or np.abs(aout).max() > 1.0:
        raise AssertionError("agingradio output")
    return launches


def _close_err(got, ref):
    return float((got.cpu() - ref).abs().max()) / max(1.0, float(ref.abs().max()))


def denoise_card_vs_cpu():
    """Phase 5d: the RNNoise path over RNN_CPU_SECONDS on the card and on the
    CPU; hrtf_convolve_blocks and upols_block on synthetic filters;
    agingradio's op with injected noise and clicks."""
    phase("5d denoising and spatial audio, card against CPU")
    from gst_plugins_rs_tpu_torch.elements.audiofx.audiornnoise import AudioLevelMeta
    from gst_plugins_rs_tpu_torch.ops import agingradio as ag
    from gst_plugins_rs_tpu_torch.ops import hrtf, sofa

    def path():
        s = _play(rnnoise_launch(RNN_CPU_SECONDS)).by_name("sink").samples
        return (np.concatenate([x.buffer.data.cpu().numpy() for x in s]),
                [x.buffer.get_meta(AudioLevelMeta).level for x in s])

    (card_out, card_lv), (host_out, host_lv) = path(), _on("cpu", path)
    d = float(np.abs(card_out - host_out).max())
    d_lv = max(abs(a - b) for a, b in zip(card_lv, host_lv))
    print(f"audiomixer ! audiornnoise {RNN_CPU_SECONDS} s, card (R1, cuFFT) vs CPU (plain): "
          f"max abs {d:.3e} a sample (gate {RNN_PATH_TOL}), level meta within {d_lv} dB")
    if card_out.shape != host_out.shape or d > RNN_PATH_TOL or d_lv > 1:
        raise AssertionError("audiornnoise: card and CPU disagree")

    rng = np.random.RandomState(9)
    C, K, steps, blk, L = 2, 3, 8, 512, 128
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (C, K, steps * blk)).astype(np.float32))
    hr = torch.from_numpy(rng.uniform(-0.5, 0.5, (C, steps, 2, L)).astype(np.float32))
    gains = torch.from_numpy(rng.uniform(0.5, 1.0, (C, steps)).astype(np.float32))
    tails = torch.from_numpy(rng.uniform(-0.1, 0.1, (C, 2, L - 1)).astype(np.float32))
    hc = hrtf.hrtf_convolve_blocks(*(t.cuda() for t in (x, hr, gains, tails)), block_len=blk,
                                   steps=steps)
    hh = hrtf.hrtf_convolve_blocks(x, hr, gains, tails, block_len=blk, steps=steps)
    d_h = max(_close_err(a, b) for a, b in zip(hc, hh))
    P, PL = 8, 64
    Hr, Hi = sofa.partition_filter(rng.uniform(-1, 1, (2, P * PL - 5)).astype(np.float32), PL)
    H = [torch.from_numpy(np.broadcast_to(m, (C,) + m.shape).copy()) for m in (Hr, Hi)]
    st_c = [torch.zeros(C, P, PL + 1, device="cuda")] * 2 + [torch.zeros(C, PL, device="cuda")]
    st_h = [torch.zeros(C, P, PL + 1)] * 2 + [torch.zeros(C, PL)]
    d_s = 0.0
    for i in range(12):
        xb = torch.from_numpy(rng.uniform(-1, 1, (C, PL)).astype(np.float32))
        *st_c, yc = sofa.upols_block(*st_c, xb.cuda(), *(m.cuda() for m in H))
        *st_h, yh = sofa.upols_block(*st_h, xb, *H)
        d_s = max(d_s, _close_err(yc, yh))
    N = 48_000
    xa = torch.from_numpy(rng.uniform(-0.7, 0.7, (N, 2)).astype(np.float32))
    clicks = torch.from_numpy(rng.rand(N // 2) < 0.001)
    noise = torch.from_numpy(rng.uniform(-1, 1, (N, 2)).astype(np.float32))
    f0 = torch.zeros(2)
    args = (0.011, ag.lowpass_alpha(48000, 2000), 4.0, 1.0)
    ac, sc_ = ag.agingradio_process(xa.cuda(), clicks.cuda(), noise.cuda(), f0.cuda(), *args,
                                    passes=3, use_lowpass=True)
    ah, sh_ = ag.agingradio_process(xa, clicks, noise, f0, *args, passes=3, use_lowpass=True)
    d_a = max(float((ac.cpu() - ah).abs().max()), float((sc_.cpu() - sh_).abs().max()))
    print(f"hrtf_convolve_blocks ({C} channels, {K} blocks of {steps}x{blk}, {L} taps): "
          f"{d_h:.3e} of scale; upols_block ({P} partitions of {PL}, 12 blocks): {d_s:.3e} of "
          f"scale (gate {SPATIAL_CPU_TOL}); agingradio op, 1 s, injected draws: max abs "
          f"{d_a:.3e} (gate {AGING_CPU_TOL})")
    if d_h > SPATIAL_CPU_TOL or d_s > SPATIAL_CPU_TOL or d_a > AGING_CPU_TOL:
        raise AssertionError("hrtf, upols or agingradio: card and CPU disagree")


def denoise_timing(card_line):
    """Phase 6d: seconds of audio per wall second of the 4d paths over 60 s
    (after a warm-up run), device busy time, device ops per 100 ms of audio
    and the top device ops (torch.profiler over 6 s)."""
    phase("6d denoising and spatial audio timing")

    sphere = {"h": {"hrir-raw": hrir_sphere()}}
    rows = {}
    for label, make, props in (
            ("audiomixer ! audiornnoise 48 kHz stereo (with its two sources)",
             lambda s: rnnoise_launch(s, "fakesink"), None),
            ("hrtfrender 48 kHz stereo -> binaural", lambda s: hrtf_launch(s, "fakesink"), sphere),
            ("agingradio 48 kHz stereo", lambda s: aging_launch(s, "fakesink"), None)):
        _play(make(6), props)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _play(make(RNN_SECONDS), props)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n_prof = 60  # 100 ms buffers in 6 s
        _, events = device_events(lambda: _play(make(n_prof // 10), props))
        busy = sum(e.self_device_time_total for e in events) / 1e3
        ops = sum(e.count for e in events if not e.key.startswith("Memcpy"))
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        # busy share of the wall: device ms per 100 ms x audio s per wall s / 100 ms
        share = busy / n_prof * (RNN_SECONDS / secs) / 100.0
        rows[label] = dict(audio_s_per_s=RNN_SECONDS / secs, busy_ms_per_100ms=busy / n_prof,
                           ops_per_100ms=ops / n_prof, busy_share=share)
        print(f"{label}: {RNN_SECONDS} s of audio in {secs:.3f} s, {RNN_SECONDS / secs:.2f} s of "
              f"audio per second; device busy {busy / n_prof:.4f} ms and {ops / n_prof:.1f} "
              f"device ops per 100 ms of audio (torch.profiler, {n_prof} buffers), "
              f"{100 * share:.1f}% of the wall; ms per 100 ms "
              f"by op: " + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n_prof:.4f}"
                                     for e in top) + f" [{card_line}]")
    return rows


# The denoiser over 16 mono streams in one call (bench.py's
# rnnoise_bank16_realtime_x, a jax.vmap of denoise_frames_fast over 16
# states): the streams are the channels of one denoise_frames_fast call at
# C = 16, one R1 call a call, one recurrence block a stream
RNN_BANK_STREAMS = 16
RNN_BANK_K = 16            # frames a call: bench.py's K_RN
RNN_BANK_CALLS = 60        # 4d': 60 calls x 16 frames = 9.6 s of each stream
# card against CPU (5d'): the denoised path's gates of phase 5d, a sample
# within RNN_PATH_TOL of full scale (3.28 s16 units) and the VADs within
# VAD_PATH_TOL; a stream's onset after silence is the least-conditioned case
# (its first frames' spectral-variance feature is large, and the ReLU GRUs
# carry f32 rounding of either version further), so the line prints that
# stream's error beside the others'
RNN_BANK_CPU_TOL = RNN_PATH_TOL * 32767


def rnn_bank_frames(K, seed=21, streams=RNN_BANK_STREAMS):
    """[K, streams, FRAME] f32 on the host: bench.py's input, uniform in
    +-0.3 times 32767 for each of the 16 streams (or `streams`); stream 5
    starts with two silent frames (its silence flag set, the others' not)."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    a = (np.random.RandomState(seed).uniform(-0.3, 0.3, (K, streams, rn.FRAME_SIZE))
         * 32767).astype(np.float32)
    a[:2, 5] = 0.0
    return a


def rnnoise_bank_kernel(card_line):
    """Phase 3d': R1 at C = 16 streams on front-end features of bench.py's
    input, at 16 frames (bench.py's K_RN) and at 100, against its plain
    version, then timed beside its bound; and on the edge cases of the same
    input: one frame, a buffer whose frames are all silent, stream 5 alone
    (one channel, silent first, then speaking) and 33 streams.  Every case
    is timed beside the floor's estimate.  Returns the 16- and 100-frame
    cases.

    On this input the two f32 versions may disagree by more than R1_TOL: the
    stream that starts silent has large onset features, and its ReLU GRU
    states carry each version's rounding.  So both are held to the plain
    version evaluated in float64 on the same features: the kernel must be
    within twice the plain f32 version's own error against it (and R1_TOL
    at least)."""
    phase("3d' the denoiser over 16 streams: R1 at C = 16 against its plain version")
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    dev = torch.device("cuda")
    w = rn.weights_to(rn.default_weights(), dev)
    w64 = {k: v.double() for k, v in w.items()}

    def features(K, streams):
        state = rn.denoise_init(streams, dev)
        _, f, _, _, _, s = rn.analysis_frames_batch(
            state, torch.from_numpy(rnn_bank_frames(K, streams=streams)).to(dev))
        return f, s, state.rnn

    feats, sil, rnn = features(100, RNN_BANK_STREAMS)
    print(f"front-end features of the 16 streams, 100 frames: max |feature| "
          f"{float(feats.abs().max()):.2f} (stream 5, silent first: "
          f"{float(feats[:, 5].abs().max()):.2f})")
    cases = {
        f"{RNN_BANK_K} frames x 16 streams": (feats[:RNN_BANK_K], sil[:RNN_BANK_K], rnn),
        "100 frames x 16 streams": (feats, sil, rnn),
        "one frame x 16 streams": (feats[:1], sil[:1], rnn),
        "16 frames x 16 streams, every frame silent": (
            feats[:RNN_BANK_K], torch.ones_like(sil[:RNN_BANK_K]), rnn),
        "stream 5 alone (silent first, then speaking), 16 frames": (
            feats[:RNN_BANK_K, 5:6], sil[:RNN_BANK_K, 5:6], rn.RnnState(*(h[5:6] for h in rnn))),
        "16 frames x 33 streams": features(RNN_BANK_K, 33),
    }
    timed = []
    for label, (f, s, r) in cases.items():
        f, s = f.contiguous(), s.contiguous()
        r = rn.RnnState(*(h.contiguous() for h in r))
        got = gru.rnn_frames(f, s, r, w)
        torch.cuda.synchronize()
        ref = gru.rnn_frames_plain(f, s, r, w)
        ref64 = gru.rnn_frames_plain(f.double(), s, rn.RnnState(*(h.double() for h in r)), w64)
        err, err_k64, err_p64 = _r1_errs(got, ref), _r1_errs(got, ref64), _r1_errs(ref, ref64)
        gate = max(R1_TOL, 2 * err_p64)
        print(f"R1 {label}: kernel vs plain {err:.3e}; against the plain version in float64: "
              f"kernel {err_k64:.3e}, plain {err_p64:.3e} (gate {gate:.3e})")
        if err_k64 > gate or not all(bool(torch.isfinite(t).all())
                                     for t in (*got[:2], *got[2])):
            raise AssertionError(f"R1 {label}, against float64: {err_k64:.3e}")
        if bool(s.all()) and not all(torch.equal(a, b) for a, b in zip(got[2], r)):
            raise AssertionError("R1 moved the states on a buffer whose frames are all silent")
        ms = cuda_ms(lambda: gru.rnn_frames(f, s, r, w))
        _r1_row(label, f, s, ms, card_line)
        K, C = f.shape[0], f.shape[1]
        if C != RNN_BANK_STREAMS or K not in (RNN_BANK_K, 100) or bool(s.all()):
            continue
        plain_ms = cuda_ms(lambda: gru.rnn_frames_plain(f, s, r, w), iters=5, warmup=1)
        bound_ms, bound_by, flop, nbytes = _r1_bound(f, s)
        print(f"R1 {K} frames x {C} streams ({K * C - int(s.sum())} not silent): kernel "
              f"{ms:.4f} ms, plain (torch ops on the card) {plain_ms:.3f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flop} f32 operations); floor "
              f"estimated {K * R1_FRAME_CYCLES / _sm_clock_hz() * 1e3:.4f} ms [{card_line}]")
        timed.append(dict(case=f"{K} frames x {C} streams of front-end features", ms=ms,
                          plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                          max_abs_err=err, library_ms=None, flop=flop, bytes=nbytes))
    return timed


def rnnoise_bank_path(card_line):
    """Phase 4d': the 16-stream denoiser as bench.py drives it, through
    denoise_frames_fast at C = 16 over RNN_BANK_CALLS calls of 16 frames
    with R1's counter set to 0 just before and read just after: one R1
    call a call, finite output of the right shape; then one call timed (CUDA
    events behind a spin) as bench.py's realtime-x of the bank."""
    phase("4d' the denoiser over 16 streams (denoise_frames_fast at C = 16) on the card")
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    dev = torch.device("cuda")
    w = rn.weights_to(rn.default_weights(), dev)
    x = torch.from_numpy(rnn_bank_frames(RNN_BANK_CALLS * RNN_BANK_K, seed=22)).to(dev)
    state = rn.denoise_init(RNN_BANK_STREAMS, dev)
    gru.launches = 0
    outs, vads = [], []
    for i in range(RNN_BANK_CALLS):
        state, o, v = rn.denoise_frames_fast(state, w, x[i * RNN_BANK_K:(i + 1) * RNN_BANK_K])
        outs.append(o)
        vads.append(v)
    torch.cuda.synchronize()
    counted = gru.launches
    out, vad = torch.cat(outs), torch.cat(vads)
    seconds = RNN_BANK_CALLS * RNN_BANK_K * rn.FRAME_SIZE / 48000
    print(f"denoise_frames_fast, {RNN_BANK_STREAMS} streams x {seconds} s in {RNN_BANK_CALLS} "
          f"calls of {RNN_BANK_K} frames: R1 launches {counted}; output {tuple(out.shape)}, rms "
          f"{float(out.pow(2).mean().sqrt()):.1f} s16 units; stream 5's first two VADs "
          f"{[float(v) for v in vad[:2, 5]]}")
    if counted != RNN_BANK_CALLS:
        raise AssertionError("R1 launches != denoise_frames_fast calls")
    if tuple(out.shape) != (RNN_BANK_CALLS * RNN_BANK_K, RNN_BANK_STREAMS, rn.FRAME_SIZE) \
            or not bool(torch.isfinite(out).all()) or bool((vad[:2, 5] != 0).any()):
        raise AssertionError("the 16-stream denoiser: shape, finiteness or the silent VADs")
    chunk = x[:RNN_BANK_K]
    ms = cuda_ms(lambda: rn.denoise_frames_fast(state, w, chunk))
    print(f"denoise_frames_fast at C = 16, {RNN_BANK_K} frames: {ms:.4f} ms a call (CUDA events "
          f"behind a spin, median of 20), realtime-x of the bank "
          f"{RNN_BANK_STREAMS * RNN_BANK_K * rn.FRAME_SIZE / 48000 / (ms / 1e3):.1f} "
          f"[{card_line}]")
    return {"rnnoise_gru_16_streams": counted}


def rnnoise_bank_card_vs_cpu():
    """Phase 5d': denoise_frames_fast at C = 16 over two calls of 16 frames,
    on the card (R1, cuFFT) and on the CPU (the plain frame loop)."""
    phase("5d' the denoiser over 16 streams, card against CPU")
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    x = rnn_bank_frames(2 * RNN_BANK_K, seed=23)
    w = rn.default_weights()
    sc, sh = rn.denoise_init(RNN_BANK_STREAMS, "cuda"), rn.denoise_init(RNN_BANK_STREAMS, "cpu")
    wc, wh = rn.weights_to(w, "cuda"), rn.weights_to(w, "cpu")
    d_stream = torch.zeros(RNN_BANK_STREAMS, dtype=torch.float64)
    d_vad, flips = 0.0, 0
    for chunk in (x[:RNN_BANK_K], x[RNN_BANK_K:]):
        # the pitch period feature (index 40) of both front ends: a near-tie
        # of two autocorrelation scores may pick another period
        _, fc, *_ = rn.analysis_frames_batch(sc, torch.from_numpy(chunk).to("cuda"))
        _, fh, *_ = rn.analysis_frames_batch(sh, torch.from_numpy(chunk))
        flips += int((fc[..., 40].cpu() != fh[..., 40]).sum())
        sc, oc, vc = rn.denoise_frames_fast(sc, wc, torch.from_numpy(chunk).to("cuda"))
        sh, oh, vh = rn.denoise_frames_fast(sh, wh, torch.from_numpy(chunk))
        d_stream = torch.maximum(d_stream, (oc.cpu() - oh).abs().amax(dim=(0, 2)).double())
        d_vad = max(d_vad, float((vc.cpu() - vh).abs().max()))
    d_out = float(d_stream.max())
    print(f"denoise_frames_fast, 16 streams x 2 calls of {RNN_BANK_K} frames, card vs CPU: max "
          f"{d_out:.4f} s16 units (gate {RNN_BANK_CPU_TOL:.2f}) on stream {int(d_stream.argmax())}"
          f" (stream 5 starts silent: {float(d_stream[5]):.4f}; the others at most "
          f"{float(torch.cat([d_stream[:5], d_stream[6:]]).max()):.4f}), VAD {d_vad:.3e} (gate "
          f"{VAD_PATH_TOL}); pitch periods that differ: {flips} of "
          f"{2 * RNN_BANK_K * RNN_BANK_STREAMS}")
    if d_out > RNN_BANK_CPU_TOL or d_vad > VAD_PATH_TOL:
        raise AssertionError("the 16-stream denoiser: card and CPU disagree")


# ---------------------------------------------------------------------------
# Video composition at 1080p: videoscale, skiacompositor, roundedcorners,
# colordetect, videocompare, and a videoconvertscale chain
# ---------------------------------------------------------------------------

COMP_FRAMES = 30           # frames of the composition path in phase 4e
COMP_TIMING_FRAMES = 120   # ... timed in phase 6e
COMP_PROFILE_FRAMES = 10   # ... under torch.profiler
SCALED_W, SCALED_H = 1280, 720  # videoscale's output in front of the compositor
PAD_W, PAD_H = 480, 270         # that pad's placement size: the antialiased downscale
CORNER_RADIUS = 48


def compose_launch(frames: int) -> str:
    """Path 1: three 30 fps sources into skiacompositor (sink_0 the 1080p
    SMPTE frame, sink_1 a checkers frame scaled to 720p by videoscale, sink_2
    a white 640x360 frame partly out of bounds); the composite tee'd into
    videoconvert ! I420 ! roundedcorners, into colordetect ! videocompare
    (against the unmodified SMPTE source) and into an appsink; a second
    videocompare gets the unmodified source on both pads.  No
    `queue`: the aggregators take no lock, and queue threads feeding one
    from two sides reorder its output (ROADMAP section C); the tees push in
    order on the sources' thread."""
    hd = f"video/x-raw,format=RGBA,width={HD_W},height={HD_H},framerate=30/1"
    return (
        f"videotestsrc pattern=smpte num-buffers={frames} ! {hd} ! tee name=ta "
        f"ta. ! comp. ta. ! cmp. ta. ! same. ta. ! same. "
        f"videotestsrc pattern=checkers-8 num-buffers={frames} ! {hd} "
        f"! videoscale ! video/x-raw,width={SCALED_W},height={SCALED_H} ! comp. "
        f"videotestsrc pattern=white num-buffers={frames} "
        f"! video/x-raw,format=RGBA,width=640,height=360,framerate=30/1 ! comp. "
        f"skiacompositor name=comp ! tee name=tc "
        f"tc. ! videoconvert ! video/x-raw,format=I420 "
        f"! roundedcorners border-radius-px={CORNER_RADIUS} ! appsink name=rounded "
        f"tc. ! colordetect ! cmp. "
        f"tc. ! appsink name=canvas "
        f"videocompare name=cmp ! appsink name=cmpsink "
        f"videocompare name=same ! appsink name=samesink")


# the pads' placement: sink_1 at (960, 270) over the SMPTE bars near the
# blockhash median, so the composite's hash differs from the source's; sink_2
# at (1600, -100), 640x360, cropped to its lower left 320x260
PAD_PROPS = {
    "sink_1": {"xpos": 960.0, "ypos": 270.0, "width": float(PAD_W), "height": float(PAD_H),
               "alpha": 0.7, "operator": "over", "anti-alias": True},
    "sink_2": {"xpos": 1600.0, "ypos": -100.0},
}


def compose_pipeline(frames: int):
    import gst_plugins_rs_tpu_torch as g

    p = g.parse_launch(compose_launch(frames))
    pads = {pad.name: pad for pad in p.by_name("comp").agg_pads()}
    for name, props in PAD_PROPS.items():
        for k, v in props.items():
            pads[name].set_property(k, v)
    return p


def convertscale_pipeline(frames: int):
    import gst_plugins_rs_tpu_torch as g

    return g.parse_launch(convertscale_launch(frames))


def convertscale_launch(frames: int) -> str:
    return (f"videotestsrc pattern=smpte num-buffers={frames} "
            f"! video/x-raw,format=RGBA,width={HD_W},height={HD_H},framerate=30/1 "
            f"! videoconvert ! video/x-raw,format=I420 ! videoconvertscale "
            f"! video/x-raw,format=RGB,width={SCALED_W},height={SCALED_H} ! appsink name=sink")


def _element_messages(msgs, name, src=None):
    """The structures of the element messages called `name` among `msgs`
    (posted by the element called `src`, when given)."""
    return [m.structure for m in msgs
            if m.structure is not None and m.structure.name == name
            and (src is None or getattr(m.src, "name", None) == src)]


def compose_pipelines():
    """Phase 4e: path 1 over COMP_FRAMES frames and the videoconvertscale
    chain: frame counts, PTS and caps on every sink, the A420 alpha plane,
    colordetect's palette message, videocompare's matches (every frame for
    identical input, none for the composite); everything on the card."""
    phase("4e video composition pipelines on the card")
    from gst_plugins_rs_tpu_torch.elements.video.roundedcorners import rounded_alpha_mask

    p = compose_pipeline(COMP_FRAMES)
    t0 = time.perf_counter()
    p.play_until_eos()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want_pts = [i * (10**9 // 30) for i in range(COMP_FRAMES)]  # videotestsrc: n x duration
    sinks = {n: p.by_name(n) for n in ("rounded", "canvas", "cmpsink", "samesink")}
    for name, s in sinks.items():
        pts = [x.buffer.pts for x in s.samples]
        if len(s.samples) != COMP_FRAMES or pts != want_pts:
            raise AssertionError(f"{name}: {len(s.samples)} frames, PTS {pts[:3]}...")
        data = s.samples[0].buffer.data
        if any(t.device.type != "cuda" for t in (data if isinstance(data, tuple) else (data,))):
            raise AssertionError(f"{name}: output is not on the card")
    # videocompare sends no caps event downstream, in both packages
    caps = {n: sinks[n].caps.structure(0) for n in ("rounded", "canvas")}
    if (caps["rounded"]["format"], caps["canvas"]["format"]) != ("A420", "RGBA") or any(
            (c["width"], c["height"]) != (HD_W, HD_H) for c in caps.values()) \
            or any(tuple(sinks[n].samples[0].buffer.data.shape) != (HD_H, HD_W, 4)
                   for n in ("canvas", "cmpsink", "samesink")):
        raise AssertionError(f"caps {caps} or frame shapes")
    y, u, v, a = sinks["rounded"].samples[-1].buffer.data
    shapes = [tuple(t.shape) for t in (y, u, v, a)]
    mask = rounded_alpha_mask(h=HD_H, w=HD_W, radius=CORNER_RADIUS, dev=torch.device("cpu"))
    if shapes != [(HD_H, HD_W), (HD_H // 2, HD_W // 2), (HD_H // 2, HD_W // 2), (HD_H, HD_W)] \
            or not torch.equal(a.cpu(), mask) or int(a[0, 0]) != 0 or int(a[540, 960]) != 255:
        raise AssertionError(f"A420 planes {shapes} or the alpha plane")
    canvas = sinks["canvas"].samples[0].buffer.data
    msgs = list(p.bus.messages())  # the bus hands each message out once
    detect = _element_messages(msgs, "colordetect")
    same = [m for m in _element_messages(msgs, "videocompare", "same")
            if m["pad-distances"][0]["distance"] == 0]
    cmp_msgs = len(_element_messages(msgs, "videocompare", "cmp"))
    print(f"composition path {HD_W}x{HD_H}, {COMP_FRAMES} frames in {secs:.3f} s (first run, "
          f"set-up included): every sink {COMP_FRAMES} frames with PTS i x 33333333 ns on the card; "
          f"A420 planes {shapes}, alpha plane equal to the CPU mask (radius {CORNER_RADIUS}); "
          f"canvas mean {float(canvas.float().mean()):.3f}; colordetect "
          f"{[(m['dominant-color'], [hex(c) for c in m['palette']]) for m in detect]}; "
          f"videocompare: {len(same)} matches for identical input, {cmp_msgs} for the composite")
    if not detect or not all(m["palette"] for m in detect):
        raise AssertionError("colordetect posted no palette")
    if len(same) != COMP_FRAMES or cmp_msgs != 0:
        raise AssertionError("videocompare: expected a match a frame for identical input and "
                             "none for the composite")
    p = _play(convertscale_launch(COMP_FRAMES))
    s = p.by_name("sink").samples
    if len(s) != COMP_FRAMES or tuple(s[0].buffer.data.shape) != (SCALED_H, SCALED_W, 3) \
            or s[0].buffer.data.device.type != "cuda" \
            or [x.buffer.pts for x in s] != want_pts:
        raise AssertionError("videoconvertscale I420 1080p -> RGB 720p")
    print(f"videoconvertscale I420 {HD_W}x{HD_H} -> RGB {SCALED_W}x{SCALED_H}: {len(s)} frames, "
          f"PTS exact, on the card")


def _composition_outputs(frames: int = 1):
    """The composite, the A420 planes, the messages and the
    videoconvertscale frame of one run on the current device, on the host."""
    p = compose_pipeline(frames)
    p.play_until_eos()
    rounded = p.by_name("rounded").samples[-1].buffer.data
    msgs = list(p.bus.messages())
    msgs = [repr(m) for m in _element_messages(msgs, "colordetect")
            + _element_messages(msgs, "videocompare")]
    scaled = _play(convertscale_launch(1)).by_name("sink").samples[0].buffer.data
    return (p.by_name("canvas").samples[-1].buffer.data.cpu(),
            tuple(t.cpu() for t in rounded), msgs, scaled.cpu())


def compose_card_vs_cpu():
    """Phase 5e: one frame of path 1 and of the videoconvertscale chain on
    the card and on the CPU: the composite, the A420 planes and the scaled
    frame within LSB_TOL, the same messages."""
    phase("5e video composition, card against CPU")
    card_out, host_out = _composition_outputs(), _on("cpu", _composition_outputs)
    d_canvas = _lsb(card_out[0].numpy(), host_out[0].numpy())
    d_planes = max(_lsb(a.numpy(), b.numpy()) for a, b in zip(card_out[1], host_out[1]))
    d_scaled = _lsb(card_out[3].numpy(), host_out[3].numpy())
    print(f"composition {HD_W}x{HD_H}, card vs CPU: composite {d_canvas} LSB, A420 planes "
          f"{d_planes} LSB, videoconvertscale frame {d_scaled} LSB (gate {LSB_TOL}); "
          f"messages equal: {card_out[2] == host_out[2]}")
    if max(d_canvas, d_planes, d_scaled) > LSB_TOL or card_out[2] != host_out[2]:
        raise AssertionError("composition: card and CPU disagree")


def compose_timing(card_line):
    """Phase 6e: path 1 and the videoconvertscale chain, wall-clock frames
    per second over COMP_TIMING_FRAMES (after a warm-up run), device busy
    ms per frame and the top device ops (torch.profiler)."""
    phase("6e video composition timing")
    from gst_plugins_rs_tpu_torch.core import State
    from gst_plugins_rs_tpu_torch.elements.video.compositor import composite
    from gst_plugins_rs_tpu_torch.ops.resize import resize_matrices, resize_u8

    # the path's two device steps alone, CUDA events: videoscale's 1080p ->
    # 720p resize and one composite of the three pads at the path's placement
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = [torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
              for shape in ((HD_H, HD_W, 4), (SCALED_H, SCALED_W, 4), (260, 320, 4))]
    ah, aw = resize_matrices(HD_H, HD_W, SCALED_H, SCALED_W, "bilinear", "cuda")
    resize_ms = cuda_ms(lambda: resize_u8(frames[0], ah, aw))
    placements = [(0, 0, HD_W, HD_H), (960, 270, PAD_W, PAD_H), (1600, 0, 320, 260)]
    comp_ms = cuda_ms(lambda: composite(frames, [1.0, 0.7, 1.0], placements, out_h=HD_H,
                                        out_w=HD_W, channels=4, operators=["over"] * 3,
                                        methods=["linear"] * 3))
    print(f"videoscale RGBA {HD_W}x{HD_H} -> {SCALED_W}x{SCALED_H} (resize_u8): {resize_ms:.4f} ms; "
          f"skiacompositor's composite of the path's three pads: {comp_ms:.4f} ms (CUDA events, "
          f"median) [{card_line}]")
    rows = {"resize_ms": resize_ms, "composite_ms": comp_ms}
    for label, make in (("composition path (3 sources, videoscale, skiacompositor, "
                         "roundedcorners, colordetect, 2 videocompare)", compose_pipeline),
                        ("videoconvertscale I420 1080p -> RGB 720p (with its source)",
                         convertscale_pipeline)):
        make(COMP_PROFILE_FRAMES).play_until_eos()  # warm-up
        torch.cuda.synchronize()
        p = make(COMP_TIMING_FRAMES)
        p.set_state(State.PLAYING)
        t0 = time.perf_counter()
        p.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        p.set_state(State.NULL)
        device_ms, upload_ms, top = profile_pipeline(lambda: make(COMP_PROFILE_FRAMES))
        per_frame = device_ms / COMP_PROFILE_FRAMES
        rows[label] = dict(fps=COMP_TIMING_FRAMES / secs, device_ms=per_frame)
        print(f"{label}, {HD_W}x{HD_H}: {COMP_TIMING_FRAMES} frames in {secs:.3f} s, "
              f"{COMP_TIMING_FRAMES / secs:.2f} frames/s end to end; device busy "
              f"{per_frame:.4f} ms per frame (torch.profiler, {COMP_PROFILE_FRAMES} frames, "
              f"host-to-device copies left out: {upload_ms:.4f} ms in all), "
              f"{100 * per_frame * COMP_TIMING_FRAMES / (secs * 1e3):.1f}% of the wall time; "
              f"ms per frame by device op: "
              + ", ".join(f"{name} {ms / COMP_PROFILE_FRAMES:.4f}" for name, ms in top)
              + f" [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# Demucs at its published width (model-name=demucs) and demucs-lite
# ---------------------------------------------------------------------------

DEMUCS_SECONDS = 30        # of 48 kHz stereo audio through model-name=demucs in 4f and 6f
DEMUCS_PARAMS = 265_646_728  # channels 64, depth 6, two BiLSTM layers (flax's tree)
# one 1 s segment at full width, card (cuDNN convs and LSTM, cuBLAS, TF32
# off) against CPU: max |d| over max |ref| a stem tensor
DEMUCS_CPU_TOL = 1e-3
STEMS = ("drums", "bass", "other", "vocals")


def demucs_launch(seconds: int, model: str = "demucs", rate: int = 48000, wave: str = "saw",
                  freq: float = 220.0, segment: int = 10**9) -> str:
    spb = rate // 10
    return (f"audiotestsrc wave={wave} freq={freq} num-buffers={seconds * 10} "
            f"samplesperbuffer={spb} ! audio/x-raw,format=F32,rate={rate},channels=2 "
            f"! demucs name=d model-name={model} segment-duration={segment} "
            + " ".join(f"d.src_{s} ! appsink name={s}" for s in STEMS))


def demucs_pipelines():
    """Phase 4f: DEMUCS_SECONDS of 48 kHz stereo through model-name=demucs
    (weights from the port's torch.Generator initialiser, seed 0): four stems
    a 1 s segment, 48 000 samples each, finite, PTS i s, on the card, and the
    published parameter count; then demucs-lite with the packaged weights: an
    80 Hz sine routes mostly to src_bass."""
    phase("4f Demucs pipelines on the card")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import State

    p = g.parse_launch(demucs_launch(DEMUCS_SECONDS))
    t0 = time.perf_counter()
    p.set_state(State.PAUSED)
    model = p.by_name("d")._model
    n_params = sum(t.numel() for n, t in model.named_parameters() if "bias_ih" not in n)
    setup = time.perf_counter() - t0
    t1 = time.perf_counter()
    p.play_until_eos()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    for s in STEMS:
        samples = p.by_name(s).samples
        pts = [x.buffer.pts for x in samples]
        if len(samples) != DEMUCS_SECONDS or pts != [i * 10**9 for i in range(DEMUCS_SECONDS)] \
                or any(tuple(x.buffer.data.shape) != (48000, 2) for x in samples) \
                or any(x.buffer.data.device.type != "cuda" for x in samples) \
                or not all(bool(torch.isfinite(x.buffer.data).all()) for x in samples):
            raise AssertionError(f"demucs src_{s}: segments, PTS, shape, device or finiteness")
    rms = {s: float(np.sqrt((p.by_name(s).concat_audio() ** 2).mean())) for s in STEMS}
    print(f"demucs model-name=demucs: {n_params} parameters (flax's count; the torch LSTMs' "
          f"zero bias_ih not counted), set-up {setup:.3f} s (the draws, on the card); "
          f"{DEMUCS_SECONDS} s of 48 kHz stereo in {secs:.3f} s: {DEMUCS_SECONDS} "
          f"segments of 48000 samples on each of 4 stems, PTS exact, finite; rms {rms}")
    if n_params != DEMUCS_PARAMS:
        raise AssertionError(f"demucs: {n_params} parameters, expected {DEMUCS_PARAMS}")
    p = _play(demucs_launch(1, "demucs-lite", rate=44100, wave="sine", freq=80.0,
                            segment=500_000_000))
    powers = {s: float((p.by_name(s).concat_audio() ** 2).mean()) for s in STEMS}
    print(f"demucs-lite, packaged weights, 1 s of an 80 Hz sine at 44.1 kHz: stem powers {powers}")
    if powers["bass"] != max(powers.values()) or not powers["bass"] > 3 * powers["drums"]:
        raise AssertionError("demucs-lite: the bass-band input did not route to src_bass")


def demucs_card_vs_cpu():
    """Phase 5f: one 1 s segment at full width (the element's seed-0 weights,
    drawn on the card and copied to the host) through the model on the card
    and on the CPU."""
    phase("5f Demucs, card against CPU")
    from gst_plugins_rs_tpu_torch.models import demucs as dm

    cfg = dm.DemucsConfig()
    state = dm.init_weights(cfg, 0, "cuda")  # the element's draws on the card, seed 0
    card_model = dm.build(cfg, state, "cuda")
    host_model = dm.build(cfg, {k: v.cpu() for k, v in state.items()}, "cpu")
    t = np.arange(48000) / 48000.0
    seg = np.stack([np.sin(2 * np.pi * 220 * t), np.sign(np.sin(2 * np.pi * 330 * t))], -1)
    mix = torch.zeros((1, cfg.valid_length(48000), 2))
    mix[0, :48000] = torch.from_numpy(0.5 * seg.astype(np.float32))
    with torch.no_grad():
        got = card_model(mix.cuda()).cpu()[0, :, :48000]
        ref = host_model(mix)[0, :, :48000]
    rel = [float((got[i] - ref[i]).abs().max() / ref[i].abs().max()) for i in range(4)]
    print(f"demucs 1 s segment at full width, card vs CPU: max |d| / max |ref| per stem "
          f"{['%.3e' % r for r in rel]} (gate {DEMUCS_CPU_TOL})")
    if not torch.isfinite(got).all() or max(rel) > DEMUCS_CPU_TOL:
        raise AssertionError("demucs: card and CPU disagree")


def demucs_timing(card_line):
    """Phase 6f: model-name=demucs over DEMUCS_SECONDS (after a warm-up run,
    set-up left out): seconds of audio per wall second, device busy ms per
    1 s segment and the top device ops (torch.profiler over 3 segments)."""
    phase("6f Demucs timing")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import State
    from gst_plugins_rs_tpu_torch.models import demucs as dm

    cfg = dm.DemucsConfig()
    model = dm.build(cfg, dm.init_weights(cfg, 0, "cuda"), "cuda")
    x = torch.randn((1, cfg.valid_length(48000), 2), generator=torch.Generator(
        device="cuda").manual_seed(6), device="cuda")
    with torch.no_grad():
        seg_ms = cuda_ms(lambda: model(x), iters=10)
    del model
    print(f"demucs forward at full width, one 1 s segment ({cfg.valid_length(48000)} samples "
          f"with the padding): {seg_ms:.4f} ms (CUDA events, median) [{card_line}]")
    rows = {"segment_ms": seg_ms}
    for model in ("demucs", "demucs-lite"):
        _play(demucs_launch(2, model))  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        p = g.parse_launch(demucs_launch(DEMUCS_SECONDS, model))
        p.set_state(State.PLAYING)  # the weights: drawn or loaded, copied to the card
        t0 = time.perf_counter()
        p.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        p.set_state(State.NULL)
        n_prof = 3
        device_ms, upload_ms, top = profile_pipeline(
            lambda: g.parse_launch(demucs_launch(n_prof, model)))
        rows[model] = dict(audio_s_per_s=DEMUCS_SECONDS / secs, device_ms=device_ms / n_prof)
        print(f"demucs model-name={model}, 48 kHz stereo in 1 s segments: {DEMUCS_SECONDS} s of "
              f"audio in {secs:.3f} s, {DEMUCS_SECONDS / secs:.2f} s of audio per second; "
              f"device busy {device_ms / n_prof:.4f} ms per segment (torch.profiler, {n_prof} "
              f"segments, host-to-device copies left out: {upload_ms:.4f} ms in all), "
              f"{100 * (device_ms / n_prof) * DEMUCS_SECONDS / (secs * 1e3):.1f}% of the wall "
              f"time; ms per segment by device op: "
              + ", ".join(f"{name} {ms / n_prof:.4f}" for name, ms in top) + f" [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# Speech transcription: whispertranscriber's builtin asr-lite model (log-mel,
# two BiGRU layers of 96 as kernel T1, a CTC head) at its only width
# ---------------------------------------------------------------------------
SPEECH_RATE = 16000
SPEECH_CHUNK = 5 * SPEECH_RATE  # chunk-duration 5 s: 498 frames, padded to 500
SPEECH_SPB = 1600               # appsrc buffers of 100 ms
# Six 5 s chunks, 30 s of speech: each one synthesised sentence (the words of
# one of the five fixed commands of tests/test_asr_quality.py, then words drawn
# from the lexicon with the chunk's seed; the sixth all drawn), as many words
# as fit, the rest of the chunk the sentence's own noise level (30 dB SNR).
# Every chunk ends at a sentence boundary.  The model reads whole chunks: its
# word accuracy on such 8-10 word sentences is ~0.9, so the seeds are the
# first of each chunk's range whose chunk the JAX package's model transcribes
# word for word (selected on the CPU with the JAX package); the port must
# give the same words on the card and on the CPU.
SPEECH_CHUNKS = ((["open", "door"], 70_000_000), (["volume", "up"], 70_001_000),
                 (["seven", "three", "zero"], 70_002_000), (["hello", "world"], 70_003_005),
                 (["stop"], 70_004_001), ([], 70_005_004))
T1_TOL = 1e-5          # T1 vs plain: |d| / (1 + |ref|) on the hidden states
ASR_LOGIT_TOL = 1e-4   # the model's logits, card vs CPU
ASR_HIDDEN = 96
ASR_T = 500            # frames of a padded 5 s chunk
# an estimate, not a measurement, of T1's floor a step (the csrc/asr_gru.cu
# header's reckoning): for the r rows and again for the candidate rows, the
# first shared load after the hand-off (~30 cycles), 96 FMAs a lane (one
# warp a sub-partition), one shuffle and add (~30) and the gate (~40); the
# two hand-offs through shared memory and a named barrier (~40 each) and the
# blend and store (~20); printed beside the measured cycles a step only
T1_STEP_CYCLES = 2 * (30 + 96 + 30 + 40) + 2 * 40 + 20
T1_EDGE_T = (1, 2, 50)  # utterances shorter than the X ring, and the shortest bucket
T1_SATURATE = 20.0      # layer inputs scaled so the gates sit at 0 or 1


def speech_chunks():
    """[(audio [SPEECH_CHUNK] f32, words)] of the speech path."""
    from gst_plugins_rs_tpu_torch.ops.speechsynth import LEXICON, synth_sentence

    vocab = sorted(LEXICON)
    out = []
    for prefix, seed in SPEECH_CHUNKS:
        rng = np.random.default_rng(seed)
        words = prefix + [vocab[int(rng.integers(len(vocab)))] for _ in range(16)]
        best = None
        for n in range(max(1, len(prefix)), len(words) + 1):
            a = synth_sentence(words[:n], seed=seed, noise_snr_db=30)
            if a.size > SPEECH_CHUNK:
                break
            best = (a, words[:n])
        a, ws = best
        level = np.sqrt(float((a ** 2).mean()) / 10 ** 3)
        pad = np.random.default_rng(seed + 1).standard_normal(SPEECH_CHUNK - a.size) * level
        out.append((np.concatenate([a, pad.astype(np.float32)]), " ".join(ws)))
    return out


def _transcribe_path(audio, chunk_ns=5 * 10**9):
    """appsrc (100 ms F32 16 kHz mono buffers) ! whispertranscriber ! appsink
    on the selected device: the output samples."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import Buffer

    p = g.parse_launch(f"appsrc name=src caps=audio/x-raw,format=F32,rate={SPEECH_RATE},"
                       f"channels=1 ! whispertranscriber chunk-duration={chunk_ns} "
                       f"! appsink name=sink")
    src = p.by_name("src")
    for i in range(0, audio.size, SPEECH_SPB):
        src.push_buffer(Buffer(torch.from_numpy(audio[i:i + SPEECH_SPB, None]),
                               pts=i * 10**9 // SPEECH_RATE,
                               duration=SPEECH_SPB * 10**9 // SPEECH_RATE))
    src.end_of_stream()
    p.play_until_eos()
    return p.by_name("sink").samples


def asr_kernel(card_line):
    """Phase 3g: T1 against its plain version (a step loop of torch ops on the
    card) for both layers and both directions at T = 500, on the log-mel
    features of the path's first chunk (layer 1 on the plain layer 0's
    states) and on seeded random ones, then on the edge cases of
    _asr_kernel_edges; then timed beside its bounds and the cycles a step
    beside its reckoned floor."""
    phase("3g speech: the BiGRU kernel T1 against its plain version")
    from gst_plugins_rs_tpu_torch.ops import asr, asr_gru

    dev = torch.device("cuda")
    w = asr.load_weights(dev=dev)
    audio, _ = speech_chunks()[0]
    feats, t = asr.padded_features(torch.from_numpy(audio).to(dev))
    if feats.shape[0] != ASR_T:
        raise AssertionError(f"a 5 s chunk gives {feats.shape[0]} padded frames, not {ASR_T}")
    rand = torch.from_numpy(np.random.RandomState(8).randn(1, ASR_T, asr.N_MEL)
                            .astype(np.float32)).to(dev)
    max_err, inputs = 0.0, {}
    for label, x in (("log-mel", feats[None]), ("random", rand)):
        for layer in range(2):
            Wx, b, U = asr.layer_mats(w, layer)
            X = asr.input_projections(x, Wx, b)
            got = asr_gru.bigru(X, U)
            torch.cuda.synchronize()
            ref = asr_gru.bigru_plain(X, U)
            err = float(((got - ref).abs() / (1 + ref.abs())).max())
            max_err = max(max_err, err)
            print(f"T1 {label} features, layer {layer} (input {x.shape[-1]} wide)"
                  f", both directions, T = {ASR_T}: max error {err:.3e} (gate {T1_TOL})")
            if err > T1_TOL or not torch.isfinite(got).all():
                raise AssertionError(f"T1 against its plain version, {label} layer {layer}")
            inputs[label, layer] = (X, U)
            x = torch.cat([ref[:, 0], ref[:, 1]], -1)
    max_err = max(max_err, _asr_kernel_edges(feats[None], w))
    X, U = inputs["log-mel", 0]
    ms = cuda_ms(lambda: asr_gru.bigru(X, U))
    plain_ms = cuda_ms(lambda: asr_gru.bigru_plain(X, U), iters=3, warmup=1)
    # one layer of one utterance: X read once, U read once, the states written
    # once; the recurrent products and the gate math of both directions
    H = ASR_HIDDEN
    nbytes = 4 * (X.numel() + U.numel() + 2 * ASR_T * H)
    flop = 2 * ASR_T * (2 * 3 * H * H + 12 * H)
    bound_ms, bound_by = bound(flop, nbytes)
    chain_ms = ASR_T * T1_STEP_CYCLES / _sm_clock_hz() * 1e3
    print(f"T1 one layer, 2 directions x {ASR_T} steps: kernel {ms:.4f} ms, plain (torch ops on "
          f"the card) {plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, {flop} "
          f"f32 operations); no library call computes it (cuDNN's GRU applies r after the "
          f"product) [{card_line}]")
    print(f"T1 {ms * 1e-3 * _sm_clock_hz() / ASR_T:.0f} cycles a step measured at the max SM clock; "
          f"floor estimated ~{T1_STEP_CYCLES} cycles a step, {chain_ms:.4f} ms ({ASR_T} steps) "
          f"[{card_line}]")
    return dict(case=f"one layer of a 5 s chunk, T = {ASR_T}, both directions", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max_err,
                library_ms=None, flop=flop, bytes=nbytes)


def _asr_kernel_edges(x, w):
    """T1's edge cases against its plain version, one launch a call: both
    layers at T = 1, 2 and 50 (the first frames of x [1, T, 40]) and with
    saturated gates at T = 500, and the six speech chunks in one call (each
    row equal to its call alone).  Returns the largest error."""
    from gst_plugins_rs_tpu_torch.ops import asr, asr_gru

    def check(label, X, U):
        before = asr_gru.launches
        got = asr_gru.bigru(X, U)
        torch.cuda.synchronize()
        if asr_gru.launches != before + 1:
            raise AssertionError(f"T1 {label}: {asr_gru.launches - before} launches, not 1")
        ref = asr_gru.bigru_plain(X, U)
        err = float(((got - ref).abs() / (1 + ref.abs())).max())
        print(f"T1 {label}: max error {err:.3e} (gate {T1_TOL})")
        if err > T1_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"T1 against its plain version, {label}")
        return got, ref, err

    max_err = 0.0
    for label, xs, scale in [(f"T = {n}", x[:, :n], 1.0) for n in T1_EDGE_T] + [
            (f"saturated gates (inputs x{T1_SATURATE:g}), T = {x.shape[1]}", x, T1_SATURATE)]:
        for layer in range(2):
            Wx, b, U = asr.layer_mats(w, layer)
            _, ref, err = check(f"{label}, layer {layer}",
                                asr.input_projections(scale * xs, Wx, b), U)
            max_err = max(max_err, err)
            xs = torch.cat([ref[:, 0], ref[:, 1]], -1)
    Wx, b, U = asr.layer_mats(w, 0)
    six = torch.stack([asr.padded_features(torch.from_numpy(a).to(x.device))[0]
                       for a, _ in speech_chunks()])
    X = asr.input_projections(six, Wx, b)
    got, _, err = check(f"the {len(six)} speech chunks in one call, layer 0", X, U)
    if not all(torch.equal(got[i:i + 1], asr_gru.bigru(X[i:i + 1].contiguous(), U))
               for i in range(len(six))):
        raise AssertionError("T1: a chunk of the batched call differs from its call alone")
    return max(max_err, err)


def speech_pipeline():
    """Phase 4g: 30 s of speech through appsrc ! whispertranscriber
    chunk-duration=5 s ! appsink with T1's counter set to 0 just before and
    read just after: two launches a chunk, the spoken words of every chunk,
    PTS and durations spanning the chunks, str payloads."""
    phase("4g speech transcription on the card")
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    chunks = speech_chunks()
    audio = np.concatenate([a for a, _ in chunks])
    asr_gru.launches = 0
    samples = _transcribe_path(audio)
    torch.cuda.synchronize()
    counted = asr_gru.launches
    texts = [s.buffer.data for s in samples]
    want = [words for _, words in chunks]
    for i, (got, words) in enumerate(zip(texts, want)):
        print(f"chunk {i} ({samples[i].buffer.pts / 1e9:.1f} s): {got!r}")
    print(f"whispertranscriber {audio.size / SPEECH_RATE:.0f} s of 16 kHz speech, 5 s chunks: "
          f"{len(samples)} transcripts, T1 launches {counted}")
    spans = [(s.buffer.pts, s.buffer.duration) for s in samples]
    if texts != want or not all(isinstance(t, str) for t in texts):
        raise AssertionError(f"transcripts differ from the spoken words: {texts} != {want}")
    if spans != [(k * 5 * 10**9, 5 * 10**9) for k in range(len(chunks))]:
        raise AssertionError(f"transcript PTS / durations: {spans}")
    if counted != 2 * len(chunks):
        raise AssertionError(f"T1 launches {counted} != 2 x {len(chunks)} chunks")
    return {"asr_gru": counted}


def speech_card_vs_cpu():
    """Phase 5g: the speech path on the CPU (the plain recurrence): the same
    transcripts; each chunk's logits, card against CPU, within
    ASR_LOGIT_TOL."""
    phase("5g speech, card against CPU")
    from gst_plugins_rs_tpu_torch.ops import asr

    chunks = speech_chunks()
    audio = np.concatenate([a for a, _ in chunks])
    card = [s.buffer.data for s in _transcribe_path(audio)]
    host = [s.buffer.data for s in _on("cpu", lambda: _transcribe_path(audio))]
    wc, wh = asr.load_weights(dev="cuda"), asr.load_weights(dev="cpu")
    d = 0.0
    for a, _ in chunks:
        feats, _ = asr.padded_features(torch.from_numpy(a))
        d = max(d, float((asr.forward(wc, feats.cuda()).cpu() - asr.forward(wh, feats))
                         .abs().max()))
    print(f"speech path: transcripts card == CPU: {card == host}; logits of the 6 chunks, card "
          f"vs CPU: max abs {d:.3e} (gate {ASR_LOGIT_TOL})")
    if card != host or d > ASR_LOGIT_TOL:
        raise AssertionError("speech path: card and CPU disagree")


def speech_timing(card_line):
    """Phase 6g: seconds of audio per wall second of the speech path (after a
    warm-up run) and device ms per chunk (torch.profiler over the path)."""
    phase("6g speech timing")
    chunks = speech_chunks()
    audio = np.concatenate([a for a, _ in chunks])
    _transcribe_path(audio[:SPEECH_CHUNK])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _transcribe_path(audio)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = len(chunks)
    device_ms, upload_ms, top = profile_device(lambda: _transcribe_path(audio))
    print(f"whispertranscriber (asr-lite): {audio.size / SPEECH_RATE:.0f} s of speech in "
          f"{secs:.3f} s, {audio.size / SPEECH_RATE / secs:.2f} s of audio per second; device "
          f"busy {device_ms / n:.4f} ms per 5 s chunk (torch.profiler, {n} chunks; host-to-device "
          f"copies left out: {upload_ms:.4f} ms in all), ms per chunk by device op: "
          + ", ".join(f"{k} {v / n:.4f}" for k, v in top) + f" [{card_line}]")
    return dict(audio_s_per_s=audio.size / SPEECH_RATE / secs, device_ms_per_chunk=device_ms / n)


# ---------------------------------------------------------------------------
# Hand detection: handdetectiontensordec on a 1920x1080 stream whose buffers
# carry a seeded palm-detection-out tensor of 2 016 rows (MediaPipe's anchor
# count) on the card; the decode is host work (no kernel), one read-back a
# buffer
# ---------------------------------------------------------------------------
HAND_W, HAND_H = 1920, 1080
HAND_ANCHORS = 2016
HAND_FRAMES = 30
HAND_SEED = 600


def palm_rows(seed: int) -> np.ndarray:
    """[HAND_ANCHORS, 8] f32 rows [score, cx, cy, size, kp0, kp2]
    (normalised): scores mostly under the threshold, 12 rows scored 0.5-0.99,
    keypoint spans and angles drawn so that some candidates pass the
    element's geometry checks and NMS has overlaps to resolve."""
    n = HAND_ANCHORS
    rng = np.random.RandomState(seed)
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0] = rng.uniform(0.0, 0.3, n)
    rows[:, 1:3] = rng.uniform(0.0, 1.0, (n, 2))
    rows[:, 3] = rng.uniform(0.02, 0.3, n)
    ang = rng.uniform(-np.pi, np.pi, n)
    span = rows[:, 3] * rng.uniform(0.2, 1.4, n)
    rows[:, 4:6] = rows[:, 1:3]
    rows[:, 6] = rows[:, 1] + span * np.cos(ang)
    rows[:, 7] = rows[:, 2] + span * np.sin(ang)
    hot = rng.choice(n, 12, replace=False)
    rows[hot, 0] = rng.uniform(0.5, 0.99, hot.size)
    return rows


def _hand_summary(m):
    """The oriented boxes (id, type, x, y, w, h, rotation, confidence), the
    classifications and the relations of a buffer's relation meta."""
    od = [(o.id, o.object_type, o.x, o.y, o.w, o.h, o.rotation, o.loc_conf_lvl) for o in m.od]
    cls = [sorted((k, repr(v)) for k, v in vars(c).items()) for c in m.cls]
    rel = [(r.name, a, b) for r, a, b in m.relations]
    return od, cls, rel


def _hand_path(tensors):
    """appsrc (RGB 1080p frames on the selected device, each buffer carrying
    its palm-detection-out tensor: a torch tensor or a numpy array) !
    handdetectiontensordec max-hands=8 ! appsink: [(pts, summary)] a buffer."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch._device import device
    from gst_plugins_rs_tpu_torch.core import Buffer
    from gst_plugins_rs_tpu_torch.elements.analytics import meta as M

    p = g.parse_launch(f"appsrc name=src caps=video/x-raw,format=RGB,width={HAND_W},"
                       f"height={HAND_H},framerate=30/1 ! handdetectiontensordec max-hands=8 "
                       f"! appsink name=sink")
    src = p.by_name("src")
    frame = torch.zeros((HAND_H, HAND_W, 3), dtype=torch.uint8, device=device())
    for i, data in enumerate(tensors):
        buf = Buffer(frame, pts=i * 10**9 // 30, duration=10**9 // 30)
        buf.add_meta(M.TensorMeta([M.Tensor("palm-detection-out", M.TensorDataType.FLOAT32,
                                            tuple(data.shape), M.TensorDimOrder.ROW_MAJOR,
                                            data)]))
        src.push_buffer(buf)
    src.end_of_stream()
    p.play_until_eos()
    return [(s.buffer.pts, _hand_summary(s.buffer.get_meta(M.AnalyticsRelationMeta)))
            for s in p.by_name("sink").samples]


def hand_pipelines(card_line):
    """Phases 4i/5i: HAND_FRAMES buffers of a 1080p stream through
    handdetectiontensordec with their palm tensors on the card (every buffer
    decoded, PTS in order, boxes inside the frame), then the same rows as
    numpy arrays through the element on the CPU (the plain decode): boxes,
    scores, classifications and relations equal; frames per second on the
    card."""
    phase("4i handdetection on the card: 2 016-row palm tensors at 1920x1080")
    rows = [palm_rows(HAND_SEED + i) for i in range(HAND_FRAMES)]
    on_card = [torch.from_numpy(r).cuda() for r in rows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = _hand_path(on_card)
    secs = time.perf_counter() - t0
    hands = [len(od) for _, (od, _, _) in card]
    print(f"handdetectiontensordec: {len(card)} buffers of {HAND_W}x{HAND_H}, "
          f"{HAND_ANCHORS} rows a tensor on the card, hands a buffer {hands}; "
          f"{len(card) / secs:.1f} buffers/s (host decode, one read-back a buffer) [{card_line}]")
    if [pts for pts, _ in card] != [i * 10**9 // 30 for i in range(HAND_FRAMES)]:
        raise AssertionError("handdetection: buffers lost or out of order")
    if min(hands) < 1:
        raise AssertionError(f"handdetection: a buffer without a hand: {hands}")
    for _, (od, cls, rel) in card:
        if len(cls) != len(od) or len(rel) != len(od) or any(
                o[4] <= 0 or o[5] <= 0 or o[2] + o[4] <= 0 or o[3] + o[5] <= 0
                or o[2] >= HAND_W or o[3] >= HAND_H or not np.isfinite(o[6]) for o in od):
            raise AssertionError(f"handdetection: malformed boxes {od}")
    phase("5i handdetection, card against the plain decode on the CPU")
    host = _on("cpu", lambda: _hand_path(rows))
    same = card == host
    print(f"handdetection: oriented boxes, scores, classifications and relations of "
          f"{HAND_FRAMES} buffers, card tensors vs numpy rows on the CPU: equal {same}")
    if not same:
        raise AssertionError("handdetection: the card's decode differs from the CPU's")


# ---------------------------------------------------------------------------
# The stream bank: 16 streams through loudnormbank (one L1 launch a tick for
# all streams), 192 kHz stereo F32
# ---------------------------------------------------------------------------
BANK_STREAMS = 16
BANK_SECONDS = 30           # a stream: 300 buffers of 100 ms
BANK_CPU_SECONDS = 4        # card against CPU
BANK_PROFILE_SECONDS = 5
# half the streams peaky (the path's tick signal: L1 walks its FSM at every
# tick), half sines at volumes 0.05 .. 0.5 (the limiter idle after the first
# frame): a broadcast playout or a podcast platform normalising many
# programmes at once
BANK_SINE_VOLUMES = tuple(0.05 + i * (0.45 / 7) for i in range(8))
# the reference's oracle (tests/test_loudnormbank.py): +-1 LU of -24 LUFS on
# the sines; the ticks take the smoke's bar of phase 4c (LN_LOUDNESS_BAR)
BANK_LOUDNESS_BAR = 1.0
# bank samples, card vs CPU, F32: the same operations on both devices, the
# K-weighting products summed in another order by cuBLAS than on the host
BANK_CPU_TOL = 1e-6


def bank_pipeline(seconds: int, shard: bool = False):
    """audiotestsrc x BANK_STREAMS (192 kHz stereo F32, 100 ms buffers) !
    capsfilter ! loudnormbank [shard=true] ! appsink x BANK_STREAMS.
    Returns (pipeline, sinks)."""
    import gst_plugins_rs_tpu_torch as g

    p = g.Pipeline()
    bank = g.element_factory_make("loudnormbank")
    bank.set_property("shard", shard)
    p.add(bank)
    sinks = []
    streams = BANK_STREAMS
    for i in range(streams):
        if i < streams // 2:
            props = {"wave": "ticks", "volume": 0.8, "sine-periods-per-tick": 1,
                     "tick-interval": 500_000_000 + 10_000_000 * i}
        else:
            props = {"wave": "sine", "freq": 220.0 + 55 * i,
                     "volume": BANK_SINE_VOLUMES[(i - streams // 2) % 8]}
        src = g.element_factory_make("audiotestsrc")
        for k, v in {**props, "samplesperbuffer": LN_FRAME, "num-buffers": seconds * 10}.items():
            src.set_property(k, v)
        cf = g.element_factory_make("capsfilter")
        cf.set_property("caps", g.parse_caps("audio/x-raw,format=F32,rate=192000,channels=2"))
        sink = g.element_factory_make("appsink")
        for e in (src, cf, sink):
            p.add(e)
        src.link(cf)
        cf.pad("src").link(bank.request_sink_pad())
        bank.pad(f"src_{i}").link(sink.pad("sink"))
        sinks.append(sink)
    return p, sinks


def bank_kernel(card_line):
    """Phase 3h: L1 over N = 16 streams in one launch against its plain twin
    (the per-stream host loop), bit for bit in f32 (the bank's type) and
    f64: a mixed bank of idle, peaky (mixed carries) and clipped streams,
    with the peaks and segments each stream walked; then the path's bank (8
    peaky windows from mixed carries, 8 idle) timed beside one peaky stream,
    the 8 idle streams and the mixed bank."""
    phase("3h bank: L1 over 16 streams a launch against its plain twin")
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    dev = torch.device("cuda")
    quiet = np.random.RandomState(40).uniform(-0.5, 0.5, (BANK_STREAMS, 40320, 2))
    carries = LIMITER_CARRIES + LIMITER_BOUNDARY[13::5]

    def bank(dtype, kinds):
        rows, ci, cf = [], [], []
        for n, kind in enumerate(kinds):
            rows.append(torch.from_numpy(quiet[n]).to(dev, dtype) if kind == "idle"
                        else limiter_window(kind, dtype, dev))
            c = carries[n % len(carries)] if kind != "idle" else LIMITER_CARRIES[0]
            ci.append(c[:3])
            cf.append(c[3:])
        return (torch.stack(rows).contiguous(), torch.tensor(ci, dtype=torch.int32, device=dev),
                torch.tensor(cf, dtype=dtype, device=dev))

    mixed = [("peaky", "idle", "clipped")[n % 3] for n in range(BANK_STREAMS)]
    path = ["peaky"] * (BANK_STREAMS // 2) + ["idle"] * (BANK_STREAMS // 2)
    stats = torch.zeros((BANK_STREAMS, 3), dtype=torch.int32, device=dev)
    err, plain_ms = 0.0, None
    for dtype, np_dtype in ((torch.float32, np.float32), (torch.float64, np.float64)):
        tp = float(np_dtype(10 ** (-2 / 20)))
        for label, kinds in (("mixed", mixed), ("path", path)):
            w, ci, cf = bank(dtype, kinds)
            out, ni, nf = lim.limiter_frames(w, ci, cf, tp, walk_stats=stats)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref, ri, rf = _limiter_plain(lim, w, ci, cf, tp)
            if dtype == torch.float32 and label == "path":
                plain_ms = (time.perf_counter() - t0) * 1e3
            err = max(err, float((out.cpu() - ref).abs().max()))
            if not (torch.equal(out.cpu(), ref) and torch.equal(ni.cpu(), ri)
                    and torch.equal(nf.cpu(), rf)) or not torch.isfinite(out).all():
                raise AssertionError(f"L1 over {BANK_STREAMS} streams ({label}, {dtype}) != its "
                                     f"plain twin ({err:.3e})")
            print(f"L1 {BANK_STREAMS} streams in one launch, {label} bank "
                  f"({'/'.join(sorted(set(kinds)))}), {dtype}: bit-equal to the plain twin; "
                  f"(peaks, segments, walk steps) a stream: {[tuple(r) for r in stats.tolist()]}")
    tp = float(np.float32(10 ** (-2 / 20)))
    w, ci, cf = bank(torch.float32, path)
    ms = cuda_ms(lambda: lim.limiter_frames(w, ci, cf, tp))
    one = [t[:1].contiguous() for t in (w, ci, cf)]
    single_ms = cuda_ms(lambda: lim.limiter_frames(*one, tp))
    idle = [t[BANK_STREAMS // 2:].contiguous() for t in (w, ci, cf)]
    idle_ms = cuda_ms(lambda: lim.limiter_frames(*idle, tp))
    wm, cim, cfm = bank(torch.float32, mixed)
    mixed_ms = cuda_ms(lambda: lim.limiter_frames(wm, cim, cfm, tp))
    peaks = int(lim.precompute_peaks(w, tp)[0].sum())
    nbytes, flop = _limiter_bytes_flop(w, tp, peaks)
    bound_ms, bound_by = bound(flop, nbytes)
    lim.limiter_frames(w, ci, cf, tp, walk_stats=stats)
    events = stats[:, 1] + stats[:, 2]  # segments and walk steps
    floor_ms = int(events.max()) * LIMITER_EVENT_CYCLES / _sm_clock_hz() * 1e3
    print(f"L1 {BANK_STREAMS} streams (8 peaky, 8 idle) in one launch: {ms:.4f} ms; one peaky "
          f"stream alone {single_ms:.4f} ms ({ms / single_ms:.2f}x); the 8 idle streams alone "
          f"{idle_ms:.4f} ms; the mixed bank (peaky, idle, clipped) {mixed_ms:.4f} ms; plain twin "
          f"(host loop, CPU) {plain_ms:.1f} ms; bound {bound_ms:.6f} ms ({bound_by}: {nbytes} B, "
          f"{flop} f32 operations); event floor of the busiest stream, estimated: "
          f"{floor_ms:.6f} ms ({int(events.max())} events x ~{LIMITER_EVENT_CYCLES} cycles) "
          f"[{card_line}]")
    return dict(case=f"{BANK_STREAMS} streams a launch, 192 kHz stereo f32, 8 peaky, 8 idle",
                ms=ms, single_peaky_ms=single_ms, idle_ms=idle_ms, mixed_ms=mixed_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                library_ms=None, flop=flop, bytes=nbytes)


def _bank_outputs(sinks):
    return [s.concat_audio() for s in sinks]


def bank_pipelines():
    """Phase 4h: BANK_STREAMS streams of BANK_SECONDS through loudnormbank
    with L1's counter set to 0 just before and read just after: one launch a
    tick (the 3 s first frame, the 100 ms inner ticks, the drain steps),
    every sample out, PTS k x 100 ms, every stream re-measured within the bar
    of -24 LUFS with its sample peak <= -2 dBFS, the r128-bank-level message."""
    phase("4h the stream bank on the card")
    from gst_plugins_rs_tpu_torch.core import MessageType
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    p, sinks = bank_pipeline(BANK_SECONDS)
    lim.launches = 0
    p.play_until_eos()
    torch.cuda.synchronize()
    counted = lim.launches
    ticks = 1 + (BANK_SECONDS * 10 - 30) + 29  # first frame, inner ticks, drain steps
    outs = _bank_outputs(sinks)
    frame_ns = LN_FRAME * 10**9 // 192000
    fails = []
    for i, (s, out) in enumerate(zip(sinks, outs)):
        loud, peaks = _r128_of(out, 2, 192000)
        bar = LN_LOUDNESS_BAR if i < BANK_STREAMS // 2 else BANK_LOUDNESS_BAR
        pts = [x.buffer.pts for x in s.samples]
        ok = (out.shape == (BANK_SECONDS * 192000, 2) and np.isfinite(out).all()
              and abs(loud + 24.0) < bar and max(peaks) <= 10 ** (-2 / 20) + 1e-7
              and pts == [k * frame_ns for k in range(len(pts))]
              and all(x.buffer.data.device.type == "cuda" for x in s.samples))
        print(f"stream {i} ({'ticks' if i < BANK_STREAMS // 2 else 'sine'}): {out.shape[0]} "
              f"samples, {loud:.3f} LUFS (bar +-{bar} LU), sample peak "
              f"{20 * np.log10(max(peaks)):.3f} dBFS, {len(pts)} buffers: {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(i)
    msgs = [m.structure for m in p.bus.messages(MessageType.ELEMENT)
            if m.structure is not None and m.structure.name == "r128-bank-level"]
    print(f"loudnormbank {BANK_STREAMS} x {BANK_SECONDS} s, 192 kHz stereo F32: L1 launches "
          f"{counted} (ticks {ticks}); r128-bank-level messages {len(msgs)}")
    if fails:
        raise AssertionError(f"loudnormbank streams {fails} miss the bar")
    if counted != ticks or len(msgs) != 1:
        raise AssertionError(f"L1 launches {counted} != ticks {ticks}, or no bank message")
    return {"loudnorm_limiter_bank": counted}


def bank_card_vs_cpu():
    """Phase 5h: a BANK_CPU_SECONDS bank run on the card against the same run
    on the CPU (the plain twin): every stream's samples within BANK_CPU_TOL."""
    phase("5h the stream bank, card against CPU")

    def run():
        p, sinks = bank_pipeline(BANK_CPU_SECONDS)
        p.play_until_eos()
        return _bank_outputs(sinks)

    card = run()
    host = _on("cpu", run)
    d = max(float(np.abs(a - b).max()) for a, b in zip(card, host))
    same = all(a.shape == b.shape for a, b in zip(card, host))
    print(f"loudnormbank {BANK_STREAMS} x {BANK_CPU_SECONDS} s, card (L1) vs CPU (plain twin): "
          f"max abs {d:.3e} a sample (gate {BANK_CPU_TOL}), shapes equal: {same}")
    if not same or d > BANK_CPU_TOL:
        raise AssertionError("loudnormbank: card and CPU disagree")


def bank_timing(card_line):
    """Phase 6h: stream-seconds per wall second of the bank path (after a
    warm-up run), device ms and device ops a tick (torch.profiler), and
    parallel/benchmark.py --chain echo,loudnorm --streams 16 for 3 s."""
    phase("6h stream bank timing")
    from gst_plugins_rs_tpu_torch.parallel import benchmark

    p, _ = bank_pipeline(4)
    p.play_until_eos()  # warm-up
    torch.cuda.synchronize()
    p, _ = bank_pipeline(BANK_SECONDS)
    t0 = time.perf_counter()
    p.play_until_eos()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rate = BANK_STREAMS * BANK_SECONDS / secs
    _, events = device_events(lambda: bank_pipeline(BANK_PROFILE_SECONDS)[0].play_until_eos())
    ticks = 1 + (BANK_PROFILE_SECONDS * 10 - 30) + 29
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events if not e.key.startswith("Memcpy"))
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    share = busy / ticks * rate / (100.0 * BANK_STREAMS)  # a tick: 100 ms of every stream
    print(f"loudnormbank {BANK_STREAMS} streams x {BANK_SECONDS} s in {secs:.3f} s: "
          f"{rate:.2f} stream-seconds per second ({rate / BANK_STREAMS:.2f} s of audio per "
          f"second a stream); device busy {busy / ticks:.4f} ms and {ops / ticks:.1f} device ops "
          f"a tick (torch.profiler, {BANK_PROFILE_SECONDS} s: {ticks} ticks), "
          f"{100 * share:.1f}% of the wall; ms a tick by op: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / ticks:.4f}" for e in top)
          + f" [{card_line}]")
    rows = benchmark.run(BANK_STREAMS, "echo,loudnorm", seconds=3.0, window=1.0, use_mesh=False)
    return dict(stream_s_per_s=rate, device_ms_per_tick=busy / ticks, ops_per_tick=ops / ticks,
                busy_share=share, benchmark=rows)


# ---------------------------------------------------------------------------
# Chain fusion (parallel/fuse.py): the effects chain, and the mixed chain of
# tests/test_fuse.py, at 1080p as one CUDA graph a fused run
# ---------------------------------------------------------------------------
FUSE_FRAMES = 32           # seeded 1080p RGBA frames, each unlike the others (4j)
FUSE_CPU_FRAMES = 2        # card against CPU (5j)
FUSE_PROFILE_FRAMES = 16   # under torch.profiler (6j)
FUSE_TIMING_FRAMES = 64    # timed a repeat (6j) ...
FUSE_REPEATS = 3           # ... the median of these
FRAME_NS = 33_333_333
FUSE_CHAINS = {
    "effects": ("hsvfilter hue-shift=120 ! colorlut location={grade} precision=approx",
                ["hsvfilter", "colorlut"]),
    "mixed": ("hsvfilter hue-shift=90 ! videoscale method=nearest "
              "! video/x-raw,width=1280,height=720 ! videoflip method=rotate-180",
              ["hsvfilter", "videoscale", "capsfilter", "videoflip"]),
}
# CUDA API calls (cuda* and cu*) that put work on a stream, as torch.profiler
# names them on the host
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def fuse_frames(n, seed=0):
    """n seeded random 1080p RGBA u8 frames on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, 256, (HD_H, HD_W, 4), generator=gen, device="cuda",
                          dtype=torch.uint8) for _ in range(n)]


def fuse_chain(tail, fused, sink="appsink name=sink", fmt="RGBA"):
    """appsrc ! <tail> ! <sink> for 1080p `fmt`, fused or not.  Returns
    (pipeline, runs fused or None)."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.parallel.fuse import fuse_pipeline

    p = g.parse_launch(f"appsrc name=src ! {tail} ! {sink}")
    n = fuse_pipeline(p) if fused else None
    p.by_name("src").set_property("caps", g.parse_caps(
        f"video/x-raw,format={fmt},width={HD_W},height={HD_H},framerate=30/1"))
    return p, n


def _push_frames(p, frames, start=0):
    import gst_plugins_rs_tpu_torch as g

    src = p.by_name("src")
    for i, f in enumerate(frames):
        src.push_buffer(g.Buffer(f, pts=(start + i) * FRAME_NS, duration=FRAME_NS))


def run_chain(tail, frames, fused, fmt="RGBA"):
    """Every frame through the chain to EOS: (runs fused, output payloads)."""
    p, n = fuse_chain(tail, fused, fmt=fmt)
    _push_frames(p, frames)
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return n, [s.buffer.data for s in p.by_name("sink").samples]


def fuse_pipelines(grade):
    """Phase 4j: each chain unfused, then fused with the counters of B4, B2
    and the graphs set to 0 just before and read just after: one fused run,
    its run the JAX package's (tests/test_fuse.py), every buffer bit-equal
    to the unfused chain's, B4 (and B2) launched once a frame, one graph
    captured and replayed for every later frame, no two outputs sharing the
    graph's memory.  Returns the launches."""
    phase("4j fused effects chains (one CUDA graph a run) on the card")
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
    from gst_plugins_rs_tpu_torch.ops import hsv_planes
    from gst_plugins_rs_tpu_torch.parallel import fuse

    frames = fuse_frames(FUSE_FRAMES)
    launches = {"hsv_planes": 0, "colorlut_lowrank_packed": 0}
    for label, (tail, names) in FUSE_CHAINS.items():
        tail = tail.format(grade=grade)
        run = [e.ELEMENT_NAME for e in fuse.fusable_runs(fuse_chain(tail, False)[0])[0]]
        _, ref = run_chain(tail, frames, fused=False)
        hsv_planes.launches = lowrank.packed_launches = 0
        fuse.captures = fuse.replays = 0
        n, got = run_chain(tail, frames, fused=True)
        torch.cuda.synchronize()
        counted = {"hsv": hsv_planes.launches, "packed": lowrank.packed_launches,
                   "captures": fuse.captures, "replays": fuse.replays}
        equal = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
        distinct = len({a.data_ptr() for a in got}) == len(got)
        differ = all(not torch.equal(a, b) for a, b in zip(got, got[1:]))
        print(f"fused {label} chain ({' ! '.join(run)}), {FUSE_FRAMES} differing {HD_W}x{HD_H} "
              f"frames: {n} run, output {tuple(got[0].shape)}, bit-equal to the unfused chain on "
              f"{sum(equal)} of {len(ref)} buffers, outputs distinct {distinct}, consecutive "
              f"outputs differ {differ}; counts {counted}")
        want = {"hsv": FUSE_FRAMES, "packed": FUSE_FRAMES if label == "effects" else 0,
                "captures": 1, "replays": FUSE_FRAMES - 1}
        if run != names or n != 1 or len(got) != FUSE_FRAMES or len(ref) != FUSE_FRAMES \
                or not all(equal) or not distinct or not differ or counted != want:
            raise AssertionError(f"the fused {label} chain: runs, output or counts")
        if any(a.device.type != "cuda" for a in got):
            raise AssertionError(f"the fused {label} chain's output is not on the card")
        launches["hsv_planes"] += counted["hsv"]
        launches["colorlut_lowrank_packed"] += counted["packed"]
    fuse_planar_passthrough()
    return launches


def fuse_planar_passthrough():
    """I420 -> NV12 at 1080p through `videoscale ! videoconvert`: the scaler
    is the identity and the converter hands its Y plane on, so one output
    plane of the fused run is an input plane.  Every buffer, the first
    included, must still equal the unfused chain's once all have gone
    through the graph."""
    from gst_plugins_rs_tpu_torch.parallel import fuse

    gen = torch.Generator(device="cuda").manual_seed(3)

    def plane(h, w):
        return torch.randint(0, 256, (h, w), generator=gen, device="cuda", dtype=torch.uint8)

    frames = [(plane(HD_H, HD_W), plane(HD_H // 2, HD_W // 2), plane(HD_H // 2, HD_W // 2))
              for _ in range(FUSE_FRAMES)]
    tail = "videoscale ! videoconvert ! video/x-raw,format=NV12"
    _, ref = run_chain(tail, frames, fused=False, fmt="I420")
    fuse.captures = fuse.replays = 0
    n, got = run_chain(tail, frames, fused=True, fmt="I420")
    torch.cuda.synchronize()
    equal = [len(a) == len(b) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
             for a, b in zip(got, ref)]
    print(f"fused planar chain (videoscale ! videoconvert, I420 -> NV12), {FUSE_FRAMES} "
          f"differing {HD_W}x{HD_H} frames: {n} run, planes equal to the unfused chain's on "
          f"{sum(equal)} of {len(ref)} buffers; captures {fuse.captures}, replays {fuse.replays}")
    if n != 1 or len(got) != FUSE_FRAMES or len(ref) != FUSE_FRAMES or not all(equal) \
            or (fuse.captures, fuse.replays) != (1, FUSE_FRAMES - 1):
        raise AssertionError("the fused planar chain: runs, output or counts")


def fuse_card_vs_cpu(grade):
    """Phase 5j: the fused chains on the card (one graph a run, B4, B2)
    against the same fused chains on the CPU (eager, the plain versions)."""
    phase("5j fused effects chains, card against CPU")
    import gst_plugins_rs_tpu_torch as g

    frames = fuse_frames(FUSE_CPU_FRAMES, seed=1)
    for label, (tail, _) in FUSE_CHAINS.items():
        tail = tail.format(grade=grade)
        _, card = run_chain(tail, frames, fused=True)
        g.set_device("cpu")
        try:
            _, host = run_chain(tail, [f.cpu() for f in frames], fused=True)
        finally:
            g.set_device("cuda")
        d = max(_lsb(a.cpu().numpy(), b.numpy()) for a, b in zip(card, host))
        print(f"fused {label} chain, {FUSE_CPU_FRAMES} frames, card (CUDA graph) vs CPU (eager "
              f"plain versions): max {d} LSB (gate {LSB_TOL})")
        if len(card) != FUSE_CPU_FRAMES or len(host) != FUSE_CPU_FRAMES or d > LSB_TOL:
            raise AssertionError(f"the fused {label} chain: card and CPU disagree")


def _profile_counts(run):
    """(device busy ms, device ops, host launch calls by name) over one call
    of `run` under torch.profiler."""
    avgs, dev = device_events(run, cuda_only=False)
    host = {e.key: e.count for e in avgs if e.key in HOST_LAUNCH_CALLS}
    return (sum(e.self_device_time_total for e in dev) / 1e3, sum(e.count for e in dev), host)


def fuse_timing(card_line, grade):
    """Phase 6j: each chain unfused and fused in one pipeline that stays
    PLAYING: two frames to warm up (the fused run captures its graph at the
    first), FUSE_PROFILE_FRAMES under torch.profiler (device busy ms, device
    ops and host launch calls a frame), then FUSE_REPEATS timed passes of
    FUSE_TIMING_FRAMES frames (host clock to torch.cuda.synchronize; the
    median)."""
    phase("6j fused against unfused effects chains, timing")
    from gst_plugins_rs_tpu_torch.core import State

    frames = fuse_frames(FUSE_FRAMES, seed=2)
    rows = {}
    for label, (tail, _) in FUSE_CHAINS.items():
        tail = tail.format(grade=grade)
        for fused in (False, True):
            p, _ = fuse_chain(tail, fused, sink="appsink name=sink max-buffers=2")
            p.set_state(State.PLAYING)
            sent = 0

            def feed(n):
                nonlocal sent
                _push_frames(p, [frames[(sent + i) % len(frames)] for i in range(n)], sent)
                sent += n
                p.run(max_iterations=n)

            feed(2)
            torch.cuda.synchronize()
            busy, ops, host = _profile_counts(lambda: feed(FUSE_PROFILE_FRAMES))
            rates = []
            for _ in range(FUSE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                feed(FUSE_TIMING_FRAMES)
                torch.cuda.synchronize()
                rates.append(FUSE_TIMING_FRAMES / (time.perf_counter() - t0))
            p.by_name("src").end_of_stream()
            p.run()
            p.set_state(State.NULL)
            fps = statistics.median(rates)
            key = f"{label} {'fused' if fused else 'unfused'}"
            rows[key] = dict(fps=fps, device_ms=busy / FUSE_PROFILE_FRAMES,
                             ops=ops / FUSE_PROFILE_FRAMES,
                             host_launches=sum(host.values()) / FUSE_PROFILE_FRAMES)
            per = ", ".join(f"{k} {v / FUSE_PROFILE_FRAMES:.2f}" for k, v in sorted(host.items()))
            print(f"{key} chain, {HD_W}x{HD_H}: {fps:.1f} frames/s (median of "
                  f"{[round(r, 1) for r in rates]}, {FUSE_TIMING_FRAMES} frames each); device "
                  f"busy {busy / FUSE_PROFILE_FRAMES:.4f} ms and {ops / FUSE_PROFILE_FRAMES:.1f} "
                  f"device ops a frame, host launch calls a frame {sum(host.values()) / FUSE_PROFILE_FRAMES:.2f} "
                  f"({per}) (torch.profiler, {FUSE_PROFILE_FRAMES} frames); device busy "
                  f"{100 * busy / FUSE_PROFILE_FRAMES * fps / 1e3:.1f}% of the wall [{card_line}]")
        for k in ("device_ms", "fps"):
            print(f"{label}: fused / unfused {k} "
                  f"{rows[label + ' fused'][k] / rows[label + ' unfused'][k]:.3f}")
    return rows


# ---------------------------------------------------------------------------
# The mesh paths (parallel/mesh.py): four logical shards on cuda:0 under
# set_virtual_devices(MESH_SHARDS) -- the sharded stream bank, one long
# stream's time axis, data- and tensor-parallel YOLOX, the histogram psum --
# and the build-time C3 route of YOLOX-x in bf16 (ROADMAP section C.1)
# ---------------------------------------------------------------------------
MESH_SHARDS = 4
MESH_BANK_TOL = 1e-6        # sharded vs unsharded bank, a sample (tests/test_loudnormbank.py:88-90)
TS_RTOL, TS_ATOL = 1e-9, 1e-12  # time-shard streaming vs default (tests/test_timeshard_streaming.py:134)
TS_GAIN_RTOL = 1e-12        # the linear mode's gain (tests/test_timeshard.py, ops parity)
YOLOX_SHARD_RTOL, YOLOX_SHARD_ATOL = 2e-4, 2e-5  # data mode (tests/test_yolox_batch_shard.py:73)
TP_RTOL = TP_ATOL = 2e-4    # tensor mode vs the reference graph (tests/test_model_parallel.py:60-61)
# YOLOX-l at 640 with init_weights(seed=0) on two seeded frames: the boxes
# reach |ref| ~5e5 and the sharded graph misses TP_RTOL / TP_ATOL by 1.25x
# on an H100 (cuDNN's kernels for a quarter of the channels round in
# another order; the unsharded graph on the card misses it against the CPU
# by 1.88x), so there it is held to 10x that gate, fixed.  A swap of two
# shards' weight slices (TP_FAULTS) must fail it: 4.4e5x on the dark3 conv.
TP_L_RTOL = TP_L_ATOL = 2e-3
TP_FAULTS = ("backbone.backbone.dark3.conv.conv.weight", "head.reg_preds_0.weight")
TP_MODEL = "l"              # MULTICHIP_r05.json's tensor-parallel stage, at 640x640 batch 1
TP_CHECK_SIZE = 64          # ... and YOLOX-s at tests/test_model_parallel.py's 64x64
TP_FRAMES = 2
MESH_YOLOX_FRAMES = 8       # phase 4's four YOLOX-tiny streams, windows of 4 frames
C1_SIZE = 64                # YOLOX-x in bf16, card against CPU
C1_SCORE_TOL = 0.05         # scores (columns 4:), tests/test_yolox_fast.py::test_bf16_close
# dark2's C3 in bf16, card vs CPU on one input, max |d| over max |ref|: 5.6e-3
# on an H100; a swap of two output channels reads 0.455
C1_C3_TOL = 2e-2
TS_PROFILE_FRAMES = 100     # 10 s of the time-sharded stream under torch.profiler (6k)


@contextlib.contextmanager
def _virtual_devices(n):
    """set_virtual_devices(n) inside the scope, the real devices after."""
    import gst_plugins_rs_tpu_torch as g

    g.set_virtual_devices(n)
    try:
        yield
    finally:
        g.set_virtual_devices(None)


def mesh_kernels(card_line):
    """Phase 3k: the route of dark2's C3 for every zoo model in both dtypes,
    B1's shared memory as the engine reckons it (ops/yolox_c3.py::
    c3_smem_bytes) against the library's for every tile, and the
    collectives over four logical shards of cuda:0."""
    phase("3k the mesh paths: C3 routes, B1's shared memory, the collectives on 4 shards")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.models.yolox import VARIANTS, Yolox, expand
    from gst_plugins_rs_tpu_torch.models.yolox_fast import c3_route
    from gst_plugins_rs_tpu_torch.ops import yolox_c3
    from gst_plugins_rs_tpu_torch.parallel import mesh as M

    t0 = time.perf_counter()
    lib = yolox_c3._lib()
    routes = {}
    for variant, (depth, width, _) in VARIANTS.items():
        with torch.device("meta"):
            model = Yolox.from_variant(variant)
        C = 2 * expand(64, width)
        h, n = expand(C, 0.5), max(round(depth * 3), 1)
        for bf16 in (False, True):
            for tile in yolox_c3._TILES:
                host = yolox_c3.c3_smem_bytes(bf16, C, h, n, tile)
                if host != lib.yolox_c3_smem_bytes(int(bf16), C, h, n, tile):
                    raise AssertionError(f"c3_smem_bytes({bf16}, {C}, {h}, {n}, {tile}) = {host} "
                                         "!= the library's")
        routes[variant] = {"f32": c3_route(model, torch.float32, fuse_c3=True),
                           "bf16": c3_route(model, torch.bfloat16, fuse_c3=True)}
        print(f"YOLOX-{variant}: dark2 C3 C={C}, h={h}, n={n}; route f32 {routes[variant]['f32']}"
              f" (tile {yolox_c3.fused_tile(False, C, h, n)}), bf16 {routes[variant]['bf16']} "
              f"(tile {yolox_c3.fused_tile(True, C, h, n)}, "
              f"{yolox_c3.c3_smem_bytes(True, C, h, n, 2)} B at tile 2 of {yolox_c3._MAX_SMEM})")
    want = {v: {"f32": "reference" if v == "nano" else "fused",
                "bf16": "reference" if v == "nano" else ("per-conv" if v == "x" else "fused")}
            for v in VARIANTS}
    if routes != want:
        raise AssertionError(f"C3 routes {routes} != {want}")
    with _virtual_devices(MESH_SHARDS):
        from gst_plugins_rs_tpu_torch.parallel.streams import make_stream_mesh

        mesh = make_stream_mesh(axis="x")
        x = torch.arange(16.0, device="cuda").reshape(4, 4)
        parts = M.shard(x, mesh)
        ring = M.ppermute(parts, [(i, (i + 1) % 4) for i in range(4)])
        ok = (mesh.devices == [torch.device("cuda", 0)] * MESH_SHARDS
              and g.visible_devices() == mesh.devices
              and torch.equal(M.gather(parts), x)
              and all(torch.equal(r[0], x[(k - 1) % 4]) for k, r in enumerate(ring))
              and all(torch.equal(a[:, 0], x) for a in M.all_gather(parts))
              and all(torch.equal(s[0], x.sum(0)) for s in M.psum(parts))
              and all(torch.equal(m[0], x.amax(0)) for m in M.pmax(parts)))
    print(f"mesh {mesh}: shard, gather, ppermute, all_gather, psum, pmax on the card: "
          f"{'ok' if ok else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    if not ok:
        raise AssertionError("the collectives on the card")
    return routes


def _allclose(a, b, rtol, atol):
    """(|a - b| <= atol + rtol |b| everywhere, max |a - b|) of two host arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return (a.shape == b.shape and bool((d <= atol + rtol * np.abs(b)).all()),
            float(d.max()) if d.size else 0.0)


def _r128_gain(x, params):
    """ops/loudnorm.py::linear_gain_from_global over the measured subblocks
    of x [n, ch] on the card, fed 1 s at a time (the unsharded reference of
    the linear mode)."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm as LN
    from gst_plugins_rs_tpu_torch.ops.ebur128 import r128_add_full_subblocks

    n100 = params.r128.n100
    nfull = (x.shape[0] // n100) * n100
    st = LN.loudnorm_init(params, x.shape[1], 0.0)
    r = st.r128_in
    for i in range(0, nfull, 10 * n100):
        r = r128_add_full_subblocks(r, params.r128, x[i:min(i + 10 * n100, nfull)])
    return LN.linear_gain_from_global(st._replace(r128_in=r), params)


def mesh_pipelines():
    """Phase 4k, under MESH_SHARDS logical shards of cuda:0: loudnormbank
    shard=true over phase 4h's bank against shard=false (L1 launches = 4 a
    tick); audioloudnorm time-shard=true over phase 4c's 60 s against
    time-shard=false (L1 launches = frames), and time-shard-mode=linear
    against the unsharded linear gain; yoloxinference shard=true over phase
    4's four YOLOX-tiny streams against shard=false (B1 launches = 4 a
    window); shard-mode=tensor with YOLOX-s at 64x64 and YOLOX-l at 640x640
    against the reference graph, and planted faults that the YOLOX-l gate
    must catch; the R-128 histogram psum over a sharded r128_bank; and
    parallel/benchmark.py --mesh for 3 s.  Each launch counter is set to 0
    just before its path and read just after."""
    phase("4k the mesh paths on 4 logical shards of the card")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.ops import loudnorm as LN
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
    from gst_plugins_rs_tpu_torch.ops import yolox_c3
    from gst_plugins_rs_tpu_torch.parallel import benchmark
    from gst_plugins_rs_tpu_torch.parallel.mesh import Mesh
    from gst_plugins_rs_tpu_torch.parallel.modelparallel import shard_yolox_variables, tp_forward
    from gst_plugins_rs_tpu_torch.parallel.streams import make_stream_mesh, r128_bank

    launches, walls = {}, {}
    with _virtual_devices(MESH_SHARDS):
        # -- the stream bank ------------------------------------------------
        t0 = time.perf_counter()
        p, sinks = bank_pipeline(BANK_SECONDS)
        p.play_until_eos()
        plain = _bank_outputs(sinks)
        walls["bank"] = time.perf_counter() - t0
        p, sinks = bank_pipeline(BANK_SECONDS, shard=True)
        lim.launches = 0
        t0 = time.perf_counter()
        p.play_until_eos()
        torch.cuda.synchronize()
        walls["bank sharded"] = time.perf_counter() - t0
        counted = lim.launches
        sharded = _bank_outputs(sinks)
        ticks = 1 + (BANK_SECONDS * 10 - 30) + 29
        d = max(float(np.abs(a - b).max()) for a, b in zip(sharded, plain))
        same = all(a.shape == b.shape for a, b in zip(sharded, plain))
        print(f"loudnormbank shard=true, {BANK_STREAMS} x {BANK_SECONDS} s over {MESH_SHARDS} "
              f"shards: L1 launches {counted} ({MESH_SHARDS} x {ticks} ticks); against "
              f"shard=false max abs {d:.3e} a sample (gate {MESH_BANK_TOL}); wall "
              f"{walls['bank sharded']:.2f} s sharded, {walls['bank']:.2f} s not")
        if not same or d > MESH_BANK_TOL:
            raise AssertionError("loudnormbank shard=true != shard=false")
        if counted != MESH_SHARDS * ticks:
            raise AssertionError(f"L1 launches {counted} != {MESH_SHARDS} x {ticks}")
        launches["loudnorm_limiter_bank"] = counted

        # -- one long stream's time axis ------------------------------------
        def loudnorm(props):
            p = g.parse_launch(loudnorm_launch(AUDIO_SECONDS, f"audioloudnorm {props} "
                                                              "! appsink name=sink"))
            t0 = time.perf_counter()
            p.play_until_eos()
            torch.cuda.synchronize()
            return p.by_name("sink").concat_audio(), time.perf_counter() - t0

        ref, walls["audioloudnorm"] = loudnorm("")
        lim.launches = 0
        got, walls["audioloudnorm time-shard"] = loudnorm("time-shard=true")
        counted = lim.launches
        frames = -(-got.shape[0] // LN_FRAME)
        ok, dmax = _allclose(got, ref, TS_RTOL, TS_ATOL)
        print(f"audioloudnorm time-shard=true (streaming), {AUDIO_SECONDS} s 192 kHz stereo F64 "
              f"over {MESH_SHARDS} shards (chunks of {MESH_SHARDS * 4} frames): {got.shape[0]} "
              f"samples, L1 launches {counted} (frames {frames}); against time-shard=false max "
              f"abs {dmax:.3e} (rtol {TS_RTOL}, atol {TS_ATOL}: {'ok' if ok else 'FAIL'}); wall "
              f"{walls['audioloudnorm time-shard']:.2f} s sharded, {walls['audioloudnorm']:.2f} s "
              f"not")
        if not ok:
            raise AssertionError("audioloudnorm time-shard=true != time-shard=false")
        if counted != frames:
            raise AssertionError(f"L1 launches {counted} != frames {frames}")
        launches["loudnorm_limiter"] = counted

        p = g.parse_launch(loudnorm_launch(
            AUDIO_SECONDS, "tee name=t t. ! queue ! audioloudnorm time-shard=true "
                           "time-shard-mode=linear ! appsink name=out t. ! queue ! appsink name=in"))
        t0 = time.perf_counter()
        p.play_until_eos()
        torch.cuda.synchronize()
        walls["audioloudnorm linear"] = time.perf_counter() - t0
        from gst_plugins_rs_tpu_torch.core import MessageType

        warns = [m for m in p.bus.messages(MessageType.WARNING) if m.structure is not None
                 and m.structure.name == "audioloudnorm-time-shard-linear"]
        x = torch.cat([s.buffer.data for s in p.by_name("in").samples]).to(g.device())
        lin = p.by_name("out").concat_audio()
        params = LN.loudnorm_params(-24.0, 7.0, -2.0, 2, torch.float64, g.device())
        gain = float(_r128_gain(x, params))
        xs = x.cpu().numpy()
        expect = xs * gain
        gain_seen = float(np.median(lin[np.abs(xs) > 1e-3] / xs[np.abs(xs) > 1e-3]))
        ok, dmax = _allclose(lin, expect, TS_GAIN_RTOL, 0.0)
        print(f"audioloudnorm time-shard-mode=linear, {AUDIO_SECONDS} s over {MESH_SHARDS} shards: "
              f"{len(warns)} WARNING past 3 s, gain {gain_seen:.15g} against the unsharded "
              f"linear_gain_from_global {gain:.15g}; samples against x * gain max abs {dmax:.3e} "
              f"(rtol {TS_GAIN_RTOL}: {'ok' if ok else 'FAIL'}); wall "
              f"{walls['audioloudnorm linear']:.2f} s")
        if not ok or len(warns) != 1:
            raise AssertionError("time-shard-mode=linear != the unsharded linear gain, or no "
                                 "single WARNING")

        # -- YOLOX, data-parallel and tensor-parallel -----------------------
        t0 = time.perf_counter()
        plain = multi_stream(4, MESH_YOLOX_FRAMES)
        yolox_c3.launches = 0
        sharded = multi_stream(4, MESH_YOLOX_FRAMES, props="shard=true")
        torch.cuda.synchronize()
        counted = yolox_c3.launches
        walls["yoloxinference data"] = time.perf_counter() - t0
        worst, ok = 0.0, True
        for a, b in zip(sharded, plain):
            _check_outputs(a, MESH_YOLOX_FRAMES)
            for sa, sb in zip(a, b):
                o, dmax = _allclose(_tensor_meta(sa.buffer).data.cpu(),
                                       _tensor_meta(sb.buffer).data.cpu(),
                                       YOLOX_SHARD_RTOL, YOLOX_SHARD_ATOL)
                ok, worst = ok and o, max(worst, dmax)
        print(f"yoloxinference shard=true (data), 4 YOLOX-tiny streams at {SIZE}x{SIZE} over "
              f"{MESH_SHARDS} shards: B1 launches {counted} ({MESH_SHARDS} x {MESH_YOLOX_FRAMES} "
              f"windows); against shard=false max abs {worst:.3e} (rtol {YOLOX_SHARD_RTOL}, atol "
              f"{YOLOX_SHARD_ATOL}: {'ok' if ok else 'FAIL'}) "
              f"({walls['yoloxinference data']:.1f} s)")
        if not ok:
            raise AssertionError("yoloxinference shard=true != shard=false")
        if counted != MESH_SHARDS * MESH_YOLOX_FRAMES:
            raise AssertionError(f"B1 launches {counted} != {MESH_SHARDS} x {MESH_YOLOX_FRAMES}")
        launches["yolox_c3"] = counted

        def tp_run(props, model, size):
            p = g.parse_launch(f"videotestsrc pattern=smpte num-buffers={TP_FRAMES} "
                               f"! video/x-raw,format=RGB,width={size},height={size} "
                               f"! yoloxinference model-type={model} {props} "
                               f"! appsink name=sink")
            p.play_until_eos()
            return [_tensor_meta(s.buffer).data.cpu() for s in p.by_name("sink").samples]

        def tp_frames(props, model, frames):
            p = g.parse_launch(f"appsrc name=src ! yoloxinference model-type={model} {props} "
                               "! appsink name=sink")
            p.by_name("src").set_property("caps", g.parse_caps(
                f"video/x-raw,format=RGB,width={frames.shape[2]},height={frames.shape[1]},"
                "framerate=30/1"))
            for i, f in enumerate(frames):
                p.by_name("src").push_buffer(g.Buffer(f, pts=i))
            p.by_name("src").end_of_stream()
            p.play_until_eos()
            return [_tensor_meta(s.buffer).data.cpu() for s in p.by_name("sink").samples]

        def rel(a, b):
            return max(float(((x - y).abs() / (y.abs() + 1e-2)).max()) for x, y in zip(a, b))

        t0 = time.perf_counter()
        # the JAX test's own configuration, YOLOX-s at 64x64: its gate
        tp = tp_run("shard=true shard-mode=tensor", "s", TP_CHECK_SIZE)
        ref = tp_run("engine=reference", "s", TP_CHECK_SIZE)
        results = [_allclose(a, b, TP_RTOL, TP_ATOL) for a, b in zip(tp, ref)]
        ok = len(tp) == len(ref) == TP_FRAMES and all(r[0] for r in results)
        print(f"yoloxinference shard=true shard-mode=tensor, YOLOX-s at {TP_CHECK_SIZE}x"
              f"{TP_CHECK_SIZE}, conv output channels over {MESH_SHARDS} shards: against the "
              f"unsharded reference graph max abs {max(r[1] for r in results):.3e} (rtol "
              f"{TP_RTOL}, atol {TP_ATOL}: {'ok' if ok else 'FAIL'})")
        if not ok:
            raise AssertionError("tensor-parallel YOLOX-s != the reference graph")
        # YOLOX-l at 640x640 batch 1 on two seeded frames, against the
        # reference graph on the card: TP_L_RTOL / TP_L_ATOL, and a swap of
        # two shards' slices of one weight must fail that gate
        frames = torch.from_numpy(np.random.RandomState(5).randint(0, 256, (TP_FRAMES, SIZE, SIZE, 3))
                                  .astype(np.uint8)).to(g.device())
        tp = tp_frames("shard=true shard-mode=tensor", TP_MODEL, frames)
        ref = tp_frames("engine=reference", TP_MODEL, frames)
        walls["yoloxinference tensor"] = time.perf_counter() - t0

        def excess(a, b):
            """max |a - b| / (atol + rtol |b|) at the JAX test's gate."""
            return max(float(((x - y).abs() / (TP_ATOL + TP_RTOL * y.abs())).max())
                       for x, y in zip(a, b))

        results = [_allclose(a, b, TP_L_RTOL, TP_L_ATOL) for a, b in zip(tp, ref)]
        ok = (len(tp) == len(ref) == TP_FRAMES and all(bool(torch.isfinite(t).all()) for t in tp)
              and all(r[0] for r in results))
        print(f"yoloxinference shard=true shard-mode=tensor, YOLOX-{TP_MODEL} at {SIZE}x{SIZE} "
              f"batch 1, conv output channels over {MESH_SHARDS} shards: against the unsharded "
              f"reference graph on the card max abs {max(r[1] for r in results):.3e} (max |ref| "
              f"{max(float(r.abs().max()) for r in ref):.3e}), |d| / (|ref| + 1e-2) "
              f"{rel(tp, ref):.3e}, {excess(tp, ref):.3f}x the JAX test's rtol {TP_RTOL} / atol "
              f"{TP_ATOL} (gate rtol {TP_L_RTOL} / atol {TP_L_ATOL}: {'ok' if ok else 'FAIL'}) "
              f"({walls['yoloxinference tensor']:.1f} s)")
        if not ok:
            raise AssertionError("tensor-parallel YOLOX != the reference graph")
        model = init_weights(Yolox.from_variant(TP_MODEL), seed=0).to(g.device())
        tp_mesh = Mesh(g.visible_devices(), ("tp",))
        sharded = shard_yolox_variables(model.state_dict(), tp_mesh)
        for key in TP_FAULTS:
            bad = dict(sharded)
            bad[key] = [sharded[key][1], sharded[key][0]] + sharded[key][2:]
            out = tp_forward(model, bad, tp_mesh)(frames).cpu()
            out = [out[i:i + 1] for i in range(TP_FRAMES)]
            caught = not all(_allclose(a, b, TP_L_RTOL, TP_L_ATOL)[0] for a, b in zip(out, ref))
            print(f"  planted fault, {key}'s shards 0 and 1 swapped: {excess(out, ref):.3e}x "
                  f"the JAX test's gate ({'caught' if caught else 'MISSED'})")
            if not caught:
                raise AssertionError(f"the tensor-parallel gate misses a swap of {key}'s shards")

        # -- the R-128 histogram psum and the bank benchmark ----------------
        t0 = time.perf_counter()
        bank = r128_bank(BANK_STREAMS, channels=1, rate=48000, mesh=make_stream_mesh())
        t = np.arange(48000) / 48000.0
        bank.add_frames(torch.from_numpy(np.repeat((0.5 * np.sin(2 * np.pi * 997.0 * t))
                                                   [None, :, None], BANK_STREAMS, axis=0)
                                         .astype(np.float32)).to(g.device()))
        merged = bank.merged_loudness()
        print(f"r128_bank of {BANK_STREAMS} over {MESH_SHARDS} shards, 1 s of a 0.5 sine: merged "
              f"loudness (the histogram psum) {merged:.4f} LUFS (bar -9 +-1 LU) "
              f"({time.perf_counter() - t0:.1f} s)")
        if abs(merged + 9.0) >= 1.0:
            raise AssertionError("the merged loudness misses -9 LUFS")
        rows = benchmark.run(BANK_STREAMS, "echo,loudnorm", seconds=3.0, window=1.0,
                             use_mesh=True)
        if not rows or any(r["buffers"] < 1 for r in rows):
            raise AssertionError("parallel/benchmark.py --mesh reported no windows")
    return launches, walls


def mesh_card_vs_cpu():
    """Phase 5k, ROADMAP section C.1: YOLOX-x in bf16 through engine=fast-bf16
    and engine=fast precision=bf16, init_weights(seed=0), one C1_SIZE frame.
    Per route: the part whose route changed, dark2's C3 on the per-conv
    chain (no B1 launch), card against CPU on one bf16 input within
    C1_C3_TOL of its scale (its f32 twin within F32_TOL, and a swap of two
    output channels must fail the gate); then the element, card against
    CPU: fast-bf16's scores within C1_SCORE_TOL.  precision=bf16's whole-net
    scores are printed beside bf16's own distance from f32 on the card for
    YOLOX-l (fused C3) and YOLOX-x; phase 5k' holds them (ROADMAP C.1)."""
    phase("5k YOLOX-x in bf16 (the per-conv C3 route), card against CPU")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
    from gst_plugins_rs_tpu_torch.models.yolox_fast import FastEngine
    from gst_plugins_rs_tpu_torch.ops import yolox_c3

    frame = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (C1_SIZE, C1_SIZE, 3))
                             .astype(np.uint8))
    model = init_weights(Yolox.from_variant("x"), seed=0)
    state = model.state_dict()
    card_state = {k: v.cuda() for k, v in state.items()}

    def scale_err(a, b):
        return float((a.float().cpu() - b.float()).abs().max() / b.float().abs().max())

    routes = {"engine=fast-bf16": dict(s2d_dtype=torch.bfloat16),
              "engine=fast precision=bf16": dict(dtype=torch.bfloat16),
              "engine=fast (f32 twin)": {}}
    for props, kw in routes.items():
        f32 = not kw
        host = FastEngine(model, state, **kw)
        card = FastEngine(model, card_state, fuse_c3=not f32, device="cuda", **kw)
        y = host.dark2_c3_input(frame[None])
        yolox_c3.launches = 0
        got = card.dark2_c3(y.cuda())
        torch.cuda.synchronize()
        counted = yolox_c3.launches
        want = host.dark2_c3(y)
        err = scale_err(got, want)
        swapped = got.clone()
        swapped[..., [0, 1]] = swapped[..., [1, 0]]
        fault = scale_err(swapped, want)
        tol = F32_TOL if f32 else C1_C3_TOL
        ok = (card.c3_route == "per-conv" and counted == 0 and err <= tol < fault
              and got.shape == want.shape)
        print(f"YOLOX-x {props}: dark2's C3 route {card.c3_route}, B1 launches {counted}; card vs "
              f"CPU on one input {tuple(y.shape)} max |d| / max |ref| {err:.3e} (max |ref| "
              f"{float(want.float().abs().max()):.3e}; gate {tol}; two output channels swapped "
              f"{fault:.3e}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"YOLOX-x {props}: dark2's C3 card and CPU disagree, or B1 ran")

    def run(props):
        p = g.parse_launch(f"appsrc name=src ! yoloxinference model-type=x {props} "
                           "! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            f"video/x-raw,format=RGB,width={C1_SIZE},height={C1_SIZE},framerate=30/1"))
        p.by_name("src").push_buffer(g.Buffer(frame.to(g.device()), pts=0))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return _tensor_meta(p.by_name("sink").samples[0].buffer).data.float().cpu()

    shape = (1, (C1_SIZE // 8) ** 2 + (C1_SIZE // 16) ** 2 + (C1_SIZE // 32) ** 2, 85)
    card32 = run("engine=fast")
    for props in ("engine=fast-bf16", "engine=fast precision=bf16"):
        t0 = time.perf_counter()
        yolox_c3.launches = 0
        card = run(props)
        torch.cuda.synchronize()
        counted = yolox_c3.launches
        host = _on("cpu", lambda: run(props))
        d = float((card[..., 4:] - host[..., 4:]).abs().max())
        own = float((card[..., 4:] - card32[..., 4:]).abs().max())
        gated = props == "engine=fast-bf16"
        ok = (card.shape == host.shape == shape and bool(torch.isfinite(card).all())
              and counted == 0 and (d < C1_SCORE_TOL or not gated))
        print(f"YOLOX-x {props}, {C1_SIZE}x{C1_SIZE}, the element: B1 launches {counted}; card vs CPU "
              f"scores max abs {d:.3e} (" + (f"gate {C1_SCORE_TOL}" if gated else
                                              "held in phase 5k', ROADMAP C.1") +
              f"); bf16 against f32 on the card {own:.3e}: {'ok' if ok else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"YOLOX-x {props}: card and CPU disagree, or B1 ran")
    for variant in ("l", "x"):
        m = init_weights(Yolox.from_variant(variant), seed=0)
        st = {k: v.cuda() for k, v in m.state_dict().items()}
        x = frame[None].cuda()
        f32 = FastEngine(m, st, fuse_c3=True, device="cuda")(x)
        b16 = FastEngine(m, st, dtype=torch.bfloat16, fuse_c3=True, device="cuda")
        print(f"YOLOX-{variant} precision=bf16 on the card ({b16.c3_route} C3): scores against f32 "
              f"max abs {float((b16(x)[..., 4:] - f32[..., 4:]).abs().max()):.3e}")


def mesh_timing(card_line):
    """Phase 6k: device ms and device ops a tick of loudnormbank shard=true
    against shard=false (torch.profiler over BANK_PROFILE_SECONDS), and a
    100 ms frame of audioloudnorm time-shard=true against time-shard=false
    (over TS_PROFILE_FRAMES frames after the 3 s first frame).  No claim:
    four shards on one card launch more."""
    phase("6k the mesh paths, timing (4 shards on one card against none)")
    import gst_plugins_rs_tpu_torch as g

    rows = {}
    with _virtual_devices(MESH_SHARDS):
        ticks = 1 + (BANK_PROFILE_SECONDS * 10 - 30) + 29
        for shard in (False, True):
            label = f"loudnormbank {BANK_STREAMS} streams{' shard=true' if shard else ''}"
            bank_pipeline(4, shard=shard)[0].play_until_eos()  # warm-up
            _, events = device_events(
                lambda: bank_pipeline(BANK_PROFILE_SECONDS, shard=shard)[0].play_until_eos())
            busy = sum(e.self_device_time_total for e in events) / 1e3
            ops = sum(e.count for e in events if not e.key.startswith("Memcpy"))
            rows[label] = dict(device_ms_per_tick=busy / ticks, ops_per_tick=ops / ticks)
            print(f"{label}: device busy {busy / ticks:.4f} ms and {ops / ticks:.1f} device ops a "
                  f"tick (torch.profiler, {BANK_PROFILE_SECONDS} s: {ticks} ticks) [{card_line}]")
        n = 30 + TS_PROFILE_FRAMES
        for props in ("", "time-shard=true"):
            label = f"audioloudnorm{' ' + props if props else ''}"

            def run():
                g.parse_launch(loudnorm_launch(n // 10, f"audioloudnorm {props} ! fakesink")
                               ).play_until_eos()

            run()  # warm-up
            _, events = device_events(run)
            busy = sum(e.self_device_time_total for e in events) / 1e3
            ops = sum(e.count for e in events if not e.key.startswith("Memcpy"))
            top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
            rows[label] = dict(device_ms_per_frame=busy / n, ops_per_frame=ops / n)
            print(f"{label} (with its source, resampler and converter): device busy "
                  f"{busy / n:.4f} ms and {ops / n:.1f} device ops per 100 ms of audio "
                  f"(torch.profiler, {n / 10:.0f} s); ms by op: "
                  + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3 / n:.4f}"
                              for e in top) + f" [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# The recording and failover path (the host-only families): togglerecord, fallbackswitch,
# the inter bridge, ts-queue and livesync behind the effects kernels (B4,
# B2) and the loudnorm limiter (L1), and the byte elements on card payloads
# ---------------------------------------------------------------------------
REC_FRAMES = 32            # seeded 1080p RGBA frames through the recording path (4l)
REC_CPU_FRAMES = 6         # card against CPU (5l)
REC_SECONDS = 60           # 192 kHz stereo F64 through audioloudnorm ! togglerecord (4l)
REC_CPU_SECONDS = 6        # card against CPU (5l)
REC_TRACK_SPB = 1000       # the recording's audio track: 20.8 ms buffers at 48 kHz, so the
                           # video's end (32 frames, 1.0667 s) falls inside one, which is clipped
REC_BYTE_FRAMES = 8        # frames through each byte round trip (4l; 2 in 5l)
REC_TIMING_FRAMES = 128    # a repeat (6l): the first REC_TIMING_WARM stream untimed,
REC_TIMING_WARM = 16       # the rest timed ...
REC_REPEATS = 3            # ... the median of these
REC_SEED = 17
# the recording: the graded frames are togglerecord's main stream and a
# test tone its audio track (sink_0 / src_0), a videotestsrc is the
# fallbackswitch's second input, and the graded stream crosses to a second
# pipeline (REC_VIDEO_OUT) through the inter bridge
REC_VIDEO = ("appsrc name=src ! hsvfilter hue-shift=120 ! colorlut location={grade} "
             "precision=approx ! togglerecord name=tr record=true ! fallbackswitch name=fs "
             "! intersink name=isink producer-name={channel} "
             "videotestsrc num-buffers=2 pattern=black "
             "! video/x-raw,format=RGBA,width={w},height={h},framerate=30/1 ! fs. "
             "ts-audiotestsrc context={channel}-track wave=white-noise seed=3 "
             "num-buffers={track} samplesperbuffer=1000 "
             "! audio/x-raw,format=F32,rate=48000,channels=2 ! tr. tr. ! appsink name=track")
REC_VIDEO_OUT = ("intersrc producer-name={channel} max-time=0 ! ts-queue name=tq "
                 "! livesync name=ls ! appsink name=sink")
REC_PLAIN = ("appsrc name=src ! hsvfilter hue-shift=120 ! colorlut location={grade} "
             "precision=approx ! appsink name=sink")
# the loudness path: a live source (each buffer waits for the pipeline's
# clock, which rec_audio sets to its time), togglerecord in live mode
# (timestamps kept, so a stop leaves a hole), and livesync behind the inter
# bridge on a clock of its own: audioloudnorm's 3 s lookahead puts its
# output 3 s behind the source's clock
REC_AUDIO = "audioloudnorm ! togglerecord name=tr is-live=true record=true " \
            "! intersink name=isink producer-name={channel}"
REC_AUDIO_OUT = "intersrc producer-name={channel} max-time=0 ! livesync name=ls " \
                "! appsink name=sink"


class PayloadTrace:
    """A pipeline tracer: each buffer that enters an element's sink pad, by
    "element:pad", as (data_ptr, device, shape, pts) for a tensor payload
    (None, the payload's type name, None, pts) otherwise."""

    def __init__(self):
        self.seen = {}

    def on_buffer(self, element, pad, buffer):
        d = buffer.data
        key = (d.data_ptr(), str(d.device), tuple(d.shape)) if isinstance(d, torch.Tensor) \
            else (None, type(d).__name__, None)
        self.seen.setdefault(f"{element.name}:{pad.name}", []).append(key + (buffer.pts,))

    def ptrs(self, where):
        return [e[0] for e in self.seen.get(where, [])]


class RecordToggle:
    """A pipeline tracer that stops the recording as frame k of `frames`
    reaches togglerecord's main pad, and starts it again from a thread of
    its own once the element has left the recording state: a non-live
    upstream blocks while the recording is stopped, so the restart cannot
    come from the streaming thread.  The frames must be at least two apart
    (rec_toggles), so each stop finds the element recording."""

    def __init__(self, tr, frames):
        self.tr, self.frames, self.count, self.threads = tr, set(frames), 0, []

    def _restart(self):
        deadline = time.monotonic() + 60
        while self.tr.get_property("recording") and time.monotonic() < deadline:
            time.sleep(0.001)
        self.tr.set_property("record", True)

    def on_buffer(self, element, pad, buffer):
        import threading

        if element is not self.tr or pad.name != "sink":
            return
        if self.count in self.frames:
            self.tr.set_property("record", False)
            t = threading.Thread(target=self._restart, daemon=True)
            t.start()
            self.threads.append(t)
        self.count += 1


_REC_RUNS = [0]


def _rec_channel(kind):
    _REC_RUNS[0] += 1
    return f"rec-{kind}-{_REC_RUNS[0]}"


def _wait_eos(sink, limit=120.0):
    deadline = time.monotonic() + limit
    while not sink.eos and time.monotonic() < deadline:
        time.sleep(0.002)
    if not sink.eos:
        raise AssertionError(f"{sink.name} saw no EOS within {limit} s")


def rec_toggles(n_frames, seed=REC_SEED):
    """The two seeded frames at which the video recording stops and starts
    again, at least two frames apart: the frame after a restart starts the
    recording anew, and a stop there would race RecordToggle's restart."""
    pairs = [(a, b) for a in range(1, n_frames - 1) for b in range(a + 2, n_frames - 1)]
    return list(pairs[int(np.random.default_rng(seed).integers(len(pairs)))])


def rec_audio_gap(n_buffers, seed=REC_SEED):
    """(the source buffer before which record goes off, buffers it stays off)."""
    rng = np.random.default_rng(seed + 1)
    return int(rng.integers(n_buffers // 2, 3 * n_buffers // 4)), int(rng.integers(2, 5))


def _video_caps():
    import gst_plugins_rs_tpu_torch as g

    return g.parse_caps(f"video/x-raw,format=RGBA,width={HD_W},height={HD_H},framerate=30/1")


def rec_video(frames, grade, toggles, around=None, warm=0, traced=True):
    """The recording's video path on the current device: `frames` (tensors
    on it) through REC_VIDEO, then REC_VIDEO_OUT.  Both pipelines run on
    TestClocks that never move, so fallbackswitch never times out and
    livesync emits each buffer as it arrives.  The first `warm` frames
    stream through both pipelines first; `around`, if given, is then called
    with the streaming of the rest (start-up, colorlut's fit and the first
    buffers' negotiation stay outside).  `traced=False` leaves the payload
    trace out (its cost is the tracer's, not the path's).  Returns (outputs,
    the track's outputs, the trace)."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import State, TestClock

    channel = _rec_channel("video")
    track = int(len(frames) * FRAME_NS * 48000 / (REC_TRACK_SPB * 10**9)) + 8
    p = g.parse_launch(REC_VIDEO.format(grade=grade, channel=channel, track=track, w=HD_W,
                                        h=HD_H))
    c = g.parse_launch(REC_VIDEO_OUT.format(channel=channel))
    trace, toggle = PayloadTrace(), RecordToggle(p.by_name("tr"), toggles)
    for q in (p, c):
        q.use_clock(TestClock())
        if traced:
            q.add_tracer(trace)
    p.add_tracer(toggle)
    p.by_name("src").set_property("caps", _video_caps())
    _push_frames(p, frames)
    p.by_name("src").end_of_stream()
    p.set_state(State.PLAYING)
    c.set_state(State.PLAYING)
    sink = c.by_name("sink")
    if warm:
        p.run(max_iterations=warm)
        c.run(max_iterations=warm)
        deadline = time.monotonic() + 60
        while len(sink.samples) < warm and time.monotonic() < deadline:
            time.sleep(0.0005)

    def stream():
        p.run()
        c.run()
        _wait_eos(sink)

    (around or (lambda fn: fn()))(stream)
    for t in toggle.threads:
        t.join(60)
    out = [s.buffer for s in c.by_name("sink").samples]
    track_out = [s.buffer for s in p.by_name("track").samples]
    c.set_state(State.NULL)
    p.set_state(State.NULL)
    return out, track_out, trace


def rec_plain(frames, grade, around=None, warm=0):
    """The same frames through REC_PLAIN (the first `warm` outside
    `around`): the outputs."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import State

    p = g.parse_launch(REC_PLAIN.format(grade=grade))
    p.by_name("src").set_property("caps", _video_caps())
    _push_frames(p, frames)
    p.by_name("src").end_of_stream()
    p.set_state(State.PLAYING)
    if warm:
        p.run(max_iterations=warm)
    (around or (lambda fn: fn()))(p.run)
    out = [s.buffer for s in p.by_name("sink").samples]
    p.set_state(State.NULL)
    return out


def rec_audio(seconds, gap):
    """The loudness path on the current device: `seconds` of the ticks
    through audioloudnorm into togglerecord (live mode) and intersink, one
    source buffer at a time on a TestClock set to its time, record off
    before source buffer gap[0] and on again gap[1] buffers later; then the
    inter bridge into livesync, each buffer let in with the output clock 1
    ns before its time, so every slot of the hole passes its deadline and
    is filled.  Returns (outputs, trace)."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import State, TestClock

    channel = _rec_channel("audio")
    launch = loudnorm_launch(seconds, tail=REC_AUDIO.format(channel=channel))
    p = g.parse_launch(launch.replace("audiotestsrc ", "audiotestsrc is-live=true ", 1))
    c = g.parse_launch(REC_AUDIO_OUT.format(channel=channel))
    trace, clocks = PayloadTrace(), (TestClock(), TestClock())
    for q, clk in zip((p, c), clocks):
        q.use_clock(clk)
        q.add_tracer(trace)
    tr = p.by_name("tr")
    p.set_state(State.PLAYING)
    src_ns = AUDIO_SPB * 10**9 // 48000
    for i in range(seconds * 10 + 1):  # the last iteration pushes EOS
        if i == gap[0]:
            tr.set_property("record", False)
        elif i == gap[0] + gap[1]:
            tr.set_property("record", True)
        clocks[0].set_time(max(clocks[0].now(), i * src_ns))
        p.run(max_iterations=1)
    c.set_state(State.PLAYING)
    for _, _, _, pts in trace.seen["isink:sink"]:
        clocks[1].set_time(max(clocks[1].now(), c.base_time + pts - 1))
        c.run(max_iterations=1)
    c.run(max_iterations=1)  # the EOS
    _wait_eos(c.by_name("sink"))
    out = [s.buffer for s in c.by_name("sink").samples]
    c.set_state(State.NULL)
    p.set_state(State.NULL)
    return out, trace


def _profiled(run):
    """(run's result, device-to-host copies) over one call of `run` under
    torch.profiler, the card's activity only.  A marker kernel (the spin
    kernel of torch.cuda._sleep) goes first and another last, inside the
    session's pads (device_events): only a session that holds both markers
    counts, so no copy of `run` was lost at its edges, and `run` is called
    again otherwise (it must build what it runs)."""
    got = []

    def marked():
        torch.cuda._sleep(MARKER_CYCLES)
        got.append(run())
        torch.cuda.synchronize()
        torch.cuda._sleep(MARKER_CYCLES)

    def complete(events):
        return sum(e.count for e in events if "spin_kernel" in e.key) == 2

    _, events = device_events(marked, complete=complete)
    return got[-1], sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))


MARKER_CYCLES = 1000


def rec_byte_chains():
    """The byte round trips after rsfilesink / rsfilesrc, as (label, launch
    fragment); the sodium keys and the stream nonce are fixed, so the sealed
    stream repeats."""
    from gst_plugins_rs_tpu_torch.net.nacl import x25519_public_key

    s, r = bytes(range(1, 33)), bytes(range(33, 65))
    enc = (f"sodiumencrypter sender-key={s.hex()} receiver-key={x25519_public_key(r).hex()} "
           f"nonce={bytes(range(24)).hex()}")
    dec = f"sodiumdecrypter sender-key={x25519_public_key(s).hex()} receiver-key={r.hex()}"
    return [("compressenc ! compressdec", "compressenc ! compressdec"),
            ("brotlicompress ! brotlidecompress", "brotlicompress ! brotlidecompress"),
            ("sodiumencrypter ! sodiumdecrypter", f"{enc} ! {dec}")]


def rec_bytes(frames, path, profiled=False):
    """Each byte round trip over `frames` (tensors): {label: (output bytes,
    device-to-host copies or None)}.  rsfilesink writes `path` and rsfilesrc
    reads it back a frame a block."""
    import gst_plugins_rs_tpu_torch as g

    nbytes = frames[0].numel() * frames[0].element_size()

    def through(launch):
        def run():
            p = g.parse_launch(launch)
            if "appsrc" in launch:
                src = p.by_name("src")
                src.set_property("caps", g.parse_caps("application/octet-stream"))
                for i, f in enumerate(frames):
                    src.push_buffer(g.Buffer(f, pts=i * FRAME_NS, duration=FRAME_NS))
                src.end_of_stream()
            p.play_until_eos()
            if "appsink" not in launch:
                return b""
            return b"".join(np.asarray(s.buffer.data).tobytes()
                            for s in p.by_name("sink").samples)
        return _profiled(run) if profiled else (run(), None)

    _, wrote = through(f"appsrc name=src ! rsfilesink location={path}")
    data, _ = through(f"rsfilesrc location={path} blocksize={nbytes} ! appsink name=sink")
    results = {"rsfilesink ! rsfilesrc": (data, wrote)}
    for label, chain in rec_byte_chains():
        results[label] = through(f"appsrc name=src ! {chain} ! appsink name=sink")
    return results


def rec_pipelines(grade):
    """Phase 4l: the recording path at full width on the card.  Video:
    REC_FRAMES seeded 1080p frames through hsvfilter and colorlut approx
    (B4, B2) into togglerecord (record off and on again at two seeded
    frames; a test tone is its audio track), fallbackswitch (a videotestsrc
    on its second input), the inter bridge, ts-queue and livesync.  Audio:
    REC_SECONDS of 192 kHz F64 through audioloudnorm (L1) into togglerecord
    (a seeded stop), the inter bridge and livesync (its silence fill).  The
    counters of B4, B2 and L1 are set to 0 just before each path and read
    just after.  Then REC_BYTE_FRAMES frames on the card through rsfilesink
    and rsfilesrc and the compress, brotli and sodium round trips.  Returns
    the launches."""
    phase("4l recording and failover path on the card")
    import importlib.util

    from gst_plugins_rs_tpu_torch.codecs import brotli
    from gst_plugins_rs_tpu_torch.core import BufferFlags
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
    from gst_plugins_rs_tpu_torch.ops import hsv_planes
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim
    from gst_plugins_rs_tpu_torch.utils.build import BUILD_DIR

    print(f"host: brotli {brotli.backend()}; the `cryptography` package "
          f"{'present' if importlib.util.find_spec('cryptography') else 'absent'} (the port's "
          f"nacl needs it); PIL {'present' if importlib.util.find_spec('PIL') else 'absent'}")
    card0 = torch.device("cuda", 0)
    frames = fuse_frames(REC_FRAMES, seed=REC_SEED)
    toggles = rec_toggles(REC_FRAMES)

    # the byte elements first: one read-back a buffer, at the first byte element
    bframes = frames[:REC_BYTE_FRAMES]
    want = b"".join(f.cpu().numpy().tobytes() for f in bframes)
    for label, (data, dtoh) in rec_bytes(bframes, BUILD_DIR / "rec_bytes.bin",
                                         profiled=True).items():
        print(f"{label}: {len(bframes)} card frames, bit-equal {data == want}, Memcpy DtoH {dtoh}")
        if data != want or dtoh != len(bframes):
            raise AssertionError(f"{label}: not bit-equal or not one read-back a buffer")

    # the kernels' own copies, read on the chain without the recording stages
    _, plain_dtoh = _profiled(lambda: rec_plain(frames, grade))

    def video():
        hsv_planes.launches = lowrank.packed_launches = 0
        got = rec_video(frames, grade, toggles)
        torch.cuda.synchronize()
        return got, {"hsv_planes": hsv_planes.launches,
                     "colorlut_lowrank_packed": lowrank.packed_launches}

    ((out, track, trace), counted), path_dtoh = _profiled(video)
    graded = trace.ptrs("tr:sink")
    stages = ("fs:sink_0", "isink:sink", "tq:sink", "ls:sink", "sink:sink")
    shared = {s: trace.ptrs(s) == graded for s in stages}
    cuts = [i for i, b in enumerate(out) if b.has_flag(BufferFlags.DISCONT)]
    on_card = all(isinstance(b.data, torch.Tensor) and b.data.device == card0 for b in out)
    track_in = trace.seen.get("tr:sink_0", [])
    clipped = [b for b in track if b.data.shape[0] != REC_TRACK_SPB]
    views = all(b.data._base is not None and b.data.device == card0 for b in clipped)
    print(f"video {len(frames)} x {HD_W}x{HD_H} RGBA: {len(out)} out, all on {card0}: {on_card}; "
          f"record off and on at frames {toggles}, DISCONT at outputs {cuts}; colorlut's output "
          f"payloads shared through {[s for s in stages if shared[s]]}; Memcpy DtoH {path_dtoh} "
          f"against {plain_dtoh} on appsrc ! hsvfilter ! colorlut ! appsink; launches {counted}")
    print(f"audio track: {len(track_in)} buffers in, {len(track)} out, clipped at the video's end "
          f"to {[b.data.shape[0] for b in clipped]} samples, views of the input on the card: "
          f"{views}")
    if len(out) != REC_FRAMES or not on_card or not all(shared.values()) \
            or len(graded) != REC_FRAMES:
        raise AssertionError("the recording's video left the card or was copied")
    if path_dtoh != plain_dtoh:
        raise AssertionError("the recording stages copied a payload off the card")
    if counted != {"hsv_planes": REC_FRAMES, "colorlut_lowrank_packed": REC_FRAMES}:
        raise AssertionError("B4 / B2 launches != frames on the recording path")
    # togglerecord marks the first frame, and at each toggle the frame that
    # met the stop and the one after it
    want_cuts = [0] + [i + k for i in toggles for k in (0, 1)]
    if cuts != want_cuts or len(clipped) != 1 or not views:
        raise AssertionError(f"togglerecord: DISCONT at {cuts}, not {want_cuts}, or the "
                             f"clipped track")
    launches = dict(counted)

    # the loudness path, and the same source and loudnorm into an appsink
    gap = rec_audio_gap(REC_SECONDS * 10)
    _, plain_adtoh = _profiled(lambda: __import__("gst_plugins_rs_tpu_torch").parse_launch(
        loudnorm_launch(REC_SECONDS)).play_until_eos())

    def audio():
        lim.launches = 0
        got = rec_audio(REC_SECONDS, gap)
        torch.cuda.synchronize()
        return got, lim.launches

    ((aout, atrace), l1), a_dtoh = _profiled(audio)
    frames_in = atrace.ptrs("tr:sink")
    # the limiter runs once a 100 ms output frame; at EOS audioloudnorm
    # drains its 3 s lookahead as one buffer of many frames
    want_l1 = -(-sum(e[2][0] for e in atrace.seen["tr:sink"]) // LN_FRAME)
    passed = [b for b in aout if not b.has_flag(BufferFlags.GAP)]
    fills = [b for b in aout if b.has_flag(BufferFlags.GAP)]
    a_shared = [b.data.data_ptr() for b in passed] == atrace.ptrs("isink:sink") \
        and atrace.ptrs("ls:sink") == atrace.ptrs("isink:sink") \
        and set(atrace.ptrs("isink:sink")) <= set(frames_in)
    a_on_card = all(b.data.device == card0 and b.data.dtype == torch.float64 for b in aout)
    zeros = all(not bool(b.data.any()) and tuple(b.data.shape) == (LN_FRAME, 2) for b in fills)
    dropped = len(frames_in) - len(passed)
    print(f"audio {REC_SECONDS} s 192 kHz F64: {len(frames_in)} frames into togglerecord, record "
          f"off from source buffer {gap[0]} for {gap[1]}: {dropped} dropped; livesync {len(aout)} "
          f"out, {len(fills)} fills, zeros on {card0}: {zeros}; all on the card: {a_on_card}; "
          f"payloads shared through the bridge and livesync: {a_shared}; Memcpy DtoH {a_dtoh} "
          f"against {plain_adtoh} on the source ! audioloudnorm ! appsink; L1 launches {l1}, "
          f"100 ms frames {want_l1}")
    if l1 != want_l1 or l1 < REC_SECONDS * 10 or not a_on_card or not a_shared \
            or a_dtoh != plain_adtoh:
        raise AssertionError("the loudness path: launches, device or copies")
    if dropped < 1 or len(fills) != dropped or not zeros:
        raise AssertionError("the loudness path: the stop or livesync's fill")
    launches["loudnorm_limiter"] = l1

    return launches


def rec_card_vs_cpu(grade):
    """Phase 5l: the recording path on the card against the same on the
    CPU, at REC_CPU_FRAMES frames and REC_CPU_SECONDS of audio: buffer
    counts, PTS, durations, flags, togglerecord's restarts and the clipped
    track's sample counts equal; pixels within LSB_TOL; the loudness path
    within LN_SAMPLE_TOL; the track and the byte round trips bit-equal."""
    phase("5l recording path, card against CPU")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.utils.build import BUILD_DIR

    frames = fuse_frames(REC_CPU_FRAMES, seed=REC_SEED + 1)
    toggles = rec_toggles(REC_CPU_FRAMES)
    gap = rec_audio_gap(REC_CPU_SECONDS * 10)
    runs = {}
    for dev in ("cuda", "cpu"):
        g.set_device(dev)
        try:
            fr = [f.to(dev) for f in frames]
            out, track, _ = rec_video(fr, grade, toggles)
            aout, _ = rec_audio(REC_CPU_SECONDS, gap)
            res = rec_bytes(fr[:2], BUILD_DIR / f"rec_bytes_{dev}.bin")
        finally:
            g.set_device("cuda")
        runs[dev] = (out, track, aout, {k: v[0] for k, v in res.items()})

    def meta(bufs):
        return [(b.pts, b.duration, b.flags.value, tuple(b.data.shape)) for b in bufs]

    def clips(bufs):
        return [b.data.shape[0] for b in bufs if b.data.shape[0] != REC_TRACK_SPB]

    (vc, tc, ac, bc), (vh, th, ah, bh) = runs["cuda"], runs["cpu"]
    same = {"video": meta(vc) == meta(vh), "track": meta(tc) == meta(th),
            "audio": meta(ac) == meta(ah)}
    same_meta = all(same.values())
    d_px = max(_lsb(a.data.cpu().numpy(), b.data.numpy()) for a, b in zip(vc, vh))
    d_audio = max(float((a.data.cpu() - b.data).abs().max()) for a, b in zip(ac, ah))
    d_track = max(float((a.data.cpu() - b.data).abs().max()) for a, b in zip(tc, th))
    print(f"video {REC_CPU_FRAMES} frames, toggles {toggles}: {len(vc)} / {len(vh)} out, buffer "
          f"metadata equal {same}, max {d_px} LSB (gate {LSB_TOL}); the track clipped to "
          f"{clips(tc)} / {clips(th)} samples, max {d_track:.3e}; audio {REC_CPU_SECONDS} s, gap "
          f"{gap}: {len(ac)} / {len(ah)} out, max {d_audio:.3e} (gate {LN_SAMPLE_TOL}); byte "
          f"round trips equal across the devices: {bc == bh} ({sorted(bc)})")
    if not same_meta or len(vc) != REC_CPU_FRAMES or d_px > LSB_TOL or d_track != 0.0 \
            or d_audio > LN_SAMPLE_TOL or bc != bh or not clips(tc):
        raise AssertionError("the recording path: card and CPU disagree")


def _stream_busy(run):
    """(device busy ms, device ops) of the streaming part of one call of
    `run(around)` under torch.profiler."""
    _, dev = device_events(run, around=True)
    return sum(e.self_device_time_total for e in dev) / 1e3, sum(e.count for e in dev)


def rec_timing(card_line, grade):
    """Phase 6l: frames per second of 4l's video path (REC_VIDEO into
    REC_VIDEO_OUT, no toggles) against REC_PLAIN on the same frames, the
    median of REC_REPEATS runs of REC_TIMING_FRAMES frames, each timed on
    the host clock to torch.cuda.synchronize over all but its first
    REC_TIMING_WARM (start-up and negotiation outside); the host ms a frame
    the recording stages add; device busy ms and ops a frame over the
    timed frames of one more run (torch.profiler) and the busy share of
    the median wall."""
    phase("6l recording path timing")
    frames = fuse_frames(REC_TIMING_FRAMES, seed=REC_SEED + 2)
    warm, timed_n = REC_TIMING_WARM, REC_TIMING_FRAMES - REC_TIMING_WARM
    paths = {"appsrc ! hsvfilter ! colorlut ! appsink": lambda around: rec_plain(
                 frames, grade, around=around, warm=warm),
             "the recording path (4l)": lambda around: rec_video(
                 frames, grade, [], around=around, warm=warm, traced=False)}
    rows = {}
    for label, run in paths.items():
        walls = []

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        for _ in range(REC_REPEATS):
            run(timed)
        busy, ops = _stream_busy(run)
        wall = statistics.median(walls)
        rows[label] = dict(fps=timed_n / wall, wall=wall, busy=busy)
        print(f"{label}, {HD_W}x{HD_H}, {timed_n} frames timed after {warm}: "
              f"{timed_n / wall:.1f} frames/s (median of "
              f"{[round(timed_n / w, 1) for w in walls]}); device busy {busy / timed_n:.4f} ms "
              f"and {ops / timed_n:.1f} ops a frame, {100 * busy / 1e3 / wall:.1f}% of the "
              f"median wall [{card_line}]")
    plain, rec = rows.values()
    print(f"the recording stages and their two test sources add "
          f"{(rec['wall'] - plain['wall']) / timed_n * 1e3:.3f} host ms a frame; frames/s "
          f"recording / plain {rec['fps'] / plain['fps']:.3f} [{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# Live captioning recorded to fragmented MP4: speech into transcriberbin (the
# builtin asr-lite, kernel T1) beside the graded video (hsvfilter B4,
# colorlut approx B2), CEA-608 captions on the video as VideoCaptionMeta,
# cea608overlay, and one cmafmux a track (CMAF carries one track a file)
# ---------------------------------------------------------------------------
CAP_WORDS = ("hello", "world")   # tests/test_asr_quality.py's sentence, seed and noise
CAP_SPEECH_SEED = 424242
CAP_SNR_DB = 30
CAP_RATE = 16000
CAP_AUDIO_SPB = 1600             # 100 ms audio buffers
CAP_CHUNK_NS = 4 * 10**9         # transcriberbin transcriber::chunk-duration
CAP_FRAG_NS = 10**9              # cmafmux fragment-duration
CAP_FPS = 30
CAP_FRAMES = 150                 # 5 s of 1080p (4m)
CAP_CPU_FRAMES = 6               # card against CPU (5m)
CAP_TIMING_REPEATS = 3           # 6m: the median of these
CAP_SEED = 29


def caption_audio():
    """The spoken sentence, F32 16 kHz mono [n, 1] (numpy)."""
    from gst_plugins_rs_tpu_torch.ops.speechsynth import synth_sentence

    return synth_sentence(list(CAP_WORDS), seed=CAP_SPEECH_SEED,
                          noise_snr_db=CAP_SNR_DB)[:, None]


class BufferTrace:
    """A pipeline tracer keeping every buffer that enters the given
    "element:pad"s, in order."""

    def __init__(self, *where):
        self.seen = {w: [] for w in where}

    def on_buffer(self, element, pad, buffer):
        got = self.seen.get(f"{element.name}:{pad.name}")
        if got is not None:
            got.append(buffer)


def caption_pipeline(g, audio, frames, grade=None, fps=CAP_FPS):
    """The captioning path in package `g` (the port, or a package with its
    API): `audio` ([n, 1] F32 at 16 kHz) in 100 ms buffers through appsrc
    into transcriberbin's sink_audio (the builtin asr-lite, 4 s chunks);
    `frames` (RGBA [h, w, 4] u8) through appsrc, with a `grade` (a .cube
    file) through hsvfilter hue-shift=120 ! colorlut precision=approx, into
    its sink_video; src_video ! cea608overlay ! cmafmux (vmux) ! appsink
    (vsink) and src_audio ! cmafmux (amux) ! appsink (asink), fragments of
    1 s.  Payloads go in as they are given (tensors stay on their device).
    Returns the pipeline with a BufferTrace of ov:sink (the graded frames
    and their caption metas), vmux:sink (the overlaid frames) and amux:sink."""
    h, w = frames[0].shape[:2]
    make = g.element_factory_make
    p = g.Pipeline()
    asrc, vsrc = make("appsrc", "asrc"), make("appsrc", "vsrc")
    asrc.set_property("caps", g.parse_caps(
        f"audio/x-raw,format=F32,rate={CAP_RATE},channels=1"))
    vsrc.set_property("caps", g.parse_caps(
        f"video/x-raw,format=RGBA,width={w},height={h},framerate={fps}/1"))
    tb = make("transcriberbin", "tb")
    tb.set_property("transcriber::chunk-duration", CAP_CHUNK_NS)
    tb.set_property("mode", "pop-on")
    effects = []
    if grade is not None:
        hsv, lut = make("hsvfilter", "hsv"), make("colorlut", "lut")
        hsv.set_property("hue-shift", 120.0)
        lut.set_property("location", str(grade))
        lut.set_property("precision", "approx")
        effects = [hsv, lut]
    ov = make("cea608overlay", "ov")
    vmux, amux = make("cmafmux", "vmux"), make("cmafmux", "amux")
    vsink, asink = make("appsink", "vsink"), make("appsink", "asink")
    for m in (vmux, amux):
        m.set_property("fragment-duration", CAP_FRAG_NS)
    for e in (asrc, vsrc, tb, *effects, ov, vmux, amux, vsink, asink):
        p.add(e)
    asrc.pad("src").link(tb.pad("sink_audio"))
    chain = [vsrc, *effects]
    for a, b in zip(chain, chain[1:]):
        a.link(b)
    chain[-1].pad("src").link(tb.pad("sink_video"))
    tb.pad("src_video").link(ov.pad("sink"))
    ov.pad("src").link(vmux.pad("sink"))
    tb.pad("src_audio").link(amux.pad("sink"))
    vmux.link(vsink)
    amux.link(asink)
    for i in range(0, len(audio), CAP_AUDIO_SPB):
        n = min(CAP_AUDIO_SPB, len(audio) - i)
        pts = i * 10**9 // CAP_RATE
        asrc.push_buffer(g.Buffer(audio[i:i + n], pts=pts,
                                  duration=(i + n) * 10**9 // CAP_RATE - pts))
    for i, f in enumerate(frames):
        pts = i * 10**9 // fps
        vsrc.push_buffer(g.Buffer(f, pts=pts, duration=(i + 1) * 10**9 // fps - pts))
    asrc.end_of_stream()
    vsrc.end_of_stream()
    p.trace = BufferTrace("ov:sink", "vmux:sink", "amux:sink")
    p.add_tracer(p.trace)
    return p


def caption_run(p, around=None):
    """Play the captioning pipeline to its end: the audio first, to its EOS
    (the video waits for the transcription, as the reference transcriberbin
    holds it back by its latency), then the video; `around`, if given, is
    called with the streaming.  Returns p."""
    from gst_plugins_rs_tpu_torch.core import State

    def stream():
        asrc = p.by_name("asrc")
        while not asrc._eos_sent:
            asrc.iterate()
        p.run()

    p.set_state(State.PLAYING)
    try:
        (around or (lambda fn: fn()))(stream)
    finally:
        p.set_state(State.NULL)
    return p


def caption_outputs(p):
    """What a captioning run produced: {"video", "audio": the files' bytes,
    "graded", "overlaid", "audio_in": the buffers that entered the overlay,
    the video muxer and the audio muxer, "pairs": the 608 byte pairs of the
    caption metas in order}."""
    def file_bytes(sink):
        return b"".join(np.asarray(s.buffer.data, np.uint8).tobytes()
                        for s in p.by_name(sink).samples)

    seen = p.trace.seen
    pairs = []
    for b in seen["ov:sink"]:
        for m in b.metas:
            if type(m).__name__ == "VideoCaptionMeta":
                if m.caption_type != "cea608-raw":
                    raise AssertionError(f"caption meta of type {m.caption_type}")
                pairs += [(m.data[i], m.data[i + 1]) for i in range(0, len(m.data) - 1, 2)]
    return {"video": file_bytes("vsink"), "audio": file_bytes("asink"),
            "graded": seen["ov:sink"], "overlaid": seen["vmux:sink"],
            "audio_in": seen["amux:sink"], "pairs": pairs}


def caption_text(pairs):
    """The text the 608 pairs decode to (the port's decoder), lower case."""
    from gst_plugins_rs_tpu_torch.ops.cea608 import Cea608Decoder

    dec = Cea608Decoder()
    for hi, lo in pairs:
        dec.push_pair(hi, lo)
    dec.flush()
    return " ".join(line for cap in dec.take_events() if cap
                    for line in getattr(cap, "lines", []) if line).lower()


def caption_changes(p, graded, overlaid):
    """([whether the overlay changed frame i], the count of changed pixels
    outside every caption box the overlay of pipeline p drew)."""
    boxes = [box.bool() for _, box in p.by_name("ov")._mask_cache.values()]
    changed, outside = [], 0
    for a, b in zip(graded, overlaid):
        diff = (torch.as_tensor(a.data, device=b.data.device) != b.data).any(-1)
        changed.append(bool(diff.any()))
        for box in boxes:
            diff &= ~box
        outside += int(diff.sum())
    return changed, outside


def mp4_skeleton(data):
    """The file's top-level boxes with every mdat's payload left out."""
    from gst_plugins_rs_tpu_torch.mux import reader

    return b"".join(data[b.start:b.start + 8] if b.type == b"mdat"
                    else data[b.start:b.start + b.size] for b in reader.parse_boxes(data))


def check_caption_file(data, kind, durations, timescale):
    """Parse one cmafmux file with the port's reader: one track of sample
    entry `kind` in `timescale` units, one sample a buffer in order with its
    duration (`durations`), each sample's decode time the sum of those before
    it (the tfdt of each fragment and the trun durations).  Returns (the
    track, the samples' bytes in order, the fragment count)."""
    from gst_plugins_rs_tpu_torch.mux import reader

    tree = reader.parse_boxes(data)
    tracks = reader.decode_tracks(tree)
    runs = reader.decode_fragments(data, tree)
    if len(tracks) != 1 or tracks[0].sample_entry_type != kind \
            or tracks[0].timescale != timescale:
        raise AssertionError(f"{kind}: tracks {tracks}")
    samples, times = [], []
    for r in runs:
        t, off = r.decode_time, 0
        for size, dur in zip(r.sample_sizes, r.sample_durations):
            samples.append(r.data[off:off + size])
            times.append((t, dur))
            off, t = off + size, t + dur
    want = [(int(sum(durations[:i])), d) for i, d in enumerate(durations)]
    if times != want:
        raise AssertionError(f"{kind}: decode times and durations {times[:4]}... "
                             f"!= {want[:4]}...")
    return tracks[0], samples, len({r.sequence_number for r in runs})


def atlas_on_this_host():
    """Whether this machine's Pillow, if it has one, draws cea608overlay's
    bundled glyph atlas (the overlay itself never imports Pillow)."""
    import importlib.metadata
    import importlib.util

    from gst_plugins_rs_tpu_torch.utils.cea608_atlas import ATLAS_PATH, draw_glyphs

    with np.load(ATLAS_PATH) as f:
        bundled, drawn_by = f["glyphs"], str(f["pillow_version"])
    if importlib.util.find_spec("PIL") is None:
        return f"no Pillow here; the bundled atlas was drawn by Pillow {drawn_by}"
    return (f"Pillow {importlib.metadata.version('pillow')} here draws the bundled atlas "
            f"(Pillow {drawn_by}'s): {bool(np.array_equal(draw_glyphs(), bundled))}")


def caption_pipelines(grade):
    """Phase 4m: the captioning path at full width on the card: the spoken
    sentence and CAP_FRAMES seeded 1080p RGBA frames (graded by hsvfilter and
    colorlut approx) through caption_pipeline.  The counters of T1, B4 and B2
    are set to 0 just before the run and read just after.  Checks: the
    caption pairs decode to both words; the overlaid frames differ from the
    graded ones, only inside the overlay's caption boxes; the files hold an
    uncv 1920x1080 track and an fpcm 16 kHz track, one sample a frame and a
    buffer with their decode times and durations, and each video sample is
    the overlay's output frame; every payload lies on cuda:0 up to the
    muxers; the device-to-host copies (torch.profiler) are one a frame and
    one an audio buffer at the muxers beyond the graded chain's and the
    transcriber's own, each read on its own.  Returns the launches."""
    phase("4m live captioning recorded to fragmented MP4, on the card")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.ops import asr_gru, hsv_planes
    from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank

    card0 = torch.device("cuda", 0)
    frames = fuse_frames(CAP_FRAMES, seed=CAP_SEED)
    audio = torch.from_numpy(caption_audio()).to(card0)
    n_audio = -(-audio.shape[0] // CAP_AUDIO_SPB)

    # the copies of the graded chain and of the transcriber, each on its own
    _, plain_dtoh = _profiled(lambda: rec_plain(frames, grade))

    def transcribe():
        p = g.parse_launch(f"appsrc name=src ! whispertranscriber chunk-duration={CAP_CHUNK_NS} "
                           f"! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            f"audio/x-raw,format=F32,rate={CAP_RATE},channels=1"))
        for i in range(0, audio.shape[0], CAP_AUDIO_SPB):
            p.by_name("src").push_buffer(g.Buffer(audio[i:i + CAP_AUDIO_SPB],
                                                  pts=i * 10**9 // CAP_RATE))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return [s.buffer.data for s in p.by_name("sink").samples]

    texts, asr_dtoh = _profiled(transcribe)

    def run():
        asr_gru.launches = hsv_planes.launches = lowrank.packed_launches = 0
        p = caption_run(caption_pipeline(g, audio, frames, grade))
        torch.cuda.synchronize()
        return p, {"asr_gru": asr_gru.launches, "hsv_planes": hsv_planes.launches,
                   "colorlut_lowrank_packed": lowrank.packed_launches}

    (p, counted), path_dtoh = _profiled(run)
    # outside the profiled run: the frames, the overlay's boxes and the files
    out = caption_outputs(p)
    text = caption_text(out["pairs"])
    graded, overlaid = out["graded"], out["overlaid"]
    on_card = all(isinstance(b.data, torch.Tensor) and b.data.device == card0
                  for b in graded + overlaid + out["audio_in"])
    changed, outside = caption_changes(p, graded, overlaid)
    first = changed.index(True) if True in changed else None
    vtrack, vsamples, vfrags = check_caption_file(
        out["video"], "uncv", [1000] * len(overlaid), CAP_FPS * 1000)
    atrack, asamples, afrags = check_caption_file(
        out["audio"], "fpcm", [b.data.shape[0] for b in out["audio_in"]], CAP_RATE)
    same_frames = len(vsamples) == CAP_FRAMES and all(
        s == b.data.cpu().numpy().tobytes() for s, b in zip(vsamples, overlaid))
    same_audio = len(asamples) == n_audio and all(
        s == b.data.cpu().numpy().tobytes() for s, b in zip(asamples, out["audio_in"]))
    print(f"captions: {len(out['pairs'])} 608 pairs on {sum(1 for b in graded if b.metas)} "
          f"frames, text {text!r}; the transcriber alone: {texts!r}; {atlas_on_this_host()}")
    print(f"video {CAP_FRAMES} x {HD_W}x{HD_H} RGBA: overlaid from frame {first}, "
          f"{sum(changed)} frames changed; file {len(out['video'])} B, {vfrags} fragments, "
          f"{vtrack.sample_entry_type} {vtrack.width}x{vtrack.height}, samples equal to the "
          f"overlay's frames: {same_frames}; audio {n_audio} buffers: file {len(out['audio'])} B, "
          f"{afrags} fragments, {atrack.sample_entry_type} {atrack.timescale} Hz, samples equal: "
          f"{same_audio}; payloads on {card0} up to the muxers: {on_card}; launches {counted}")
    print(f"Memcpy DtoH: the path {path_dtoh}; the graded chain alone {plain_dtoh}, the "
          f"transcriber alone {asr_dtoh}, the muxers' one a frame and a buffer "
          f"{CAP_FRAMES + n_audio}")
    if not all(w in text for w in CAP_WORDS):
        raise AssertionError(f"the captions {text!r} lack a spoken word")
    if not on_card or len(graded) != CAP_FRAMES or len(out["audio_in"]) != n_audio:
        raise AssertionError("a payload left the card before the muxers, or went missing")
    if first is None or not all(changed[first:]) or outside:
        raise AssertionError(f"the overlay changed frames {changed}, {outside} pixels "
                             f"outside its caption boxes")
    if (vtrack.width, vtrack.height) != (HD_W, HD_H) or not same_frames or not same_audio:
        raise AssertionError("the files' samples differ from the muxers' input")
    if path_dtoh != plain_dtoh + asr_dtoh + CAP_FRAMES + n_audio:
        raise AssertionError("not one read-back a payload at the muxers")
    chunks = -(-audio.shape[0] * 10**9 // (CAP_CHUNK_NS * CAP_RATE))
    if counted["asr_gru"] != 2 * chunks or counted["hsv_planes"] != CAP_FRAMES \
            or counted["colorlut_lowrank_packed"] != CAP_FRAMES:
        raise AssertionError(f"T1 / B4 / B2 launches {counted}")
    return counted


def caption_card_vs_cpu(grade):
    """Phase 5m: the captioning path at CAP_CPU_FRAMES frames on the card
    (kernels) and on the CPU (plain versions): the caption pairs and their
    text equal, both files equal byte for byte outside their mdat payloads,
    the video samples within LSB_TOL, the audio samples bit-equal."""
    phase("5m captioning path, card against CPU")
    import gst_plugins_rs_tpu_torch as g

    frames = fuse_frames(CAP_CPU_FRAMES, seed=CAP_SEED + 1)
    audio = torch.from_numpy(caption_audio())
    runs = {}
    for dev in ("cuda", "cpu"):
        g.set_device(dev)
        try:
            runs[dev] = caption_outputs(caption_run(caption_pipeline(
                g, audio.to(dev), [f.to(dev) for f in frames], grade)))
        finally:
            g.set_device("cuda")
    c, h = runs["cuda"], runs["cpu"]

    def samples(out, kind):
        data = out["video" if kind == "uncv" else "audio"]
        ins = out["overlaid" if kind == "uncv" else "audio_in"]
        durs = [1000] * len(ins) if kind == "uncv" else [b.data.shape[0] for b in ins]
        return check_caption_file(data, kind, durs, CAP_FPS * 1000 if kind == "uncv"
                                  else CAP_RATE)[1]

    vc, vh = samples(c, "uncv"), samples(h, "uncv")
    d_px = max(_lsb(np.frombuffer(a, np.uint8), np.frombuffer(b, np.uint8))
               for a, b in zip(vc, vh))
    same = {"pairs": c["pairs"] == h["pairs"],
            "video boxes": mp4_skeleton(c["video"]) == mp4_skeleton(h["video"]),
            "audio file": c["audio"] == h["audio"],
            "samples": len(vc) == len(vh) == CAP_CPU_FRAMES}
    text = caption_text(c["pairs"])
    print(f"{CAP_CPU_FRAMES} frames {HD_W}x{HD_H}: caption text {text!r} / "
          f"{caption_text(h['pairs'])!r}, equal {same}; video samples max {d_px} LSB "
          f"(gate {LSB_TOL})")
    if not all(same.values()) or d_px > LSB_TOL or not all(w in text for w in CAP_WORDS):
        raise AssertionError("the captioning path: card and CPU disagree")


def caption_timing(card_line, grade):
    """Phase 6m: frames per second of 4m's captioning path against the same
    graded chain into an appsink (appsrc ! hsvfilter ! colorlut ! appsink),
    the median of CAP_TIMING_REPEATS runs of CAP_FRAMES frames, each timed on
    the host clock to torch.cuda.synchronize over the streaming (colorlut's
    fit in its start stays outside); the host ms a frame that transcriberbin,
    cea608overlay and the two cmafmux add; device busy ms and ops a frame
    over one more run (torch.profiler), the busy share of the median wall,
    and the muxers' device-to-host copies: their device ms and MB/s."""
    phase("6m captioning path timing")
    import gst_plugins_rs_tpu_torch as g

    frames = fuse_frames(CAP_FRAMES, seed=CAP_SEED + 2)
    audio = torch.from_numpy(caption_audio()).cuda()
    paths = {"appsrc ! hsvfilter ! colorlut ! appsink": lambda around: rec_plain(
                 frames, grade, around=around),
             "the captioned recording (4m)": lambda around: caption_run(
                 caption_pipeline(g, audio, frames, grade), around=around)}
    rows = {}
    for label, run in paths.items():
        walls = []

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        for _ in range(CAP_TIMING_REPEATS):
            run(timed)
        _, dev = device_events(run, around=True)
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        ops = sum(e.count for e in dev)
        dtoh = [e for e in dev if e.key.startswith("Memcpy DtoH")]
        dtoh_ms = sum(e.self_device_time_total for e in dtoh) / 1e3
        wall = statistics.median(walls)
        rows[label] = dict(fps=CAP_FRAMES / wall, wall=wall, busy=busy, dtoh_ms=dtoh_ms,
                           dtoh=sum(e.count for e in dtoh))
        print(f"{label}, {HD_W}x{HD_H}, {CAP_FRAMES} frames: {CAP_FRAMES / wall:.2f} frames/s "
              f"(median of {[round(CAP_FRAMES / w, 2) for w in walls]}); device busy "
              f"{busy / CAP_FRAMES:.4f} ms and {ops / CAP_FRAMES:.1f} ops a frame, "
              f"{100 * busy / 1e3 / wall:.1f}% of the median wall; Memcpy DtoH "
              f"{rows[label]['dtoh']} taking {dtoh_ms:.3f} device ms [{card_line}]")
    plain, cap = rows.values()
    read_back = CAP_FRAMES * HD_H * HD_W * 4 + audio.numel() * 4
    mux_ms = cap["dtoh_ms"] - plain["dtoh_ms"]
    print(f"transcriberbin, cea608overlay and the two cmafmux add "
          f"{(cap['wall'] - plain['wall']) / CAP_FRAMES * 1e3:.3f} host ms a frame; frames/s "
          f"captioned / plain {cap['fps'] / plain['fps']:.3f}; the muxers read back "
          f"{read_back / 1e6:.1f} MB in {mux_ms:.3f} device ms of copies "
          f"({read_back / 1e6 / (mux_ms / 1e3):.0f} MB/s on the card's copy engine, "
          f"{read_back / 1e6 / cap['wall']:.0f} MB/s of the median wall) [{card_line}]")
    return rows


# ROADMAP C.1: YOLOX-x precision=bf16, the engine's stages card against CPU.
# The stages read: stem and dark2 (the s2d stage), dark3-dark5, the FPN and
# PAN convs and C3s, each level's head stem and last cls / reg convs, and
# the scores.
C1_STAGES = ("stem+dark2", "backbone.backbone.dark3", "backbone.backbone.dark4",
             "backbone.backbone.dark5", "backbone.lateral_conv0", "backbone.c3_p4",
             "backbone.reduce_conv1", "backbone.c3_p3", "backbone.bu_conv2", "backbone.c3_n3",
             "backbone.bu_conv1", "backbone.c3_n4") + tuple(
    f"head.{k}_{i}{c}" for i in range(3)
    for k, c in (("stems", ""), ("cls_convs", ".conv1"), ("reg_convs", ".conv1"))) + ("scores",)
C1_DRIFT_RATIO = 2.0  # a stage where the card's bf16 drift outgrows the CPU's by more is a fault
# The whole-net gate of YOLOX-x bf16 on the card, scores card against CPU
# (both bf16), fixed from this phase's reading on an NVIDIA H100 80GB HBM3
# at 700 W (max 0.2402, mean 2.663e-3; PERF.md section 6): 1.25x and 1.5x
# above it.  The two planted faults read 0.2695 / 6.785e-3 (dark3's conv
# x1.1) and 0.9958 / 2.486e-2 (c3_p3's conv3, two output channels swapped);
# head.cls_convs_1.conv1 x1.1 (0.2402 / 4.020e-3) lies within 1.51x of the
# rounding and is not planted here.
C1_CARD_MAX_GATE = 0.30
C1_CARD_MEAN_GATE = 4e-3
C1_PLANTED = (("backbone.backbone.dark3.conv", "scale"), ("backbone.c3_p3.conv3", "swap"))


def yolox_stages(engine, x):
    """{stage: output as float32 on the CPU} of one engine forward on x:
    each stage of C1_STAGES, read by wrapping the engine's stage methods."""
    got = {}
    stages = set(C1_STAGES)

    def keep(name, out):
        if name in stages:
            got[name] = out.float().cpu()
        return out

    base, block, neck, stem = (engine._base, engine._csp_block, engine._csp_bottleneck,
                               engine._stem_dark2_s2d)
    engine._base = lambda prefix, *a, **k: keep(prefix, base(prefix, *a, **k))
    engine._csp_block = lambda prefix, *a, **k: keep(prefix, block(prefix, *a, **k))
    engine._csp_bottleneck = lambda prefix, *a, **k: keep(prefix, neck(prefix, *a, **k))
    engine._stem_dark2_s2d = lambda y: keep("stem+dark2", stem(y))
    try:
        got["scores"] = engine(x)[..., 4:].float().cpu()
    finally:
        for name in ("_base", "_csp_block", "_csp_bottleneck", "_stem_dark2_s2d"):
            delattr(engine, name)
    return got


def yolox_x_bf16_stages(card_line):
    """Phase 5k': YOLOX-x with precision=bf16 (FastEngine dtype=bfloat16),
    stage by stage: one init_weights(seed=0) tree, one seeded C1_SIZE frame,
    f32 and bf16 on the card and on the CPU.  Per stage: the card against the
    CPU (max |d| / max |ref|) in each dtype, and each device's own bf16
    drift from its f32.  A stage where the card's drift outgrows the CPU's
    by more than C1_DRIFT_RATIO fails the phase.  Then the whole-net gate:
    the card's bf16 scores against the CPU's within C1_CARD_MAX_GATE (max)
    and C1_CARD_MEAN_GATE (mean), and each fault of C1_PLANTED, planted in
    one layer of the card's weights (10% high, or two output channels
    swapped), must break one of them.  Returns the stage rows."""
    phase("5k' YOLOX-x precision=bf16 stage by stage, card against CPU (ROADMAP C.1)")
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
    from gst_plugins_rs_tpu_torch.models.yolox_fast import FastEngine

    model = init_weights(Yolox.from_variant("x"), seed=0).eval()
    state = model.state_dict()
    card_state = {k: v.cuda() for k, v in state.items()}
    x = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (1, C1_SIZE, C1_SIZE, 3))
                         .astype(np.uint8))
    reads, engines = {}, {}
    for dev, st in (("cpu", state), ("cuda", card_state)):
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            engines[dev, name] = FastEngine(model, st, dtype=dtype, fuse_c3=dev == "cuda",
                                            device=dev)
            reads[dev, name] = yolox_stages(engines[dev, name], x.to(dev))
    torch.cuda.synchronize()

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    rows, faults = [], []
    print(f"{'stage':32s} {'card-CPU f32':>12s} {'card-CPU bf16':>13s} {'CPU drift':>10s} "
          f"{'card drift':>10s} {'ratio':>6s}")
    for stage in C1_STAGES:
        r = dict(stage=stage,
                 f32=gap(reads["cuda", "f32"][stage], reads["cpu", "f32"][stage]),
                 bf16=gap(reads["cuda", "bf16"][stage], reads["cpu", "bf16"][stage]),
                 cpu_drift=gap(reads["cpu", "bf16"][stage], reads["cpu", "f32"][stage]),
                 card_drift=gap(reads["cuda", "bf16"][stage], reads["cuda", "f32"][stage]))
        r["ratio"] = r["card_drift"] / max(r["cpu_drift"], 1e-30)
        rows.append(r)
        if r["ratio"] > C1_DRIFT_RATIO:
            faults.append(stage)
        print(f"{stage:32s} {r['f32']:12.3e} {r['bf16']:13.3e} {r['cpu_drift']:10.3e} "
              f"{r['card_drift']:10.3e} {r['ratio']:6.2f}")
    sc, sh = reads["cuda", "bf16"]["scores"], reads["cpu", "bf16"]["scores"]
    d = (sc - sh).abs()
    whole = (float(d.max()), float(d.mean()))
    own = {dev: float((reads[dev, "bf16"]["scores"] - reads[dev, "f32"]["scores"]).abs().max())
           for dev in ("cpu", "cuda")}
    print(f"YOLOX-x {C1_SIZE}x{C1_SIZE} precision=bf16 scores, card against CPU: max "
          f"{whole[0]:.4f}, mean {whole[1]:.3e} (gates {C1_CARD_MAX_GATE}, {C1_CARD_MEAN_GATE}); "
          f"bf16 against f32: CPU {own['cpu']:.4f}, card {own['cuda']:.4f} [{card_line}]")
    planted, engine = {}, engines["cuda", "bf16"]
    for layer, fault in C1_PLANTED:  # as tests/test_torch_yolox_bf16.py plants them
        W, bias = engine.convs[layer]
        swap = [1, 0] + list(range(2, W.shape[0]))
        engine.convs[layer] = (W * 1.1 if fault == "scale" else W[swap], bias)
        got = engine(x.cuda())[..., 4:].float().cpu()
        engine.convs[layer] = (W, bias)
        e = (got - sh).abs()
        planted[f"{layer} {fault}"] = (float(e.max()), float(e.mean()))
    caught = {k: v[0] > C1_CARD_MAX_GATE or v[1] > C1_CARD_MEAN_GATE for k, v in planted.items()}
    print("planted one-layer faults, scores against the CPU's bf16 (max, mean): "
          + "; ".join(f"{k} {v[0]:.4f}, {v[1]:.3e} caught {caught[k]}" for k, v in planted.items()))
    if faults:
        raise AssertionError(f"YOLOX-x bf16: the card's drift outgrows the CPU's at {faults}")
    if whole[0] > C1_CARD_MAX_GATE or whole[1] > C1_CARD_MEAN_GATE or not all(caught.values()):
        raise AssertionError("YOLOX-x bf16 on the card: the whole-net gate fails, or a planted "
                             "fault passes it")
    return rows


# ---------------------------------------------------------------------------
# The ONVIF camera: YOLOX detections published as ONVIF Profile M metadata
# over RTP, beside a G.711 audio track (phases 4n/5n/6n)
# ---------------------------------------------------------------------------
ONVIF_FRAMES = 60            # seeded 640x640 RGB frames at 30/1 (4n)
ONVIF_CPU_FRAMES = 3         # card against CPU (5n)
ONVIF_FPS = 30
ONVIF_SEED = 41
ONVIF_TIMING_REPEATS = 3     # 6n: the median of these
# yoloxtensordec's box and class thresholds.  On these seeded 640x640 frames
# YOLOX-tiny's random-init weights (init_weights(seed=0)) score objectness
# 0.024 at the median and 0.14 at most, classes 0.33 and 0.88, so the
# element's 0.4 defaults find nothing, and 0.02 / 0.3 pass ~4,000 candidates
# a frame, which the decoder cuts to its top 400 and then to 100 detections
# (166 host ms a frame on an H100's host, most of it, by the code, the
# decoder's Python NMS); 0.06 / 0.5 pass 15-38 candidates a frame (median
# 24), the few tens of objects of a busy scene
ONVIF_THRESHOLDS = (0.06, 0.5)
# fixed RTP identities so that packets compare byte for byte between runs
ONVIF_META_RTP = "ssrc=3735928559 timestamp-offset=0 seqnum-offset=0"
ONVIF_AUDIO_RTP = "ssrc=305419896 timestamp-offset=0 seqnum-offset=0 max-ptime=20000000"
ONVIF_AUDIO_RATE = 8000
ONVIF_AUDIO_SPB = 160        # 20 ms of S16 mono, one PCMU packet a buffer
ONVIF_AUDIO_BUFFERS = 60
ONVIF_GREEN = (0, 255, 0)    # onvifmetadataoverlay's box colour on RGB
ONVIF_THICKNESS = 2          # ... and its default edge width
# the elements that receive the video frames, on their sink pads (the
# metadata branch carries XML and packets, host data by design)
ONVIF_VIDEO_PADS = {"det": "sink", "dec": "sink", "toxml": "sink", "ext": "sink",
                    "mq": "sink", "comb": "media", "torel": "sink", "overlay": "sink",
                    "sink": "sink"}


def onvif_frames(n, size=SIZE, seed=ONVIF_SEED):
    """n seeded RGB u8 frames [size, size, 3] on the host (numpy), each
    unlike the others."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8) for _ in range(n)]


def onvif_audio(n=ONVIF_AUDIO_BUFFERS, seed=ONVIF_SEED):
    """n seeded buffers of ONVIF_AUDIO_SPB S16 mono samples [spb, 1] on the
    host: a sine with noise over the whole 16-bit range."""
    rng = np.random.default_rng(seed + 1)
    t = np.arange(n * ONVIF_AUDIO_SPB) / ONVIF_AUDIO_RATE
    x = 20000 * np.sin(2 * np.pi * 440 * t) + rng.normal(0, 3000, t.shape)
    x = np.clip(np.round(x), -32768, 32767).astype(np.int16).reshape(n, ONVIF_AUDIO_SPB, 1)
    return list(x)


class OnvifTap:
    """Pipeline tracer of the ONVIF paths (a tracer sees each buffer as a
    sink pad receives it): in push order, the XML frames into the metadata
    payloader, the RTP packets into the sessions (pay -> send, apay ->
    asend), the RTCP packets each session's other half receives, the XML
    frames that reach the combiner's meta pad, and where each video payload
    lies as the pads of ONVIF_VIDEO_PADS receive it."""

    def __init__(self):
        self.xml, self.rtp, self.audio_rtp, self.rtcp = [], [], [], []
        self.meta, self.video = [], []

    def on_buffer(self, element, pad, buffer):
        name, d = element.name, buffer.data
        if name == "pay":
            self.xml.append(d)
        elif name == "send" and pad.name.startswith("rtp_sink"):
            self.rtp.append(np.asarray(d).tobytes())
        elif name == "asend" and pad.name.startswith("rtp_sink"):
            self.audio_rtp.append(np.asarray(d).tobytes())
        elif pad.name.startswith("rtcp_sink"):
            self.rtcp.append((name, np.asarray(d).tobytes()))
        elif name == "comb" and pad.name == "meta":
            self.meta.append(d)
        elif ONVIF_VIDEO_PADS.get(name) == pad.name:
            self.video.append((name, str(d.device) if isinstance(d, torch.Tensor)
                               else type(d).__name__))


def _rtp_session(g, p, send, rtp_id, downstream):
    """rtpsend `send` (already in p, its rtp_sink_0 linked) -> a new rtprecv
    with RTCP looped both ways (SR to the receiver, RR back) -> `downstream`."""
    recv = g.element_factory_make("rtprecv", f"{send.name}_recv")
    recv.set_property("rtp-id", rtp_id)
    p.add(recv)
    send.pad("rtp_src_0").link(recv.request_sink_pad())
    send.pad("rtcp_src_0").link(recv.pad("rtcp_sink_0"))
    recv.pad("rtcp_src_0").link(send.pad("rtcp_sink_0"))
    recv.link(downstream)
    return recv


def onvif_pipeline(g, detect="yoloxinference name=det engine=fast",
                   thresholds=ONVIF_THRESHOLDS, size=SIZE):
    """The ONVIF camera's video graph in package `g` (the port; the CPU
    tests also build it in the JAX package): appsrc ! [detect !
    yoloxtensordec !] relationmeta2onvifmeta (UtcTime from the running time)
    ! onvifmetadataextractor remove-onvif-metadata=true, whose meta_src goes
    onvifmetadatapay ! rtpsend ! rtprecv ! onvifmetadatadepay !
    onvifmetadataparse into the combiner's meta pad, and whose src goes
    through a queue into its media pad; onvifmetadatacombiner !
    onvifmeta2relationmeta ! onvifmetadataoverlay ! appsink.  detect=None
    leaves the detector out: the buffers then carry their relation metas
    from the appsrc.  Returns (pipeline, OnvifTap)."""
    head = ""
    if detect:
        box, cls = thresholds
        head = (f"{detect} ! yoloxtensordec name=dec box-confidence-threshold={box} "
                f"class-confidence-threshold={cls} ! ")
    p = g.parse_launch(
        f"appsrc name=src ! {head}relationmeta2onvifmeta name=toxml time-source=running-time "
        f"! onvifmetadataextractor name=ext remove-onvif-metadata=true ! queue name=mq "
        f"onvifmetadatacombiner name=comb ! onvifmeta2relationmeta name=torel "
        f"! onvifmetadataoverlay name=overlay ! appsink name=sink "
        f"onvifmetadatapay name=pay {ONVIF_META_RTP} ! rtpsend name=send rtp-id=onvif-meta")
    p.by_name("src").set_property("caps", g.parse_caps(
        f"video/x-raw,format=RGB,width={size},height={size},framerate={ONVIF_FPS}/1"))
    depay = g.element_factory_make("onvifmetadatadepay", "depay")
    parse = g.element_factory_make("onvifmetadataparse", "parse")
    p.add(depay)
    p.add(parse)
    p.by_name("ext").pad("meta_src").link(p.by_name("pay").pad("sink"))
    p.by_name("mq").pad("src").link(p.by_name("comb").pad("media"))
    _rtp_session(g, p, p.by_name("send"), "onvif-meta", depay)
    depay.link(parse)
    parse.pad("src").link(p.by_name("comb").pad("meta"))
    tap = OnvifTap()
    p.add_tracer(tap)
    return p, tap


def onvif_run(g, p, frames, metas=None, around=None):
    """Push `frames` (tensors or host arrays, at 30/1, no duration: the
    combiner then attaches to a frame only the metadata of its own time),
    each with a copy of metas[i] if given, and play to the appsink's EOS;
    `around`, if given, is called with the streaming.  Returns the appsink's
    buffers."""
    State = g.core.State
    src = p.by_name("src")
    for i, f in enumerate(frames):
        buf = g.Buffer(f, pts=i * 10**9 // ONVIF_FPS)
        if metas is not None:
            buf.add_meta(copy.deepcopy(metas[i]))
        src.push_buffer(buf)
    src.end_of_stream()
    p.set_state(State.PLAYING)
    sink = p.by_name("sink")

    def stream():
        p.run()
        _wait_eos(sink)

    try:
        (around or (lambda fn: fn()))(stream)
    finally:
        p.set_state(State.NULL)
    return [s.buffer for s in sink.samples]


def onvif_plain_run(g, frames, around=None):
    """The plain YOLOX stream the ONVIF camera is held to: `frames` at 30/1
    through appsrc ! yoloxinference engine=fast ! yoloxtensordec (at
    ONVIF_THRESHOLDS) ! appsink; `around`, if given, is called with the
    streaming.  Returns the appsink's buffers."""
    box, cls = ONVIF_THRESHOLDS
    p = g.parse_launch(f"appsrc name=src ! yoloxinference engine=fast ! yoloxtensordec "
                       f"box-confidence-threshold={box} class-confidence-threshold={cls} "
                       f"! appsink name=sink")
    p.by_name("src").set_property("caps", g.parse_caps(
        f"video/x-raw,format=RGB,width={SIZE},height={SIZE},framerate={ONVIF_FPS}/1"))
    for i, f in enumerate(frames):
        p.by_name("src").push_buffer(g.Buffer(f, pts=i * 10**9 // ONVIF_FPS))
    p.by_name("src").end_of_stream()
    p.set_state(g.core.State.PLAYING)
    try:
        (around or (lambda fn: fn()))(p.run)
    finally:
        p.set_state(g.core.State.NULL)
    return [s.buffer for s in p.by_name("sink").samples]


def pcmu_pipeline(g):
    """The camera's audio in package `g`: appsrc (S16 8 kHz mono) ! mulawenc
    ! rtppcmupay2 ! rtpsend ! rtprecv ! rtppcmudepay2 ! mulawdec ! appsink.
    Returns (pipeline, OnvifTap)."""
    p = g.parse_launch(f"appsrc name=asrc ! mulawenc ! rtppcmupay2 name=apay "
                       f"{ONVIF_AUDIO_RTP} ! rtpsend name=asend rtp-id=onvif-audio")
    p.by_name("asrc").set_property("caps", g.parse_caps(
        f"audio/x-raw,format=S16,rate={ONVIF_AUDIO_RATE},channels=1,layout=interleaved"))
    depay = g.element_factory_make("rtppcmudepay2", "adepay")
    dec = g.element_factory_make("mulawdec", "adec")
    sink = g.element_factory_make("appsink", "asink")
    for e in (depay, dec, sink):
        p.add(e)
    _rtp_session(g, p, p.by_name("asend"), "onvif-audio", depay)
    depay.link(dec)
    dec.link(sink)
    tap = OnvifTap()
    p.add_tracer(tap)
    return p, tap


def pcmu_run(g, p, audio, around=None):
    """Push the audio buffers (20 ms each) and play to EOS; `around`, if
    given, is called with the streaming.  Returns the appsink's buffers."""
    State = g.core.State
    src = p.by_name("asrc")
    dur = ONVIF_AUDIO_SPB * 10**9 // ONVIF_AUDIO_RATE
    for i, a in enumerate(audio):
        src.push_buffer(g.Buffer(a, pts=i * dur, duration=dur))
    src.end_of_stream()
    p.set_state(State.PLAYING)
    try:
        (around or (lambda fn: fn()))(p.run)
    finally:
        p.set_state(State.NULL)
    return [s.buffer for s in p.by_name("asink").samples]


def onvif_detections(g, buf):
    """(yoloxtensordec's detections, the detections the XML carried back)
    of a sink buffer: [(label, x, y, w, h, likelihood)] each, in order."""
    rels = list(buf.iter_meta(g.elements.analytics.meta.AnalyticsRelationMeta))
    rows = [[(o.object_type, o.x, o.y, o.w, o.h, o.loc_conf_lvl) for o in r.od] for r in rels]
    if len(rows) != 2:
        raise AssertionError(f"expected the decoder's and the XML's relation metas, got "
                             f"{len(rows)}")
    return rows[0], rows[1]


def onvif_xml_frames(g, buf):
    """The XML frames the combiner attached to a sink buffer."""
    return [x for m in buf.iter_meta(g.elements.analytics.onvif.OnvifXMLFrameMeta)
            for x in m.frames]


def onvif_overlay_expected(frame, boxes, thickness=ONVIF_THICKNESS):
    """The plain overlay: `frame` (a tensor) with the edges of `boxes`
    [(x, y, w, h)] set to ONVIF_GREEN, on the frame's device."""
    h, w = frame.shape[:2]
    edges = torch.zeros((h, w), dtype=torch.bool, device=frame.device)
    t = thickness
    for x, y, bw, bh in boxes:
        x0, y0, x1, y1 = max(x, 0), max(y, 0), min(x + bw, w), min(y + bh, h)
        if x1 <= x0 or y1 <= y0:
            continue
        edges[y0:y0 + t, x0:x1] = True
        edges[max(y1 - t, 0):y1, x0:x1] = True
        edges[y0:y1, x0:x0 + t] = True
        edges[y0:y1, max(x1 - t, 0):x1] = True
    out = frame.clone()
    out[edges] = torch.tensor(ONVIF_GREEN, dtype=frame.dtype, device=frame.device)
    return out, edges


def _detections_within_gates(ref, got):
    """YOLOX's parity gates on two frames' detections, as sets: labels
    equal, boxes within 1 px, likelihoods within 1e-3."""
    ref, got = sorted(ref), sorted(got)
    return len(ref) == len(got) and all(
        r[0] == s[0] and all(abs(a - b) <= 1 for a, b in zip(r[1:5], s[1:5]))
        and abs(r[5] - s[5]) < 1e-3 for r, s in zip(ref, got))


def onvif_pipelines():
    """Phase 4n: the ONVIF camera at full width on the card: ONVIF_FRAMES
    seeded 640x640 frames on cuda:0 through onvif_pipeline (YOLOX-tiny,
    engine=fast, f32) and ONVIF_AUDIO_BUFFERS seeded 20 ms buffers through
    pcmu_pipeline.  yolox_c3's count is set to 0 just before the video run
    and read just after.  Checks: every frame has boxes, and the XML that
    came back over RTP carries exactly yoloxtensordec's detections of that
    frame; every video payload lies on cuda:0 up to the appsink; the overlay
    changed exactly the box edges, to green; B1's launches equal the
    forwards; the device-to-host copies (torch.profiler) of the ONVIF path
    equal those of appsrc ! yoloxinference ! yoloxtensordec ! appsink on the
    same frames; the audio's are one a buffer; the decoded audio equals the
    plain G.711 round trip bit for bit.  Returns B1's launches."""
    phase("4n the ONVIF camera on the card: YOLOX detections as ONVIF metadata over RTP, "
          "G.711 audio")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import AnalyticsRelationMeta
    from gst_plugins_rs_tpu_torch.elements.analytics.onvif import _utc_of
    from gst_plugins_rs_tpu_torch.ops import g711, yolox_c3

    card0 = torch.device("cuda", 0)
    frames = [torch.from_numpy(f).to(card0) for f in onvif_frames(ONVIF_FRAMES)]
    audio = [torch.from_numpy(a).to(card0) for a in onvif_audio()]
    box_thr, cls_thr = ONVIF_THRESHOLDS
    print(f"yoloxtensordec box-confidence-threshold={box_thr} "
          f"class-confidence-threshold={cls_thr}")

    plain_out, plain_dtoh = _profiled(lambda: onvif_plain_run(g, frames))

    def run():
        yolox_c3.launches = 0
        p, tap = onvif_pipeline(g)
        out = onvif_run(g, p, frames)
        torch.cuda.synchronize()
        return out, tap, yolox_c3.launches

    (out, tap, launches), path_dtoh = _profiled(run)
    forwards = _check_outputs([SimpleNamespace(buffer=b) for b in out], ONVIF_FRAMES)
    boxes_per_frame, carried, one_xml = [], True, True
    for i, buf in enumerate(out):
        dec, back = onvif_detections(g, buf)
        xml = onvif_xml_frames(g, buf)
        utc = _utc_of(i * 10**9 // ONVIF_FPS)
        one_xml &= len(xml) == 1 and f'UtcTime="{utc}"' in xml[0]
        carried &= dec == back
        boxes_per_frame.append(len(dec))
    on_card = all(d == str(card0) for _, d in tap.video) and all(
        isinstance(b.data, torch.Tensor) and b.data.device == card0 for b in out)
    overlay_ok = True
    for f, buf in zip(frames, out):
        expected, _ = onvif_overlay_expected(f, [d[1:5] for d in onvif_detections(g, buf)[0]])
        overlay_ok &= torch.equal(buf.data, expected)
    same_as_plain = all(onvif_detections(g, b)[0] == [
        (o.object_type, o.x, o.y, o.w, o.h, o.loc_conf_lvl)
        for o in pb.get_meta(AnalyticsRelationMeta).od]
        for b, pb in zip(out, plain_out))
    sr = sum(1 for n, _ in tap.rtcp if n == "send")
    rr = sum(1 for n, _ in tap.rtcp if n == "send_recv")
    print(f"video {ONVIF_FRAMES} x {SIZE}x{SIZE} RGB: boxes a frame {min(boxes_per_frame)}-"
          f"{max(boxes_per_frame)} (total {sum(boxes_per_frame)}); XML frames {len(tap.xml)}, "
          f"RTP packets {len(tap.rtp)}, RTCP SR {sr} / RR {rr}; one XML frame a buffer at its "
          f"own UtcTime: {one_xml}; the XML carried the decoder's detections: {carried}; the "
          f"same detections as the plain path: {same_as_plain}; payloads on {card0} up to the "
          f"appsink: {on_card} ({len(tap.video)} pushes); overlay = the box edges in green: "
          f"{overlay_ok}; {forwards} forwards, yolox_c3 launches {launches}")
    print(f"Memcpy DtoH: the ONVIF path {path_dtoh}, appsrc ! yoloxinference ! yoloxtensordec "
          f"! appsink {plain_dtoh}")
    if min(boxes_per_frame) < 1:
        raise AssertionError(f"a frame without boxes: {boxes_per_frame}")
    if not (one_xml and carried and same_as_plain):
        raise AssertionError("the XML over RTP does not carry each frame's detections")
    if not on_card or not overlay_ok:
        raise AssertionError("a frame left the card, or the overlay drew other than the edges")
    if len(tap.xml) != ONVIF_FRAMES or sr < 1:
        raise AssertionError(f"{len(tap.xml)} XML frames, {sr} sender reports")
    if launches != forwards or forwards != ONVIF_FRAMES:
        raise AssertionError("yolox_c3 launches != forward passes")
    if path_dtoh != plain_dtoh:
        raise AssertionError("the ONVIF stages read a frame back")

    def audio_run():
        p, atap = pcmu_pipeline(g)
        got = pcmu_run(g, p, audio)
        torch.cuda.synchronize()
        return got, atap

    (got, atap), audio_dtoh = _profiled(audio_run)
    decoded = torch.cat([b.data for b in got])
    ref = g711.mulaw_decode(g711.mulaw_encode(torch.cat(audio)))
    audio_on_card = all(b.data.device == card0 for b in got)
    print(f"audio {ONVIF_AUDIO_BUFFERS} x 20 ms S16 {ONVIF_AUDIO_RATE} Hz: {len(atap.audio_rtp)} "
          f"PCMU packets, {len(got)} decoded buffers on {card0}: {audio_on_card}, equal to the "
          f"plain G.711 round trip: {torch.equal(decoded, ref)}; Memcpy DtoH {audio_dtoh}")
    if not torch.equal(decoded, ref) or not audio_on_card:
        raise AssertionError("the PCMU loop's audio differs from the plain G.711 round trip")
    if audio_dtoh != ONVIF_AUDIO_BUFFERS or len(atap.audio_rtp) != ONVIF_AUDIO_BUFFERS:
        raise AssertionError("not one read-back and one packet an audio buffer")
    return launches


def onvif_card_vs_cpu():
    """Phase 5n: the ONVIF camera, card against CPU, on ONVIF_CPU_FRAMES
    frames: the whole graph's detections within YOLOX's gates (as sets) and
    its yolox-out within CPU_TOL; given the CPU run's relation metas on both
    devices, the ONVIF stages' XML frames, RTP packets and overlaid frames
    equal (0 LSB); the audio's RTP packets and decoded samples equal."""
    phase("5n the ONVIF camera, card against CPU")
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import AnalyticsRelationMeta

    frames = onvif_frames(ONVIF_CPU_FRAMES, seed=ONVIF_SEED + 1)
    audio = onvif_audio(seed=ONVIF_SEED + 1)
    runs, audio_runs = {}, {}
    for dev in ("cuda", "cpu"):
        g.set_device(dev)
        try:
            p, _ = onvif_pipeline(g)
            runs[dev] = onvif_run(g, p, [torch.from_numpy(f).to(dev) for f in frames])
        finally:
            g.set_device("cuda")
    gates = all(_detections_within_gates(onvif_detections(g, h)[0], onvif_detections(g, c)[0])
                for c, h in zip(runs["cuda"], runs["cpu"]))
    err = max(float(((_tensor_meta(c).data.cpu() - _tensor_meta(h).data).abs()
                     / (_tensor_meta(h).data.abs() + 1e-2)).max())
              for c, h in zip(runs["cuda"], runs["cpu"]))
    metas = [b.get_meta(AnalyticsRelationMeta) for b in runs["cpu"]]
    same = {}
    for dev in ("cuda", "cpu"):
        g.set_device(dev)
        try:
            p, tap = onvif_pipeline(g, detect=None)
            same[dev] = (onvif_run(g, p, [torch.from_numpy(f).to(dev) for f in frames], metas),
                         tap)
            p, atap = pcmu_pipeline(g)
            audio_runs[dev] = (pcmu_run(g, p, [torch.from_numpy(a).to(dev) for a in audio]), atap)
        finally:
            g.set_device("cuda")
    (c_out, c_tap), (h_out, h_tap) = same["cuda"], same["cpu"]
    d_px = max(_lsb(c.data.cpu().numpy(), h.data.numpy()) for c, h in zip(c_out, h_out))
    (c_aud, c_atap), (h_aud, h_atap) = audio_runs["cuda"], audio_runs["cpu"]
    equal = {"xml": c_tap.xml == h_tap.xml and len(c_tap.xml) == ONVIF_CPU_FRAMES,
             "rtp": c_tap.rtp == h_tap.rtp and len(c_tap.rtp) >= ONVIF_CPU_FRAMES,
             "frames": d_px == 0 and len(c_out) == len(h_out) == ONVIF_CPU_FRAMES,
             "audio rtp": c_atap.audio_rtp == h_atap.audio_rtp,
             "audio": torch.equal(torch.cat([b.data.cpu() for b in c_aud]),
                                  torch.cat([b.data for b in h_aud]))}
    print(f"{ONVIF_CPU_FRAMES} frames {SIZE}x{SIZE}: detections within the YOLOX gates: {gates} "
          f"({[len(onvif_detections(g, b)[0]) for b in runs['cuda']]} / "
          f"{[len(onvif_detections(g, b)[0]) for b in runs['cpu']]} boxes); yolox-out max rel "
          f"{err:.3e} (gate {CPU_TOL}); from the CPU run's relation metas: equal {equal}, "
          f"overlay max {d_px} LSB")
    if not gates or not err < CPU_TOL or not all(equal.values()):
        raise AssertionError("the ONVIF camera: card and CPU disagree")


def onvif_timing(card_line):
    """Phase 6n: frames per second of 4n's video path against the plain
    YOLOX single stream (appsrc ! yoloxinference ! yoloxtensordec ! appsink)
    on the same ONVIF_FRAMES frames, the median of ONVIF_TIMING_REPEATS runs
    each timed on the host clock from the streaming's start to the appsink's
    EOS and torch.cuda.synchronize; the host ms a frame the ONVIF stages add;
    device busy ms and ops a frame over one more run (torch.profiler) and
    the busy share of the median wall; the PCMU loop's buffers per second
    and host ms a buffer."""
    phase("6n the ONVIF camera, timing")
    import gst_plugins_rs_tpu_torch as g

    card0 = torch.device("cuda", 0)
    frames = [torch.from_numpy(f).to(card0)
              for f in onvif_frames(ONVIF_FRAMES, seed=ONVIF_SEED + 2)]
    audio = [torch.from_numpy(a).to(card0) for a in onvif_audio(seed=ONVIF_SEED + 2)]

    paths = {"appsrc ! yoloxinference ! yoloxtensordec ! appsink": lambda around: onvif_plain_run(
                 g, frames, around=around),
             "the ONVIF camera's video path (4n)": lambda around: onvif_run(
                 g, onvif_pipeline(g)[0], frames, around=around),
             "the PCMU loop (4n)": lambda around: pcmu_run(
                 g, pcmu_pipeline(g)[0], audio, around=around)}
    rows = {}
    for label, run in paths.items():
        walls = []

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)

        run(timed)  # warm-up: weights, cuDNN plans
        walls.clear()
        for _ in range(ONVIF_TIMING_REPEATS):
            run(timed)
        _, dev = device_events(run, around=True)
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        ops = sum(e.count for e in dev)
        wall = statistics.median(walls)
        n = ONVIF_AUDIO_BUFFERS if "PCMU" in label else ONVIF_FRAMES
        unit = "buffers" if "PCMU" in label else "frames"
        rows[label] = dict(rate=n / wall, wall=wall, busy=busy, ops=ops)
        print(f"{label}, {n} {unit}: {n / wall:.2f} {unit}/s (median of "
              f"{[round(n / w, 2) for w in walls]}), host {wall / n * 1e3:.3f} ms a "
              f"{unit[:-1]}; device busy {busy / n:.4f} ms and {ops / n:.1f} ops a "
              f"{unit[:-1]}, {100 * busy / 1e3 / wall:.1f}% of the median wall [{card_line}]")
    plain_row, onvif_row = (rows[k] for k in list(rows)[:2])
    print(f"the ONVIF stages add {(onvif_row['wall'] - plain_row['wall']) / ONVIF_FRAMES * 1e3:.3f}"
          f" host ms a frame; frames/s ONVIF / plain {onvif_row['rate'] / plain_row['rate']:.3f} "
          f"[{card_line}]")
    return rows


def main() -> int:
    card_line = card()
    sys.path.insert(0, str(ROOT))
    import gst_plugins_rs_tpu_torch as g

    g.set_device("cuda")
    build()
    cases = kernels(card_line)
    grade = write_grade()
    effect_cases, path_ops = effect_kernels(card_line, grade)
    launches = pipelines()
    effect_launches = effect_pipelines(grade, path_ops)
    for name, n in fuse_pipelines(grade).items():
        effect_launches[name] += n  # the fused chains' launches, graph replays included
    card_vs_cpu()
    effects_card_vs_cpu(grade)
    fuse_card_vs_cpu(grade)
    limiter_case = limiter_kernel(card_line)
    rnn_cases = rnnoise_kernel(card_line)
    rnn_bank_cases = rnnoise_bank_kernel(card_line)
    asr_case = asr_kernel(card_line)
    bank_case = bank_kernel(card_line)
    mesh_kernels(card_line)
    audio_launches = audio_pipelines()
    audio_launches.update(denoise_pipelines())
    audio_launches.update(rnnoise_bank_path(card_line))
    audio_card_vs_cpu()
    denoise_card_vs_cpu()
    rnnoise_bank_card_vs_cpu()
    compose_pipelines()
    demucs_pipelines()
    audio_launches.update(speech_pipeline())
    audio_launches.update(bank_pipelines())
    mesh_launches, _ = mesh_pipelines()
    rec_launches = rec_pipelines(grade)
    cap_launches = caption_pipelines(grade)
    onvif_launches = onvif_pipelines()
    compose_card_vs_cpu()
    demucs_card_vs_cpu()
    speech_card_vs_cpu()
    hand_pipelines(card_line)
    bank_card_vs_cpu()
    mesh_card_vs_cpu()
    yolox_x_bf16_stages(card_line)
    rec_card_vs_cpu(grade)
    caption_card_vs_cpu(grade)
    onvif_card_vs_cpu()
    timing(card_line)
    effects_timing(card_line, grade)
    fuse_timing(card_line, grade)
    audio_timing(card_line)
    denoise_timing(card_line)
    compose_timing(card_line)
    demucs_timing(card_line)
    speech_timing(card_line)
    bank_timing(card_line)
    mesh_timing(card_line)
    rec_timing(card_line, grade)
    caption_timing(card_line, grade)
    onvif_timing(card_line)
    # the sharded paths' launches (phase 4k) join their kernels' counts
    launches += mesh_launches["yolox_c3"]
    for name in ("loudnorm_limiter", "loudnorm_limiter_bank"):
        audio_launches[name] += mesh_launches[name]
    # and the recording path's (phase 4l)
    for name in ("hsv_planes", "colorlut_lowrank_packed"):
        effect_launches[name] += rec_launches[name]
    audio_launches["loudnorm_limiter"] += rec_launches["loudnorm_limiter"]
    # and the captioning path's (phase 4m)
    for name in ("hsv_planes", "colorlut_lowrank_packed"):
        effect_launches[name] += cap_launches[name]
    audio_launches["asr_gru"] += cap_launches["asr_gru"]
    # and the ONVIF camera's (phase 4n)
    launches += onvif_launches
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "library_ms")
    main_case = next(c for c in cases if c["dtype"] == "f32" and c["batch"] == 1)
    entries = [{
        "name": "yolox_c3",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/yolox_c3.cu",
        "replaces": "gst_plugins_rs_tpu/ops/pallas_yolox_c3.py:104",
        "launches": launches,
        **{k: main_case[k] for k in keys},
        "cases": cases,
    }]
    def effect_entry(name, source, replaces):
        kcases = effect_cases[name]
        return {
            "name": name,
            "route": "cuda",
            "source": f"gst_plugins_rs_tpu_torch/csrc/{source}",
            "replaces": f"gst_plugins_rs_tpu/ops/{replaces}",
            "launches": effect_launches[name],
            **{k: kcases[0][k] for k in keys},  # the first case is the path's shape
            "cases": kcases,
        }

    for name, source, replaces in (
            ("colorlut_lowrank_packed", "colorlut_lowrank.cu", "pallas_colorlut_lowrank.py:205"),
            ("colorlut_lowrank_fused", "colorlut_lowrank.cu", "pallas_colorlut_lowrank.py:63"),
            ("hsv_planes", "hsv_planes.cu", "pallas_hsv.py:78"),
            ("colorlut_mxu", "colorlut_mxu.cu", "pallas_colorlut.py:87")):
        entries.append(effect_entry(name, source, replaces))
    # packed64 is B3's chain on RGBA64 pixels: listed under B3's row
    b3 = next(e for e in entries if e["name"] == "colorlut_lowrank_fused")
    b3["entries"] = [effect_entry("colorlut_lowrank_packed64", "colorlut_lowrank.cu",
                                  "pallas_colorlut_lowrank.py:63")]
    # B5's packed entries (its chain on RGBA and RGBA64 pixels) under B5's row
    b5 = next(e for e in entries if e["name"] == "colorlut_mxu")
    b5["entries"] = [effect_entry(name, "colorlut_mxu.cu", "pallas_colorlut.py:87")
                     for name in ("colorlut_mxu_packed", "colorlut_mxu_packed64")]
    l1_bank = {
        "name": "loudnorm_limiter_bank",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/loudnorm_limiter.cu",
        "replaces": "gst_plugins_rs_tpu/ops/loudnorm.py:286",
        "launches": audio_launches["loudnorm_limiter_bank"],
        **{k: bank_case[k] for k in keys},
        "cases": [bank_case],
    }
    entries.append({
        "name": "loudnorm_limiter",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/loudnorm_limiter.cu",
        "replaces": "gst_plugins_rs_tpu/ops/loudnorm.py:175",
        "launches": audio_launches["loudnorm_limiter"],
        **{k: limiter_case[k] for k in keys},
        "cases": [limiter_case],
        "entries": [l1_bank],  # N streams a launch: loudnormbank's tick
    })
    r1_bank = {
        "name": "rnnoise_gru_16_streams",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/rnnoise_gru.cu",
        "replaces": "gst_plugins_rs_tpu/ops/rnnoise.py:309",
        "launches": audio_launches["rnnoise_gru_16_streams"],
        **{k: rnn_bank_cases[0][k] for k in keys},  # 16 frames, bench.py's K_RN
        "cases": rnn_bank_cases,
    }
    entries.append({
        "name": "rnnoise_gru",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/rnnoise_gru.cu",
        "replaces": "gst_plugins_rs_tpu/ops/rnnoise.py:309",
        "launches": audio_launches["rnnoise_gru"],
        **{k: rnn_cases[0][k] for k in keys},  # 100 frames, as phase 3d states
        "cases": rnn_cases,
        "entries": [r1_bank],  # 16 streams a launch: bench.py's denoiser bank
    })
    entries.append({
        "name": "asr_gru",
        "route": "cuda",
        "source": "gst_plugins_rs_tpu_torch/csrc/asr_gru.cu",
        "replaces": "gst_plugins_rs_tpu/ops/asr.py:124",
        "launches": audio_launches["asr_gru"],
        **{k: asr_case[k] for k in keys},
        "cases": [asr_case],
    })
    if any(e["launches"] < 1
           for e in entries + b3["entries"] + b5["entries"] + [l1_bank, r1_bank]):
        raise AssertionError("a kernel of the paths was never launched")
    print(json.dumps({"kernels": entries}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
