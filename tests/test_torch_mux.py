"""The port's muxers against the JAX package's mux tests.

Each test of tests/test_fmp4_scenarios.py, test_mp4_scenarios.py,
test_mux.py and test_tsmux_sei.py runs on the port with the same inputs and
the same assertions, except those that need a module of a later slice."""
import pytest

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


# test_mux_external_oracle.py demuxes the muxers' output (and hlscmafsink's
# segments) with the system libavformat (codecs/avlib).
# tests/test_torch_rtp_families.py mirrors test_gcc_mp2t.py.
MIRRORED = (mirror_jax_tests("test_fmp4_scenarios.py", globals())
            + mirror_jax_tests("test_mp4_scenarios.py", globals())
            + mirror_jax_tests("test_mux.py", globals())
            + mirror_jax_tests("test_mux_external_oracle.py", globals())
            + mirror_jax_tests("test_tsmux_sei.py", globals()))


# ---------------------------------------------------------------------------
# Port against the JAX package on seeded input, byte for byte, from numpy
# and from tensor payloads
# ---------------------------------------------------------------------------
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gst_plugins_rs_tpu as fx  # noqa: E402
import gst_plugins_rs_tpu_torch as tfx  # noqa: E402
from test_image_flv import make_flv  # noqa: E402
from torch_parity_helpers import buffer_summary  # noqa: E402

FRAME = 100_000_000  # 10 frames a second


def _video(n, fmt="RGBA", w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    chans = {"RGBA": 4, "RGB": 3}[fmt]
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=10/1"
    return caps, [dict(data=rng.integers(0, 256, (h, w, chans), dtype=np.uint8),
                       pts=i * FRAME, duration=FRAME) for i in range(n)]


def _audio(n, fmt="S16", spb=4800, rate=48000, seed=1):
    rng = np.random.default_rng(seed)
    caps = f"audio/x-raw,format={fmt},rate={rate},channels=2,layout=interleaved"
    dur = spb * 10**9 // rate
    if fmt == "S16":
        make = lambda: rng.integers(-32768, 32768, (spb, 2), dtype=np.int16)  # noqa: E731
    else:
        make = lambda: rng.standard_normal((spb, 2)).astype(np.float32)  # noqa: E731
    return caps, [dict(data=make(), pts=i * dur, duration=dur) for i in range(n)]


def _bytes_in(chunks, caps, spacing=FRAME):
    return caps, [dict(data=np.frombuffer(c, np.uint8).copy(), pts=i * spacing)
                  for i, c in enumerate(chunks)]


def _run_mux(pkg, launch, feeds, tensors):
    """Run `launch` with each appsrc of `feeds` ({name: (caps, buffers)})
    fed its buffers (payloads as tensors if asked), then EOS.  Returns the
    appsink's buffer summaries."""
    p = pkg.parse_launch(launch)
    for name, (caps, bufs) in feeds.items():
        src = p.by_name(name)
        src.set_property("caps", pkg.parse_caps(caps))
        for b in bufs:
            b = dict(b)
            data = b.pop("data")
            src.push_buffer(pkg.Buffer(torch.from_numpy(data) if tensors else data, **b))
        src.end_of_stream()
    p.play_until_eos()
    return [buffer_summary(s.buffer) for s in p.by_name("sink").samples]


def _flv_stream():
    rng = np.random.default_rng(5)
    avcc = bytes([1, 0x64, 0x00, 0x28, 0xFF, 0xE1])
    tags = [(9, 0, bytes([0x17, 0x00, 0, 0, 0]) + avcc), (8, 0, bytes([0x80]) + bytes(160))]
    for i in range(6):
        key = 0x17 if i % 3 == 0 else 0x27
        tags.append((9, 40 * i, bytes([key, 0x01, 0, 0, 0])
                     + rng.integers(0, 256, 200 + 17 * i, dtype=np.uint8).tobytes()))
        tags.append((8, 20 * i, bytes([0x80]) + rng.integers(0, 256, 160, dtype=np.uint8).tobytes()))
    flv = make_flv(tags)
    return [flv[i:i + 333] for i in range(0, len(flv), 333)]


def _h264_aus(n, seed=4):
    rng = np.random.default_rng(seed)
    aus = []
    for i in range(n):
        nal = bytes([0x65 if i % 4 == 0 else 0x41]) + rng.integers(
            1, 256, 300 + 11 * i, dtype=np.uint8).tobytes()
        aus.append(b"\x00\x00\x00\x01\x09\xf0" + b"\x00\x00\x00\x01" + nal)
    return aus


MUX_CASES = {
    "cmafmux": ("appsrc name=v ! cmafmux fragment-duration=300000000 ! appsink name=sink",
                lambda: {"v": _video(10)}),
    "isomp4mux": ("appsrc name=v ! mux. appsrc name=a ! mux. isomp4mux name=mux "
                  "! appsink name=sink",
                  lambda: {"v": _video(8, "RGB"), "a": _audio(8)}),
    "isofmp4mux": ("appsrc name=v ! mux. appsrc name=a ! mux. isofmp4mux name=mux "
                   "fragment-duration=400000000 ! appsink name=sink",
                   lambda: {"v": _video(10), "a": _audio(10, "F32")}),
    "mpegtsmux": ("appsrc name=v ! mux. appsrc name=k ! mux. mpegtsmux name=mux "
                  "! appsink name=sink",
                  lambda: {"v": _bytes_in(_h264_aus(8), "video/x-h264,stream-format=byte-stream,"
                                          "alignment=au"),
                           "k": _bytes_in([bytes([i]) * (40 + i) for i in range(5)],
                                          "meta/x-klv,parsed=true", 2 * FRAME)}),
    "rsflvdemux": ("appsrc name=s ! rsflvdemux name=d d.video ! appsink name=sink",
                   lambda: {"s": _bytes_in(_flv_stream(), "video/x-flv", 0)}),
    "rsflvdemux-audio": ("appsrc name=s ! rsflvdemux name=d d.audio ! appsink name=sink",
                         lambda: {"s": _bytes_in(_flv_stream(), "video/x-flv", 0)}),
}


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(MUX_CASES))
def test_output_bytes_equal_jax(case, payload):
    launch, feeds = MUX_CASES[case]
    ref = _run_mux(fx, launch, feeds(), tensors=False)
    got = _run_mux(tfx, launch, feeds(), tensors=payload == "torch")
    assert ref and len(got) == len(ref)
    assert got == ref


# ---------------------------------------------------------------------------
# The latency deadline on the clock thread against the streaming thread
# ---------------------------------------------------------------------------
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

RUN_TIMEOUT_S = 60.0
LIVE_FRAMES = 60         # 10 ms video frames, a key every 50 ms
LIVE_AUDIO = 25          # the audio stops after these: later fragments lag
MS = 1_000_000


def _live_cut_run():
    """One run of isofmp4mux with 50 ms fragments and a 5 ms latency on the
    system clock: the test thread pushes each video frame and, for the first
    LIVE_AUDIO, an audio buffer when the clock reaches its time, so the clock
    thread cuts the fragments whose audio lags while buffers arrive.  Returns
    the harness after EOS."""
    from fractions import Fraction

    from gst_plugins_rs_tpu_torch.core import State, SystemClock

    clock = SystemClock.obtain()
    h = MuxHarness("isofmp4mux", 2, 50 * MS, props={"latency": 5 * MS})  # noqa: F821
    h.mux.set_state(State.PAUSED)
    h.mux.clock, h.mux.base_time = clock, clock.now()
    h.mux.set_state(State.PLAYING)
    h.set_caps(0, video_caps(framerate=Fraction(100, 1)))  # noqa: F821
    h.set_caps(1, aac_caps())  # noqa: F821
    for i in range(LIVE_FRAMES):
        while clock.now() - h.mux.base_time < i * 10 * MS:
            time.sleep(0.0002)
        h.push(0, i * 10 * MS, dur=10 * MS, key=i % 5 == 0, dts=i * 10 * MS)
        if i < LIVE_AUDIO:
            h.push(1, i * 10 * MS, dur=10 * MS)
    h.eos()
    h.mux.set_state(State.NULL)
    return h


@pytest.mark.parametrize("run", range(5))
def test_live_deadline_cuts_under_threads(run):
    """The deadline cut (clock thread) and the aggregation (streaming
    thread) take the aggregator's lock, then the muxer's: no hang within
    RUN_TIMEOUT_S, and every sample leaves exactly once with rising decode
    times on each track."""
    result, errors = [], []

    def target():
        try:
            with port_on_cpu():
                result.append(_live_cut_run())
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(RUN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive(), f"run {run}: the muxer did not finish in {RUN_TIMEOUT_S} s"
    assert not errors, errors
    h = result[0]
    per_track = {}
    for frag in h.frags():
        for r in MuxHarness.runs(frag):  # noqa: F821
            per_track.setdefault(r.track_id, []).append(
                (r.decode_time, len(r.sample_durations)))
    for track, runs in per_track.items():
        times = [t for t, _ in runs]
        assert times == sorted(times) and len(set(times)) == len(times), (track, runs)
    assert sum(n for _, n in per_track[1]) == LIVE_FRAMES
    assert sum(n for _, n in per_track[2]) == LIVE_AUDIO
