"""The GStreamer-core support elements of the PyTorch port (volume, videoflip,
videocrop, videorate, audiorate) against the JAX package, on the CPU.

The first eleven tests mirror tests/test_corefx.py on the port.  The rest
hold each element against the JAX element on the same seeded numpy input:

- the eight videoflip methods and videocrop: bit-equal (layout operations);
- volume at F32 and F64: bit-equal, the payload type kept (one product by
  the gain rounded to the payload's type, in both packages);
- videorate and audiorate: the same buffers with the same PTS and
  durations, the same frames duplicated and the same samples filled or
  dropped.
"""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as fx


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = fx.requested_device()
    fx.set_device("cpu")
    yield
    fx.set_device(prev)


def _one_frame(desc):
    p = fx.parse_launch(desc)
    p.play_until_eos()
    return np.asarray(p.by_name("sink").samples[0].buffer.data)


# ---------------------------------------------------------------------------
# the mirror of tests/test_corefx.py


def test_volume_scales_and_mutes():
    p = fx.parse_launch(
        "audiotestsrc wave=sine num-buffers=2 samplesperbuffer=256 "
        "! audio/x-raw,format=F32,rate=48000,channels=2 "
        "! volume volume=0.5 ! appsink name=sink")
    p.play_until_eos()
    half = p.by_name("sink").concat_audio()
    p = fx.parse_launch(
        "audiotestsrc wave=sine num-buffers=2 samplesperbuffer=256 "
        "! audio/x-raw,format=F32,rate=48000,channels=2 ! appsink name=sink")
    p.play_until_eos()
    full = p.by_name("sink").concat_audio()
    np.testing.assert_allclose(half, full * 0.5, atol=1e-7)
    p = fx.parse_launch(
        "audiotestsrc num-buffers=1 samplesperbuffer=64 "
        "! audio/x-raw,format=F32,rate=48000,channels=1 "
        "! volume mute=true ! appsink name=sink")
    p.play_until_eos()
    assert np.abs(p.by_name("sink").concat_audio()).max() == 0.0


def test_videoflip_orientations_match_numpy():
    base = _one_frame(
        "videotestsrc pattern=gradient num-buffers=1 "
        "! video/x-raw,format=RGB,width=32,height=16 ! appsink name=sink")
    cases = {
        "clockwise": np.rot90(base, k=-1, axes=(0, 1)),
        "counterclockwise": np.rot90(base, k=1, axes=(0, 1)),
        "rotate-180": base[::-1, ::-1],
        "horizontal-flip": base[:, ::-1],
        "vertical-flip": base[::-1, :],
        "upper-left-diagonal": np.swapaxes(base, 0, 1),
    }
    for method, want in cases.items():
        got = _one_frame(
            "videotestsrc pattern=gradient num-buffers=1 "
            "! video/x-raw,format=RGB,width=32,height=16 "
            f"! videoflip method={method} ! appsink name=sink")
        np.testing.assert_array_equal(got, want, err_msg=method)


def test_videocrop_region():
    base = _one_frame(
        "videotestsrc pattern=gradient num-buffers=1 "
        "! video/x-raw,format=RGB,width=32,height=16 ! appsink name=sink")
    got = _one_frame(
        "videotestsrc pattern=gradient num-buffers=1 "
        "! video/x-raw,format=RGB,width=32,height=16 "
        "! videocrop top=2 bottom=3 left=4 right=5 ! appsink name=sink")
    np.testing.assert_array_equal(got, base[2:-3, 4:-5])
    assert got.shape == (11, 23, 3)


def test_videorate_drop_and_duplicate():
    for tgt, nexp in (("10/1", 10), ("60/1", 60)):
        p = fx.parse_launch(
            "videotestsrc num-buffers=30 "
            "! video/x-raw,format=RGB,width=8,height=8,framerate=30/1 "
            f"! videorate ! video/x-raw,framerate={tgt} ! appsink name=sink")
        p.play_until_eos()
        samples = p.by_name("sink").samples
        assert len(samples) == nexp
        # output timeline is the exact target grid
        for i, s in enumerate(samples):
            den, num = {"10/1": (10, 1), "60/1": (60, 1)}[tgt]
            assert s.buffer.pts == i * 1_000_000_000 * num // den


def test_videorate_duplicates_most_recent_frame():
    p = fx.parse_launch(
        "videotestsrc pattern=gradient num-buffers=3 "
        "! video/x-raw,format=RGB,width=8,height=8,framerate=10/1 "
        "! videorate ! video/x-raw,framerate=30/1 ! appsink name=sink")
    p.play_until_eos()
    frames = [np.asarray(s.buffer.data) for s in p.by_name("sink").samples]
    assert len(frames) == 9
    for k in range(3):  # each input frame fills 3 slots
        np.testing.assert_array_equal(frames[3 * k], frames[3 * k + 1])
        np.testing.assert_array_equal(frames[3 * k], frames[3 * k + 2])


def test_audiorate_fills_gap_with_silence():
    p = fx.parse_launch(
        "appsrc name=src caps=audio/x-raw,format=F32,rate=48000,channels=1 "
        "! audiorate ! appsink name=sink")
    src = p.by_name("src")
    src.push_buffer(fx.Buffer(np.ones((4800, 1), np.float32), pts=0,
                              duration=100_000_000))
    src.push_buffer(fx.Buffer(np.ones((4800, 1), np.float32),
                              pts=300_000_000, duration=100_000_000))
    src.end_of_stream()
    p.play_until_eos()
    a = p.by_name("sink").concat_audio()
    assert a.shape[0] == 4 * 4800  # gap became samples
    assert np.abs(a[4800:9600]).max() == 0.0  # ... of silence
    assert np.abs(a[:4800]).min() == 1.0 and np.abs(a[-4800:]).min() == 1.0


def test_audiorate_drops_overlap():
    p = fx.parse_launch(
        "appsrc name=src caps=audio/x-raw,format=F32,rate=48000,channels=1 "
        "! audiorate ! appsink name=sink")
    src = p.by_name("src")
    src.push_buffer(fx.Buffer(np.full((4800, 1), 1.0, np.float32), pts=0,
                              duration=100_000_000))
    # overlaps the first buffer by 50 ms
    src.push_buffer(fx.Buffer(np.full((4800, 1), 2.0, np.float32),
                              pts=50_000_000, duration=100_000_000))
    src.end_of_stream()
    p.play_until_eos()
    a = p.by_name("sink").concat_audio()
    assert a.shape[0] == 4800 + 2400
    assert float(a[4800]) == 2.0  # overlap head was dropped, not doubled


def test_videorate_preserves_input_rate_when_unconstrained():
    p = fx.parse_launch(
        "videotestsrc num-buffers=10 "
        "! video/x-raw,format=RGB,width=8,height=8,framerate=25/1 "
        "! videorate ! appsink name=sink")
    p.play_until_eos()
    samples = p.by_name("sink").samples
    assert len(samples) == 10  # no silent retime to a 30 fps default
    assert samples[1].buffer.pts - samples[0].buffer.pts == 40_000_000


def test_audiorate_untimestamped_buffers_are_contiguous():
    p = fx.parse_launch(
        "appsrc name=src caps=audio/x-raw,format=F32,rate=48000,channels=1 "
        "! audiorate ! appsink name=sink")
    src = p.by_name("src")
    for _ in range(3):
        src.push_buffer(fx.Buffer(np.ones((4800, 1), np.float32)))
    src.end_of_stream()
    p.play_until_eos()
    assert p.by_name("sink").concat_audio().shape[0] == 3 * 4800


def test_videocrop_overcrop_fails_cleanly():
    p = fx.parse_launch(
        "videotestsrc num-buffers=1 ! video/x-raw,format=RGB,width=32,height=16 "
        "! videocrop left=20 right=20 ! appsink name=sink")
    try:
        p.play_until_eos()
        frames = p.by_name("sink").samples
        assert not frames or all(
            np.asarray(s.buffer.data).shape[1] > 0 for s in frames), \
            "zero-width frames must not reach downstream"
        raised = False
    except Exception:
        raised = True
    assert raised, "over-cropping must fail, not emit empty frames"


def test_volume_preserves_f64_dtype():
    p = fx.parse_launch(
        "appsrc name=src caps=audio/x-raw,format=F64,rate=48000,channels=1 "
        "! volume volume=0.5 ! appsink name=sink")
    src = p.by_name("src")
    src.push_buffer(fx.Buffer(np.ones((64, 1), np.float64)))
    src.end_of_stream()
    p.play_until_eos()
    out = p.by_name("sink").samples[0].buffer.data
    assert np.asarray(out).dtype == np.float64
    assert float(np.asarray(out)[0, 0]) == 0.5


# ---------------------------------------------------------------------------
# port against the JAX package


def _through(pkg, desc, caps, buffers):
    """`appsrc name=src ! <desc> ! appsink name=sink` over (payload, pts,
    duration) triples (numpy payloads, handed to the port as tensors):
    [(host payload, pts, duration)] of the sink."""
    p = pkg.parse_launch(f"appsrc name=src ! {desc} ! appsink name=sink")
    src = p.by_name("src")
    src.set_property("caps", pkg.parse_caps(caps))
    for data, pts, dur in buffers:
        src.push_buffer(pkg.Buffer(torch.from_numpy(data) if pkg is fx else data,
                                   pts=pts, duration=dur))
    src.end_of_stream()
    p.play_until_eos()
    return [(np.asarray(s.buffer.data), s.buffer.pts, s.buffer.duration)
            for s in p.by_name("sink").samples]


def _same(desc, caps, buffers):
    got, want = _through(fx, desc, caps, buffers), _through(jfx, desc, caps, buffers)
    assert len(got) == len(want)
    for (g, gp, gd), (w, wp, wd) in zip(got, want):
        assert (gp, gd) == (wp, wd)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    return got


def _video(n, h=12, w=20, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (h, w, 3)).astype(np.uint8), i * 100_000_000, 100_000_000)
            for i in range(n)]


RGB_CAPS = "video/x-raw,format=RGB,width=20,height=12,framerate=10/1"


@pytest.mark.parametrize("method", ["none", "clockwise", "rotate-180", "counterclockwise",
                                    "horizontal-flip", "vertical-flip",
                                    "upper-left-diagonal", "upper-right-diagonal"])
def test_videoflip_matches_jax(method):
    got = _same(f"videoflip method={method}", RGB_CAPS, _video(2, seed=1))
    swaps = method in ("clockwise", "counterclockwise", "upper-left-diagonal",
                       "upper-right-diagonal")
    assert got[0][0].shape == ((20, 12, 3) if swaps else (12, 20, 3))


def test_videocrop_matches_jax():
    got = _same("videocrop top=1 bottom=2 left=3 right=4", RGB_CAPS, _video(2, seed=2))
    assert got[0][0].shape == (9, 13, 3)


@pytest.mark.parametrize("fmt,dtype", [("F32", np.float32), ("F64", np.float64)])
def test_volume_matches_jax(fmt, dtype):
    rng = np.random.RandomState(3)
    bufs = [(rng.uniform(-1, 1, (480, 2)).astype(dtype), i * 10_000_000, 10_000_000)
            for i in range(3)]
    caps = f"audio/x-raw,format={fmt},rate=48000,channels=2,layout=interleaved"
    got = _same("volume volume=0.37", caps, bufs)
    assert all(g.dtype == dtype for g, _, _ in got)


@pytest.mark.parametrize("target", ["4/1", "25/1"])
def test_videorate_matches_jax(target):
    # 10 fps in, with a skipped slot (PTS 300 ms missing) to duplicate across
    bufs = [b for i, b in enumerate(_video(6, seed=4)) if i != 3]
    got = _same(f"videorate ! video/x-raw,framerate={target}", RGB_CAPS, bufs)
    assert len(got) > 1


def test_audiorate_matches_jax():
    rng = np.random.RandomState(5)

    def buf(pts, n):
        return rng.uniform(-1, 1, (n, 1)).astype(np.float32), pts, n * 1_000_000_000 // 48000

    # a gap (silence), an overlap (dropped head), an untimestamped buffer
    bufs = [buf(0, 480), buf(20_000_000, 480), buf(25_000_000, 480), buf(None, 240)]
    got = _same("audiorate", "audio/x-raw,format=F32,rate=48000,channels=1", bufs)
    assert sum(g.shape[0] for g, _, _ in got) == 960 + 480 + 240 + 240
