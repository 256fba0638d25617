"""The core runtime and plumbing of the PyTorch port against the JAX package.

Mirrors tests/test_pipeline.py, tests/test_caps.py and tests/test_clock.py:
the same `parse_launch` strings run through both packages, and the buffers
(data, PTS, duration, offsets), the negotiated caps, the EOS message and the
clock behaviour are compared.  Plumbing among the scenarios: tee, queue,
identity, capsfilter, audiotestsrc, audioconvert, videotestsrc and
videoconvert.  Gates: bit-equal, except videoconvert's colour conversions
(I420/NV12/GRAY8), which may differ by 1 u8 LSB where a value lies within an
f32 rounding of .5: XLA's CPU backend contracts the BT.601 products into
FMAs, the port rounds each product (tests/test_convert.py's own gate is
1-2 LSB against BT.601).
"""
import time

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu.core as jcore
import gst_plugins_rs_tpu_torch as tfx
import gst_plugins_rs_tpu_torch.core as tcore
from torch_parity_helpers import port_on_cpu

PKGS = [(jfx, jcore), (tfx, tcore)]
YUV_LSB = 1


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _host(data):
    if isinstance(data, (tuple, list)):
        return tuple(_host(d) for d in data)
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _max_diff(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        return max(_max_diff(x, y) for x, y in zip(a, b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) if a.dtype.kind in "iu" \
        else float(np.abs(a - b).max())


def _run(pkg, launch, sinks):
    p = pkg.parse_launch(launch)
    p.play_until_eos()
    eos = [m for m in p.bus.messages() if m.type.name == "EOS"]
    return p, {name: p.by_name(name).samples for name in sinks}, len(eos)


LAUNCHES = {
    "audiotestsrc_to_appsink": (
        "audiotestsrc wave=sine freq=440 num-buffers=10 samplesperbuffer=1024 "
        "! audio/x-raw,format=F32,rate=48000,channels=2 ! appsink name=sink", ("sink",), 0),
    "caps_fixate_defaults": ("audiotestsrc num-buffers=1 ! appsink name=sink", ("sink",), 0),
    "capsfilter_f64_192k_mono": (
        "audiotestsrc num-buffers=2 ! audio/x-raw,format=F64,rate=192000,channels=1 "
        "! appsink name=sink", ("sink",), 0),
    "identity_queue": (
        "audiotestsrc num-buffers=3 samplesperbuffer=256 ! identity ! queue ! appsink name=sink",
        ("sink",), 0),
    "tee_two_branches": (
        "audiotestsrc num-buffers=3 samplesperbuffer=128 ! tee name=t "
        "t. ! queue ! appsink name=a t. ! queue ! audioconvert ! audio/x-raw,format=S16 "
        "! appsink name=b", ("a", "b"), 0),
    "audioconvert_s16_to_f32": (
        "audiotestsrc wave=square num-buffers=2 ! audio/x-raw,format=S16,channels=2 "
        "! audioconvert ! audio/x-raw,format=F32 ! appsink name=sink", ("sink",), 0),
    "audioconvert_f32_to_s16_clips": (
        "audiotestsrc wave=saw volume=3.0 num-buffers=2 ! audio/x-raw,format=F32 "
        "! audioconvert ! audio/x-raw,format=S16 ! appsink name=sink", ("sink",), 0),
    "audioconvert_planar": (
        "audiotestsrc num-buffers=2 samplesperbuffer=100 ! audio/x-raw,format=F32,channels=2 "
        "! audioconvert ! audio/x-raw,format=F64,layout=non-interleaved ! appsink name=sink",
        ("sink",), 0),
    "videotestsrc_smpte": (
        "videotestsrc num-buffers=2 ! video/x-raw,format=RGB,width=128,height=64 "
        "! appsink name=sink", ("sink",), 0),
    "videoconvert_rgb_to_bgra": (
        "videotestsrc pattern=checkers-8 num-buffers=2 ! video/x-raw,format=RGB,width=64,"
        "height=48 ! videoconvert ! video/x-raw,format=BGRA ! appsink name=sink", ("sink",), 0),
    "videoconvert_same_format": (
        "videotestsrc num-buffers=1 ! video/x-raw,format=RGBA,width=32,height=16 "
        "! videoconvert ! video/x-raw,format=RGBA ! appsink name=sink", ("sink",), 0),
    "videoconvert_rgba64_to_xrgb": (
        "videotestsrc pattern=gradient num-buffers=1 ! video/x-raw,format=RGBA64LE,width=64,"
        "height=16 ! videoconvert ! video/x-raw,format=xRGB ! appsink name=sink", ("sink",), 0),
    "videoconvert_rgb_to_i420": (
        "videotestsrc num-buffers=2 ! video/x-raw,format=RGB,width=64,height=48 "
        "! videoconvert ! video/x-raw,format=I420 ! appsink name=sink", ("sink",), YUV_LSB),
    "videoconvert_i420_to_bgrx": (
        "videotestsrc pattern=gradient num-buffers=1 ! video/x-raw,format=RGBA,width=64,"
        "height=32 ! videoconvert ! video/x-raw,format=I420 ! videoconvert "
        "! video/x-raw,format=BGRx ! appsink name=sink", ("sink",), YUV_LSB),
    "videoconvert_nv12_round_trip": (
        "videotestsrc pattern=smpte num-buffers=1 ! video/x-raw,format=BGRA,width=64,"
        "height=32 ! videoconvert ! video/x-raw,format=NV12 ! videoconvert "
        "! video/x-raw,format=RGBA64LE ! appsink name=sink", ("sink",), 257 * YUV_LSB),
    "videoconvert_rgb_to_gray8": (
        "videotestsrc pattern=gradient num-buffers=1 ! video/x-raw,format=RGB,width=64,"
        "height=8 ! videoconvert ! video/x-raw,format=GRAY8 ! appsink name=sink", ("sink",),
        YUV_LSB),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launch_matches_jax(name):
    launch, sinks, tol = LAUNCHES[name]
    (_, jout, jeos), (_, tout, teos) = (_run(pkg, launch, sinks) for pkg, _ in PKGS)
    assert jeos == teos >= 1  # one EOS message per sink
    for sink in sinks:
        js, ts = jout[sink], tout[sink]
        assert len(js) == len(ts) > 0
        for a, b in zip(js, ts):
            assert (a.buffer.pts, a.buffer.duration, a.buffer.offset, a.buffer.offset_end) == \
                (b.buffer.pts, b.buffer.duration, b.buffer.offset, b.buffer.offset_end)
            assert repr(a.caps) == repr(b.caps)
            assert _max_diff(_host(a.buffer.data), _host(b.buffer.data)) <= tol


def test_random_frames_convert_like_jax():
    """Seeded random frames through every conversion pair of videoconvert,
    as build_format_converter builds them in each package."""
    from gst_plugins_rs_tpu.elements.generic.convert import build_format_converter as jconv
    from gst_plugins_rs_tpu_torch.elements.generic.convert import build_format_converter as tconv

    rng = np.random.RandomState(0)
    fmts = ["RGB", "BGRA", "ARGB", "RGBx", "RGBA64LE", "GRAY8", "I420", "NV12"]
    frames = {f: rng.randint(0, 256 if f != "RGBA64LE" else 65536,
                             (16, 24, jcore.VideoInfo(f, 24, 16).components)).astype(
                                 jcore.VideoInfo(f, 24, 16).dtype)
              for f in fmts if f not in ("I420", "NV12")}
    y, u, v = (rng.randint(0, 256, s).astype(np.uint8) for s in ((16, 24), (8, 12), (8, 12)))
    frames["I420"] = (y, u, v)
    frames["NV12"] = (y, np.stack([u, v], -1).reshape(8, 24))
    for fin in fmts:
        if fin == "GRAY8":
            continue  # a sink format only, as in the JAX package
        for fout in fmts:
            if fin == fout:
                continue
            jinfo = (jcore.VideoInfo(fin, 24, 16), jcore.VideoInfo(fout, 24, 16))
            tinfo = (tcore.VideoInfo(fin, 24, 16), tcore.VideoInfo(fout, 24, 16))
            frame = frames[fin]
            ja = _host(jconv(*jinfo)(tuple(frame) if isinstance(frame, tuple) else frame))
            tin = tuple(torch.from_numpy(p) for p in frame) if isinstance(frame, tuple) \
                else torch.from_numpy(frame)
            tb = _host(tconv(*tinfo)(tin))
            yuv = fin in ("I420", "NV12") or fout in ("I420", "NV12", "GRAY8") or \
                fin == "RGBA64LE"
            tol = (257 if fout == "RGBA64LE" else 1) * YUV_LSB if yuv else 0
            assert _max_diff(ja, tb) <= tol, (fin, fout)


def test_yuv_ops_match_jax():
    """ops/yuv.py's packed helpers and NV12 (de)interleave against the JAX
    module's, on a seeded random RGBA frame."""
    from gst_plugins_rs_tpu.ops import yuv as jyuv
    from gst_plugins_rs_tpu_torch.ops import yuv as tyuv

    rgba = np.random.RandomState(1).randint(0, 256, (32, 48, 4)).astype(np.uint8)
    jplanes = tuple(np.array(p) for p in _host(jyuv.rgb_to_i420(rgba)))
    tplanes = tyuv.rgb_to_i420(torch.from_numpy(rgba))
    assert _max_diff(jplanes, _host(tplanes)) <= YUV_LSB
    assert _max_diff(_host(jyuv.i420_to_rgb(*jplanes)),
                     _host(tyuv.i420_to_rgb(*(torch.from_numpy(p) for p in jplanes)))) <= YUV_LSB
    _, u, v = (torch.from_numpy(p) for p in jplanes)
    uv = tyuv.uv_to_nv12(u, v)
    assert np.array_equal(uv.numpy(), _host(jyuv.uv_to_nv12(jplanes[1], jplanes[2])))
    assert all(torch.equal(a, b) for a, b in zip(tyuv.nv12_to_uv(uv), (u, v)))


def test_incompatible_caps_raise_in_both():
    for pkg, _ in PKGS:
        p = pkg.parse_launch("audiotestsrc num-buffers=1 ! video/x-raw,format=RGB ! fakesink")
        with pytest.raises(Exception):
            p.play_until_eos()


def test_named_elements_and_eos_flag():
    for pkg, _ in PKGS:
        p = pkg.parse_launch("audiotestsrc name=mysrc num-buffers=1 ! appsink name=mysink")
        assert p.by_name("mysrc").ELEMENT_NAME == "audiotestsrc"
        p.play_until_eos()
        assert p.by_name("mysink").eos


def _caps_intersect_concrete(c):
    a = c.Caps.builder("audio/x-raw", format="F32", rate=48000)
    b = c.Caps.builder("audio/x-raw", format="F32", rate=48000, channels=2)
    return repr(a.intersect(b))


def _caps_disjoint(c):
    return c.Caps.builder("audio/x-raw", format="F32").intersect(
        c.Caps.builder("audio/x-raw", format="F64")).is_empty()


def _caps_list_range(c):
    a = c.Caps.builder("audio/x-raw", format=c.ValueList(["F32", "F64"]),
                       rate=c.IntRange(1, 192000))
    return repr(a.intersect(c.Caps.builder("audio/x-raw", format="F64", rate=48000)))


def _caps_range_range(c):
    a = c.Caps.builder("audio/x-raw", rate=c.IntRange(100, 200))
    return (repr(a.intersect(c.Caps.builder("audio/x-raw", rate=c.IntRange(150, 300)))),
            a.intersect(c.Caps.builder("audio/x-raw", rate=c.IntRange(201, 300))).is_empty())


def _caps_fixate(c):
    caps = c.Caps.builder("audio/x-raw", format=c.ValueList(["F32", "F64"]),
                          rate=c.IntRange(1, 192000))
    return repr(caps.fixate({"rate": 48000}))


def _caps_any(c):
    any_, conc = c.Caps.new_any(), c.Caps.builder("video/x-raw", format="RGB")
    return repr(any_.intersect(conc)), conc.is_subset(any_), any_.is_subset(conc)


def _caps_parse(c):
    return (repr(c.parse_caps("audio/x-raw,format=F32,rate=48000,channels=2")),
            repr(c.parse_caps("audio/x-raw,format={F32,F64},rate=[1,192000]")),
            [c.parse_value(v) for v in ("48000", "0.5", "true", "sine", "30/1")])


@pytest.mark.parametrize("case", [_caps_intersect_concrete, _caps_disjoint, _caps_list_range,
                                  _caps_range_range, _caps_fixate, _caps_any, _caps_parse],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_caps_algebra_matches_jax(case):
    assert case(jcore) == case(tcore)


def _test_clock_order(c):
    tc = c.TestClock()
    fired = []
    for t in (30, 10, 20):
        tc.new_single_shot_id(t).wait_async(lambda _, t=t: fired.append(t))
    tc.advance(15)
    first = list(fired)
    tc.advance(20)
    return first, fired, tc.new_single_shot_id(0).wait() == c.ClockReturn.EARLY


def _pipeline_clock(pkg, c):
    p = pkg.parse_launch("audiotestsrc num-buffers=2 samplesperbuffer=480 "
                         "! audio/x-raw,format=F32,rate=48000,channels=1 "
                         "! rsaudioecho ! appsink name=sink")
    tc = c.TestClock(start=1234)
    p.use_clock(tc)
    p.set_state(c.State.PLAYING)
    try:
        clocks = [(e.clock is tc, e.base_time, e.running_time()) for e in p.elements]
        tc.advance(7)
        return clocks, p.elements[0].running_time()
    finally:
        p.set_state(c.State.NULL)


def _latency_through_loudnorm(pkg, c):
    p = pkg.parse_launch("audiotestsrc num-buffers=1 samplesperbuffer=480 "
                         "! audio/x-raw,format=F64,rate=192000,channels=1 "
                         "! audioloudnorm ! appsink name=sink")
    p.set_state(c.State.PAUSED)
    try:
        return p.query_latency().result["min_latency"]
    finally:
        p.set_state(c.State.NULL)


def _pause_resume(pkg, c):
    p = pkg.parse_launch("audiotestsrc num-buffers=2 samplesperbuffer=480 "
                         "! audio/x-raw,format=F32,rate=48000,channels=1 ! appsink name=sink")
    tc = c.TestClock(start=0)
    p.use_clock(tc)
    p.set_state(c.State.PLAYING)
    tc.advance(5 * c.SECOND)
    before = p.elements[0].running_time()
    p.set_state(c.State.PAUSED)
    tc.advance(100 * c.SECOND)
    p.set_state(c.State.PLAYING)
    after = p.elements[0].running_time()
    p.set_state(c.State.NULL)
    return before, after


@pytest.mark.parametrize("case", ["test_clock_order", "pipeline_clock", "latency", "pause_resume"])
def test_clock_scenarios_match_jax(case):
    results = []
    for pkg, c in PKGS:
        if case == "test_clock_order":
            results.append(_test_clock_order(c))
        elif case == "pipeline_clock":
            results.append(_pipeline_clock(pkg, c))
        elif case == "latency":
            results.append(_latency_through_loudnorm(pkg, c))
        else:
            results.append(_pause_resume(pkg, c))
    assert results[0] == results[1]
    if case == "latency":
        assert results[1] == 3 * tcore.SECOND


def test_live_source_paces_on_the_clock():
    p = tfx.parse_launch("audiotestsrc is-live=true num-buffers=3 samplesperbuffer=4800 "
                         "! audio/x-raw,format=F32,rate=48000,channels=1 ! appsink name=sink")
    t0 = time.monotonic()
    p.play_until_eos()
    assert time.monotonic() - t0 >= 0.18
    assert len(p.by_name("sink").samples) == 3
