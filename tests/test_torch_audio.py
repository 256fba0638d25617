"""The audio elements of the PyTorch port against the JAX package, on the CPU.

The same `parse_launch` strings run through both packages.  Gates:
audiotestsrc bit-equal (the same float64 host synthesis and the same
`np.random.RandomState(seed)` noise; F64 stays float64 in both with x64 on);
audioconvert bit-equal; rsaudioecho <= 1e-6 in f32 and <= 1e-12 in f64 (the
same products and sums, the chunks walked by a loop instead of a scan);
audioresample <= 1e-5 (f32 convolutions that sum in another order); the
ebur128level messages with the same fields and timestamps, loudness within
1e-9 LU and peaks within 1e-12.
"""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core import MessageType as JMessageType
from gst_plugins_rs_tpu.ops import echo as jecho
from gst_plugins_rs_tpu.ops import resample as jresample
from gst_plugins_rs_tpu_torch.core import MessageType as TMessageType
from gst_plugins_rs_tpu_torch.ops import echo as techo
from gst_plugins_rs_tpu_torch.ops import resample as tresample
from torch_parity_helpers import port_on_cpu

ECHO_F32_TOL = 1e-6
ECHO_F64_TOL = 1e-12
RESAMPLE_TOL = 1e-5
LU_TOL = 1e-9
PEAK_TOL = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _both(launch, sink="sink"):
    """(jax samples, torch samples) of `launch` run to EOS in each package."""
    out = []
    for pkg in (jfx, tfx):
        p = pkg.parse_launch(launch)
        p.play_until_eos()
        out.append(p.by_name(sink).samples)
    return out


def _host(data):
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _same_meta(js, ts):
    assert len(js) == len(ts) > 0
    for a, b in zip(js, ts):
        assert (a.buffer.pts, a.buffer.duration, a.buffer.offset, a.buffer.offset_end) == \
            (b.buffer.pts, b.buffer.duration, b.buffer.offset, b.buffer.offset_end)
        assert repr(a.caps) == repr(b.caps)


def _concat(samples):
    return np.concatenate([_host(s.buffer.data) for s in samples])


@pytest.mark.parametrize("wave", ["sine", "square", "saw", "triangle", "silence",
                                  "white-noise", "ticks"])
@pytest.mark.parametrize("fmt", ["F32", "F64", "S16", "S32"])
def test_audiotestsrc_bit_equal(wave, fmt):
    js, ts = _both(f"audiotestsrc wave={wave} num-buffers=3 samplesperbuffer=1000 seed=3 "
                   f"freq=997 tick-interval=10000000 ! audio/x-raw,format={fmt},rate=44100,"
                   f"channels=2 ! appsink name=sink")
    _same_meta(js, ts)
    for a, b in zip(js, ts):
        assert isinstance(b.buffer.data, torch.Tensor)
        ja, tb = _host(a.buffer.data), _host(b.buffer.data)
        assert ja.dtype == tb.dtype and np.array_equal(ja, tb)


def test_audiotestsrc_seek_is_sample_exact():
    """After a seek both sources continue from the segment's sample, equal
    to the tail of a stream that started at 0."""
    from gst_plugins_rs_tpu.core import Caps as JCaps, Segment as JSegment
    from gst_plugins_rs_tpu_torch.core import Caps as TCaps, Segment as TSegment

    full = tfx.parse_launch("audiotestsrc wave=triangle num-buffers=4 samplesperbuffer=480 "
                            "! audio/x-raw,format=F64,rate=48000,channels=1 ! appsink name=sink")
    full.play_until_eos()
    whole = _concat(full.by_name("sink").samples)
    tails = []
    for pkg, caps, seg_cls in ((jfx, JCaps, JSegment), (tfx, TCaps, TSegment)):
        src = pkg.element_factory_make("audiotestsrc")
        src.set_property("wave", "triangle")
        src.set_property("samplesperbuffer", 480)
        src.negotiated(caps.builder("audio/x-raw", format="F64", rate=48000, channels=1,
                                    layout="interleaved"))
        seg = seg_cls()
        seg.start = 960 * 10**9 // 48000
        assert src.do_seek(seg)
        buf = src.create()
        assert buf.pts == seg.start and buf.offset == 960
        tails.append(_host(buf.data))
    assert np.array_equal(tails[0], tails[1]) and np.array_equal(tails[1], whole[960:1440])


@pytest.mark.parametrize("src_fmt,dst_fmt", [
    ("F32", "S16"), ("F32", "S32"), ("S16", "F32"), ("S32", "F64"), ("F64", "F32"),
    ("F64", "S16"), ("S16", "S32"), ("F32", "F64")])
def test_audioconvert_bit_equal(src_fmt, dst_fmt):
    js, ts = _both(f"audiotestsrc wave=saw volume=1.2 num-buffers=2 samplesperbuffer=700 "
                   f"! audio/x-raw,format={src_fmt},rate=48000,channels=2 ! audioconvert "
                   f"! audio/x-raw,format={dst_fmt} ! appsink name=sink")
    _same_meta(js, ts)
    a, b = _concat(js), _concat(ts)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_audioconvert_layouts_and_tee():
    launch = ("audiotestsrc wave=sine num-buffers=2 samplesperbuffer=256 "
              "! audio/x-raw,format=F32,rate=48000,channels=2 ! tee name=t "
              "t. ! queue ! audioconvert ! audio/x-raw,layout=non-interleaved ! appsink name=a "
              "t. ! queue ! appsink name=b")
    out = {}
    for name, pkg in (("jax", jfx), ("torch", tfx)):
        p = pkg.parse_launch(launch)
        p.play_until_eos()
        out[name] = (p.by_name("a").samples, p.by_name("b").samples)
    for j, t in zip(out["jax"], out["torch"]):
        _same_meta(j, t)
        assert np.array_equal(_concat(j), _concat(t))
    planar, inter = out["torch"]
    assert _host(planar[0].buffer.data).shape == (2, 256)
    assert np.array_equal(_host(planar[0].buffer.data).T, _host(inter[0].buffer.data))


@pytest.mark.parametrize("rate_in,rate_out", [(48000, 192000), (44100, 48000),
                                              (192000, 48000), (16000, 48000)])
def test_resampler_matches_jax(rate_in, rate_out):
    rng = np.random.RandomState(rate_in + rate_out)
    x = rng.uniform(-1, 1, (5000, 2)).astype(np.float32)
    jr, tr = jresample.Resampler(rate_in, rate_out), tresample.Resampler(rate_in, rate_out)
    assert np.array_equal(jresample.design_filter(jr.L, jr.M), tresample.design_filter(tr.L, tr.M))
    outs_j, outs_t = [], []
    for i in range(0, 5000, 1234):
        outs_j.append(np.asarray(jr.process(x[i:i + 1234])))
        outs_t.append(tr.process(torch.from_numpy(x[i:i + 1234])).numpy())
    outs_j.append(np.asarray(jr.drain()))
    outs_t.append(tr.drain().numpy())
    for a, b in zip(outs_j, outs_t):
        assert a.shape == b.shape
        if a.size:
            assert np.abs(a - b).max() <= RESAMPLE_TOL


def test_resampler_chunked_equals_oneshot():
    x = np.random.RandomState(1).uniform(-1, 1, (4000, 1)).astype(np.float32)
    one = tresample.Resampler(48000, 44100)
    y1 = torch.cat([one.process(torch.from_numpy(x)), one.drain()]).numpy()
    ch = tresample.Resampler(48000, 44100)
    parts = [ch.process(torch.from_numpy(x[i:i + 333])) for i in range(0, 4000, 333)]
    y2 = torch.cat(parts + [ch.drain()]).numpy()
    assert y1.shape == y2.shape and np.abs(y1 - y2).max() <= RESAMPLE_TOL


def test_audioresample_pipeline_matches_jax():
    js, ts = _both("audiotestsrc wave=sine num-buffers=5 samplesperbuffer=4800 "
                   "! audio/x-raw,format=F32,rate=48000,channels=2 ! audioresample "
                   "! audio/x-raw,rate=192000 ! audioconvert ! audio/x-raw,format=F64 "
                   "! appsink name=sink")
    _same_meta(js, ts)
    a, b = _concat(js), _concat(ts)
    assert b.dtype == np.float64 and a.shape == b.shape
    assert np.abs(a - b).max() <= RESAMPLE_TOL


@pytest.mark.parametrize("fmt,tol", [("F32", ECHO_F32_TOL), ("F64", ECHO_F64_TOL)])
@pytest.mark.parametrize("delay_ms,feedback", [(0, 0.0), (10, 0.0), (30, 0.5), (500, 0.3)])
def test_audioecho_matches_jax(fmt, tol, delay_ms, feedback):
    js, ts = _both(f"audiotestsrc wave=ticks num-buffers=6 samplesperbuffer=1000 "
                   f"tick-interval=50000000 ! audio/x-raw,format={fmt},rate=24000,channels=2 "
                   f"! rsaudioecho max-delay=1000000000 delay={delay_ms * 1000000} "
                   f"intensity=0.6 feedback={feedback} ! appsink name=sink")
    _same_meta(js, ts)
    a, b = _concat(js), _concat(ts)
    assert a.dtype == b.dtype
    assert np.abs(a - b).max() <= tol


def test_echo_op_matches_jax_and_properties_change_while_playing():
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, 3001).astype(np.float32)
    hist = np.zeros(400, np.float32)
    for lag in (1, 7, 400):
        jo, jh = jecho.echo_apply_flat(x, hist, np.float32(0.5), np.float32(0.25), lag=lag)
        to, th = techo.echo_apply_flat(torch.from_numpy(x), torch.from_numpy(hist), 0.5, 0.25,
                                       lag=lag)
        assert np.abs(np.asarray(jo) - to.numpy()).max() <= ECHO_F32_TOL
        assert np.abs(np.asarray(jh) - th.numpy()).max() <= ECHO_F32_TOL
    specs = {p.name: p for p in type(tfx.element_factory_make("rsaudioecho")).PROPERTIES}
    assert [specs[p].mutable for p in ("delay", "intensity", "feedback", "max-delay")] == \
        ["playing", "playing", "playing", "ready"]
    # a delay change while PLAYING takes effect from the next buffer on
    from gst_plugins_rs_tpu_torch.core import Harness

    echo = tfx.element_factory_make("rsaudioecho")
    echo.set_property("delay", 1_000_000)
    echo.set_property("intensity", 1.0)
    h = Harness(echo)
    h.set_src_caps(tfx.Caps.builder("audio/x-raw", format="F32", rate=1000, channels=1,
                                    layout="interleaved"))
    h.push(tfx.Buffer(torch.ones(10, 1), pts=0))
    echo.set_property("delay", 3_000_000)
    h.push(tfx.Buffer(torch.zeros(10, 1), pts=10**7))
    out = np.concatenate([_host(b.data) for b in h.pull_all()])[:, 0]
    h.teardown()
    # 1 ms lag: ones + the delayed ones; then the 3 ms lag reads 3 samples back
    assert np.array_equal(out[:10], [1.0] + [2.0] * 9)
    assert np.array_equal(out[10:13], [1.0, 1.0, 1.0]) and np.all(out[13:] == 0.0)


def _levels(pkg, mtype, launch):
    p = pkg.parse_launch(launch)
    p.play_until_eos()
    return [m.structure for m in p.bus.messages(mtype)
            if m.structure is not None and m.structure.name == "ebur128-level"]


@pytest.mark.parametrize("fmt,rate", [("F32", 48000), ("S16", 48000), ("F64", 44100),
                                      ("S32", 192000)])
def test_ebur128level_messages_match_jax(fmt, rate):
    launch = (f"audiotestsrc wave=white-noise volume=0.4 num-buffers=14 "
              f"samplesperbuffer={rate // 20 + 17} "
              f"! audio/x-raw,format={fmt},rate={rate},channels=2 "
              f"! ebur128level interval=250000000 ! fakesink")
    jm, tm = _levels(jfx, JMessageType.ELEMENT, launch), _levels(tfx, TMessageType.ELEMENT, launch)
    assert len(jm) == len(tm) > 0
    for a, b in zip(jm, tm):
        assert sorted(a.fields) == sorted(b.fields)
        for k in ("timestamp", "running-time", "stream-time"):
            assert a[k] == b[k]
        for k in ("momentary-loudness", "shortterm-loudness", "global-loudness",
                  "relative-threshold", "loudness-range"):
            assert a[k] == b[k] or abs(a[k] - b[k]) <= LU_TOL, (k, a[k], b[k])
        for k in ("sample-peak", "true-peak"):
            assert np.abs(np.array(a[k]) - np.array(b[k])).max() <= PEAK_TOL


def test_ebur128level_modes_reset_and_passthrough():
    launch = ("audiotestsrc wave=sine num-buffers=10 samplesperbuffer=4800 "
              "! audio/x-raw,format=F32,rate=48000,channels=2 "
              "! ebur128level mode=5 interval=200000000 ! appsink name=sink")
    for pkg, mt in ((jfx, JMessageType.ELEMENT), (tfx, TMessageType.ELEMENT)):
        msgs = _levels(pkg, mt, launch)
        assert len(msgs) == 5
        assert {"momentary-loudness", "global-loudness"} <= set(msgs[0].fields)
        assert "loudness-range" not in msgs[0].fields and "true-peak" not in msgs[0].fields
    p = tfx.parse_launch(launch)
    p.play_until_eos()
    src = tfx.parse_launch("audiotestsrc wave=sine num-buffers=10 samplesperbuffer=4800 "
                           "! audio/x-raw,format=F32,rate=48000,channels=2 ! appsink name=sink")
    src.play_until_eos()
    assert np.array_equal(_concat(p.by_name("sink").samples), _concat(src.by_name("sink").samples))
    level = tfx.element_factory_make("ebur128level")
    level.reset()
    assert level._reset_pending


# chip_smoke.py's audioloudnorm path: ticks (one 440 Hz period at 0.8 every
# 0.5 s) at 48 kHz F32, resampled to 192 kHz F64.  Normalised to -24 LUFS
# every tick crosses -2 dBTP, and the limiter's clamping leaves the output
# below the target: on 6 s the JAX element reads -25.25 LUFS, and so does
# the port, outside the reference's +-1 LU (which holds on the reference's
# own signals, tests/test_torch_loudnorm.py).  The smoke's 2 LU bar on this
# signal rests on this reading.
SMOKE_TICKS = "wave=ticks volume=0.8 sine-periods-per-tick=1 tick-interval=500000000"
SMOKE_LOUDNESS_BAR = 2.0
LN_SAMPLE_TOL = 1e-9


def test_audioloudnorm_on_the_smoke_signal_reads_as_the_jax_element():
    from gst_plugins_rs_tpu.core import Buffer as JBuffer, Caps as JCaps
    from gst_plugins_rs_tpu_torch.core import Buffer as TBuffer, Caps as TCaps
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    front = jfx.parse_launch(
        f"audiotestsrc {SMOKE_TICKS} num-buffers=60 samplesperbuffer=4800 "
        f"! audio/x-raw,format=F32,rate=48000,channels=2 ! audioresample "
        f"! audio/x-raw,rate=192000 ! audioconvert "
        f"! audio/x-raw,format=F64,rate=192000,channels=2 ! appsink name=sink")
    front.play_until_eos()
    ins = [s.buffer for s in front.by_name("sink").samples]  # fed to both normalisers
    outs, pts, loud = [], [], []
    for pkg, buffer_cls, caps_cls in ((jfx, JBuffer, JCaps), (tfx, TBuffer, TCaps)):
        p = pkg.parse_launch("appsrc name=src ! audioloudnorm ! appsink name=sink")
        src = p.by_name("src")
        src.set_property("caps", caps_cls.builder("audio/x-raw", format="F64", rate=192000,
                                                  channels=2, layout="interleaved"))
        for b in ins:
            data = np.asarray(b.data)
            if buffer_cls is TBuffer:
                data = torch.from_numpy(data.copy())
            src.push_buffer(buffer_cls(data, pts=b.pts, duration=b.duration, offset=b.offset))
        src.end_of_stream()
        p.play_until_eos()
        samples = p.by_name("sink").samples
        out = _concat(samples)
        r = EbuR128(2, 192000)
        r.add_frames(torch.from_numpy(out))
        assert max(r.sample_peak(c) for c in range(2)) <= 10 ** (-2 / 20) + 1e-9
        outs.append(out)
        pts.append([s.buffer.pts for s in samples])
        loud.append(r.loudness_global())
    n_in = sum(np.asarray(b.data).shape[0] for b in ins)  # 6 s and the resampler's tail
    assert pts[0] == pts[1] and outs[0].shape == outs[1].shape == (n_in, 2)
    assert np.abs(outs[0] - outs[1]).max() <= LN_SAMPLE_TOL
    assert abs(loud[0] - loud[1]) <= LU_TOL
    assert 1.0 < abs(loud[0] + 24.0) < SMOKE_LOUDNESS_BAR, loud[0]
