"""The port's remaining ts-* elements against the JAX package's on the same
seeded input, and on torch payloads.

ts-appsrc, ts-queue, ts-blocking-adapter, ts-intersink/ts-intersrc,
ts-clocksync and ts-input-selector hand the buffer objects on;
ts-audiotestsrc mute=true gives zeros of the synthesised payload's type
where it lies; ts-rtpdtmfsrc builds the JAX element's packets byte for
byte.  The pipelines that run a queue's thread wait for the sink's EOS with
a limit of their own.
"""
import time

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu_torch.core import FlowReturn, Pad, PadDirection
from torch_parity_helpers import port_on_cpu, run_launch

MS = 1_000_000


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


@pytest.mark.parametrize("tones,redundancy", [("159#", 1), ("*0D", 3)])
def test_rtpdtmfsrc_matches_jax(tones, redundancy):
    launch = (f"ts-rtpdtmfsrc tones={tones} ssrc=77 seqnum-offset=100 timestamp-offset=5000 "
              f"packet-redundancy={redundancy} tone-duration-ms=100 ! appsink name=sink")
    got, ref = run_launch(tfx, launch), run_launch(fx, launch)
    assert len(ref[0]) == len(tones) and got == ref


def _wait_eos(sink, limit=30.0):
    deadline = time.monotonic() + limit
    while not sink.eos and time.monotonic() < deadline:
        time.sleep(0.005)
    assert sink.eos, "the sink saw no EOS within its limit"


def _tone_run(pkg, mute):
    p = pkg.parse_launch(
        f"ts-audiotestsrc wave=white-noise seed=5 num-buffers=4 samples-per-buffer=480 "
        f"mute={'true' if mute else 'false'} ! audio/x-raw,format=F32,rate=48000,channels=2 "
        f"! ts-queue ! appsink name=sink")
    p.set_state(pkg.State.PLAYING)
    p.run()
    sink = p.by_name("sink")
    _wait_eos(sink)
    p.set_state(pkg.State.NULL)
    return [s.buffer for s in sink.samples]


@pytest.mark.parametrize("mute", [False, True])
def test_audiotestsrc_matches_jax(mute):
    ref, got = _tone_run(fx, mute), _tone_run(tfx, mute)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        assert isinstance(a.data, torch.Tensor)
        assert (a.pts, a.duration, a.offset) == (b.pts, b.duration, b.offset)
        np.testing.assert_array_equal(a.data.numpy(), np.asarray(b.data))
        if mute:
            assert a.data.dtype == torch.float32 and not a.data.any()


def _passthrough(chain, sent, caps="audio/x-raw,format=F32,rate=48000,channels=2,"
                 "layout=interleaved", consumer=None):
    p = tfx.parse_launch(f"appsrc name=src ! {chain}")
    p.by_name("src").set_property("caps", tfx.parse_caps(caps))
    for i, t in enumerate(sent):
        p.by_name("src").push_buffer(tfx.Buffer(t, pts=i * 10 * MS, duration=10 * MS))
    p.by_name("src").end_of_stream()
    p.set_state(tfx.State.PLAYING)
    p.run()
    if consumer is None:
        sink = p.by_name("sink")
        _wait_eos(sink)
        p.set_state(tfx.State.NULL)
        return [s.buffer.data for s in sink.samples]
    p.set_state(tfx.State.NULL)
    c = tfx.parse_launch(consumer)
    c.play_until_eos()
    return [s.buffer.data for s in c.by_name("sink").samples]


@pytest.mark.parametrize("chain,consumer", [
    ("ts-queue context=tq ! appsink name=sink", None),
    ("ts-queue ! appsink name=sink", None),
    ("ts-blocking-adapter ! appsink name=sink", None),
    ("ts-clocksync sync=false ! appsink name=sink", None),
    ("ts-intersink inter-context=tensors",
     "ts-intersrc inter-context=tensors max-size-time=0 ! appsink name=sink"),
])
def test_passthrough_elements_hand_tensors_on(chain, consumer):
    sent = [torch.full((8, 2), float(i)) for i in range(5)]
    got = _passthrough(chain, sent, consumer=consumer)
    assert len(got) == 5 and all(a is b for a, b in zip(got, sent))


def test_input_selector_hands_the_active_pads_tensors_on():
    sel = tfx.element_factory_make("ts-input-selector")
    pads = [sel.request_sink_pad() for _ in range(2)]
    out = []
    cap = Pad("cap", PadDirection.SINK)
    cap.chain_function = lambda pad, b: (out.append(b), FlowReturn.OK)[1]
    cap.event_function = lambda pad, e: True
    sel.srcpad.link(cap)
    sel.set_property("active-pad", "sink_1")
    sent = [[tfx.Buffer(torch.full((4,), 10.0 * k + i), pts=i * MS) for i in range(3)]
            for k in range(2)]
    for i in range(3):
        for k, pad in enumerate(pads):
            assert pad.chain(sent[k][i]) == FlowReturn.OK
    assert out == sent[1]


def test_clocksync_delays_as_jax():
    """ts-clocksync sync=true holds each buffer to its PTS in wall time from
    the first: the output is the JAX element's, and the run takes at least
    the span of the PTS (60 ms), under a generous limit of its own."""
    bufs = [dict(data=np.full(4, i, np.uint8), pts=i * 20 * MS, duration=20 * MS)
            for i in range(4)]
    results = []
    for pkg in (fx, tfx):
        t0 = time.monotonic()
        results.append(run_launch(pkg, "appsrc name=src ! ts-clocksync ! appsink name=sink",
                                  bufs, caps="application/octet-stream"))
        span = time.monotonic() - t0
        assert 0.06 <= span < 30.0, (pkg.__name__, span)
    assert results[1][0] == results[0][0]
