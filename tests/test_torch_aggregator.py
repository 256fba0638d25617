"""The port's Aggregator under two feeding threads.

Two `queue` elements (one worker thread each) feed one audiomixer with many
small buffers.  Without a lock around the pad queues and the aggregation
loop, the two threads can pop and push at once and the mixer's output
leaves out of order or loses buffers.  The port's core holds one reentrant
lock per aggregator; each run must give strictly rising PTS and every
sample.  A run has its own time limit, so a deadlock fails the test instead
of hanging the suite.  The switch interval is shortened so the threads
interleave often.
"""
import sys
import threading

import numpy as np
import pytest

import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import port_on_cpu

RATE = 48_000
SPB = 48            # 1 ms buffers
BUFFERS = 500
RUN_TIMEOUT_S = 60.0


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _mixer_run():
    p = tfx.parse_launch(
        f"audiotestsrc wave=sine num-buffers={BUFFERS} samplesperbuffer={SPB} "
        f"! audio/x-raw,format=F32,rate={RATE},channels=1 ! queue ! mix. "
        f"audiotestsrc wave=white-noise num-buffers={BUFFERS} samplesperbuffer={SPB} "
        f"! audio/x-raw,format=F32,rate={RATE},channels=1 ! queue ! mix. "
        f"audiomixer name=mix output-buffer-duration=1000000 ! appsink name=sink")
    p.play_until_eos()
    return p.by_name("sink").samples


@pytest.mark.parametrize("run", range(20))
def test_two_queues_into_one_aggregator_keep_order(run):
    result, errors = [], []

    def target():
        try:
            result.append(_mixer_run())
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
    assert not t.is_alive(), f"run {run}: the pipeline did not finish in {RUN_TIMEOUT_S} s"
    assert not errors, errors
    samples = result[0]
    pts = [s.buffer.pts for s in samples]
    assert all(b > a for a, b in zip(pts, pts[1:])), f"run {run}: PTS out of order: {pts}"
    frames = sum(int(np.asarray(s.buffer.data).shape[0]) for s in samples)
    assert frames == BUFFERS * SPB, f"run {run}: {frames} frames out, {BUFFERS * SPB} in"
    assert pts[0] == 0 and pts[-1] == (frames - SPB) * 10**9 // RATE
