"""The port's fallbackswitch and livesync on torch payloads, and against the
JAX elements on the same seeded streams.

livesync works on the payload where it lies: the sample count comes from
the tensor's shape, a single-segment clip is a view of the tensor, and the
silence and resized repeats are zeros of the payload's dtype on its device.
fallbackswitch hands the active input's buffer objects on.  The parity
cases drive both packages through the JAX test files' own helpers
(tests/test_livesync.py, tests/test_fallbackswitch.py) on a TestClock, so
every slot comes out at a cranked deadline, not on the wall clock.
"""
import numpy as np
import pytest
import torch

from torch_parity_helpers import buffer_summary, load_test_module, port_on_cpu

LS = {"jax": load_test_module("test_livesync.py", port=False),
      "port": load_test_module("test_livesync.py", port=True)}
FS = {"jax": load_test_module("test_fallbackswitch.py", port=False),
      "port": load_test_module("test_fallbackswitch.py", port=True)}
MS = 1_000_000
SLOT = 100 * MS
RATE = 48000


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def _audio(n, samples=4800, tensor=False, dtype=np.float32):
    data = np.random.default_rng(n).standard_normal((samples, 2)).astype(dtype)
    return torch.from_numpy(data) if tensor else data


def _livesync_run(pkg, tensor, single_segment, stall=(5, 8), dtype=np.float32,
                  wrong_duration=False):
    """Ten 100 ms stereo buffers of seeded noise with an upstream stall over
    slots `stall`: returns the output buffers and the input payloads."""
    ns = LS[pkg]
    tc, ls, h = ns["_mk"](single_segment, latency=0)
    h.set_src_caps(ns["Caps"].builder("audio/x-raw", format="F32", rate=RATE, channels=2,
                                      layout="interleaved"))
    sent, out = [], []

    def push(i):
        data = _audio(i, tensor=tensor, dtype=dtype)
        sent.append(data)
        dur = SLOT + 7 * MS if wrong_duration else SLOT
        h.push(ns["Buffer"](data, pts=i * SLOT, duration=dur, offset=i * 4800))

    push(0)  # one buffer ahead of the slots, as the reference's test feeds
    for i in range(1, 10):
        if not stall[0] <= i < stall[1]:
            push(i)
        assert tc.crank()
        out += h.pull_all()
    h.push_eos()
    while tc.crank():
        out += h.pull_all()
    out += h.pull_all()
    return out, sent


@pytest.mark.parametrize("single_segment", [False, True])
@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_livesync_matches_jax(payload, single_segment):
    ref, _ = _livesync_run("jax", False, single_segment)
    got, _ = _livesync_run("port", payload == "torch", single_segment)
    assert any(b.flags.value & LS["jax"]["BufferFlags"].GAP.value for b in ref)
    assert [buffer_summary(b) for b in got] == [buffer_summary(b) for b in ref]


def test_livesync_repairs_durations_from_tensor_shapes():
    """A duration that disagrees with the sample count is rebuilt from the
    tensor's shape, as the JAX element does from the array's."""
    ref, _ = _livesync_run("jax", False, False, wrong_duration=True)
    got, _ = _livesync_run("port", True, False, wrong_duration=True)
    assert all(b.duration == SLOT for b in got)
    assert [buffer_summary(b) for b in got] == [buffer_summary(b) for b in ref]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_livesync_fills_are_zero_tensors_where_the_payload_lies(dtype):
    got, sent = _livesync_run("port", True, False, dtype=dtype)
    gaps = [b for b in got if b.flags.value & LS["port"]["BufferFlags"].GAP.value]
    assert len(gaps) == 3
    for b in gaps:
        assert isinstance(b.data, torch.Tensor) and b.data.dtype == torch.from_numpy(
            np.zeros(1, dtype)).dtype and b.data.device == sent[0].device
        assert tuple(b.data.shape) == (4800, 2) and not b.data.any()
    passed = [b for b in got if not b.flags.value & LS["port"]["BufferFlags"].GAP.value]
    assert [b.data for b in passed] == sent  # the same tensor objects


def _clip_run(pkg, tensor):
    ns = LS[pkg]
    tc, ls, h = ns["_mk"](True, latency=0)
    h.set_src_caps(ns["Caps"].builder("audio/x-raw", format="F32", rate=RATE, channels=2,
                                      layout="interleaved"))
    seg = ns["Segment"]()
    seg.start = 50 * MS
    h.push_event(ns["Event"].new_segment(seg))
    data = _audio(0, tensor=tensor)
    h.push(ns["Buffer"](data, pts=0, duration=SLOT))
    assert tc.crank()
    return h.pull_all(), data


def test_livesync_single_segment_clip_is_a_view():
    """In single-segment mode a buffer straddling the segment start is cut
    to a view of the incoming tensor; the slot after it repeats as zeros of
    the clip's length.  The JAX element gives the same buffers."""
    out, data = _clip_run("port", True)
    ref, _ = _clip_run("jax", False)
    assert out[0].data._base is data
    assert tuple(out[0].data.shape) == (2400, 2) and out[0].duration == 50 * MS
    assert torch.equal(out[0].data, data[2400:])
    assert all(isinstance(b.data, torch.Tensor) and not b.data.any() for b in out[1:])
    assert [buffer_summary(b) for b in out] == [buffer_summary(b) for b in ref]


def _fallback_run(pkg, tensor):
    """Main frames at 0-3 s, a stall, fallback frames from 2 s on, main back
    at 9 s: the reference's failover-and-recovery timeline."""
    ns = FS[pkg]
    c = ns["Ctx"]()
    mk = (lambda h, w, i: torch.full((h, w, 4), i, dtype=torch.uint8)) if tensor else \
        (lambda h, w, i: np.full((h, w, 4), i, np.uint8))
    S = ns["SECOND"]
    sent = []
    for t in range(12):
        c.tc.set_time(t * S)
        if t < 4 or t >= 9:
            b = ns["Buffer"](mk(240, 320, t), pts=t * S, duration=S)
            sent.append(b)
            c.fmain.push(b)
        if t >= 2:
            b = ns["Buffer"](mk(120, 160, 100 + t), pts=t * S, duration=S)
            sent.append(b)
            c.ffallback.push(b)
    return c.out, sent


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_fallbackswitch_matches_jax(payload):
    ref, _ = _fallback_run("jax", False)
    got, sent = _fallback_run("port", payload == "torch")
    assert {b.data.shape for b in ref} == {(240, 320, 4), (120, 160, 4)}  # it switched
    assert [buffer_summary(b) for b in got] == [buffer_summary(b) for b in ref]
    assert all(any(b is s for s in sent) for b in got)  # the input buffers themselves
