"""The port's togglerecord on torch payloads, and against the JAX element on
the same seeded streams.

The JAX element clips raw audio only when the payload is a numpy array; the
port must clip torch tensors too, to a view of the incoming tensor, or it
stops clipping at every record toggle.  The streams are driven by the JAX
test file's own driver (tests/test_togglerecord.py: one thread a stream),
compiled once for each package.  Each test's threads have their own time
limit (the driver's join).
"""
import numpy as np
import pytest
import torch

from torch_parity_helpers import buffer_summary, load_test_module, port_on_cpu

JAX = load_test_module("test_togglerecord.py", port=False)
PORT = load_test_module("test_togglerecord.py", port=True)
MS = 1_000_000
RATE = 48000


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def _audio(seed, n, tensor):
    data = np.random.default_rng(seed).standard_normal((n, 2)).astype(np.float32)
    return torch.from_numpy(data) if tensor else data


def _scenario(ns, payload, main_eos_at=None):
    """One main stream of 10 ms keyframes and a stereo F32 secondary of 20 ms
    buffers from live upstreams; record on at 10 ms, off at 40 ms, on again
    at 70 ms (so the secondary straddles every boundary), the main stream
    ending at `main_eos_at` ms if given.  Returns the element, both drivers
    and the secondary's input payloads."""
    core = ns["Caps"]
    tr, main, (sec,) = ns["_make"](record=False, n_secondary=1)
    sec.set_caps(core.builder("audio/x-raw", format="F32", rate=RATE, channels=2,
                              layout="interleaved"))
    toggle = lambda v: (lambda: tr.set_property("record", v))  # noqa: E731
    actions = [ns["_buf"](0), toggle(True), ns["_buf"](10), ns["_buf"](20), ns["_buf"](30),
               toggle(False), ns["_buf"](40), ns["_buf"](50), ns["_buf"](60), toggle(True),
               ns["_buf"](70), ns["_buf"](80)]
    if main_eos_at is not None:
        actions = [a for a in actions if not isinstance(a, ns["Buffer"])
                   or a.pts < main_eos_at * MS]
    actions.append(ns["Event"].new_eos())
    main.run(actions)
    payloads = [_audio(t, 960, payload == "torch") for t in range(0, 100, 20)]
    sec.run([ns["Buffer"](d, pts=t * MS, duration=20 * MS)
             for t, d in zip(range(0, 100, 20), payloads)] + [ns["Event"].new_eos()])
    main.join()
    sec.join()
    return tr, main, sec, payloads


def _shares_storage(view, base):
    return view.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()


def test_clips_torch_audio_to_views():
    """Clipped tensor buffers are views of the incoming tensors with the
    JAX element's sample counts; the JAX element's numpy clip is the
    reference."""
    _, _, sec, payloads = _scenario(PORT, "torch")
    _, _, jsec, jpayloads = _scenario(JAX, "numpy")
    lens = [b.data.shape[0] for b in sec.buffers]
    assert lens == [b.data.shape[0] for b in jsec.buffers]
    assert any(n < 960 for n in lens), "no buffer was clipped"
    for out in sec.buffers:
        assert isinstance(out.data, torch.Tensor)
        base = next(p for p in payloads if _shares_storage(out.data, p))
        if out.data.shape[0] < 960:
            assert out.data._base is base  # a view, not a copy
        np.testing.assert_array_equal(out.data.numpy(), np.asarray(
            jsec.buffers[sec.buffers.index(out)].data))


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("main_eos_at", [None, 60, 50])
def test_togglerecord_matches_jax(payload, main_eos_at):
    """Both streams' buffers (payload bytes, PTS, duration, flags) and the
    secondary's flow returns equal the JAX element's on the same input."""
    _, jmain, jsec, _ = _scenario(JAX, "numpy", main_eos_at)
    _, main, sec, _ = _scenario(PORT, payload, main_eos_at)
    assert [buffer_summary(b) for b in main.buffers] == [buffer_summary(b) for b in jmain.buffers]
    assert [buffer_summary(b) for b in sec.buffers] == [buffer_summary(b) for b in jsec.buffers]
    assert [r.value for r in sec.returns] == [r.value for r in jsec.returns]
    assert [e.type.value for e in sec.events] == [e.type.value for e in jsec.events]


def test_passes_buffer_objects_outside_a_cut():
    """Outside a cut the main stream's buffers leave as they came in (the
    same objects), payload included."""
    tr, main, _ = PORT["_make"](record=True)
    sent = [PORT["Buffer"](torch.arange(4, dtype=torch.uint8) + i, pts=i * 10 * MS,
                           duration=10 * MS) for i in range(4)]
    main.run(sent + [PORT["Event"].new_eos()])
    main.join()
    assert main.buffers[0].data is sent[0].data
    assert all(a is b for a, b in zip(main.buffers[1:], sent[1:]))
