"""The port's fallbacksrc against tests/test_fallbacksrc.py (each of its tests
runs on the port, with the same inputs and the same assertions), and on the
port's device: the dummy audio and video streams are tensors on `device()`,
so a fallbackswitch never mixes host and device payloads on one output,
while the dummy byte stream stays host bytes.  Each run waits for its
buffers with a limit of its own (the JAX file's `collect`)."""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import load_test_module, mirror_jax_tests, port_on_cpu

JAX = load_test_module("test_fallbacksrc.py", port=False)
PORT = load_test_module("test_fallbacksrc.py", port=True)
MS = 1_000_000


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_fallbacksrc.py", globals())


def _dummy(ns, tmp_path, **props):
    p, src, sink = ns["build"](**{"uri": f"file://{tmp_path}/missing.bin",
                                  "restart-timeout": 20 * MS, "timeout": 50 * MS, **props})
    p.set_state(ns["State"].PLAYING)
    ns["collect"](sink, 2)
    samples = list(sink.samples[:2])
    p.set_state(ns["State"].NULL)
    return samples


@pytest.mark.parametrize("kind", ["audio", "video"])
def test_dummy_streams_are_device_tensors(tmp_path, kind):
    props = {} if kind == "audio" else {
        "enable-audio": False,
        "dummy-video-caps": "video/x-raw,format=RGB,width=16,height=8,framerate=50/1"}
    got, ref = _dummy(PORT, tmp_path, **props), _dummy(JAX, tmp_path, **props)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert isinstance(a.buffer.data, torch.Tensor)
        assert a.buffer.data.device == tfx.device()
        ref_data = np.asarray(b.buffer.data)
        assert a.buffer.data.numpy().dtype == ref_data.dtype
        assert a.buffer.data.shape == ref_data.shape and not a.buffer.data.any()
        # the first slot out depends on the wall clock; the slot grid does not
        assert a.buffer.duration == b.buffer.duration
        assert a.buffer.pts % a.buffer.duration == b.buffer.pts % b.buffer.duration == 0
        assert str(a.caps) == str(b.caps)
