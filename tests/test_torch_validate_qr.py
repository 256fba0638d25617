"""The port's QR codec (codecs/qr.py) and validate action (utils/validate.py)
against the JAX package's.

tests/test_validate_qr.py runs on the port with the same inputs and
assertions.  Then: qr.encode gives the JAX package's matrices, each
package decodes the other's raster, and check-last-frame-qrcode reads a
tensor frame back once, the last one only."""
import json

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.codecs import qr as jqr
from gst_plugins_rs_tpu.utils import validate as jvalidate
from gst_plugins_rs_tpu_torch.codecs import qr
from gst_plugins_rs_tpu_torch.utils import validate
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_validate_qr.py", globals())

TEXTS = ["", "a", "hello world", "x" * 17, "y" * 30, "HELLO-123 $%", "z" * 70,
         json.dumps({"frames": 32, "seed": 103}, sort_keys=True), "été ✓",
         "w" * 60]


@pytest.mark.parametrize("text", TEXTS)
def test_encode_matrices_equal_the_jax_packages(text):
    """The same version, mask and modules for every length class (versions
    1-4), byte-mode text with non-ASCII UTF-8 included."""
    m = qr.encode(text)
    assert m.dtype == jqr.encode(text).dtype and np.array_equal(m, jqr.encode(text))
    assert np.array_equal(qr.rasterize(m, module_px=3, quiet=2),
                          jqr.rasterize(m, module_px=3, quiet=2))


@pytest.mark.parametrize("text", TEXTS[1:])
@pytest.mark.parametrize("module_px", [1, 4])
def test_each_package_decodes_the_others_raster(text, module_px):
    port_img = qr.rasterize(qr.encode(text), module_px=module_px)
    jax_img = jqr.rasterize(jqr.encode(text), module_px=module_px)
    assert qr.decode(jax_img) == text and jqr.decode(port_img) == text
    rgb = np.repeat(port_img[..., None], 3, -1)
    assert qr.decode(rgb) == jqr.decode(rgb) == text


def test_errors_equal_the_jax_packages():
    for fn, jfn, arg in ((qr.encode, jqr.encode, "a" * 200),
                         (qr.decode, jqr.decode, np.full((50, 50), 255, np.uint8))):
        with pytest.raises(ValueError) as got:
            fn(arg)
        with pytest.raises(ValueError) as ref:
            jfn(arg)
        assert str(got.value) == str(ref.value)


def _qr_frames(pkg, text, tensor):
    """Three RGB frames through appsrc ! appsink in `pkg`: two plain, the
    last white with the QR of `text` at (10, 10)."""
    img = qr.rasterize(qr.encode(text), module_px=4)
    frame = np.full((240, 320, 3), 255, np.uint8)
    frame[10:10 + img.shape[0], 10:10 + img.shape[1]] = img[..., None]
    frames = [np.zeros((240, 320, 3), np.uint8), np.full((240, 320, 3), 40, np.uint8), frame]
    p = pkg.parse_launch("appsrc name=src ! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(
        "video/x-raw,format=RGB,width=320,height=240,framerate=1/1"))
    for f in frames:
        p.by_name("src").push_buffer(pkg.Buffer(torch.from_numpy(f) if tensor else f))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return p


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_action_on_the_jax_packages_frames(payload):
    """check-last-frame-qrcode on the same frames: the same decoded text,
    and the same errors, in both packages."""
    record = json.dumps({"frames": 3, "seed": 7}, sort_keys=True)
    p = _qr_frames(tfx, record, payload == "torch")
    jp = _qr_frames(fx, record, False)
    got = validate.run_action("check-last-frame-qrcode", p, sink_name="sink",
                              expected_fields={"seed": 7, "frames": 3})
    assert got == jvalidate.run_action("check-last-frame-qrcode", jp, sink_name="sink",
                                       expected_fields={"seed": 7, "frames": 3}) == record
    for kwargs in ({"expected_text": "other"}, {"expected_fields": {"seed": 8}},
                   {"sink_name": "nope"}):
        with pytest.raises(validate.ValidateError) as e:
            validate.check_last_frame_qrcode(p, **kwargs)
        with pytest.raises(jvalidate.ValidateError) as je:
            jvalidate.check_last_frame_qrcode(jp, **kwargs)
        assert str(e.value) == str(je.value)
    with pytest.raises(KeyError):
        validate.run_action("check-everything", p)


def test_action_reads_the_last_frame_back_once(monkeypatch):
    """Only the last frame is read back, once, through core/payload.py's
    host_array: a frame on the card crosses to the host at the end of the
    run and no buffer before it does."""
    p = _qr_frames(tfx, "once", tensor=True)
    seen = []
    real = validate.host_array

    def counted(data, dtype=None):
        seen.append(data)
        return real(data, dtype)

    monkeypatch.setattr(validate, "host_array", counted)
    assert validate.check_last_frame_qrcode(p, expected_text="once") == "once"
    assert len(seen) == 1 and seen[0] is p.by_name("sink").samples[-1].buffer.data
