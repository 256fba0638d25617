"""hsvfilter / hsvdetector of the PyTorch port against the JAX package, on
the CPU.

On the CPU the port's kernel B4 (ops/hsv_planes.py) runs its plain
version; it is held against the JAX Pallas kernel in interpret mode, as
tests/test_pallas_hsv.py runs it.  The port's hsvfilter element runs
through B4, where the JAX element runs the XLA op `hsv_filter_frame`; the
elements are compared end to end, and against the NumPy oracle of the
reference math in tests/test_hsv.py.  The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerances:
- B4 planes, port (plain) vs Pallas: max abs <= 1e-6 (the same f32
  operations; XLA may contract a product and a sum into one FMA);
- frames, port vs JAX and vs the oracle: <= 1 u8 LSB, the documented gate
  of tests/test_hsv.py and test_pallas_hsv.py (u8 truncation boundaries
  depend on the order of f32 operations);
- hsvdetector: RGB copied exactly; the alpha mask equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core import Buffer as JBuffer
from gst_plugins_rs_tpu.core import Caps as JCaps
from gst_plugins_rs_tpu.core import Fraction as JFraction
from gst_plugins_rs_tpu.core import Harness as JHarness
from gst_plugins_rs_tpu.core import element_factory_make as jmake
from gst_plugins_rs_tpu.ops import hsv as jhsv
from gst_plugins_rs_tpu.ops.pallas_hsv import hsv_filter_pallas

from gst_plugins_rs_tpu_torch.core import Buffer as TBuffer
from gst_plugins_rs_tpu_torch.core import Caps as TCaps
from gst_plugins_rs_tpu_torch.core import Fraction as TFraction
from gst_plugins_rs_tpu_torch.core import Harness as THarness
from gst_plugins_rs_tpu_torch.core import element_factory_make as tmake
from gst_plugins_rs_tpu_torch.ops import hsv as thsv
from gst_plugins_rs_tpu_torch.ops import hsv_planes
from test_hsv import oracle_filter, oracle_rgb_to_hsv


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tfx.requested_device()
    tfx.set_device("cpu")
    yield
    tfx.set_device(prev)


JPKG = (jmake, JHarness, JBuffer, JCaps, JFraction)
TPKG = (tmake, THarness, TBuffer, TCaps, TFraction)


def _run(pkg, factory, frame, fmt, **props):
    make, harness, buffer, caps, frac = pkg
    elem = make(factory)
    for k, v in props.items():
        elem.set_property(k.replace("_", "-"), v)
    h = harness(elem)
    hh, ww = frame.shape[:2]
    h.set_src_caps(caps.builder("video/x-raw", format=fmt, width=ww, height=hh,
                                framerate=frac(30, 1)))
    h.push(buffer(torch.from_numpy(frame) if pkg is TPKG else frame, pts=0))
    out = h.pull().data
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _max_lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _frame(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


_PARAMS = [
    [123.0, 1.1, -0.05, 0.95, 0.02],
    [45.0, 1.0, 0.0, 1.0, 0.0],
    [0.0, 1.0, 0.0, 1.0, 0.0],
    [359.5, 0.5, 0.2, 1.2, -0.1],
]


@pytest.mark.parametrize("params", _PARAMS)
@pytest.mark.parametrize("shape", [(64, 512), (50, 300)])
def test_b4_plain_matches_jax_kernel(params, shape):
    """B4: the port's plain version against the Pallas kernel (interpret
    mode) on the same planes, then both quantized against the XLA op."""
    frame = _frame(shape + (3,), 3)
    frame[0, :6] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                    [128, 128, 128]]
    planes = [frame[..., i].astype(np.float32) / np.float32(255.0) for i in range(3)]
    ref = hsv_filter_pallas(*(jnp.asarray(p) for p in planes),
                            jnp.asarray(params, jnp.float32), interpret=True)
    before = hsv_planes.launches
    got = hsv_planes.hsv_filter_planes(*(torch.from_numpy(p) for p in planes),
                                       torch.tensor(params, dtype=torch.float32))
    assert hsv_planes.launches == before  # a CPU tensor runs the plain version
    for r, g in zip(ref, got):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        assert float(np.abs(np.asarray(r) - g.numpy()).max()) <= 1e-6
    q = np.stack([np.clip(g.numpy() * 255.0, 0, 255).astype(np.uint8) for g in got], -1)
    xla = np.asarray(jhsv.hsv_filter_frame(jnp.asarray(frame), jnp.asarray(params, jnp.float32),
                                           offsets=(0, 1, 2)))
    assert _max_lsb(q, xla) <= 1


@pytest.mark.parametrize("params", _PARAMS)
def test_hsv_filter_frame_matches_jax(params):
    frame = _frame((31, 17, 4), 1)
    ref = np.asarray(jhsv.hsv_filter_frame(jnp.asarray(frame), jnp.asarray(params, jnp.float32),
                                           offsets=(2, 1, 0)))
    got = thsv.hsv_filter_frame(torch.from_numpy(frame), torch.tensor(params),
                                offsets=(2, 1, 0)).numpy()
    assert _max_lsb(ref, got) <= 1 and np.array_equal(got[..., 3], frame[..., 3])


def test_rgb_hsv_conversions_match_jax():
    frame = _frame((40, 40, 3), 2)
    planes = [frame[..., i].astype(np.float32) / np.float32(255.0) for i in range(3)]
    ref = jhsv.rgb_to_hsv(*(jnp.asarray(p) for p in planes))
    got = thsv.rgb_to_hsv(*(torch.from_numpy(p) for p in planes))
    oracle = oracle_rgb_to_hsv(frame)
    for r, g, o in zip(ref, got, oracle):
        assert float(np.abs(np.asarray(r) - g.numpy()).max()) <= 1e-4
        assert float(np.abs(o - g.numpy()).max()) <= 1e-4
    back_ref = jhsv.hsv_to_rgb(*ref)
    back = thsv.hsv_to_rgb(*got)
    for r, g, p in zip(back_ref, back, planes):
        assert float(np.abs(np.asarray(r) - g.numpy()).max()) <= 1e-5
        assert float(np.abs(p - g.numpy()).max()) <= 1e-5


_FILTER_CASES = [
    ("RGB", {}),                                        # test_identity_params_roundtrip
    ("RGB", {"hue_shift": 90.0}),                       # test_hue_shift_matches_oracle
    ("RGB", {"saturation_mul": 0.5, "saturation_off": 0.2,
             "value_mul": 1.2, "value_off": -0.1}),     # test_sat_value_transform
    ("RGBA", {"hue_shift": 45.0, "value_mul": 0.7}),    # test_alpha_channel_untouched
    ("BGRA", {"hue_shift": 120.0}),                     # test_bgra_format_offsets
    ("xRGB", {"hue_shift": -30.0, "saturation_mul": 1.2}),
    ("BGR", {"hue_shift": 400.0, "value_off": 0.02}),
]


@pytest.mark.parametrize("fmt,props", _FILTER_CASES)
def test_filter_element_matches_jax(fmt, props):
    channels = 3 if fmt in ("RGB", "BGR") else 4
    frame = _frame((23, 19, channels), len(props) + channels)
    before = hsv_planes.launches
    got = _run(TPKG, "hsvfilter", frame, fmt, **props)
    assert hsv_planes.launches == before
    ref = _run(JPKG, "hsvfilter", frame, fmt, **props)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    assert _max_lsb(ref, got) <= 1
    if channels == 4:
        other = {"RGBA": 3, "BGRA": 3, "xRGB": 0}[fmt]
        assert np.array_equal(got[..., other], frame[..., other])
    if fmt == "RGB":
        p = {"hue_shift": 0.0, "saturation_mul": 1.0, "saturation_off": 0.0,
             "value_mul": 1.0, "value_off": 0.0, **props}
        oracle = oracle_filter(frame, p["hue_shift"], p["saturation_mul"], p["saturation_off"],
                               p["value_mul"], p["value_off"])
        assert _max_lsb(oracle, got) <= 1
        if not props:
            assert _max_lsb(frame, got) <= 1


def test_pure_colors_hue_shift_exact():
    """test_hsv.py::test_pure_colors_hue_shift_exact through the port."""
    frame = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255]]], np.uint8)
    out = _run(TPKG, "hsvfilter", frame, "RGB", hue_shift=120.0)
    assert out[0].tolist() == [[0, 255, 0], [0, 0, 255], [255, 0, 0]]
    frame = np.zeros((2, 2, 4), np.uint8)
    frame[..., 2], frame[..., 3] = 255, 200
    out = _run(TPKG, "hsvfilter", frame, "BGRA", hue_shift=120.0)
    assert tuple(out[0, 0]) == (0, 255, 0, 200)


def test_filter_leaves_source_frame_untouched():
    """videotestsrc hands one tensor to all its buffers; hsvfilter rebinds
    buf.data to a new frame and never writes into that tensor."""
    p = tfx.parse_launch("videotestsrc pattern=smpte num-buffers=2 "
                         "! video/x-raw,format=RGBA,width=32,height=8 "
                         "! hsvfilter hue-shift=90 value-mul=0.5 ! appsink name=sink")
    src = p.sources()[0]
    p.set_state(tfx.State.PLAYING)
    p.run()
    frame = src._frame
    samples = p.by_name("sink").samples
    before = torch.from_numpy(src._render_pattern())
    p.set_state(tfx.State.NULL)
    assert len(samples) == 2
    assert all(s.buffer.data is not frame for s in samples)
    assert torch.equal(frame, before)
    outs = [s.buffer.data for s in samples]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], before)
    assert all(o.data_ptr() != frame.data_ptr() for o in outs)
    assert outs[0].data_ptr() != outs[1].data_ptr()


_DETECT_CASES = [
    ("RGB", dict(hue_ref=0.0, hue_var=10.0, saturation_ref=1.0, saturation_var=0.2,
                 value_ref=1.0, value_var=0.2)),           # test_detector_red_reference
    ("RGB", dict(hue_ref=0.0, hue_var=15.0, saturation_ref=1.0, saturation_var=0.1,
                 value_ref=1.0, value_var=0.1)),           # test_detector_hue_wraparound
    ("BGRx", dict(hue_ref=120.0, hue_var=60.0, saturation_ref=0.5, saturation_var=0.5,
                  value_ref=0.5, value_var=0.5)),
    ("xBGR", dict(hue_ref=300.0, hue_var=90.0, saturation_ref=0.3, saturation_var=0.3,
                  value_ref=0.6, value_var=0.4)),
]


@pytest.mark.parametrize("in_fmt,props", _DETECT_CASES)
def test_detector_element_matches_jax(in_fmt, props):
    channels = 3 if in_fmt in ("RGB", "BGR") else 4
    frame = _frame((16, 20, channels), 9)
    frame[0, :4, :3] = [[255, 0, 0], [250, 10, 5], [0, 255, 0], [128, 128, 128]]
    frame[0, 4, :3] = [255, 0, 42]  # hue ~350, across the wrap from 0
    ref = _run(JPKG, "hsvdetector", frame, in_fmt, **props)
    got = _run(TPKG, "hsvdetector", frame, in_fmt, **props)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (16, 20, 4)
    assert np.array_equal(got, ref)  # RGB copied, the same alpha mask
    assert set(np.unique(got[..., 3]).tolist()) == {0, 255}
    if in_fmt == "RGB":  # red and near-red in, green and grey out, hue ~350 in
        assert got[0, :5, 3].tolist() == [255, 255, 0, 0, 255]
