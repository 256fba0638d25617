"""handdetectiontensordec of the PyTorch port against the JAX element, on the CPU.

Mirrors of tests/test_handdetection.py: each scenario goes through both
elements on the same tensor, and the oriented boxes (id, type, x, y, w, h,
rotation, confidence), the classifications and the relations must be
equal (host float64 arithmetic on both sides).  The port also takes the
tensor as a torch tensor (read back once a buffer), as it arrives from a
device; a seeded 2 016-row tensor (MediaPipe's anchor count) at 1920x1080
covers the full-size decode.
"""
import math

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu.core as jcore
import gst_plugins_rs_tpu.elements.analytics.meta as jmeta
import gst_plugins_rs_tpu_torch.core as tcore
import gst_plugins_rs_tpu_torch.elements.analytics.meta as tmeta
from gst_plugins_rs_tpu_torch.elements.analytics.handdetection import OrientedOdMtd
from torch_parity_helpers import port_on_cpu


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def make_row(score, cx, cy, size, rot_deg=0.0):
    """A detection row whose keypoints encode the rotation (as
    tests/test_handdetection.py builds it)."""
    ang = math.radians(rot_deg)
    dx, dy = 0.5 * size * math.cos(ang), 0.5 * size * math.sin(ang)
    return [score, cx, cy, size, cx, cy, cx + dx, cy + dy]


def palm_rows(seed, n=2016):
    """n seeded rows: mostly low scores, a few hands with valid geometry."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0] = rng.uniform(0.0, 0.3, n)
    rows[:, 1:3] = rng.uniform(0.0, 1.0, (n, 2))
    rows[:, 3] = rng.uniform(0.02, 0.3, n)
    ang = rng.uniform(-math.pi, math.pi, n)
    span = rows[:, 3] * rng.uniform(0.2, 1.4, n)
    rows[:, 4:6] = rows[:, 1:3]
    rows[:, 6] = rows[:, 1] + span * np.cos(ang)
    rows[:, 7] = rows[:, 2] + span * np.sin(ang)
    hot = rng.choice(n, 12, replace=False)
    rows[hot, 0] = rng.uniform(0.5, 0.99, hot.size)
    return rows


def _run(core, meta, rows, width, height, props, as_tensor=False):
    elem = core.element_factory_make("handdetectiontensordec")
    for k, v in props.items():
        elem.set_property(k.replace("_", "-"), v)
    h = core.Harness(elem)
    h.set_src_caps(core.Caps.builder("video/x-raw", format="RGB", width=width, height=height,
                                     framerate=core.Fraction(30, 1)))
    buf = core.Buffer(np.zeros((height, width, 3), np.uint8), pts=0)
    arr = np.asarray(rows, np.float32)
    data = torch.from_numpy(arr) if as_tensor else arr
    buf.add_meta(meta.TensorMeta([meta.Tensor("palm-detection-out", meta.TensorDataType.FLOAT32,
                                              arr.shape, meta.TensorDimOrder.ROW_MAJOR, data)]))
    h.push(buf)
    return h.pull().get_meta(meta.AnalyticsRelationMeta)


def _summary(m):
    if m is None:
        return None
    od = [(o.id, o.object_type, o.x, o.y, o.w, o.h, o.rotation, o.loc_conf_lvl) for o in m.od]
    cls = [sorted((k, repr(v)) for k, v in vars(c).items()) for c in m.cls]
    rel = [(r.name, a, b) for r, a, b in m.relations]
    return repr((od, cls, rel))  # repr: a NaN score compares equal to itself


def both(rows, width=640, height=480, as_tensor=False, **props):
    ref = _run(jcore, jmeta, rows, width, height, props)
    got = _run(tcore, tmeta, rows, width, height, props, as_tensor)
    assert _summary(got) == _summary(ref)
    return got


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_basic_detection(as_tensor):
    m = both([make_row(0.9, 0.5, 0.5, 0.1)], as_tensor=as_tensor)
    assert m is not None and len(m.od) == 1
    od = m.od[0]
    assert od.object_type == "hand" and 180 <= od.w <= 190
    assert isinstance(od, OrientedOdMtd)
    assert od.loc_conf_lvl == pytest.approx(0.9)
    assert len(m.cls) == 1 and m.relations[0][0].name == "RELATE_TO"


def test_confidence_threshold():
    assert len(both([make_row(0.1, 0.5, 0.5, 0.1)]).od) == 0


@pytest.mark.parametrize("size", [0.01, 0.6])
def test_size_window_rejects(size):
    assert len(both([make_row(0.9, 0.5, 0.5, size)]).od) == 0


def test_nms_and_max_hands():
    rows = [make_row(0.9, 0.5, 0.5, 0.1), make_row(0.8, 0.51, 0.5, 0.1),
            make_row(0.7, 0.15, 0.2, 0.1), make_row(0.6, 0.8, 0.8, 0.1)]
    m = both(rows, max_hands=2)
    assert [round(o.loc_conf_lvl, 6) for o in m.od] == [0.9, 0.7]


@pytest.mark.parametrize("rot", [30.0, -120.0])
def test_rotation_reported(rot):
    m = both([make_row(0.9, 0.5, 0.5, 0.1, rot_deg=rot)])
    assert len(m.od) == 1
    expect = math.remainder(math.radians(rot), 2 * math.pi)
    assert math.remainder(m.od[0].rotation - expect, 2 * math.pi) == pytest.approx(0, abs=0.05)


def test_no_tensor_is_passthrough():
    for core, meta in ((jcore, jmeta), (tcore, tmeta)):
        h = core.Harness(core.element_factory_make("handdetectiontensordec"))
        h.set_src_caps(core.Caps.builder("video/x-raw", format="RGB", width=64, height=64,
                                         framerate=core.Fraction(30, 1)))
        h.push(core.Buffer(np.zeros((64, 64, 3), np.uint8), pts=0))
        assert h.pull().get_meta(meta.AnalyticsRelationMeta) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_full_size_anchor_tensor(seed, as_tensor):
    """2 016 seeded rows on a 1920x1080 stream, max-hands 8."""
    m = both(palm_rows(seed), 1920, 1080, as_tensor=as_tensor, max_hands=8)
    assert len(m.od) >= 1


def test_nan_rows_match():
    rows = palm_rows(5, 64)
    rows[3, 0] = np.nan
    rows[7, 1] = np.nan
    both(rows, 1920, 1080, max_hands=8)


def test_properties_match_jax():
    a = jcore.element_factory_make("handdetectiontensordec")
    b = tcore.element_factory_make("handdetectiontensordec")
    assert {p.name: p.default for p in a._all_props()} == {p.name: p.default
                                                           for p in b._all_props()}
