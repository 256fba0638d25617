"""The scalers, compositor and frame-analysis elements of the PyTorch port
against the JAX package, on the CPU: videoscale, videoconvertscale,
skiacompositor, roundedcorners, colordetect and videocompare, with their
operators (ops/resize.py, ops/image_resize.py, ops/palette.py,
ops/imagehash.py).

Mirrors tests/test_videoscale.py (12), tests/test_compositor.py (4),
tests/test_roundedcorners.py (4), tests/test_videofx.py (8) and
skiacompositor's pad properties from tests/test_pad_properties.py: each
scenario runs through both packages, the port's output is held to the
JAX test's own assertions and to the JAX package's output.

Gates and why:

- u8 frames within U8_LSB = 1: the port's products sum in another order
  than XLA's (and XLA's CPU backend contracts products and sums into FMAs),
  so a value within an f32 rounding of a rounding or truncation boundary may
  land one step away (the compositor's blends too, whatever the resize).
  Nearest resampling (one-hot matrices and gathers), the roundedcorners
  mask and the histograms are exact.
- The weights of `jax.image.resize`: the twin's matrices equal jax's (read
  out by resizing an identity), and the twin's resize of a frame is within
  RESIZE_TOL = 1e-5 of its scale.
- Hash bits exact, except bits whose two compared values lie within
  TIE_REL = 1e-4 of their magnitude (f32 sums in another order): such
  near-ties are named and counted, and their number is reported.

Torch runs on one intra-op thread (tests/torch_parity_helpers.py).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu.core as jcore
import gst_plugins_rs_tpu_torch as tfx
import gst_plugins_rs_tpu_torch.core as tcore
from gst_plugins_rs_tpu.core.parse import parse_caps as jparse_caps
from gst_plugins_rs_tpu.elements.video import compositor as jcomp
from gst_plugins_rs_tpu.elements.video.roundedcorners import rounded_alpha_mask as jmask
from gst_plugins_rs_tpu.ops import imagehash as jhash
from gst_plugins_rs_tpu.ops import palette as jpal
from gst_plugins_rs_tpu.ops import resize as jresize
from gst_plugins_rs_tpu_torch.core.parse import parse_caps as tparse_caps
from gst_plugins_rs_tpu_torch.elements.video import compositor as tcomp
from gst_plugins_rs_tpu_torch.elements.video.roundedcorners import rounded_alpha_mask as tmask
from gst_plugins_rs_tpu_torch.ops import image_resize as tir
from gst_plugins_rs_tpu_torch.ops import imagehash as thash
from gst_plugins_rs_tpu_torch.ops import palette as tpal
from gst_plugins_rs_tpu_torch.ops import resize as tresize
from torch_parity_helpers import port_on_cpu

ROOT = Path(__file__).resolve().parents[1]
U8_LSB = 1
RESIZE_TOL = 1e-5
TIE_REL = 1e-4
CPU = torch.device("cpu")
PKGS = [(jfx, jparse_caps), (tfx, tparse_caps)]


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _host(data):
    if isinstance(data, (tuple, list)):
        return tuple(_host(d) for d in data)
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _lsb(a, b):
    """max |a - b| of two u8 payloads (tuples of planes or frames)."""
    a, b = _host(a), _host(b)
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        return max(_lsb(x, y) for x, y in zip(a, b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max()) if a.size else 0


def _run_both(launch, sink="sink"):
    """The launch through both packages: [(pipeline, samples)] (JAX, port)."""
    out = []
    for pkg, _ in PKGS:
        p = pkg.parse_launch(launch)
        p.play_until_eos()
        out.append((p, p.by_name(sink).samples if sink else None))
    return out


def _same_samples(jsamples, tsamples, lsb=U8_LSB):
    assert len(jsamples) == len(tsamples) > 0
    for js, ts in zip(jsamples, tsamples):
        assert (js.buffer.pts, js.buffer.duration) == (ts.buffer.pts, ts.buffer.duration)
        assert _lsb(js.buffer.data, ts.buffer.data) <= lsb


def _smooth_frame(rng, h, w, c=3):
    """u8 [h, w, c]: a coarse random field upsampled, plus noise (structure
    at several scales, so hashes and resizes see edges and gradients)."""
    coarse = rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1, c))
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(field + rng.normal(0, 12, (h, w, c)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# jax.image.resize's weights (ops/image_resize.py)
# ---------------------------------------------------------------------------
SIZES = [(720, 270), (1280, 480), (33, 8), (8, 33), (1080, 8), (1920, 9), (7, 3), (3, 7),
         (100, 17), (13, 13), (270, 720), (5, 4), (4, 5)]


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_resize_weights_equal_jax(n_in, n_out):
    """Resizing an identity along one axis reads out jax's weight matrix
    (linear) and its gather indices (nearest)."""
    eye = jnp.eye(n_in, dtype=jnp.float32)
    want = np.asarray(jax.image.resize(eye, (n_out, n_in), "linear")).T  # [n_in, n_out]
    got = tir.linear_weights(n_in, n_out)
    assert np.abs(got - want).max() <= 1e-12
    ramp = jnp.arange(n_in, dtype=jnp.float32)[:, None]
    want_idx = np.asarray(jax.image.resize(ramp, (n_out, 1), "nearest"))[:, 0]
    np.testing.assert_array_equal(tir.nearest_indices(n_in, n_out), want_idx.astype(np.int64))


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("shape,size", [((37, 53, 3), (11, 19)), ((12, 9, 4), (31, 26)),
                                         ((40, 30), (9, 9)), ((21, 20, 3), (21, 7))])
def test_resize_matches_jax(method, shape, size):
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), tuple(size) + shape[2:], method))
    got = tir.resize(torch.from_numpy(img), size, method).numpy()
    assert got.shape == want.shape
    if method == "nearest":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= RESIZE_TOL * 255


def test_resize_is_not_interpolate():
    """F.interpolate is another function: its bilinear does not antialias a
    downscale and its nearest reads other pixels."""
    img = torch.from_numpy(_smooth_frame(np.random.RandomState(2), 64, 64, 1)[..., 0]
                           .astype(np.float32))
    ours = tir.resize(img, (8, 8), "linear")
    theirs = torch.nn.functional.interpolate(img[None, None], size=(8, 8), mode="bilinear",
                                             align_corners=False)[0, 0]
    assert float((ours - theirs).abs().max()) > 1.0
    near = tir.nearest_indices(720, 270)
    assert list(near[:3]) == [1, 3, 6] and int(np.floor(1 * 720 / 270)) == 2


# ---------------------------------------------------------------------------
# videoscale / videoconvertscale (tests/test_videoscale.py)
# ---------------------------------------------------------------------------
def test_matrices_are_partitions_of_unity():
    for method in ("bilinear", "nearest"):
        for n_out, n_in in ((720, 1080), (1080, 720), (33, 100), (7, 3)):
            m = tresize.resize_matrix(n_out, n_in, method)
            np.testing.assert_allclose(m.sum(axis=1), 1.0, atol=1e-6)
            np.testing.assert_array_equal(m, jresize.resize_matrix(n_out, n_in, method))


def _both_resizers(h1, w1, h2, w2, method="bilinear"):
    return (jresize.make_resizer(h1, w1, h2, w2, method),
            tresize.make_resizer(h1, w1, h2, w2, method))


def test_identity_is_exact():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (24, 32, 3), np.uint8)
    jr, tr = _both_resizers(24, 32, 24, 32)
    out = tr(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(out, np.asarray(jr(img)))


def test_nearest_2x_is_pixel_repeat():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (8, 12, 3), np.uint8)
    jr, tr = _both_resizers(8, 12, 16, 24, "nearest")
    out = tr(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, np.repeat(np.repeat(img, 2, 0), 2, 1))
    np.testing.assert_array_equal(out, np.asarray(jr(img)))


def _numpy_bilinear(img, h2, w2):
    h1, w1 = img.shape[:2]
    out = np.zeros((h2, w2) + img.shape[2:], np.float64)
    sy = (np.arange(h2) + 0.5) * h1 / h2 - 0.5
    sx = (np.arange(w2) + 0.5) * w1 / w2 - 0.5
    for i, y in enumerate(sy):
        y0 = int(np.floor(y))
        fy = y - y0
        y0c, y1c = np.clip([y0, y0 + 1], 0, h1 - 1)
        for j, x in enumerate(sx):
            x0 = int(np.floor(x))
            fx = x - x0
            x0c, x1c = np.clip([x0, x0 + 1], 0, w1 - 1)
            out[i, j] = ((1 - fy) * (1 - fx) * img[y0c, x0c] + (1 - fy) * fx * img[y0c, x1c]
                         + fy * (1 - fx) * img[y1c, x0c] + fy * fx * img[y1c, x1c])
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h2,w2", [(15, 23), (40, 64)])
def test_bilinear_matches_scalar_oracle(h2, w2):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 30, 3), np.uint8)
    jr, tr = _both_resizers(20, 30, h2, w2, "bilinear")
    got = tr(torch.from_numpy(img)).numpy()
    want = _numpy_bilinear(img.astype(np.float64), h2, w2)
    assert np.max(np.abs(got.astype(int) - want.astype(int))) <= 1
    assert _lsb(got, np.asarray(jr(img))) <= U8_LSB


def test_flat_field_is_invariant():
    img = np.full((30, 40, 3), 137, np.uint8)
    jr, tr = _both_resizers(30, 40, 17, 29)
    out = tr(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(out, np.full((17, 29, 3), 137, np.uint8))
    np.testing.assert_array_equal(out, np.asarray(jr(img)))


def test_pipeline_rgb_downscale():
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=gradient num-buffers=2 "
        "! video/x-raw,format=RGB,width=64,height=48 "
        "! videoscale ! video/x-raw,format=RGB,width=32,height=24 "
        "! appsink name=sink")
    assert len(ts) == 2
    assert tuple(ts[0].buffer.data.shape) == (24, 32, 3)
    _same_samples(js, ts)


def test_pipeline_i420_upscale():
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=smpte num-buffers=1 "
        "! video/x-raw,format=RGB,width=64,height=48 "
        "! videoconvert ! video/x-raw,format=I420 "
        "! videoscale method=nearest ! video/x-raw,format=I420,width=128,height=96 "
        "! appsink name=sink")
    y, u, v = _host(ts[0].buffer.data)
    assert y.shape == (96, 128) and u.shape == (48, 64) and v.shape == (48, 64)
    # nearest copies pixels, and videoconvert's BT.601 step is held within
    # 1 LSB by tests/test_torch_core.py
    _same_samples(js, ts)


def test_videoconvertscale_fused_rgb_to_i420_downscale():
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=red num-buffers=1 "
        "! video/x-raw,format=RGB,width=64,height=48 "
        "! videoconvertscale ! video/x-raw,format=I420,width=32,height=24 "
        "! appsink name=sink")
    y, u, v = _host(ts[0].buffer.data)
    assert y.shape == (24, 32) and u.shape == (12, 16)
    # flat red field: scaling cannot change the BT.601 anchor values
    assert (int(y[5, 5]), int(u[5, 5]), int(v[5, 5])) == (81, 90, 240)
    _same_samples(js, ts, lsb=0)


def test_videoconvertscale_i420_to_packed_upscale():
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=smpte num-buffers=1 "
        "! video/x-raw,format=RGB,width=32,height=24 "
        "! videoconvert ! video/x-raw,format=I420 "
        "! videoconvertscale ! video/x-raw,format=BGRx,width=64,height=48 "
        "! appsink name=sink")
    assert tuple(ts[0].buffer.data.shape) == (48, 64, 4)
    _same_samples(js, ts)


def test_videoconvertscale_passthrough():
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=gradient num-buffers=1 "
        "! video/x-raw,format=RGB,width=16,height=16 "
        "! videoconvertscale ! video/x-raw,format=RGB,width=16,height=16 "
        "! appsink name=sink")
    assert tuple(ts[0].buffer.data.shape) == (16, 16, 3)
    _same_samples(js, ts, lsb=0)


def test_convertscale_planar_to_odd_packed_dims():
    """I420 (even) -> RGB at odd output dims: scaling runs in the packed
    domain after conversion."""
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=smpte num-buffers=1 "
        "! video/x-raw,format=RGB,width=64,height=48 "
        "! videoconvert ! video/x-raw,format=I420 "
        "! videoconvertscale ! video/x-raw,format=RGB,width=33,height=25 "
        "! appsink name=sink")
    assert tuple(ts[0].buffer.data.shape) == (25, 33, 3)
    _same_samples(js, ts)


def test_convertscale_odd_packed_to_planar_dims():
    """RGB at odd input dims -> I420 (even out): scaling runs in the packed
    domain before conversion."""
    (_, js), (_, ts) = _run_both(
        "videotestsrc pattern=smpte num-buffers=1 "
        "! video/x-raw,format=RGB,width=33,height=25 "
        "! videoconvertscale ! video/x-raw,format=I420,width=64,height=48 "
        "! appsink name=sink")
    y, u, v = _host(ts[0].buffer.data)
    assert y.shape == (48, 64) and u.shape == (24, 32)
    _same_samples(js, ts)


@pytest.mark.parametrize("fmt", ["NV12", "RGBA"])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_videoscale_formats_and_methods(fmt, method):
    """Seeded random frames through videoscale (NV12 runs the interleaved
    chroma path) in both packages."""
    frame = _smooth_frame(np.random.RandomState(3), 36, 52, 4)
    outs = []
    for pkg, parse_caps in PKGS:
        p = pkg.parse_launch(
            "appsrc name=src ! videoconvert ! video/x-raw,format=" + fmt
            + f" ! videoscale method={method} ! video/x-raw,width=22,height=18 "
            "! appsink name=sink")
        src = p.by_name("src")
        src.set_property("caps", parse_caps("video/x-raw,format=RGBA,width=52,height=36,"
                                            "framerate=30/1"))
        src.push_buffer(pkg.Buffer(torch.from_numpy(frame) if pkg is tfx else frame, pts=0,
                                   duration=33_333_333))
        src.end_of_stream()
        p.play_until_eos()
        outs.append(p.by_name("sink").samples)
    _same_samples(*outs, lsb=0 if method == "nearest" else U8_LSB)


# ---------------------------------------------------------------------------
# skiacompositor (tests/test_compositor.py, tests/test_pad_properties.py)
# ---------------------------------------------------------------------------
def _solid_src(pkg, parse_caps, p, color, w, h, n=2):
    src = pkg.element_factory_make("videotestsrc")
    src.set_property("pattern", color)
    src.set_property("num-buffers", n)
    caps = pkg.element_factory_make("capsfilter")
    caps.set_property("caps", parse_caps(f"video/x-raw,format=RGB,width={w},height={h},"
                                         "framerate=30/1"))
    p.add(src)
    p.add(caps)
    src.link(caps)
    return caps


def _compose(pkg, parse_caps, inputs, **props):
    """inputs: [(color, w, h, pad props)] -> (frames, sink caps)."""
    p = pkg.Pipeline()
    comp = pkg.element_factory_make("skiacompositor")
    comp.set_property("background", "black")
    for k, v in props.items():
        comp.set_property(k, v)
    sink = pkg.element_factory_make("appsink")
    p.add(comp)
    p.add(sink)
    comp.pad("src").link(sink.pad("sink"))
    for color, w, h, pad_props in inputs:
        src = _solid_src(pkg, parse_caps, p, color, w, h)
        pad = comp.request_sink_pad()
        pad.props.update(pad_props)
        src.pad("src").link(pad)
    p.play_until_eos()
    return [_host(s.buffer.data) for s in sink.samples], sink.caps


def _compose_both(inputs, **props):
    (jf, jcaps), (tf, tcaps) = [_compose(pkg, pc, inputs, **props) for pkg, pc in PKGS]
    assert len(jf) == len(tf) > 0
    for a, b in zip(jf, tf):
        assert _lsb(a, b) <= U8_LSB
    assert repr(jcaps) == repr(tcaps)
    return tf, tcaps


class TestCompositor:
    def test_two_inputs_placement(self):
        frames, _ = _compose_both([("red", 32, 32, {}), ("blue", 16, 16, dict(xpos=40, ypos=40))],
                                  width=64, height=64)
        f = frames[0]
        assert f.shape == (64, 64, 3)
        assert (f[0:32, 0:32, 0] == 255).all()  # red block
        assert (f[40:56, 40:56, 2] == 255).all()  # blue block
        assert (f[33:39, 33:39] == 0).all()  # background black

    def test_scaling_and_alpha(self):
        frames, _ = _compose_both([("white", 8, 8, dict(width=32, height=32, alpha=0.5))],
                                  width=32, height=32)
        f = frames[0]
        assert f.shape == (32, 32, 3)
        assert (np.abs(f.astype(int) - 127) <= 1).all()  # 50% white over black

    def test_out_of_bounds_clipping(self):
        frames, _ = _compose_both([("green", 16, 16, dict(xpos=24, ypos=-8))],
                                  width=32, height=32)
        f = frames[0]
        assert (f[0:8, 24:32, 1] == 255).all()  # clipped region drawn
        assert (f[9:, :, :] == 0).all()

    def test_output_size_from_first_input(self):
        frames, caps = _compose_both([("red", 48, 24, {})])
        assert frames[0].shape == (24, 48, 3)
        assert caps.structure(0)["width"] == 48


class TestCompositorPadProps:
    def test_placement_and_operator(self):
        comp = tfx.element_factory_make("skiacompositor")
        pad = comp.request_sink_pad()
        pad.set_property("xpos", 10.0)
        pad.set_property("alpha", 0.5)
        pad.set_property("operator", "add")
        pad.set_property("anti-alias", False)
        assert pad.props["xpos"] == 10.0  # alias view stays live
        assert pad.get_property("operator") == "add"
        assert pad.get_property("anti-alias") is False

    def test_operator_math(self):
        dst = torch.full((2, 2), 100.0)
        img = torch.full((2, 2), 200.0)
        assert float(tcomp.blend("over", dst, img, 0.5)[0, 0]) == 150.0
        assert float(tcomp.blend("source", dst, img, 0.5)[0, 0]) == 100.0
        assert float(tcomp.blend("add", dst, img, 1.0)[0, 0]) == 300.0
        assert float(tcomp.blend("dest", dst, img, 1.0)[0, 0]) == 100.0
        assert float(tcomp.blend("clear", dst, img, 1.0)[0, 0]) == 0.0
        assert float(tcomp.blend("modulate", dst, img, 1.0)[0, 0]) == pytest.approx(
            100 * 200 / 255)
        assert float(tcomp.blend("xor", dst, img, 0.25)[0, 0]) == 75.0


@pytest.mark.parametrize("op", tcomp.OPERATORS)
def test_blend_matches_jax(op):
    """Every Porter-Duff closed form on random f32 canvases, bit for bit."""
    rng = np.random.RandomState(4)
    dst = rng.uniform(0, 255, (6, 15)).astype(np.float32)
    img = rng.uniform(0, 255, (6, 15)).astype(np.float32)
    for a in (0.0, 0.3, 0.7, 1.0):
        want = np.asarray(jcomp._blend(op, jnp.asarray(dst), jnp.asarray(img), jnp.float32(a)))
        got = tcomp.blend(op, torch.from_numpy(dst), torch.from_numpy(img), a).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("background", ["checker", "black", "white", "transparent"])
@pytest.mark.parametrize("channels", [3, 4])
def test_background_matches_jax(background, channels):
    want = np.asarray(jcomp._background_canvas(background, 20, 27, channels))
    got = tcomp.background_canvas(background, 20, 27, channels, CPU).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_composite_matches_jax(method):
    """The path's shape at a small size: a downscaled pad with alpha 0.7
    (the antialiased resize when linear), a cropped pad partly out of
    bounds, RGB and RGBA inputs on an RGBA canvas, every operator."""
    rng = np.random.RandomState(5)
    H, W = 54, 96
    base = _smooth_frame(rng, H, W, 4)
    scaled = _smooth_frame(rng, 36, 64, 4)
    rgb = _smooth_frame(rng, 18, 32, 3)
    crop = rgb[5:18, 0:16]  # the host crop of a pad at (80, -5), 32x18
    lsb_seen = 0
    for op in tcomp.OPERATORS:
        frames = [base, scaled, crop]
        placements = ((0, 0, W, H), (8, 6, 24, 14), (80, 0, 16, 13))
        alphas = [1.0, 0.7, 0.45]
        ops = ("over", op, "add")
        methods = ("nearest", method, method)
        want = np.asarray(jcomp._composite(
            tuple(jnp.asarray(f) for f in frames), jnp.asarray(alphas, jnp.float32),
            placements=placements, out_h=H, out_w=W, channels=4, background="checker",
            operators=ops, methods=methods))
        got = tcomp.composite([torch.from_numpy(np.ascontiguousarray(f)) for f in frames],
                              alphas, placements, out_h=H, out_w=W, channels=4,
                              background="checker", operators=ops, methods=methods).numpy()
        lsb = _lsb(got, want)
        assert lsb <= U8_LSB, op
        lsb_seen = max(lsb_seen, lsb)
    print(f"composite ({method}): max {lsb_seen} LSB over {len(tcomp.OPERATORS)} operators")


# ---------------------------------------------------------------------------
# roundedcorners (tests/test_roundedcorners.py)
# ---------------------------------------------------------------------------
def _make_i420(h=32, w=64):
    y = np.full((h, w), 128, np.uint8)
    u = np.full((h // 2, w // 2), 64, np.uint8)
    v = np.full((h // 2, w // 2), 192, np.uint8)
    return (y, u, v)


def _build_rc(pkg, core, radius):
    elem = pkg.element_factory_make("roundedcorners")
    elem.set_property("border-radius-px", radius)
    h = core.Harness(elem)
    h.set_src_caps(core.Caps.builder("video/x-raw", format="I420", width=64, height=32,
                                     framerate=core.Fraction(30, 1)))
    return h, elem


def _i420_for(pkg):
    planes = _make_i420()
    return tuple(torch.from_numpy(p) for p in planes) if pkg is tfx else planes


def _rc_both(radius, pushes=1):
    out = []
    for pkg, core in ((jfx, jcore), (tfx, tcore)):
        h, elem = _build_rc(pkg, core, radius)
        for i in range(pushes):
            h.push(core.Buffer(_i420_for(pkg), pts=i))
        out.append((h, elem))
    return out


def test_radius_zero_outputs_i420():
    (jh, _), (th, _) = _rc_both(0)
    jout, tout = jh.pull(), th.pull()
    assert th.out_caps().structure(0)["format"] in ("I420", "A420")
    assert th.out_caps().structure(0)["format"] == jh.out_caps().structure(0)["format"]
    # radius 0 negotiates I420 first (no alpha plane needed)
    assert len(tout.data) == 3 == len(jout.data)
    assert _lsb(jout.data, tout.data) == 0


def test_radius_adds_alpha_plane():
    (jh, _), (th, _) = _rc_both(8)
    jout, out = jh.pull(), th.pull()
    assert th.out_caps().structure(0)["format"] == "A420"
    assert len(out.data) == 4
    alpha = _host(out.data[3])
    assert alpha.shape == (32, 64)
    assert alpha[0, 0] == 0  # corner transparent
    assert alpha[16, 32] == 255  # center opaque
    assert alpha[0, 32] == 255  # top edge middle opaque
    np.testing.assert_array_equal(_host(out.data[0]), _make_i420()[0])  # luma untouched
    assert _lsb(jout.data, out.data) == 0


def test_mask_cached_until_radius_changes():
    _, (h, elem) = _rc_both(8)
    m1 = elem._mask
    h.push(tcore.Buffer(_i420_for(tfx), pts=1))
    assert elem._mask is m1  # cached
    elem.set_property("border-radius-px", 12)
    h.push(tcore.Buffer(_i420_for(tfx), pts=2))
    assert elem._mask is not m1
    out = h.pull_all()[-1]
    alpha = _host(out.data[3])
    assert alpha[2, 2] == 0  # larger radius -> more transparent corner
    np.testing.assert_array_equal(alpha, np.asarray(jmask(h=32, w=64, radius=12)))


def test_antialiased_edge():
    (jh, _), (th, _) = _rc_both(10)
    alpha = _host(th.pull().data[3])
    # the corner arc must contain intermediate (antialiased) alpha values
    corner = alpha[:10, :10].astype(int)
    assert ((corner > 0) & (corner < 255)).any()
    np.testing.assert_array_equal(alpha, _host(jh.pull().data[3]))


@pytest.mark.parametrize("h,w", [(32, 64), (17, 33), (270, 480), (1080, 1920)])
def test_mask_bit_equal(h, w):
    for radius in (0, 1, 3, 8, 10, 48, 100, 700):
        np.testing.assert_array_equal(tmask(h=h, w=w, radius=radius, dev=CPU).numpy(),
                                      np.asarray(jmask(h=h, w=w, radius=radius)))


# ---------------------------------------------------------------------------
# colordetect and videocompare (tests/test_videofx.py)
# ---------------------------------------------------------------------------
def _messages(p, name):
    return [m.structure for m in p.bus.messages()
            if m.structure is not None and m.structure.name == name]


def _same_messages(jp, tp, name):
    jm, tm = _messages(jp, name), _messages(tp, name)
    assert [repr(s) for s in jm] == [repr(s) for s in tm]
    return tm


def test_css_color_names():
    assert tpal.css_color_name((255, 0, 0)) == "red"
    assert tpal.css_color_name((250, 5, 5)) == "red"
    assert tpal.css_color_name((0, 128, 0)) == "green"
    assert tpal.css_color_name((255, 255, 255)) == "white"
    rng = np.random.RandomState(6)
    for rgb in rng.randint(0, 256, (200, 3)):
        assert tpal.css_color_name(tuple(rgb)) == jpal.css_color_name(tuple(rgb))


def test_videocompare_same_pattern_matches():
    (jp, _), (tp, _) = _run_both(
        "videotestsrc pattern=red num-buffers=3 ! video/x-raw,format=RGB,width=64,height=64 "
        "! videocompare name=compare ! fakesink name=sink "
        "videotestsrc pattern=red num-buffers=3 ! video/x-raw,format=RGB,width=64,height=64 "
        "! compare.", sink=None)
    msgs = _same_messages(jp, tp, "videocompare")
    assert len(msgs) == 3
    assert msgs[0]["pad-distances"][0]["distance"] == 0.0
    assert tp.by_name("sink").rendered == 3


def test_videocompare_different_pattern_no_match():
    (jp, _), (tp, _) = _run_both(
        "videotestsrc pattern=red num-buffers=2 ! video/x-raw,format=RGB,width=64,height=64 "
        "! videocompare name=compare ! fakesink "
        "videotestsrc pattern=checkers-8 num-buffers=2 "
        "! video/x-raw,format=RGB,width=64,height=64 ! compare.", sink=None)
    assert _same_messages(jp, tp, "videocompare") == []


@pytest.mark.parametrize("algo", ["mean", "gradient", "vertgradient", "doublegradient",
                                  "blockhash"])
def test_videocompare_algorithms(algo):
    (jp, _), (tp, _) = _run_both(
        f"videotestsrc pattern=checkers-8 num-buffers=1 "
        f"! video/x-raw,format=RGB,width=64,height=64 "
        f"! videocompare name=compare hash-algo={algo} ! fakesink "
        f"videotestsrc pattern=checkers-8 num-buffers=1 "
        f"! video/x-raw,format=RGB,width=64,height=64 ! compare.", sink=None)
    assert len(_same_messages(jp, tp, "videocompare")) == 1  # identical -> distance 0


def test_videocompare_threshold():
    (jp, _), (tp, _) = _run_both(
        "videotestsrc pattern=smpte num-buffers=1 ! video/x-raw,format=RGB,width=64,height=64 "
        "! videocompare name=compare max-dist-threshold=64 ! fakesink "
        "videotestsrc pattern=gradient num-buffers=1 "
        "! video/x-raw,format=RGB,width=64,height=64 ! compare.", sink=None)
    msgs = _same_messages(jp, tp, "videocompare")
    assert len(msgs) == 1
    assert msgs[0]["pad-distances"][0]["distance"] > 0


def test_colordetect_red():
    (jp, _), (tp, _) = _run_both(
        "videotestsrc pattern=red num-buffers=3 ! video/x-raw,format=RGB,width=64,height=64 "
        "! colordetect ! fakesink", sink=None)
    msgs = _same_messages(jp, tp, "colordetect")
    # color only CHANGES once (None -> red): exactly one message for 3 frames
    assert len(msgs) == 1
    assert msgs[0]["dominant-color"] == "red"
    assert (msgs[0]["palette"][0] >> 16) > 200


def test_colordetect_changes():
    out = []
    for pkg, core in ((jfx, jcore), (tfx, tcore)):
        elem = pkg.element_factory_make("colordetect")
        h = core.Harness(elem)
        h.set_src_caps(core.Caps.builder("video/x-raw", format="RGB", width=32, height=32,
                                         framerate=core.Fraction(30, 1)))
        red = np.zeros((32, 32, 3), np.uint8)
        red[..., 0] = 255
        blue = np.zeros((32, 32, 3), np.uint8)
        blue[..., 2] = 255
        for i, f in enumerate((red, red, blue)):
            h.push(core.Buffer(torch.from_numpy(f) if pkg is tfx else f, pts=i))
        out.append([m.structure["dominant-color"] for m in h.bus.messages()
                    if m.structure is not None and m.structure.name == "colordetect"])
    assert out[1] == ["red", "blue"] == out[0]


def test_parse_multi_chain_by_name():
    p = tfx.parse_launch(
        "videotestsrc num-buffers=1 ! videocompare name=c ! fakesink "
        "videotestsrc num-buffers=1 ! c."
    )
    assert len(p.by_name("c").agg_pads()) == 2


@pytest.mark.parametrize("fmt", ["RGB", "RGBA", "BGRx", "BGRA"])
@pytest.mark.parametrize("max_colors", [1, 2, 5])
def test_colordetect_palette_matches_jax(fmt, max_colors):
    """Seeded frames (with transparent and near-white pixels) through
    colordetect in both packages: the same messages."""
    rng = np.random.RandomState(7)
    comps = 3 if fmt == "RGB" else 4
    frames = [_smooth_frame(rng, 40, 48, comps) for _ in range(3)]
    frames[1][:10] = 255  # near-white rows are skipped
    out = []
    for pkg, core in ((jfx, jcore), (tfx, tcore)):
        elem = pkg.element_factory_make("colordetect")
        elem.set_property("max-colors", max_colors)
        elem.set_property("quality", 3)
        h = core.Harness(elem)
        h.set_src_caps(core.Caps.builder("video/x-raw", format=fmt, width=48, height=40,
                                         framerate=core.Fraction(30, 1)))
        for i, f in enumerate(frames):
            h.push(core.Buffer(torch.from_numpy(f) if pkg is tfx else f, pts=i))
        out.append([repr(m.structure) for m in h.bus.messages()
                    if m.structure is not None and m.structure.name == "colordetect"])
    assert out[0] == out[1] and out[1]


@pytest.mark.parametrize("quality", [1, 3, 10])
@pytest.mark.parametrize("has_alpha", [False, True])
def test_histogram_exact(quality, has_alpha):
    rng = np.random.RandomState(8)
    frame = rng.randint(0, 256, (37, 41, 4 if has_alpha else 3)).astype(np.uint8)
    frame[:5] = 253  # near-white
    want = np.asarray(jpal.color_histogram(jnp.asarray(frame), quality=quality,
                                           has_alpha=has_alpha))
    got = tpal.color_histogram(torch.from_numpy(frame), quality=quality,
                               has_alpha=has_alpha).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert tpal.median_cut_palette(got, 4) == jpal.median_cut_palette(want, 4)


ALGOS = ["mean", "gradient", "vertgradient", "doublegradient", "blockhash"]


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("shape", [(64, 64, 3), (72, 96, 4), (45, 61, 3)])
def test_hash_bits_match_jax(algo, shape):
    """Hash bits exact outside near-ties: bits whose two compared values
    (port's) lie within TIE_REL of their magnitude are named and counted."""
    rng = np.random.RandomState(9)
    named = 0
    for _ in range(4):
        frame = _smooth_frame(rng, *shape)
        want = np.asarray(jhash.hash_image(jnp.asarray(frame), algo=algo))
        left, right = thash.hash_values(torch.from_numpy(frame), algo=algo)
        got = (left > right).numpy()
        assert got.shape == want.shape == ((32,) if algo == "doublegradient" else (64,))
        l64, r64 = left.double().numpy(), right.double().numpy()
        ties = np.abs(l64 - r64) <= TIE_REL * np.maximum(np.abs(l64), np.abs(r64))
        named += int(ties.sum())
        np.testing.assert_array_equal(got[~ties], want[~ties])
        assert np.array_equal(thash.hash_image(torch.from_numpy(frame), algo=algo).numpy(), got)
    print(f"{algo} {shape}: {named} near-tie bits named of {4 * want.size}")


def test_hash_values_match_jax():
    """The compared values themselves: luma, the resized images and the
    block sums within f32 rounding of JAX's; the median is the mean of the
    two middle sums (jnp.median), not torch.median's lower one."""
    rng = np.random.RandomState(10)
    frame = _smooth_frame(rng, 72, 96)
    jl = np.asarray(jhash._to_luma(jnp.asarray(frame)))
    tl = thash.to_luma(torch.from_numpy(frame)).numpy()
    assert np.abs(jl - tl).max() <= 1e-4
    js = np.asarray(jhash._resize(jnp.asarray(jl), 8, 9))
    ts = tir.resize(torch.from_numpy(tl), (8, 9), "linear").numpy()
    assert np.abs(js - ts).max() <= RESIZE_TOL * 255
    sums, med = thash.hash_values(torch.from_numpy(frame), algo="blockhash")
    s = np.sort(sums.numpy())
    assert float(med[0]) == float((s[31] + s[32]) * np.float32(0.5))
    assert float(med[0]) != float(torch.median(sums))


def test_hamming():
    a = torch.tensor([True, False, True, True])
    b = torch.tensor([True, True, False, True])
    assert int(thash.hamming(a, b)) == 2 == int(jhash.hamming(jnp.asarray(a.numpy()),
                                                              jnp.asarray(b.numpy())))


# ---------------------------------------------------------------------------
# the registry entries against the JAX package's and docs/elements.json
# ---------------------------------------------------------------------------
FACTORIES = ["videoscale", "videoconvertscale", "skiacompositor", "roundedcorners",
             "colordetect", "videocompare", "demucs"]


def _value(v, core):
    if isinstance(v, core.IntRange):
        return {"range": [v.lo, v.hi]}
    if isinstance(v, core.ValueList):
        return {"choices": list(v.values)}
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    return repr(v)


def _caps(caps, core):
    if caps.is_any():
        return "ANY"
    return [{"name": s.name, **{k: _value(val, core) for k, val in s.fields.items()}}
            for s in caps.structures]


def _info(pkg, core, name):
    """docs/elements.json's entry of a factory, built from a package's class
    (utils/registry_dump.py's fields, without "python")."""
    cls = core.factory_class(name)
    props = []
    for p in cls._all_props():
        e = {"name": p.name, "type": p.type, "default": _value(p.default, core),
             "mutable": p.mutable}
        if p.minimum is not None:
            e["min"] = p.minimum
        if p.maximum is not None:
            e["max"] = p.maximum
        if p.choices:
            e["choices"] = list(p.choices)
        if p.doc:
            e["doc"] = p.doc
        props.append(e)
    inst = cls()
    pads = [{"name": pad.template.name_template if pad.template else pad.name,
             "direction": pad.direction.value,
             "presence": pad.template.presence.value if pad.template else "always",
             "caps": _caps(pad.pad_template_caps(), core)} for pad in inst.pads.values()]
    if hasattr(inst, "request_sink_pad") and not cls.EXTRA_PAD_TEMPLATES:
        pads.append({"name": "sink_%u", "direction": "sink", "presence": "request",
                     "caps": _caps(getattr(cls, "SINK_TEMPLATE_CAPS", core.Caps.new_any()),
                                   core)})
    for name_t, direction, presence, caps_name in cls.EXTRA_PAD_TEMPLATES:
        pads.append({"name": name_t, "direction": direction, "presence": presence,
                     "caps": [{"name": caps_name}]})
    info = {"name": name, "class": cls.ELEMENT_CLASS, "description": cls.ELEMENT_DESCRIPTION,
            "properties": props,
            "signals": {s: ("action" if m else "request") for s, m in cls._all_signals().items()},
            "pads": pads}
    pad_props = {t: [{"name": p.name, "type": p.type, "default": _value(p.default, core),
                      **({"doc": p.doc} if p.doc else {})} for p in specs]
                 for t, specs in cls._all_pad_properties().items()}
    if pad_props:
        info["pad-properties"] = pad_props
    return info


@pytest.mark.parametrize("name", FACTORIES)
def test_registry_entry_matches_jax_and_docs(name):
    docs = json.loads((ROOT / "docs" / "elements.json").read_text())[name]
    docs = {k: v for k, v in docs.items() if k not in ("python", "object-properties")}
    want = json.loads(json.dumps(_info(jfx, jcore, name)))
    got = json.loads(json.dumps(_info(tfx, tcore, name)))
    assert got == want
    assert got == docs
