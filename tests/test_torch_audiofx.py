"""agingradio, hrtfrender, sofalizer and audiomixer of the PyTorch port
against the JAX package, on the CPU.

Gates and why:

- agingradio's op with the JAX function's own draws (reproduced with the
  same `jax.random` split and uniform calls and handed to the port): within
  AGING_F32_TOL = 1e-6 (f32) / AGING_F64_TOL = 1e-12 (f64) a sample and in
  the filter state: the lowpass runs as a Hillis-Steele scan where the JAX
  function runs `associative_scan`, the same recurrence combined in another
  order.  With quantization on, a sample whose pre-quantization value lies
  at a rounding tie between the two orders may land one step away; such
  samples are counted and must be ties.  The element's own draws come from
  a torch.Generator and are checked by their statistics (the click rate
  per 2-sample chunk, the noise bounds); with clicks and noise off the two
  elements are compared directly.
- hrtfrender and sofalizer: within SPATIAL_TOL = 1e-6 of max(1, the
  output's scale) a sample (f32 FFTs of two libraries, whose rounding
  scales with the signal; the port overlap-adds all segments of a call at
  once); the same PTS, offsets and durations.
- audiomixer: bit-equal (the same f32 sums of the same chunks).

Torch runs on one intra-op thread (tests/torch_parity_helpers.py).
"""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import agingradio as jaging
from gst_plugins_rs_tpu.ops import hrtf as jhrtf
from gst_plugins_rs_tpu.ops import sofa as jsofa
from gst_plugins_rs_tpu_torch.ops import agingradio as taging
from gst_plugins_rs_tpu_torch.ops import hrtf as thrtf
from gst_plugins_rs_tpu_torch.ops import sofa as tsofa
from torch_parity_helpers import port_on_cpu

AGING_F32_TOL = 1e-6
AGING_F64_TOL = 1e-12
SPATIAL_TOL = 1e-6
RATE = 44_100


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(ref, got, tol=SPATIAL_TOL):
    """max |got - ref| <= tol * max(1, max |ref|)."""
    ref, got = np.asarray(ref), _np(got)
    assert ref.shape == got.shape
    if ref.size:
        assert np.abs(ref - got).max() <= tol * max(1.0, float(np.abs(ref).max()))


def _harness(pkg, factory, rate, channels, fmt="F32", **props):
    elem = pkg.element_factory_make(factory)
    for k, v in props.items():
        elem.set_property(k.replace("_", "-"), v)
    h = pkg.Harness(elem)
    h.set_src_caps(pkg.Caps.builder("audio/x-raw", format=fmt, rate=rate, channels=channels,
                                    layout="interleaved"))
    return h, elem


# ---------------------------------------------------------------------------
# agingradio
# ---------------------------------------------------------------------------
def _jax_draws(key, N, ch, dtype):
    """The draws agingradio_process makes from `key` (ops/agingradio.py:61-68
    of the JAX package): uniform click scores per 2-sample chunk and the
    noise in [-1, 1)."""
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, ((N + 1) // 2,), dtype)
    noise = jax.random.uniform(k2, (N, ch), dtype, minval=-1.0, maxval=1.0)
    return np.array(u), np.array(noise)  # writable copies for torch.from_numpy


def _aging_pair(x, seed, dtype, noise_ampl, clicks_prob, alpha, bits, distortion, passes,
                use_lowpass, state):
    key = jax.random.PRNGKey(seed)
    jout, jstate = jaging.agingradio_process(
        jnp.asarray(x, dtype), key, jnp.asarray(state, dtype), noise_ampl, clicks_prob, alpha,
        bits, distortion, passes=passes, use_lowpass=use_lowpass)
    u, noise = _jax_draws(key, x.shape[0], x.shape[1], dtype)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    clicks = torch.from_numpy(u) < clicks_prob
    tout, tstate = taging.agingradio_process(
        torch.from_numpy(np.asarray(x)).to(tdt), clicks, torch.from_numpy(noise),
        torch.from_numpy(np.asarray(state)).to(tdt), noise_ampl, alpha, bits, distortion,
        passes=passes, use_lowpass=use_lowpass)
    return (np.asarray(jout), np.asarray(jstate)), (_np(tout), _np(tstate)), clicks


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, AGING_F32_TOL), (jnp.float64, AGING_F64_TOL)],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("bits,passes,distortion,use_lowpass", [
    (0.0, 0, 0.0, True),    # the lowpass scan alone
    (0.0, 3, 1.0, True),    # + cubic distortion
    (4.0, 3, 1.0, True),    # the element's defaults
    (4.0, 2, 0.5, False),   # no lowpass
])
def test_agingradio_op_matches_jax_with_its_draws(dtype, tol, bits, passes, distortion,
                                                  use_lowpass):
    rng = np.random.RandomState(0)
    x = rng.uniform(-0.6, 0.6, (3001, 2))
    state = rng.uniform(-0.3, 0.3, 2)
    alpha = taging.lowpass_alpha(48000, 2000)
    (jo, js), (to, ts), clicks = _aging_pair(x, 7, dtype, 0.05, 0.01, alpha, bits, distortion,
                                             passes, use_lowpass, state)
    assert 0 < int(clicks.sum()) < clicks.numel()  # both paths of the chain run
    assert to.dtype == jo.dtype and to.shape == jo.shape
    d = np.abs(jo - to)
    off = d > tol
    if bits > 0 and off.any():
        # only rounding ties between the two scan orders may step apart
        step = 2.0 ** -bits
        (pre, _), _, _ = _aging_pair(x, 7, dtype, 0.05, 0.01, alpha, 0.0, 0.0, 0,
                                     use_lowpass, state)
        frac = np.abs(np.abs(pre * 2.0 ** bits) % 1.0 - 0.5)
        assert off.sum() <= 2 and (frac[off] < 1e3 * tol).all(), d.max()
        assert (d[off] <= step * 1.01).all()
    else:
        assert d.max() <= tol
    assert np.abs(js - ts).max() <= tol


def test_first_order_scan_is_the_recurrence():
    rng = np.random.RandomState(1)
    N = 1000
    x = rng.randn(N, 3)
    a = rng.uniform(0.5, 1.0, (N, 3))
    b = rng.uniform(0.0, 0.5, (N, 3))
    y0 = rng.randn(3)
    y, ref = y0.copy(), []
    for n in range(N):
        y = a[n] * y + b[n] * x[n]
        ref.append(y)
    got = taging.first_order_scan(*(torch.from_numpy(v) for v in (x, a, b, y0)))
    assert np.abs(_np(got) - np.stack(ref)).max() <= 1e-12


@pytest.mark.parametrize("fmt", ["F32", "F64"])
def test_agingradio_element_matches_jax_without_draws(fmt):
    """With the noise and the clicks off nothing random is left: the two
    elements agree across buffers (the filter state carried)."""
    props = dict(white_noise_ampl=0.0, clicks_prob=0.0, bits_to_quantize=0.0,
                 cubic_curve_passes=2)
    x = np.random.RandomState(2).uniform(-0.8, 0.8, (2400, 2))
    outs = []
    for pkg in (jfx, tfx):
        h, _ = _harness(pkg, "agingradio", 48000, 2, fmt, **props)
        for i in range(0, 2400, 800):
            h.push(pkg.Buffer(x[i:i + 800].astype(np.float64 if fmt == "F64" else np.float32),
                              pts=i * 10**9 // 48000))
        outs.append(np.concatenate([_np(b.data) for b in h.pull_all()]))
    tol = AGING_F64_TOL if fmt == "F64" else AGING_F32_TOL
    assert outs[1].dtype == (np.float64 if fmt == "F64" else np.float32)
    assert np.abs(outs[0] - outs[1]).max() <= tol


def _run_aging(sig, rate=48000, ch=1, **props):
    h, _ = _harness(tfx, "agingradio", rate, ch, **props)
    h.push(tfx.Buffer(sig.astype(np.float32), pts=0))
    return _np(h.pull().data)


def test_agingradio_click_rate_and_noise_bounds():
    """The element's draws: one click decision per 2-sample chunk at
    clicks-prob (a binomial count within 5 sigma), a clicked chunk all 1.0;
    the noise uniform within +-white-noise-ampl, mean ~0."""
    n, p = 200_000, 0.02
    out = _run_aging(np.zeros((n, 1)), white_noise_ampl=0.0, clicks_prob=p, lowpass_freq=0,
                     bits_to_quantize=0.0, cubic_curve_distortion=0.0)
    chunks = out[:, 0].reshape(-1, 2)
    clicked = (chunks == 1.0).all(1)
    assert ((chunks == 1.0).any(1) == clicked).all()  # whole chunks
    m = n // 2
    assert abs(clicked.sum() - m * p) <= 5 * np.sqrt(m * p * (1 - p))
    out = _run_aging(np.zeros((n, 1)), white_noise_ampl=0.25, clicks_prob=0.0, lowpass_freq=0,
                     bits_to_quantize=0.0, cubic_curve_distortion=0.0)
    assert np.abs(out).max() <= 0.25 and np.abs(out).max() > 0.249
    assert abs(out.mean()) < 5 * 0.25 / np.sqrt(3 * n)
    assert abs(np.abs(out).mean() - 0.125) < 0.005


# mirrors of tests/test_agingradio.py on the port
def test_quantization_only():
    sig = np.linspace(-0.9, 0.9, 1000)[:, None]
    out = _run_aging(sig, white_noise_ampl=0.0, clicks_prob=0.0, lowpass_freq=0,
                     cubic_curve_distortion=0.0, bits_to_quantize=4.0)
    np.testing.assert_allclose(out, (np.round(sig * 16.0) / 16.0).astype(np.float32), atol=1e-7)


def test_cubic_distortion_only():
    out = _run_aging(np.full((100, 1), 0.5), white_noise_ampl=0.0, clicks_prob=0.0,
                     lowpass_freq=0, bits_to_quantize=0.0, cubic_curve_distortion=1.0,
                     cubic_curve_passes=1)
    np.testing.assert_allclose(out, 0.5 - 0.5**3, atol=1e-6)


def test_clicks_always():
    out = _run_aging(np.zeros((64, 2)), ch=2, clicks_prob=1.0)
    np.testing.assert_array_equal(out, np.ones_like(out))


def test_lowpass_smooths_step():
    sig = np.concatenate([np.zeros((10, 1)), np.full((2000, 1), 0.5)])
    out = _run_aging(sig, white_noise_ampl=0.0, clicks_prob=0.0, lowpass_freq=2000,
                     bits_to_quantize=0.0, cubic_curve_distortion=0.0)
    assert out[11, 0] < 0.25
    assert abs(out[-1, 0] - 0.5) < 0.01


def test_deterministic_with_seed():
    sig = np.random.RandomState(0).uniform(-0.5, 0.5, (4800, 2))
    a = _run_aging(sig.copy(), ch=2, seed=42)
    b = _run_aging(sig.copy(), ch=2, seed=42)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, _run_aging(sig.copy(), ch=2, seed=43))


def test_noise_amplitude():
    out = _run_aging(np.zeros((48000, 1)), white_noise_ampl=0.25, clicks_prob=0.0,
                     lowpass_freq=0, bits_to_quantize=0.0, cubic_curve_distortion=0.0)
    assert 0.2 < np.abs(out).max() <= 0.25
    assert np.abs(out).mean() > 0.05


# ---------------------------------------------------------------------------
# hrtfrender
# ---------------------------------------------------------------------------
def icosahedron():
    """(vertices [12, 3] unit, faces [20, 3]): the faces are the triples of
    mutually adjacent vertices (edge = the shortest vertex distance)."""
    phi = (1 + 5**0.5) / 2
    verts = []
    for a in (-1, 1):
        for b in (-phi, phi):
            verts += [(0, a, b), (a, b, 0), (b, 0, a)]
    v = np.asarray(verts, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    adj = np.abs(d - d[d > 1e-9].min()) < 1e-6
    faces = [(i, j, k) for i in range(12) for j in range(i + 1, 12) for k in range(j + 1, 12)
             if adj[i, j] and adj[j, k] and adj[i, k]]
    return v.astype(np.float32), np.asarray(faces, np.uint32)


def make_sphere_bytes(rate=RATE, length=8):
    """The synthetic HRIR sphere of tests/test_hrtfrender.py: lateral
    panning (gain from x) with an impulse at tap 0, plus a small decaying
    tail so the overlap-add carries across blocks."""
    v, faces = icosahedron()
    V = len(v)
    left = np.zeros((V, length), np.float32)
    right = np.zeros((V, length), np.float32)
    for i, (x, _, _) in enumerate(v):
        left[i, 0] = 0.5 * (1.0 - x)
        right[i, 0] = 0.5 * (1.0 + x)
        left[i, 1:] = 0.05 * 0.5 ** np.arange(1, length) * (1.0 - x)
        right[i, 1:] = 0.05 * 0.5 ** np.arange(1, length) * (1.0 + x)
    out = b"HRIR" + struct.pack("<IIII", rate, length, V, faces.size) + faces.tobytes()
    for i in range(V):
        out += struct.pack("<fff", *v[i]) + left[i].tobytes() + right[i].tobytes()
    return out


SPHERE = make_sphere_bytes()


def test_sphere_parser_and_sampling_match_jax():
    ts = thrtf.HrirSphere.parse(SPHERE, RATE)
    js = jhrtf.HrirSphere.parse(SPHERE, RATE)
    assert ts.length == 8 and ts.vertices.shape[0] == 12 and ts.faces.shape == (20, 3)
    for a in ("vertices", "faces", "left", "right"):
        assert np.array_equal(getattr(ts, a), getattr(js, a))
    for d in [(1.0, 0.0, 0.0), (-0.3, 0.2, 0.9), (0.0, -1.0, 0.1), (0.0, 0.0, 0.0)]:
        for a, b in zip(ts.sample_bilinear(d), js.sample_bilinear(d)):
            assert np.array_equal(a, b)
    l, r = ts.sample_bilinear((1.0, 0.0, 0.0))
    assert r[0] > 0.9 and l[0] < 0.1
    t48, j48 = ts.resampled(48000), js.resampled(48000)
    assert t48.length == j48.length and np.array_equal(t48.left, j48.left)


@pytest.mark.parametrize("L", [1, 8, 300])
def test_hrtf_convolve_block_and_blocks_match_jax(L):
    rng = np.random.RandomState(L)
    C, steps, blk, K = 2, 4, 64, 3
    x = rng.uniform(-0.5, 0.5, (C, K, steps * blk)).astype(np.float32)
    hrirs = rng.uniform(-0.5, 0.5, (C, steps, 2, L)).astype(np.float32)
    gains = rng.uniform(0.5, 1.0, (C, steps)).astype(np.float32)
    tails = rng.uniform(-0.1, 0.1, (C, 2, L - 1)).astype(np.float32)
    jo, jt = jhrtf.hrtf_convolve_block(jnp.asarray(x[:, 0]), jnp.asarray(hrirs), jnp.asarray(gains),
                                       jnp.asarray(tails), block_len=blk, steps=steps)
    to, tt = thrtf.hrtf_convolve_block(*(torch.from_numpy(v) for v in (x[:, 0], hrirs, gains, tails)),
                                       block_len=blk, steps=steps)
    _close(jo, to)
    _close(jt, tt)
    jo, jt = jhrtf.hrtf_convolve_blocks(jnp.asarray(x), jnp.asarray(hrirs), jnp.asarray(gains),
                                        jnp.asarray(tails), block_len=blk, steps=steps)
    to, tt = thrtf.hrtf_convolve_blocks(*(torch.from_numpy(v) for v in (x, hrirs, gains, tails)),
                                        block_len=blk, steps=steps)
    assert tuple(to.shape) == (K, steps * blk, 2)
    _close(jo, to)
    _close(jt, tt)


def _hrtf_both(pushes, channels, objs_seq=None, eos=True, **props):
    """The same buffers through both elements; objs_seq[i] (if given) is set
    as spatial-objects before push i.  (jax buffers, torch buffers)."""
    outs = []
    for pkg in (jfx, tfx):
        h, elem = _harness(pkg, "hrtfrender", RATE, channels, hrir_raw=SPHERE, **props)
        pts = 0
        for i, data in enumerate(pushes):
            if objs_seq is not None and objs_seq[i] is not None:
                elem.set_property("spatial-objects", objs_seq[i])
            h.push(pkg.Buffer(data.copy(), pts=pts * 10**9 // RATE, offset=pts))
            pts += data.shape[0]
        if eos:
            h.push_eos()
        outs.append(h.pull_all())
    return outs


def _same_buffers(js, ts, tol):
    assert len(js) == len(ts) > 0
    for a, b in zip(js, ts):
        assert (a.pts, a.offset, a.duration) == (b.pts, b.offset, b.duration)
        assert isinstance(b.data, torch.Tensor)
        _close(a.data, b.data, tol)


def test_hrtfrender_matches_jax_with_moving_objects():
    rng = np.random.RandomState(3)
    x = rng.uniform(-0.5, 0.5, (3 * 4096 + 1000, 2)).astype(np.float32)
    objs = [[{"x": -2.0, "y": 0.0, "z": 1.0}, {"x": 2.5, "y": 0.5, "z": 0.0}],
            None,
            [{"x": 1.0, "y": 0.0, "z": -2.0, "distance-gain": 0.7},
             {"x": -1.0, "y": 1.0, "z": 0.5, "coordinate-system": "cartesian"}]]
    js, ts = _hrtf_both([x[:9000], x[9000:11000], x[11000:]], 2, objs)
    _same_buffers(js, ts, SPATIAL_TOL)
    # two blocks in one call (the steady-state batch), one block after the
    # objects moved (interpolated), the EOS residue
    assert [b.data.shape[0] for b in ts] == [8192, 4096, 1000]


def test_hrtfrender_matches_jax_on_default_positions():
    x = np.random.RandomState(4).uniform(-0.5, 0.5, (2 * 4096, 6)).astype(np.float32)
    js, ts = _hrtf_both([x], 6, interpolation_steps=4, block_length=256)
    _same_buffers(js, ts, SPATIAL_TOL)


# mirrors of tests/test_hrtfrender.py on the port
def _hrtf_harness(channels=1, **props):
    return _harness(tfx, "hrtfrender", RATE, channels, hrir_raw=SPHERE, **props)


def test_samples_in_samples_out():
    h, _ = _hrtf_harness()
    n = 4096 + 20
    h.push(tfx.Buffer(np.zeros((n, 1), np.float32), pts=0, duration=round(n * 10**9 / RATE),
                      offset=0))
    buf = h.pull()
    assert buf.data.shape == (4096, 2) and buf.pts == 0
    h.push_eos()
    buf = h.pull()
    assert buf.data.shape == (20, 2) and buf.offset == 4096
    assert buf.pts == 4096 * 10**9 // RATE and buf.duration == 20 * 10**9 // RATE


def test_implicit_spatial_objects():
    _, elem = _hrtf_harness(8)
    assert len(elem.get_property("spatial-objects")) == 8


def test_output_caps_forced_stereo():
    h, _ = _hrtf_harness(4)
    h.push(tfx.Buffer(np.zeros((4096, 4), np.float32), pts=0))
    assert h.out_caps().structure(0)["channels"] == 2


def test_panning_energy():
    h, elem = _hrtf_harness()
    elem.set_property("spatial-objects", [{"x": 2.5, "y": 0.0, "z": 0.0, "distance-gain": 1.0,
                                           "coordinate-system": "left-handed"}])
    sig = np.random.RandomState(0).uniform(-0.5, 0.5, (4096, 1)).astype(np.float32)
    h.push(tfx.Buffer(sig, pts=0))
    out = _np(h.pull().data)
    assert np.sum(out[:, 1] ** 2) > 10 * np.sum(out[:, 0] ** 2)


def test_distance_gain_scales_output():
    sig = np.random.RandomState(1).uniform(-0.5, 0.5, (4096, 1)).astype(np.float32)
    outs = []
    for g in (1.0, 0.5):
        h, elem = _hrtf_harness()
        elem.set_property("spatial-objects", [{"x": 0.0, "y": 0.0, "z": 2.5, "distance-gain": g}])
        h.push(tfx.Buffer(sig.copy(), pts=0))
        outs.append(_np(h.pull().data))
    np.testing.assert_allclose(outs[1], 0.5 * outs[0], atol=1e-6)


def test_overlap_add_continuity():
    sig = np.random.RandomState(2).uniform(-0.5, 0.5, (8192, 1)).astype(np.float32)
    h1, _ = _hrtf_harness()
    h1.push(tfx.Buffer(sig, pts=0))
    o1 = np.concatenate([_np(b.data) for b in h1.pull_all()])
    h2, _ = _hrtf_harness()
    h2.push(tfx.Buffer(sig[:4096], pts=0))
    h2.push(tfx.Buffer(sig[4096:], pts=round(4096 * 10**9 / RATE)))
    o2 = np.concatenate([_np(b.data) for b in h2.pull_all()])
    np.testing.assert_allclose(o1, o2, atol=1e-6)


def test_flush_stop_clears_adapter():
    h, _ = _hrtf_harness()
    h.push(tfx.Buffer(np.zeros((1000, 1), np.float32), pts=0))
    h.push_event(tfx.Event.new_flush_stop())
    h.push_eos()
    assert all(b.data.shape[0] == 0 or b.data.shape[0] >= 4096 for b in h.pull_all())


def test_channels_mix():
    h, elem = _hrtf_harness(2)
    elem.set_property("spatial-objects", [{"x": -2.5, "y": 0.0, "z": 0.0, "distance-gain": 1.0},
                                          {"x": 2.5, "y": 0.0, "z": 0.0, "distance-gain": 1.0}])
    sig = np.random.RandomState(3).uniform(-0.5, 0.5, (4096, 2)).astype(np.float32)
    h.push(tfx.Buffer(sig, pts=0))
    out = _np(h.pull().data)
    assert np.sum(out[:, 0] ** 2) > 0.1 and np.sum(out[:, 1] ** 2) > 0.1


# ---------------------------------------------------------------------------
# sofalizer (needs h5py, as tests/test_sofalizer.py)
# ---------------------------------------------------------------------------
SOFA_RATE = 48000


def make_sofa(path, taps=96):
    """The tiny synthetic SOFA of tests/test_sofalizer.py: 4 measurements on
    the horizontal plane, impulses with position-dependent gain and delay."""
    h5py = pytest.importorskip("h5py")
    az = np.array([0.0, 90.0, 180.0, 270.0])
    M = len(az)
    ir = np.zeros((M, 2, taps), np.float32)
    for m in range(M):
        ir[m, 0, m] = 1.0 - 0.1 * m
        ir[m, 1, m + 1] = 0.5 + 0.1 * m
        ir[m, :, 10:] = np.random.RandomState(m).uniform(-0.05, 0.05, (2, taps - 10))
    pos = np.stack([az, np.zeros(M), np.full(M, 1.0)], axis=1)
    with h5py.File(path, "w") as f:
        f.create_dataset("Data.IR", data=ir)
        f.create_dataset("Data.SamplingRate", data=np.array([SOFA_RATE], np.float64))
        f.create_dataset("SourcePosition", data=pos)
    return ir, pos


def test_sofa_loader_matches_jax(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    ts, js = tsofa.SofaFile.from_file(p), jsofa.SofaFile.from_file(p)
    assert ts.rate == js.rate == SOFA_RATE and ts.ir.shape == (4, 2, 96)
    assert np.array_equal(ts.ir, js.ir) and np.array_equal(ts.positions, js.positions)
    for pt in [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (-1.0, 0.0, 0.0), (0.3, -0.9, 0.1)]:
        assert ts.nearest(pt) == js.nearest(pt)


def test_partition_filter_and_upols_match_jax_and_direct_convolution():
    rng = np.random.RandomState(0)
    L = 16
    h = rng.uniform(-1, 1, (2, 50)).astype(np.float32)
    Hr, Hi = tsofa.partition_filter(h, L)
    jHr, jHi = jsofa.partition_filter(h, L)
    assert np.array_equal(Hr, jHr) and np.array_equal(Hi, jHi)
    x = rng.uniform(-1, 1, 96).astype(np.float32)
    fdl = (torch.zeros((Hr.shape[0], L + 1)), torch.zeros((Hr.shape[0], L + 1)))
    jfdl = (jnp.zeros((Hr.shape[0], L + 1), jnp.float32),) * 2
    prev, jprev = torch.zeros(L), jnp.zeros((L,), jnp.float32)
    outs, jouts = [], []
    for i in range(0, len(x), L):
        *fdl, prev, y = tsofa.upols_block(*fdl, prev, torch.from_numpy(x[i:i + L]),
                                          torch.from_numpy(Hr), torch.from_numpy(Hi))
        *jfdl, jprev, jy = jsofa.upols_block(*jfdl, jprev, jnp.asarray(x[i:i + L]),
                                             jnp.asarray(Hr), jnp.asarray(Hi))
        outs.append(_np(y))
        jouts.append(np.asarray(jy))
    got = np.concatenate(outs)
    ref = np.stack([np.convolve(x, h[e])[:96] for e in range(2)], axis=1)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    _close(np.concatenate(jouts), got)
    _close(jfdl[0], fdl[0])
    _close(jfdl[1], fdl[1])


def _sofa_harness(pkg, path, channels=1, **props):
    return _harness(pkg, "sofalizer", SOFA_RATE, channels, sofa=path, **props)


def test_sofalizer_matches_jax(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    x = np.random.RandomState(5).uniform(-0.5, 0.5, (1300, 6)).astype(np.float32)
    outs = []
    for pkg in (jfx, tfx):
        h, elem = _sofa_harness(pkg, p, 6, partition_length=32)
        h.push(pkg.Buffer(x[:600].copy(), pts=0, offset=0))
        objs = [{"x": 1.0, "y": 0.2 * c, "z": 0.0, "coordinate-system": "cartesian",
                 "distance-gain": 1.0 - 0.1 * c} for c in range(6)]
        elem.set_property("spatial-objects", objs)
        h.push(pkg.Buffer(x[600:].copy(), pts=600 * 10**9 // SOFA_RATE, offset=600))
        h.push_eos()
        outs.append(h.pull_all())
    _same_buffers(*outs, SPATIAL_TOL)
    assert [b.data.shape[0] for b in outs[1]] == [512, 768, 20]


# mirrors of tests/test_sofalizer.py on the port
def test_sofalizer_renders_stereo(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    h, elem = _sofa_harness(tfx, p)
    elem.set_property("spatial-objects", [{"x": 1.0, "y": 0.0, "z": 0.0, "distance-gain": 1.0,
                                           "coordinate-system": "cartesian"}])
    sig = np.zeros((256, 1), np.float32)
    sig[0, 0] = 1.0
    h.push(tfx.Buffer(sig, pts=0))
    out = _np(h.pull().data)
    assert out.shape == (256, 2)
    assert out[0, 0] == pytest.approx(1.0, abs=1e-4)
    assert out[1, 1] == pytest.approx(0.5, abs=1e-4)


def test_lfe_channel_dropped(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    h, _ = _sofa_harness(tfx, p, 6)
    sig = np.zeros((256, 6), np.float32)
    sig[0, 3] = 1.0
    h.push(tfx.Buffer(sig, pts=0))
    np.testing.assert_allclose(_np(h.pull().data), 0.0, atol=1e-7)


def test_update_threshold(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    h, elem = _sofa_harness(tfx, p)
    elem.set_property("spatial-objects", [{"x": 1.0, "y": 0.0, "z": 0.0,
                                           "coordinate-system": "cartesian"}])
    applied_before = list(elem._applied)
    elem.set_property("update-threshold", 0.5)
    elem.set_property("spatial-objects", [{"x": 1.0, "y": 0.01, "z": 0.0,
                                           "coordinate-system": "cartesian"}])
    assert elem._applied == applied_before
    elem.set_property("spatial-objects", [{"x": 0.0, "y": 1.0, "z": 0.0,
                                           "coordinate-system": "cartesian"}])
    assert elem._applied != applied_before
    sig = np.zeros((256, 1), np.float32)
    sig[0, 0] = 1.0
    h.push(tfx.Buffer(sig, pts=0))
    assert _np(h.pull().data)[1, 0] == pytest.approx(0.9, abs=1e-4)


def test_eos_drain_residue(tmp_path):
    p = str(tmp_path / "t.sofa")
    make_sofa(p)
    h, _ = _sofa_harness(tfx, p)
    h.push(tfx.Buffer(np.zeros((300, 1), np.float32), pts=0, offset=0))
    assert h.pull().data.shape[0] == 256
    h.push_eos()
    residue = h.pull()
    assert residue.data.shape[0] == 44 and residue.pts == 256 * 10**9 // SOFA_RATE


# ---------------------------------------------------------------------------
# audiomixer
# ---------------------------------------------------------------------------
def _mixer_both(launch):
    outs = []
    for pkg in (jfx, tfx):
        p = pkg.parse_launch(launch)
        p.play_until_eos()
        outs.append(p.by_name("sink").samples)
    return outs


@pytest.mark.parametrize("fmt,dur", [("F32", 10_000_000), ("F64", 25_000_000)])
def test_audiomixer_matches_jax(fmt, dur):
    """Two sources of different lengths: the shorter one's pad reaches EOS
    first and the mixer pads its last chunk with zeros."""
    js, ts = _mixer_both(
        f"audiotestsrc wave=sine freq=440 volume=0.25 num-buffers=10 samplesperbuffer=480 "
        f"! audio/x-raw,format={fmt},rate=48000,channels=2 "
        f"! audiomixer name=mix output-buffer-duration={dur} ! appsink name=sink "
        f"audiotestsrc wave=white-noise volume=0.1 num-buffers=7 samplesperbuffer=500 "
        f"! audio/x-raw,format={fmt},rate=48000,channels=2 ! mix.")
    assert len(js) == len(ts) > 0
    for a, b in zip(js, ts):
        assert (a.buffer.pts, a.buffer.duration) == (b.buffer.pts, b.buffer.duration)
        assert repr(a.caps) == repr(b.caps)
        assert isinstance(b.buffer.data, torch.Tensor)
        assert np.array_equal(np.asarray(a.buffer.data), _np(b.buffer.data))


# mirrors of tests/test_audiomixer.py on the port
def test_mixes_two_sines():
    p = tfx.parse_launch(
        "audiotestsrc wave=sine freq=440 volume=0.25 num-buffers=10 samplesperbuffer=480 "
        "! audio/x-raw,format=F32,rate=48000,channels=1 "
        "! audiomixer name=mix output-buffer-duration=10000000 ! appsink name=sink "
        "audiotestsrc wave=sine freq=440 volume=0.25 num-buffers=10 samplesperbuffer=480 "
        "! audio/x-raw,format=F32,rate=48000,channels=1 ! mix.")
    sink = p.by_name("sink")
    p.play_until_eos()
    data = sink.concat_audio()
    assert data.shape[0] == 4800
    np.testing.assert_allclose(data[:, 0], 0.5 * np.sin(2 * np.pi * 440 * np.arange(4800) / 48000),
                               atol=1e-5)
    pts = [s.buffer.pts for s in sink.samples]
    assert pts[0] == 0 and pts[1] == 10 * 10**9 // 1000


def test_loudnorm_limiter_pipeline_with_mixer():
    """The reference limiter scenario wired as upstream, at 192 kHz, on the
    port."""
    p = tfx.parse_launch(
        "audiotestsrc wave=sine volume=0.05 num-buffers=400 samplesperbuffer=1920 "
        "! audio/x-raw,format=F64,rate=192000,channels=1 "
        "! audiomixer name=mixer output-buffer-duration=10000000 "
        "! audio/x-raw,format=F64,rate=192000,channels=1 "
        "! audioloudnorm ! appsink name=sink "
        "audiotestsrc wave=ticks sine-periods-per-tick=1 tick-interval=4000000000 "
        "num-buffers=400 samplesperbuffer=1920 "
        "! audio/x-raw,format=F64,rate=192000,channels=1 ! mixer.")
    sink = p.by_name("sink")
    p.play_until_eos()
    data = sink.concat_audio()
    assert data.shape[0] == 400 * 1920
    from gst_plugins_rs_tpu_torch.ops.ebur128 import EbuR128

    r = EbuR128(1, 192000, device="cpu")
    r.add_frames(torch.from_numpy(data))
    assert abs(r.loudness_global() + 24.0) < 1.0
    assert 20 * np.log10(r.sample_peak(0)) <= -2.0 + 1e-6
