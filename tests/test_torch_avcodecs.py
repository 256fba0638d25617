"""The port's libavcodec-backed elements against the JAX package's.

Each test of tests/test_avcodecs.py runs on the port with the same inputs
and the same assertions; its dav1ddec round trip reads the decoded planes
with numpy methods, so the port's copy below reads its planes (tensors on
the selected device) back first and keeps the JAX test's gates.  Then, on
seeded input: ffv1dec, dav1ddec and lewtondec decode the JAX elements'
output from the same packets, rav1enc's stream decodes within the JAX
test's gates, and where the shim is missing each element fails with the
JAX element's error."""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.codecs import avlib as javlib
from gst_plugins_rs_tpu_torch.codecs import avlib
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


OWN = "tests/test_torch_avcodecs.py (planes read back from the device)"
MIRRORED = mirror_jax_tests("test_avcodecs.py", globals(),
                            skip={"TestRav1Enc::test_roundtrip_through_dav1ddec": OWN})

needs_shim = pytest.mark.skipif(not avlib.available(), reason="libavcodec shim not built")


@pytest.fixture
def jax_shim(monkeypatch):
    """The JAX package's shim, loaded, for the tests that run its elements.

    Its loader runs the whole Makefile in place when the library is missing
    and keeps a failed load for the life of the process
    (gst_plugins_rs_tpu/codecs/avlib.py:26-38).  Under xdist every worker
    collects tests/test_avcodecs.py, whose skipif calls that loader, so a
    worker can load native/libgstpu_avshim.so while another is still
    writing it and keep None.  The port's loader builds under a name of its
    own and renames (utils/native_build.py): load through it first, and
    where the reference cached a failure in this process, clear that cache
    and load the reference again.  The reference must load: its elements
    are what the test compares with."""
    assert avlib.available()
    if javlib._lib is None and javlib._tried:
        monkeypatch.setattr(javlib, "_tried", False)
    assert javlib.available(), "the JAX package's libavcodec shim does not load"


def _planes(buf):
    return tuple(p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
                 for p in buf.data)


class TestRav1Enc(TestRav1Enc):  # noqa: F821  (the mirrored class, extended)
    def test_roundtrip_through_dav1ddec(self):
        """tests/test_avcodecs.py's round trip with the planes read back."""
        frames = i420_frames(5)  # noqa: F821
        sink = self._encode(frames, quantizer=60)
        pkts = [np.asarray(s.buffer.data, np.uint8).tobytes() for s in sink.samples]
        dsink = run_pipeline(  # noqa: F821
            "video/x-av1,stream-format=obu-stream,alignment=tu", "dav1ddec", pkts)
        assert len(dsink.samples) == 5
        s = dsink.caps.structure(0)
        assert s["format"] == "I420" and s["width"] == W and s["height"] == H  # noqa: F821
        for (y, u, v), sample in zip(frames, dsink.samples):
            dy, du, dv = _planes(sample.buffer)
            assert np.abs(dy.astype(int) - y.astype(int)).mean() < 4.0
            assert np.abs(du.astype(int) - u.astype(int)).mean() < 4.0


def _run(pkg, caps, factory, buffers, tensor=False):
    p = pkg.parse_launch(f"appsrc name=src ! {factory} ! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(caps) if isinstance(caps, str) else caps)
    for b in buffers:
        if isinstance(b, bytes):
            b = np.frombuffer(b, np.uint8).copy()
            b = torch.from_numpy(b) if tensor else b
        elif tensor:
            b = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in b)
        p.by_name("src").push_buffer(pkg.Buffer(b))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return p.by_name("sink")


def _seeded_i420(n, w=64, h=48, seed=0):
    rng = np.random.default_rng(seed)
    base = np.add.outer(np.arange(h), np.arange(w)).astype(np.float64)
    out = []
    for i in range(n):
        y = np.clip(base * 1.5 + 8 * i + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
        u = rng.integers(100, 156, (h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(100, 156, (h // 2, w // 2), dtype=np.uint8)
        out.append((y, u, v))
    return out


@needs_shim
@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_ffv1dec_matches_jax(payload, jax_shim):
    """ffv1dec on the port and in the JAX package decode the same packets
    to the same planes, bit-exact to the input (FFV1 is lossless); the
    port's three planes are views of one tensor on the selected device."""
    frames = _seeded_i420(4, seed=3)
    enc = avlib.VideoEncoder("ffv1", 64, 48)
    pkts = []
    for i, (y, u, v) in enumerate(frames):
        pkts += [d for d, _, _ in enc.encode(y, u, v, pts=i)]
    pkts += [d for d, _, _ in enc.encode(None)]
    caps = "video/x-ffv,ffvversion=1,width=64,height=48"
    ref = _run(fx, caps, "ffv1dec", pkts)
    got = _run(tfx, caps, "ffv1dec", pkts, tensor=payload == "torch")
    assert len(got.samples) == len(ref.samples) == 4
    for f, r, g in zip(frames, ref.samples, got.samples):
        planes = g.buffer.data
        assert all(isinstance(p, torch.Tensor) for p in planes)
        assert len({p.untyped_storage().data_ptr() for p in planes}) == 1
        for a, b, c in zip(f, _planes(r.buffer), _planes(g.buffer)):
            assert np.array_equal(a, b) and np.array_equal(b, c)
        assert (r.buffer.pts, r.buffer.duration) == (g.buffer.pts, g.buffer.duration)
    assert got.caps.structure(0).fields == ref.caps.structure(0).fields


@needs_shim
@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_rav1enc_round_trip_matches_jax(payload, jax_shim):
    """rav1enc on the port, from numpy and from tensor planes: keyframe
    first, one packet a frame, and both packages' dav1ddec decode its stream
    to the same planes, within tests/test_avcodecs.py's gates of the input."""
    frames = _seeded_i420(5, seed=4)
    caps = "video/x-raw,format=I420,width=64,height=48,framerate=30/1"
    p = tfx.parse_launch("appsrc name=src ! rav1enc speed-preset=10 quantizer=60 "
                         "! appsink name=sink")
    p.by_name("src").set_property("caps", tfx.parse_caps(caps))
    for f in frames:
        planes = tuple(torch.from_numpy(x) for x in f) if payload == "torch" else f
        p.by_name("src").push_buffer(tfx.Buffer(planes))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    out = p.by_name("sink").samples
    assert len(out) == 5 and not out[0].buffer.has_flag(tfx.BufferFlags.DELTA_UNIT)
    pkts = [np.asarray(s.buffer.data, np.uint8).tobytes() for s in out]
    av1 = "video/x-av1,stream-format=obu-stream,alignment=tu"
    ref = _run(fx, av1, "dav1ddec", pkts)
    got = _run(tfx, av1, "dav1ddec", pkts)
    assert len(ref.samples) == len(got.samples) == 5
    for f, r, g in zip(frames, ref.samples, got.samples):
        for a, b, c in zip(f, _planes(r.buffer), _planes(g.buffer)):
            assert np.array_equal(b, c)
            assert np.abs(c.astype(int) - a.astype(int)).mean() < 4.0


@needs_shim
@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_lewtondec_matches_jax(payload, jax_shim):
    """lewtondec decodes the same Vorbis packets to the JAX element's
    samples, timestamps and caps; the port's samples lie on the device."""
    enc = avlib.AudioEncoder("libvorbis", 48000, 2)
    fs = enc.frame_size
    rng = np.random.default_rng(6)
    pcm = (0.3 * np.sin(np.arange(fs * 12)[:, None] * [0.05, 0.07])
           + rng.normal(0, 0.02, (fs * 12, 2))).astype(np.float32)
    pkts = []
    for i in range(0, len(pcm), fs):
        pkts += [d for d, _ in enc.encode(pcm[i:i + fs], pts=i)]
    pkts += [d for d, _ in enc.encode(None)]
    stream = avlib.parse_xiph_extradata(enc.extradata) + pkts
    ref = _run(fx, "audio/x-vorbis", "lewtondec", stream)
    got = _run(tfx, "audio/x-vorbis", "lewtondec", stream, tensor=payload == "torch")
    assert len(ref.samples) == len(got.samples) > 4
    for r, g in zip(ref.samples, got.samples):
        assert isinstance(g.buffer.data, torch.Tensor)
        assert np.array_equal(g.buffer.data.numpy(), np.asarray(r.buffer.data))
        assert (r.buffer.pts, r.buffer.duration) == (g.buffer.pts, g.buffer.duration)
    assert got.caps.structure(0).fields == ref.caps.structure(0).fields


VORBIS_HEADERS = [  # identification (2 channels, 48 kHz), comment, setup
    b"\x01vorbis" + bytes([0, 0, 0, 0, 2]) + (48000).to_bytes(4, "little") + bytes(16),
    b"\x03vorbis" + bytes(8), b"\x05vorbis" + bytes(8)]
I420_FRAME = (np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8),
              np.zeros((24, 32), np.uint8))
WITHOUT_SHIM = [
    ("dav1ddec", "video/x-av1,stream-format=obu-stream,alignment=tu", [bytes(16)]),
    ("ffv1dec", "video/x-ffv,ffvversion=1,width=64,height=48", [bytes(16)]),
    ("rav1enc", "video/x-raw,format=I420,width=64,height=48,framerate=30/1", [I420_FRAME]),
    ("lewtondec", "audio/x-vorbis", VORBIS_HEADERS),
]


def unavailable_error(pkg, factory, caps, buffers):
    """(error type, message, buffers out, bus errors) of a run of `factory`
    whose libavcodec shim is missing."""
    try:
        sink = _run(pkg, caps, factory, buffers)
    except Exception as e:  # noqa: BLE001  (the run's own error is the result)
        return type(e).__name__, str(e)
    return None, len(sink.samples)


@pytest.mark.parametrize("factory,caps,buffers", WITHOUT_SHIM, ids=[c[0] for c in WITHOUT_SHIM])
def test_missing_shim_fails_as_jax(monkeypatch, factory, caps, buffers):
    """Without the shim (as on a machine without libavcodec) each element
    fails its run with the JAX element's RuntimeError, and neither package
    decodes or encodes anything in its place."""
    for mod in (avlib, javlib):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
    assert not avlib.available() and not javlib.available()
    got = unavailable_error(tfx, factory, caps, buffers)
    ref = unavailable_error(fx, factory, caps, buffers)
    assert got == ref and got[0] == "RuntimeError"
    assert got[1].startswith("libavcodec shim unavailable")


@pytest.mark.parametrize("shim", ["available", "missing"])
def test_smoke_library_checks_pass_either_way(monkeypatch, shim):
    """chip_smoke.py's checks of the library-bound elements pass on the CPU
    with the shim (FFV1 bit-exact, AV1 within the JAX test's gate) and
    without it (each element's RuntimeError), and rswebpdec's WebP check
    with this host's Pillow."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    if shim == "missing":
        monkeypatch.setattr(avlib, "_lib", None)
        monkeypatch.setattr(avlib, "_tried", True)
    elif not avlib.available():
        pytest.skip("libavcodec shim not built")
    checks = chip_smoke.library_bound(tfx)
    assert all(ok for _, ok, _ in checks), checks
    names = " ".join(n for n, _, _ in checks)
    assert ("round trip" in names) == (shim == "available")
    assert ("without the shim" in names) == (shim == "missing")
