"""The port's FLAC codec and claxondec against the JAX package's.

Each test of tests/test_flac.py and test_flac_external_oracle.py runs on the
port with the same inputs and the same assertions.  Then, on seeded input:
the port's encoder writes the JAX encoder's bytes, both decoders (native and
Python) decode the JAX decoders' samples bit for bit, claxondec emits the
JAX element's buffers from numpy and from tensor payloads, and each native
loader builds only its own target."""
import os
import shutil

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.codecs import flac as jflac
from gst_plugins_rs_tpu_torch.codecs import avlib, flac
from gst_plugins_rs_tpu_torch.utils import native_build
from torch_parity_helpers import mirror_jax_tests, port_on_cpu, run_launch


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = (mirror_jax_tests("test_flac.py", globals())
            + mirror_jax_tests("test_flac_external_oracle.py", globals()))


def _pcm(n, channels, bps, seed):
    """Seeded tones, noise, a silent stretch and a full-scale run."""
    rng = np.random.default_rng(seed)
    lim = (1 << (bps - 1)) - 1
    t = np.arange(n)
    out = np.stack([np.sin(t * (0.013 + 0.004 * c)) * 0.6 * lim
                    + rng.normal(0, 0.01 * lim, n) for c in range(channels)], 1)
    out[n // 3 : n // 3 + 700] = 0
    out[-50:] = lim
    return np.clip(np.rint(out), -lim - 1, lim).astype(np.int64)


CASES = [
    dict(channels=2, bps=16, rate=44100, block_size=4096, mode="fixed", stereo_mode="independent"),
    dict(channels=2, bps=16, rate=48000, block_size=1152, mode="lpc", stereo_mode="left-side"),
    dict(channels=2, bps=24, rate=192000, block_size=4096, mode="fixed", stereo_mode="mid-side"),
    dict(channels=1, bps=24, rate=96000, block_size=1000, mode="verbatim", stereo_mode="independent"),
    dict(channels=6, bps=16, rate=48000, block_size=576, mode="fixed", stereo_mode="independent"),
    dict(channels=2, bps=8, rate=22050, block_size=256, mode="constant", stereo_mode="independent"),
]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c['bps']}bit-{c['mode']}-{c['stereo_mode']}")
def test_encoder_bytes_equal_jax(case):
    case = dict(case)
    pcm = _pcm(9001, case.pop("channels"), case["bps"], seed=case["block_size"])
    assert flac.encode(pcm, **case) == jflac.encode(pcm, **case)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("case", CASES[:4], ids=lambda c: f"{c['bps']}bit-{c['mode']}")
def test_decode_bit_equal_jax(case, native):
    case = dict(case)
    pcm = _pcm(7001, case.pop("channels"), case["bps"], seed=3)
    data = jflac.encode(pcm, **case)
    info, got = flac.decode(data, native=native)
    jinfo, ref = jflac.decode(data, native=native)
    assert info == flac.StreamInfo(**vars(jinfo))
    assert got.dtype == ref.dtype == np.int32
    assert np.array_equal(got, ref) and np.array_equal(got, pcm)


def test_native_decoder_is_the_one_that_runs():
    """With the native library built, decode() and claxondec decode every
    frame natively, and the Python reference none."""
    assert flac.native_available()
    pcm = _pcm(12000, 2, 16, seed=5)
    data = flac.encode(pcm, block_size=4096)
    flac.native_frames = flac.python_frames = 0
    flac.decode(data)
    assert (flac.native_frames, flac.python_frames) == (3, 0)
    flac.decode(data, native=False)
    assert (flac.native_frames, flac.python_frames) == (3, 3)


def _claxon_buffers(data, tensor, chunk=997):
    chunks = [np.frombuffer(data[i:i + chunk], np.uint8).copy() for i in range(0, len(data), chunk)]
    return [dict(data=torch.from_numpy(c) if tensor else c) for c in chunks]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("bps", [16, 24])
def test_claxondec_matches_jax(bps, payload):
    """The same buffers, timestamps and caps as the JAX element; the port's
    samples lie on the selected device."""
    pcm = _pcm(20000, 2, bps, seed=bps)
    data = flac.encode(pcm, rate=48000, bps=bps, block_size=2048, stereo_mode="mid-side")
    launch = "appsrc name=src ! claxondec ! appsink name=sink"
    ref = run_launch(fx, launch, _claxon_buffers(data, False), caps="audio/x-flac")
    got = run_launch(tfx, launch, _claxon_buffers(data, payload == "torch"), caps="audio/x-flac")
    assert len(ref[0]) >= 2 and got == ref
    p = tfx.parse_launch(launch)
    p.by_name("src").set_property("caps", tfx.parse_caps("audio/x-flac"))
    for b in _claxon_buffers(data, False, chunk=65536):
        p.by_name("src").push_buffer(tfx.Buffer(b["data"]))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    out = [s.buffer.data for s in p.by_name("sink").samples]
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu" for o in out)
    assert np.array_equal(torch.cat(out).numpy(), pcm)


def test_claxondec_keeps_no_decoded_bytes():
    """The element's accumulator holds at most the frame still arriving."""
    from gst_plugins_rs_tpu_torch.elements.audiofx.claxondec import ClaxonDec

    pcm = _pcm(30000, 2, 16, seed=9)
    data = flac.encode(pcm, block_size=1024)
    dec = ClaxonDec()
    dec.set_state(tfx.State.PLAYING)
    try:
        sizes = []
        for i in range(0, len(data), 4096):
            dec._acc += data[i:i + 4096]
            dec._decode_ready(final=False)
            sizes.append(len(dec._acc))
    finally:
        dec.set_state(tfx.State.NULL)
    assert max(sizes) < 4096 + 8192  # a chunk and one frame at most


@pytest.fixture
def scratch_native(tmp_path, monkeypatch):
    """A copy of native/ whose libavcodec shim cannot link, with both
    loaders pointed at it and their state reset."""
    root = tmp_path / "native"
    root.mkdir()
    for name in os.listdir(native_build.NATIVE_DIR):
        if not name.endswith(".so"):
            shutil.copy(os.path.join(native_build.NATIVE_DIR, name), root / name)
    mk = (root / "Makefile").read_text()
    assert "-lavcodec" in mk
    (root / "Makefile").write_text(mk.replace("-lavcodec", "-lgstpu_no_such_library"))
    for mod, lib, tried in ((flac, "_native_lib", "_native_tried"), (avlib, "_lib", "_tried")):
        monkeypatch.setattr(mod, "NATIVE_DIR", str(root))
        monkeypatch.setattr(mod, lib, None)
        monkeypatch.setattr(mod, tried, False)
    return root


def test_loaders_build_only_their_own_target(scratch_native):
    """Where the shim cannot link, the FLAC decoder still builds and loads
    natively, and avlib reports no shim instead of raising."""
    assert avlib.available() is False
    assert not (scratch_native / "libgstpu_avshim.so").exists()
    assert flac.native_available()
    assert (scratch_native / "libgstpu_flacdec.so").exists()
    assert not (scratch_native / "libgstpu_hostops.so").exists()  # no other target built
    assert not [n for n in os.listdir(scratch_native) if ".tmp" in n]
    pcm = _pcm(5000, 2, 16, seed=1)
    flac.native_frames = 0
    _, out = flac.decode(flac.encode(pcm))
    assert flac.native_frames == 2 and np.array_equal(out, pcm)
    with pytest.raises(RuntimeError, match="libavcodec shim unavailable"):
        avlib.VideoDecoder("ffv1")
