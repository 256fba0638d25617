"""The port's decodebin and typefind against the JAX package's.

Each test of tests/test_decodebin.py runs on the port with the same inputs
and the same assertions.  Every factory of the plug table is ported: FLAC
streams plug claxondec, PNG and JPEG imagersdec, GIF gifdec and WebP
rswebpdec, SCC and MCC caption files their parsers, an FLV stream
rsflvdemux and then mulawdec on its mu-law audio, each decoding what the
JAX package's decodebin decodes, from numpy and from tensor payloads.
Streams with no decoder to plug are exposed raw.  Where a stream needs a
factory that is not registered (hidden here from the registry), decodebin
fails loudly and cleanly: an ERROR message on the bus that names the
missing factory, nothing exposed downstream, an error flow to the upstream
source, and no KeyError out of the streaming thread.
"""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.core.typefind import typefind as jtypefind
from gst_plugins_rs_tpu_torch.core import FlowReturn
from gst_plugins_rs_tpu_torch.core.registry import factory_exists
from gst_plugins_rs_tpu_torch.core.typefind import typefind
from gst_plugins_rs_tpu_torch.elements.generic import decodebin
from torch_parity_helpers import mirror_jax_tests, port_on_cpu, run_launch

HEADS = {
    "flac": (b"fLaC" + bytes(60), "claxondec"),
    "flv": (b"FLV\x01" + bytes(60), "rsflvdemux"),
    "png": (b"\x89PNG\r\n\x1a\n" + bytes(56), "imagersdec"),
    "jpeg": (b"\xff\xd8\xff\xe0" + bytes(60), "imagersdec"),
    "gif": (b"GIF89a" + bytes(58), "gifdec"),
    "webp": (b"RIFF\x00\x00\x00\x00WEBP" + bytes(52), "rswebpdec"),
    "scc": (b"Scenarist_SCC V1.0\n" + bytes(45), "sccparse"),
    "mcc": (b"File Format=MacCaption_MCC V1.0\n" + bytes(32), "mccparse"),
}


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_decodebin.py", globals())


def test_typefind_matches_jax():
    rng = np.random.default_rng(0)
    heads = [h for h, _ in HEADS.values()] + [
        bytes(4) + b"ftypisom", (b"\x47" + bytes(187)) * 2, b"gst-sodium10" + bytes(40),
        b"WEBVTT\n\n", b"\xff\xfb\x90\x00", b"\x00\x00\x00\x00", b"ab"]
    heads += [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (4, 16, 400)]
    for h in heads:
        assert typefind(h) == jtypefind(h), h[:16]
    assert typefind(HEADS["flac"][0]) == "audio/x-flac"


def _raw(tensor):
    data = np.frombuffer(b"\x01\x02\x03\x04" * 2000, np.uint8).copy()
    chunks = [data[i:i + 1500] for i in range(0, len(data), 1500)]
    return [dict(data=torch.from_numpy(c.copy()) if tensor else c, pts=i * 1_000_000)
            for i, c in enumerate(chunks)]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_unknown_stream_exposed_raw_as_jax(payload):
    launch = "appsrc name=src ! decodebin ! appsink name=sink"
    ref = run_launch(fx, launch, _raw(False), caps="application/octet-stream")
    got = run_launch(tfx, launch, _raw(payload == "torch"), caps="application/octet-stream")
    assert b"".join(s[0][2] for s in got[0]) == b"\x01\x02\x03\x04" * 2000
    assert got[0] == ref[0]


def _hide(monkeypatch, factory):
    """decodebin sees `factory` as not registered (a factory of a package
    built without it)."""
    assert factory_exists(factory)
    monkeypatch.setattr(decodebin, "factory_exists", lambda name: name != factory)


# the streams whose decoder was a factory of a later slice until this one
# (sccparse, mccparse and rsflvdemux came before: their cases are below)
MISSING = sorted(k for k, (_, f) in HEADS.items()
                 if f not in ("sccparse", "mccparse", "rsflvdemux"))


@pytest.mark.parametrize("kind", MISSING)
def test_missing_factory_posts_error_and_exposes_nothing(monkeypatch, kind):
    head, factory = HEADS[kind]
    _hide(monkeypatch, factory)
    p = tfx.parse_launch("appsrc name=src ! decodebin name=db ! appsink name=sink")
    src, db = p.by_name("src"), p.by_name("db")
    src.set_property("caps", tfx.parse_caps("application/octet-stream"))
    for i in range(2):
        src.push_buffer(tfx.Buffer(np.frombuffer(head, np.uint8).copy(), pts=i))
    src.end_of_stream()
    with pytest.raises(RuntimeError, match="flow error"):  # the source's error flow
        p.play_until_eos()
    errors = [m.structure for m in p.bus.messages(tfx.MessageType.ERROR)]
    assert len(errors) == 1 and errors[0]["factory"] == factory
    assert factory in errors[0]["reason"]
    assert db.src_pads() == [] and p.by_name("sink").samples == []


def test_failed_decodebin_answers_every_buffer_with_an_error_flow(monkeypatch):
    _hide(monkeypatch, "imagersdec")
    p = tfx.parse_launch("appsrc name=src ! decodebin name=db ! appsink name=sink")
    p.by_name("src").set_property("caps", tfx.parse_caps("application/octet-stream"))
    db = p.by_name("db")
    p.set_state(tfx.State.PLAYING)
    try:
        head = HEADS["png"][0]
        for _ in range(3):
            assert db.sinkpad.chain(tfx.Buffer(np.frombuffer(head, np.uint8).copy())) \
                == FlowReturn.ERROR
    finally:
        p.set_state(tfx.State.NULL)
    assert len(p.bus.messages(tfx.MessageType.ERROR)) == 1


def _stream(kind):
    """A seeded stream of each kind the image and codec slice decodes."""
    import io

    from PIL import Image

    from gst_plugins_rs_tpu.codecs import flac

    rng = np.random.default_rng(len(kind))
    if kind == "flac":
        t = np.arange(9000)
        pcm = np.stack([np.sin(t * 0.02) * 9000, np.cos(t * 0.013) * 7000], 1).astype(np.int64)
        return flac.encode(pcm + rng.integers(-40, 40, pcm.shape), rate=48000, block_size=2048)
    y, x = np.mgrid[0:24, 0:40]
    frame = np.stack([x * 6, y * 10, (x + y) * 4], -1).astype(np.uint8)
    frame = (frame + rng.integers(0, 8, frame.shape)).astype(np.uint8)
    bio = io.BytesIO()
    params = {"jpeg": {"quality": 90}, "webp": {"lossless": True}}.get(kind, {})
    Image.fromarray(frame).save(bio, kind.upper(), **params)
    return bio.getvalue()


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("kind", MISSING)
def test_codec_and_image_streams_autoplugged_as_jax(kind, payload):
    """decodebin typefinds the stream and plugs the slice's decoder: the
    same buffers, timestamps and bus messages as the JAX package's
    decodebin, the port's output on the selected device."""
    data = _stream(kind)
    chunks = [data[i:i + 777] for i in range(0, len(data), 777)]
    launch = "appsrc name=src ! decodebin ! appsink name=sink"

    def bufs(tensor):
        return [dict(data=(torch.from_numpy if tensor else np.asarray)(
            np.frombuffer(c, np.uint8).copy()), pts=None) for c in chunks]

    ref = run_launch(fx, launch, bufs(False), caps="application/octet-stream")
    got = run_launch(tfx, launch, bufs(payload == "torch"), caps="application/octet-stream")
    assert len(ref[0]) >= 1 and got == ref
    p = tfx.parse_launch(launch)
    p.by_name("src").set_property("caps", tfx.parse_caps("application/octet-stream"))
    for b in bufs(False):
        p.by_name("src").push_buffer(tfx.Buffer(b["data"]))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    assert all(isinstance(s.buffer.data, torch.Tensor) for s in p.by_name("sink").samples)


def _caption_file(kind):
    """An SCC or MCC file of two pop-on captions, written by the port's
    encoder (the MCC header's uuid and date fixed)."""
    from gst_plugins_rs_tpu_torch.ops import cea608

    pairs = cea608.encode_pop_on(["VIA DECODEBIN"]) + cea608.encode_pop_on(["SECOND", "CAPTION"])
    launch = f"appsrc name=src ! {kind}enc name=enc ! appsink name=sink"

    def configure(p):
        if kind == "mcc":
            p.by_name("enc").set_property("uuid", "5E1B2C3D-4A5B-4C6D-8E7F-0A1B2C3D4E5F")
            p.by_name("enc").set_property("creation-date", "Sunday, October 18, 2026")

    bufs = [dict(data=np.asarray(pairs[i:i + 2], np.uint8), pts=i * 16_683_333)
            for i in range(0, len(pairs) - 1, 2)]
    samples, _ = run_launch(tfx, launch, bufs, caps="closedcaption/x-cea-608,format=raw",
                            configure=configure)
    return b"".join(s[0].encode() if isinstance(s[0], str) else s[0][2] for s in samples)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("kind", ["scc", "mcc"])
def test_caption_file_autoplugged_as_jax(kind, payload):
    """decodebin typefinds an SCC / MCC file and plugs sccparse / mccparse:
    the same 608 pairs, timestamps and bus messages as the JAX package's
    decodebin (tests/test_decodebin.py's scc case)."""
    data = _caption_file(kind)
    chunks = [data[i:i + 700] for i in range(0, len(data), 700)]
    launch = "appsrc name=src ! decodebin ! appsink name=sink"

    def bufs(tensor):
        return [dict(data=(torch.from_numpy if tensor else np.asarray)(
            np.frombuffer(c, np.uint8).copy()), pts=None) for c in chunks]

    ref = run_launch(fx, launch, bufs(False), caps="application/octet-stream")
    got = run_launch(tfx, launch, bufs(payload == "torch"), caps="application/octet-stream")
    assert len(ref[0]) >= 2 and got == ref


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_flv_autoplugged_through_mulawdec_as_jax(payload):
    """An FLV stream with mu-law audio: decodebin plugs rsflvdemux, then
    mulawdec on its audio pad, and decodes the samples the JAX package's
    decodebin decodes (tests/test_decodebin.py's FLV case), equal to
    audioop's G.711 table, from numpy and from tensor chunks."""
    import audioop

    from test_image_flv import make_flv

    rng = np.random.default_rng(3)
    ulaw = [rng.integers(0, 256, 160, dtype=np.uint8).tobytes() for _ in range(3)]
    flv = make_flv([(8, i * 20, bytes([0x80]) + u) for i, u in enumerate(ulaw)])
    chunks = [flv[:200], flv[200:]]
    launch = "appsrc name=src ! decodebin ! appsink name=sink"

    def bufs(tensor):
        return [dict(data=(torch.from_numpy if tensor else np.asarray)(
            np.frombuffer(c, np.uint8).copy()), pts=None) for c in chunks]

    ref = run_launch(fx, launch, bufs(False), caps="application/octet-stream")
    got = run_launch(tfx, launch, bufs(payload == "torch"), caps="application/octet-stream")
    assert len(got[0]) == 3 and got == ref
    pcm = b"".join(s[0][2] for s in got[0])
    assert pcm == audioop.ulaw2lin(b"".join(ulaw), 2)
