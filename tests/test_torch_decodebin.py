"""The port's decodebin and typefind against the JAX package's.

The plug table names factories of later slices of the port.  Until they
are ported, a stream that needs one of them must fail loudly and cleanly:
an ERROR message on the bus that names the missing factory, nothing
exposed downstream, an error flow to the upstream source, and no KeyError
out of the streaming thread.  Streams with no decoder to plug are exposed
raw, as in the JAX package, from numpy and from tensor payloads, and SCC
and MCC caption files are plugged into their parsers as in the JAX
package.  An FLV stream plugs rsflvdemux, whose mu-law audio then needs
mulawdec (ops/g711.py, a later slice's).
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
from torch_parity_helpers import port_on_cpu, run_launch

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


# the streams whose decoder is a factory of a later slice (sccparse,
# mccparse and rsflvdemux are ported: their cases are below)
MISSING = sorted(k for k, (_, f) in HEADS.items()
                 if f not in ("sccparse", "mccparse", "rsflvdemux"))


@pytest.mark.parametrize("kind", MISSING)
def test_missing_factory_posts_error_and_exposes_nothing(kind):
    head, factory = HEADS[kind]
    assert not factory_exists(factory)
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


def test_failed_decodebin_answers_every_buffer_with_an_error_flow():
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


def test_flv_plugs_rsflvdemux_then_posts_error_naming_mulawdec():
    """An FLV stream with mu-law audio: decodebin plugs rsflvdemux, whose
    audio pad needs mulawdec, which waits for ops/g711.py: an ERROR names
    it, nothing is exposed, and the source's next buffer gets an error
    flow."""
    from test_image_flv import make_flv

    from gst_plugins_rs_tpu_torch.core import State

    assert factory_exists("rsflvdemux") and not factory_exists("mulawdec")
    flv = make_flv([(8, i * 20, bytes([0x80]) + bytes([i]) * 160) for i in range(3)])
    p = tfx.parse_launch("appsrc name=src ! decodebin name=db ! appsink name=sink")
    src, db = p.by_name("src"), p.by_name("db")
    src.set_property("caps", tfx.parse_caps("application/octet-stream"))
    for i, at in enumerate((0, 200, len(flv))[:-1]):
        src.push_buffer(tfx.Buffer(np.frombuffer(flv[at:(200, len(flv))[i]], np.uint8).copy(),
                                   pts=None))
    src.end_of_stream()
    p.set_state(State.PLAYING)
    try:
        with pytest.raises(RuntimeError, match="flow error"):
            p.run()
        assert [c.ELEMENT_NAME for c in db._children] == ["rsflvdemux"]
    finally:
        p.set_state(State.NULL)
    errors = [m.structure for m in p.bus.messages(tfx.MessageType.ERROR)]
    assert [e["factory"] for e in errors] == ["mulawdec"]
    assert errors[0]["caps"] == "audio/x-mulaw"
    assert db.src_pads() == [] and p.by_name("sink").samples == []
