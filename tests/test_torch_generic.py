"""The port's generic elements against the JAX package's on the same seeded
input: originalbuffersave/restore, the file, inter, compression and brotli
elements, gopbuffer, debugseimetainserter, the misc inventory and the brotli
codec.

Every case runs one launch line in both packages.  The port gets the input
twice: as host numpy arrays (the JAX package's payloads) and as torch
tensors, which the byte elements must read back once and the pass-through
elements must hand on.  Payload bytes, PTS, DTS, durations, offsets, flags
and bus messages must be equal, with no tolerance.
"""
import struct
import time

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.codecs import brotli as jbrotli
from gst_plugins_rs_tpu_torch.codecs import brotli as tbrotli
from torch_parity_helpers import payload_summary, port_on_cpu, run_launch

MS = 1_000_000
OCTETS = "application/octet-stream"


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def _bytes(rng, n):
    # compressible but not trivial: runs of a few symbols
    return np.repeat(rng.integers(0, 16, n // 8 + 1, dtype=np.uint8), 8)[:n]


def byte_buffers(seed, n=4, size=3000, flags=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = dict(data=_bytes(rng, size), pts=i * 40 * MS, duration=40 * MS, offset=i * size)
        if flags is not None:
            b["flags"] = flags[i]
        out.append(b)
    return out


def sei_buffers(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        nal = bytes([0x65]) + rng.integers(0, 256, 200 + 50 * i, dtype=np.uint8).tobytes()
        au = len(nal).to_bytes(4, "big") + nal
        out.append(dict(data=np.frombuffer(au, np.uint8).copy(), pts=i * 33 * MS))
    return out


def s302m_buffers(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, (ch, bits) in enumerate([(0, 0), (2, 1), (1, 2), (3, 0)]):
        header = struct.pack(">HH", 240, (ch << 14) | (bits << 4))
        body = rng.integers(0, 256, 240, dtype=np.uint8).tobytes()
        out.append(dict(data=np.frombuffer(header + body, np.uint8).copy(), pts=i * 5 * MS))
    return out


def ac4_buffers(seed):
    """Three AC-4 frames (0xAC40, 0xAC41 with CRC, a 24-bit size) behind junk,
    cut into chunks at seeded points."""
    rng = np.random.default_rng(seed)
    frames = b""
    for sync, size, wide in ((0x40, 120, False), (0x41, 300, False), (0x40, 90, True)):
        head = bytes([0xAC, sync]) + (b"\xff\xff" + size.to_bytes(3, "big") if wide
                                      else size.to_bytes(2, "big"))
        frames += head + rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        if sync == 0x41:
            frames += b"\x12\x34"
    stream = b"\x00\x07" + frames
    cuts = sorted(rng.choice(np.arange(1, len(stream)), 4, replace=False).tolist())
    pieces = [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])]
    return [dict(data=np.frombuffer(p, np.uint8).copy()) for p in pieces]


def text_buffers(seed):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    return [dict(data=" ".join(rng.choice(words, 3)), pts=i * 500 * MS, duration=400 * MS)
            for i in range(5)]


def gop_flags(seed, n):
    rng = np.random.default_rng(seed)
    return [[] if i == 0 or rng.random() < 0.3 else ["DELTA_UNIT"] for i in range(n)]


# name -> (launch, caps of the appsrc, buffer maker)
CASES = {
    "compressenc-zlib": ("compressenc format=zlib level=6", OCTETS, lambda: byte_buffers(1)),
    "compressenc-deflate-roundtrip": ("compressenc format=deflate ! compressdec format=deflate",
                                      OCTETS, lambda: byte_buffers(2)),
    "zlib-aliases": ("zlibcompress ! zlibdecompress", OCTETS, lambda: byte_buffers(3)),
    "deflate-aliases": ("deflatecompress level=1 ! deflatedecompress", OCTETS,
                        lambda: byte_buffers(4)),
    "brotlicompress": ("brotlicompress level=5", OCTETS, lambda: byte_buffers(5)),
    "brotli-roundtrip": ("brotlicompress ! brotlidecompress", OCTETS, lambda: byte_buffers(6)),
    "originalbuffer": ("originalbuffersave ! originalbufferrestore", OCTETS,
                       lambda: byte_buffers(7)),
    "gopbuffer": ("gopbuffer minimum-duration=100000000", OCTETS,
                  lambda: byte_buffers(8, n=12, size=64, flags=gop_flags(8, 12))),
    "gopbuffer-max-size-time": ("gopbuffer minimum-duration=300000000 max-size-time=200000000",
                                OCTETS,
                                lambda: byte_buffers(9, n=16, size=32, flags=gop_flags(9, 16))),
    "debugseimetainserter": ("debugseimetainserter", "video/x-h264,stream-format=avc",
                             lambda: sei_buffers(10)),
    "debugseimetainserter-data": ("debugseimetainserter data=hello uuid="
                                  "00112233-4455-6677-8899-aabbccddeeff",
                                  "video/x-h264,stream-format=avc", lambda: sei_buffers(11)),
    "s302mparse": ("s302mparse", "audio/x-smpte-302m", lambda: s302m_buffers(12)),
    "ac4parse": ("ac4parse", "audio/x-ac4", lambda: ac4_buffers(13)),
    "textahead": ("textahead n-ahead=2 n-previous=1 ahead-attributes=size=\"small\"",
                  "text/x-raw,format=utf8", lambda: text_buffers(14)),
}


def as_tensors(buffers):
    return [dict(b, data=torch.from_numpy(np.array(b["data"]))) if isinstance(b["data"], np.ndarray)
            else dict(b) for b in buffers]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_generic_element_parity(case, payload):
    chain, caps, make = CASES[case]
    launch = f"appsrc name=src ! {chain} ! appsink name=sink"
    ref = run_launch(fx, launch, make(), caps=caps)
    inputs = make() if payload == "numpy" else as_tensors(make())
    got = run_launch(tfx, launch, inputs, caps=caps)
    assert ref[0], "the JAX package emitted nothing"
    assert got == ref


def test_byte_elements_emit_host_uint8_from_tensors():
    """A tensor payload comes out of a byte element as host numpy uint8, as
    from the JAX elements; a pass-through element hands the tensor on."""
    src = byte_buffers(20, n=2)
    for chain, host in (("compressenc", True), ("brotlicompress", True),
                        ("debugseimetainserter", True), ("originalbuffersave", False),
                        ("gopbuffer minimum-duration=0", False)):
        caps = "video/x-h264,stream-format=avc" if "sei" in chain else OCTETS
        p = tfx.parse_launch(f"appsrc name=src ! {chain} ! appsink name=sink")
        p.by_name("src").set_property("caps", tfx.parse_caps(caps))
        sent = [torch.from_numpy(b["data"].copy()) for b in src]
        for i, t in enumerate(sent):
            p.by_name("src").push_buffer(tfx.Buffer(t, pts=i * MS))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        outs = [s.buffer.data for s in p.by_name("sink").samples]
        assert len(outs) == len(sent), chain
        if host:
            assert all(isinstance(o, np.ndarray) and o.dtype == np.uint8 for o in outs), chain
        else:
            assert all(o is t for o, t in zip(outs, sent)), chain


def test_file_roundtrip_parity(tmp_path):
    """rsfilesink writes the same bytes from numpy and tensor payloads as the
    JAX element; rsfilesrc reads them back as the JAX element does."""
    bufs = byte_buffers(30, n=5, size=2500)
    want = b"".join(b["data"].tobytes() for b in bufs)
    files = {}
    for label, pkg, inputs in (("jax", fx, bufs), ("numpy", tfx, bufs),
                               ("torch", tfx, as_tensors(bufs))):
        path = tmp_path / f"{label}.bin"
        _write(pkg, path, inputs)
        files[label] = path.read_bytes()
    assert files["jax"] == files["numpy"] == files["torch"] == want
    launch = f"rsfilesrc location={tmp_path / 'jax.bin'} blocksize=1000 ! appsink name=sink"
    assert run_launch(tfx, launch) == run_launch(fx, launch)


def _write(pkg, path, inputs):
    p = pkg.parse_launch(f"appsrc name=src ! rsfilesink location={path}")
    p.by_name("src").set_property("caps", pkg.parse_caps(OCTETS))
    for b in inputs:
        p.by_name("src").push_buffer(pkg.Buffer(b["data"], pts=b["pts"]))
    p.by_name("src").end_of_stream()
    p.play_until_eos()


@pytest.mark.parametrize("pair", [("intersink", "intersrc"), ("ts-proxysink", "ts-proxysrc")])
def test_inter_bridge_parity(pair):
    """Buffers cross the in-process bridge unchanged: the port hands the
    same buffer objects on, with the JAX package's timestamps and caps."""
    sink_el, src_el = pair
    key = "producer-name" if sink_el == "intersink" else "proxy-context"
    name = f"parity-{sink_el}"
    results = []
    for pkg in (fx, tfx):
        p1 = pkg.parse_launch(
            f"audiotestsrc wave=white-noise seed=3 num-buffers=6 samplesperbuffer=480 "
            f"! audio/x-raw,format=F32,rate=48000,channels=2 ! {sink_el} {key}={name}")
        p1.play_until_eos()
        p2 = pkg.parse_launch(f"{src_el} {key}={name} ! appsink name=sink")
        p2.play_until_eos()
        sink = p2.by_name("sink")
        results.append(([s.buffer.pts for s in sink.samples],
                        [s.buffer.duration for s in sink.samples],
                        [payload_summary(s.buffer.data)[1] for s in sink.samples],
                        str(sink.caps)))
    assert results[1] == results[0]
    assert len(results[0][0]) == 6


def test_intersrc_passes_tensor_objects():
    sent = [torch.arange(8 * i, 8 * i + 8, dtype=torch.float32).reshape(4, 2) for i in range(3)]
    p1 = tfx.parse_launch("appsrc name=src ! intersink producer-name=tensor-objects")
    p1.by_name("src").set_property("caps", tfx.parse_caps(
        "audio/x-raw,format=F32,rate=48000,channels=2,layout=interleaved"))
    for i, t in enumerate(sent):
        p1.by_name("src").push_buffer(tfx.Buffer(t, pts=i * MS))
    p1.by_name("src").end_of_stream()
    p1.play_until_eos()
    p2 = tfx.parse_launch("intersrc producer-name=tensor-objects max-time=0 ! ts-queue "
                          "! appsink name=sink")
    p2.set_state(tfx.State.PLAYING)
    p2.run()
    sink = p2.by_name("sink")
    deadline = time.monotonic() + 30  # the queue's thread drains on its own
    while not sink.eos and time.monotonic() < deadline:
        time.sleep(0.005)
    p2.set_state(tfx.State.NULL)
    got = [s.buffer.data for s in sink.samples]
    assert len(got) == 3 and all(a is b for a, b in zip(got, sent))


def test_viuersink_parity():
    rng = np.random.default_rng(40)
    frame = rng.integers(0, 256, (36, 64, 4), dtype=np.uint8)
    renders = []
    for pkg, data in ((fx, frame), (tfx, frame), (tfx, torch.from_numpy(frame.copy()))):
        for truecolor in (True, False):
            el = pkg.element_factory_make("viuersink")
            el.set_property("width", 20)
            el.set_property("truecolor", truecolor)
            el.render(pkg.Buffer(data))
            renders.append(el.last_render)
    assert renders[0] and renders[0] == renders[2] == renders[4]
    assert renders[1] and renders[1] == renders[3] == renders[5]


def test_brotli_codec_parity():
    """The port's brotli module is the JAX module's: the same backend on this
    host, the same compressed bytes, and streams that split the same way."""
    assert tbrotli.backend() in ("libbrotli", "stored-subset")
    rng = np.random.default_rng(50)
    for size in (0, 1, 1000, 70_000):
        data = _bytes(rng, size).tobytes()
        for q in (0, 5, 11):
            c = tbrotli.compress(data, quality=q)
            assert c == jbrotli.compress(data, quality=q)
            assert tbrotli.decompress(c) == data
        two = tbrotli.compress(data) + tbrotli.compress(data[::-1])
        assert tbrotli.decompress_stream(two) == jbrotli.decompress_stream(two)
    assert tbrotli._compress_stored(b"abc" * 999) == jbrotli._compress_stored(b"abc" * 999)
    assert tbrotli._decompress_subset(tbrotli._compress_stored(b"xyz" * 77)) == b"xyz" * 77


def test_uriplaylistbin_parity(tmp_path):
    """Seeded files played twice through uriplaylistbin: the same bytes,
    item messages and final indices in both packages."""
    rng = np.random.default_rng(60)
    uris = []
    for i in range(3):
        path = tmp_path / f"item{i}.bin"
        path.write_bytes(_bytes(rng, 1500 + 700 * i).tobytes())
        uris.append(f"file://{path}")
    uris.insert(2, uris[1])  # a repeated item posts no new collection
    launch = (f"uriplaylistbin name=pl uris={','.join(uris)} iterations=2 blocksize=1024 "
              f"! appsink name=sink")
    results = []
    for pkg in (fx, tfx):
        p = pkg.parse_launch(launch)
        p.play_until_eos()
        pl = p.by_name("pl")
        results.append(([buffer_payload(s) for s in p.by_name("sink").samples],
                        [m for m in map(_msg, p.bus.messages()) if m is not None],
                        pl.get_property("current-uri-index"),
                        pl.get_property("current-iteration")))
    assert results[1] == results[0]
    assert results[0][2:] == (3, 1)


def buffer_payload(sample):
    return payload_summary(sample.buffer.data)


def _msg(m):
    if m.structure is None or m.type.value == "state-changed":
        return None
    return m.type.value, m.structure.name, sorted((k, str(v)) for k, v in m.structure.fields.items())
