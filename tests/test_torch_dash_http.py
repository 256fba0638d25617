"""The port's dashsink2 (elements/net/dashsink.py), reqwesthttpsrc and
icecastsink (elements/net/http.py) against the JAX package's.

tests/test_dash_http.py runs on the port with the same inputs and
assertions.  Then, from numpy and from tensor payloads: dashsink2 writes
the JAX element's MPD, init and media segments byte for byte, static and
dynamic; reqwesthttpsrc fetches the same bytes, offsets and caps as the
JAX element (whole files, ranges, seeks); icecastsink sends a server the
same request and body."""
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import mirror_jax_tests, port_on_cpu

import chip_smoke


@pytest.fixture(autouse=True)
def _port_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_dash_http.py", globals())


def _payload(pkg, data, payload):
    return torch.from_numpy(np.ascontiguousarray(data)) if pkg is tfx and payload == "torch" \
        else data


def _files(root):
    root = Path(root)
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*"))
            if f.is_file()}


def _dash_run(pkg, out, payload, dynamic):
    """Video (RGB 64x32 at 10/1) into video_0 and audio (S16 stereo 48 kHz)
    into audio_0 of one dashsink2, two seconds each, one-second segments."""
    sink = pkg.element_factory_make("dashsink2")
    sink.set_property("mpd-root-path", str(out))
    sink.set_property("target-duration", 1)
    sink.set_property("dynamic", dynamic)
    p = pkg.Pipeline()
    p.add(sink)
    rng = np.random.default_rng(3)
    feeds = []
    for kind, caps, n, dur, make in (
            ("video", "video/x-raw,format=RGB,width=64,height=32,framerate=10/1", 20, 10**8,
             lambda: rng.integers(0, 256, (32, 64, 3), dtype=np.uint8)),
            ("audio", "audio/x-raw,format=S16,rate=48000,channels=2,layout=interleaved", 20,
             10**8, lambda: rng.integers(-3000, 3000, (4800, 2), dtype=np.int16))):
        src = pkg.element_factory_make("appsrc", f"src_{kind}")
        src.set_property("caps", pkg.parse_caps(caps))
        p.add(src)
        src.pad("src").link(sink.request_pad(f"{kind}_%u"))
        feeds.append((src, [make() for _ in range(n)], dur))
    for src, bufs, dur in feeds:
        for i, b in enumerate(bufs):
            src.push_buffer(pkg.Buffer(_payload(pkg, b, payload), pts=i * dur, duration=dur))
        src.end_of_stream()
    p.play_until_eos()


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_dashsink2_bytes_equal(tmp_path, payload, dynamic):
    got, ref = tmp_path / "port", tmp_path / "jax"
    got.mkdir()
    ref.mkdir()
    _dash_run(tfx, got, payload, dynamic)
    _dash_run(fx, ref, "numpy", dynamic)
    files = _files(got)
    assert files == _files(ref)
    assert sorted(files) == ["init_0.mp4", "init_1.mp4", "manifest.mpd", "seg_0_1.m4s",
                             "seg_0_2.m4s", "seg_1_1.m4s", "seg_1_2.m4s"]
    assert (b'type="dynamic"' in files["manifest.mpd"]) == dynamic


@pytest.fixture()
def origin(tmp_path):
    """A directory of files (the sizes of a playlist, a segment and a
    block-sized remainder) served over HTTP on 127.0.0.1."""
    root = tmp_path / "www"
    root.mkdir()
    rng = np.random.default_rng(9)
    for name, n in (("a.m3u8", 300), ("seg.m4s", 1_000_003), ("block", 65536 * 3)):
        (root / name).write_bytes(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    with chip_smoke.http_origin(root) as base:
        yield root, base


def _fetch(pkg, url, blocksize, seek=None):
    """reqwesthttpsrc ! appsink: [(bytes, offset, offset_end)], the caps."""
    p = pkg.parse_launch(f"reqwesthttpsrc name=src location={url} blocksize={blocksize} "
                         f"! appsink name=sink")
    if seek is not None:
        assert p.by_name("src").handle_seek(pkg.Event.new_seek(*seek, fmt="bytes"))
    p.play_until_eos()
    sink = p.by_name("sink")
    return ([(chip_smoke._bytes(s.buffer), s.buffer.offset, s.buffer.offset_end)
             for s in sink.samples], sink.caps.structure(0).name)


@pytest.mark.parametrize("name,blocksize", [("a.m3u8", 65536), ("seg.m4s", 65536),
                                            ("seg.m4s", 1 << 20), ("block", 65536)])
def test_reqwesthttpsrc_fetches_as_the_jax_element(origin, name, blocksize):
    root, base = origin
    got = _fetch(tfx, f"{base}/{name}", blocksize)
    assert got == _fetch(fx, f"{base}/{name}", blocksize)
    assert b"".join(b for b, _, _ in got[0]) == (root / name).read_bytes()


def test_reqwesthttpsrc_seek_without_ranges_fails_as_the_jax_element(origin):
    """A byte seek on a server that answers without Range support (the
    standard library's, as the smoke's origin serves): both elements fail
    their run with the same error."""
    _, base = origin
    errors = []
    for pkg in (tfx, fx):
        with pytest.raises(RuntimeError) as e:
            _fetch(pkg, f"{base}/seg.m4s", 65536, seek=(1000, 200_000))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "Range" in errors[0]


class _Icecast(threading.Thread):
    """tests/test_dash_http.py's fake Icecast server."""

    def __init__(self):
        import socket

        super().__init__(daemon=True)
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.request, self.body = b"", b""

    def run(self):
        import socket

        conn, _ = self.sock.accept()
        data = b""
        while b"\r\n\r\n" not in data:
            data += conn.recv(4096)
        self.request, _, self.body = data.partition(b"\r\n\r\n")
        conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
        conn.settimeout(1.0)
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                self.body += chunk
        except socket.timeout:
            pass
        conn.close()
        self.sock.close()


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_icecastsink_sends_what_the_jax_element_sends(payload):
    """Byte buffers (u8 payloads, numpy or tensors) and text buffers into
    icecastsink: the server gets the same PUT request and body from both
    packages; a tensor's bytes are read back once, as host_bytes reads
    them."""
    rng = np.random.default_rng(4)
    bufs = [rng.integers(0, 256, 700, dtype=np.uint8) for _ in range(3)]
    out = {}
    for pkg in (tfx, fx):
        srv = _Icecast()
        srv.start()
        p = pkg.parse_launch(f"appsrc name=src ! icecastsink port={srv.port} mount=/live "
                             f"stream-name=Origin genre=test public=true "
                             f"content-type=audio/ogg")
        p.by_name("src").set_property("caps", pkg.parse_caps("application/ogg"))
        for b in bufs:
            p.by_name("src").push_buffer(pkg.Buffer(_payload(pkg, b, payload) if pkg is tfx
                                                    else b))
        p.by_name("src").push_buffer(pkg.Buffer("tail"))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        srv.join(timeout=5)
        # the Host header names the server's port, one a run
        out[pkg.__name__] = (srv.request.replace(f":{srv.port}".encode(), b":<port>"),
                             srv.body)
    got, ref = out["gst_plugins_rs_tpu_torch"], out["gst_plugins_rs_tpu"]
    assert got == ref
    assert got[1] == b"".join(b.tobytes() for b in bufs) + b"tail"
    assert got[0].startswith(b"PUT /live HTTP/1.1") and b"Ice-Public: 1" in got[0]
