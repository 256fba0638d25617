"""The port's AWS elements (elements/net/aws.py), its event-stream framing
(net/eventstream.py) and its S3 client (net/s3.py) against the JAX
package's.

tests/test_aws.py runs on the port with the same inputs and assertions:
S3 sources and sinks against a SigV4-checking fake, Polly, Translate,
Transcribe's event stream, the HLS sink's segments and the reference's
property surface.  Then, on seeded inputs, the two packages give the same
bytes: event-stream messages; every S3 request of a multipart upload, a
PutObject and ranged reads, signed at one fixed time (the port's payloads
tensors, F32 among them: their raw bytes); Polly's PCM under each overflow
mode; and the AudioEvents awstranscriber2 sends for F32 tensors.  And the
divergence at EOS: a transcript still owed when the stream ends reaches
the port's output, and not the JAX element's."""
import datetime
import io
import json
import threading
import time
import urllib.parse

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.net import eventstream as jes, sigv4 as jsigv4
from gst_plugins_rs_tpu_torch.net import eventstream as tes, sigv4 as tsigv4
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_aws.py", globals())

SEEDS = range(3)
FIXED = datetime.datetime(2026, 3, 14, 15, 9, 26, tzinfo=datetime.timezone.utc)


@pytest.mark.parametrize("seed", SEEDS)
def test_eventstream_bytes_equal_the_jax_packages(seed):
    rng = np.random.default_rng(seed)
    headers = {":message-type": "event", ":event-type": "AudioEvent",
               ":content-type": "application/octet-stream",
               f"x-seed-{seed}": "v" * int(rng.integers(0, 40))}
    payload = rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
    msg = tes.encode_message(headers, payload)
    assert msg == jes.encode_message(headers, payload)
    assert tes.decode_message(msg) == jes.decode_message(msg) == (headers, payload, len(msg))


class _Recorder:
    """urllib.request.urlopen for both packages' S3 clients, with no
    network: records every request (method, URL, headers, body) and answers
    as S3 does (multipart initiate, parts, completion, PUT, HEAD, ranged
    GET) from its own objects."""

    def __init__(self):
        self.requests, self.objects = [], {}

    def __call__(self, req, timeout=None):
        import email.message

        method, url, body = req.get_method(), req.full_url, req.data or b""
        self.requests.append((method, url, sorted((k.lower(), v) for k, v in req.header_items()),
                              body))
        u = urllib.parse.urlsplit(url)
        q = dict(urllib.parse.parse_qsl(u.query, keep_blank_values=True))
        out, status, hdrs = b"", 200, email.message.Message()
        if method == "POST" and "uploads" in q:
            out = b"<InitiateMultipartUploadResult><UploadId>u1</UploadId>" \
                  b"</InitiateMultipartUploadResult>"
        elif method == "PUT" and "partNumber" in q:
            self.objects.setdefault((u.path, "parts"), []).append(body)
            hdrs["ETag"] = f'"e{q["partNumber"]}"'
        elif method == "POST":
            self.objects[u.path] = b"".join(self.objects.pop((u.path, "parts"), []))
        elif method == "PUT":
            self.objects[u.path] = body
            hdrs["ETag"] = '"e"'
        elif method == "HEAD":
            hdrs["Content-Length"] = str(len(self.objects[u.path]))
        elif method == "GET":
            start, end = req.get_header("Range")[6:].split("-")
            out, status = self.objects[u.path][int(start):int(end) + 1], 206
        return _Resp(out, status, hdrs)


class _Resp:
    def __init__(self, body, status, headers):
        self._body, self.status, self.headers = io.BytesIO(body), status, headers

    def read(self):
        return self._body.read()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _s3_run(pkg, payloads, monkeypatch):
    """awss3sink (multipart, 3000-byte parts), awss3putobjectsink and
    awss3src (ranged reads of 2500 bytes) against a _Recorder, every request
    signed at FIXED."""
    import urllib.request

    rec = _Recorder()
    sigv4 = tsigv4 if pkg is tfx else jsigv4
    sign = sigv4.sign_headers
    monkeypatch.setattr(sigv4, "sign_headers", lambda *a, **k: sign(*a, **{**k, "now": FIXED}))
    monkeypatch.setattr(urllib.request, "urlopen", rec)
    creds = ("region=eu-west-1 access-key=AKID secret-access-key=secret "
             "endpoint-uri=http://s3.test:9000")
    for sink in ("awss3sink part-size=3000 key=multi.bin",
                 "awss3putobjectsink key=put.bin content-type=application/octet-stream"):
        p = pkg.parse_launch(f"appsrc name=src ! {sink} bucket=bkt {creds}")
        p.by_name("src").set_property("caps", pkg.parse_caps("application/octet-stream"))
        for b in payloads:
            p.by_name("src").push_buffer(pkg.Buffer(b))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
    p = pkg.parse_launch(f"awss3src bucket=bkt key=multi.bin blocksize=2500 {creds} "
                         f"! appsink name=sink")
    p.play_until_eos()
    back = b"".join(np.asarray(s.buffer.data).tobytes() for s in p.by_name("sink").samples)
    monkeypatch.undo()
    return rec, back


def test_s3_requests_signed_at_a_fixed_time_equal_the_jax_packages(monkeypatch):
    """Every request of the uploads and the ranged reads, headers
    (Authorization among them) and bodies, equal between the packages; the
    port's payloads are tensors (u8 and F32: their raw bytes)."""
    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 256, 2000, dtype=np.uint8),
              rng.standard_normal(700).astype(np.float32),
              rng.integers(0, 256, 3100, dtype=np.uint8)]
    ref, ref_back = _s3_run(fx, arrays, monkeypatch)
    got, got_back = _s3_run(tfx, [torch.from_numpy(a) for a in arrays], monkeypatch)
    raw = b"".join(a.tobytes() for a in arrays)
    assert got.requests == ref.requests and len(got.requests) > 8
    assert got.objects["/bkt/multi.bin"] == got.objects["/bkt/put.bin"] == raw
    assert got_back == ref_back == raw
    assert all(any(k == "authorization" for k, _ in h) for _, _, h, _ in got.requests)


@pytest.mark.parametrize("mode,duration,max_overflow,max_compression", [
    ("clip", 20_000_000, 0, 0.0), ("nothing", 20_000_000, 0, 0.0),
    ("compress", 20_000_000, 4, 0.0), ("compress", 20_000_000, 50, 1.5),
    ("compress", 20_000_000, 0, 3.0), ("clip", None, 0, 0.0)])
def test_polly_overflow_pcm_equals_the_jax_packages(mode, duration, max_overflow,
                                                    max_compression):
    pcm = (np.random.default_rng(5).standard_normal((900, 1)) * 4000).astype(np.int16)
    out = []
    for pkg in (tfx, fx):
        el = pkg.element_factory_make("awspolly")
        el.set_property("overflow", mode)
        el.set_property("max-overflow", max_overflow)
        el.set_property("max-compression", max_compression)
        out.append(el._apply_overflow(pcm, duration))
    assert out[0].dtype == out[1].dtype == np.int16
    assert np.array_equal(out[0], out[1])


def _transcribe_fake(delay_s=0.0):
    """Transcribe's websocket: records each AudioEvent, answers it with a
    final transcript `delay_s` later, ends the stream after the empty one."""
    from websockets.sync.server import serve

    events = []

    def handler(ws):
        n = 0
        for raw in ws:
            _, payload, _ = tes.decode_message(raw if isinstance(raw, bytes) else raw.encode())
            if not payload:
                return
            events.append(payload)
            n += 1
            time.sleep(delay_s)
            doc = {"Transcript": {"Results": [{"IsPartial": False,
                                               "Alternatives": [{"Transcript": f"chunk {n}"}]}]}}
            ws.send(tes.encode_message({":message-type": "event",
                                        ":event-type": "TranscriptEvent"},
                                       json.dumps(doc).encode()))

    srv = serve(handler, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"ws://127.0.0.1:{srv.socket.getsockname()[1]}", events


def _transcribe(pkg, uri, bufs):
    p = pkg.parse_launch(f"appsrc name=src ! awstranscriber2 endpoint-uri={uri} "
                         f"! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(
        "audio/x-raw,format=F32,rate=16000,channels=1,layout=interleaved"))
    for i, b in enumerate(bufs):
        p.by_name("src").push_buffer(pkg.Buffer(b, pts=i * 100_000_000))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return [bytes(np.asarray(s.buffer.data, np.uint8)).decode() for s in p.by_name("sink").samples]


def test_transcriber_audio_events_from_f32_tensors_equal_the_jax_packages():
    rng = np.random.default_rng(9)
    bufs = [(rng.standard_normal((1600, 1)) * 0.7).astype(np.float32) for _ in range(3)]
    srv, uri, events = _transcribe_fake()
    try:
        _transcribe(fx, uri, bufs)
        ref = list(events)
        events.clear()
        got_text = _transcribe(tfx, uri, [torch.from_numpy(b) for b in bufs])
    finally:
        srv.shutdown()
    assert events == ref == [(np.clip(b, -1, 1) * 32767).astype(np.int16).tobytes()
                             for b in bufs]
    assert got_text == ["chunk 1", "chunk 2", "chunk 3"]


def test_transcriber_waits_for_the_transcripts_owed_at_eos():
    """Transcripts 0.2 s after each AudioEvent: at EOS the port's
    awstranscriber2 ends the stream (the empty AudioEvent) and waits for the
    service to end it: every transcript out, in order, on the main and the
    unsynced pads; the JAX element loses those in flight."""
    bufs = [np.zeros((1600, 1), np.float32) for _ in range(3)]
    srv, uri, _ = _transcribe_fake(0.2)
    try:
        ref = _transcribe(fx, uri, bufs)
        p = tfx.parse_launch(f"appsrc name=src ! awstranscriber2 name=t endpoint-uri={uri} "
                             f"! appsink name=sink")
        un = tfx.element_factory_make("appsink", "un")
        p.add(un)
        p.by_name("t").pad("unsynced_src").link(un.pad("sink"))
        p.by_name("src").set_property("caps", tfx.parse_caps(
            "audio/x-raw,format=F32,rate=16000,channels=1,layout=interleaved"))
        for b in bufs:
            p.by_name("src").push_buffer(tfx.Buffer(b))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
    finally:
        srv.shutdown()
    texts = [[bytes(np.asarray(s.buffer.data, np.uint8)).decode() for s in sink.samples]
             for sink in (p.by_name("sink"), un)]
    assert texts == [["chunk 1", "chunk 2", "chunk 3"]] * 2
    assert len(ref) < 3 and ref == texts[0][:len(ref)]
