"""The port's translationbin and transcriberbin with the AWS transcriber and
translator (elements/cc, elements/net/aws.py) against the JAX package's.

tests/test_translationbin.py runs on the port with the same inputs and
assertions (translationbin over awstranscriber2 and awstranslate against
fake services, the compress and onvif aliases).  Then, against the same
fakes in both packages: translationbin's es-ES pad through awstranslate,
and transcriberbin with transcriber=awstranscriber captioning frames.  The
JAX transcriber may lose a transcript still in flight at EOS (its 10 ms
reply window; the port waits for what is owed), so the JAX package's
output is held to be a prefix of the port's, which is complete; the
captions are compared as the CEA-608 byte pairs they carry, which do not
depend on which buffer a transcript came out with.  Both packages caption
the transcriber's UTF-8 bytes as the text of their array (textwrap reads a
payload as str(data): ROADMAP C.8)."""
import json
import threading

import numpy as np
import pytest

import chip_smoke as cs
import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu_torch.net import eventstream
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_translationbin.py", globals())

N_AUDIO = 4


@pytest.fixture()
def services():
    """A Transcribe websocket answering AudioEvent n with "word n" (the
    stream ended after the empty AudioEvent) and a REST Translate
    answering "<lang>: <text>"; the requests' texts are recorded."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from websockets.sync.server import serve

    seen = {"translate": []}

    def transcribe(ws):
        n = 0
        for raw in ws:
            _, payload, _ = eventstream.decode_message(raw if isinstance(raw, bytes)
                                                       else raw.encode())
            if not payload:
                return
            n += 1
            doc = {"Transcript": {"Results": [{"IsPartial": False,
                                               "Alternatives": [{"Transcript": f"word {n}"}]}]}}
            ws.send(eventstream.encode_message(
                {":message-type": "event", ":event-type": "TranscriptEvent"},
                json.dumps(doc).encode()))

    class Translate(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen["translate"].append(body["Text"])
            out = json.dumps({"TranslatedText":
                              f"{body['TargetLanguageCode']}: {body['Text']}"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

    ws = serve(transcribe, "127.0.0.1", 0)
    http = ThreadingHTTPServer(("127.0.0.1", 0), Translate)
    for srv in (ws, http):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield (f"ws://127.0.0.1:{ws.socket.getsockname()[1]}",
           f"http://127.0.0.1:{http.server_address[1]}", seen)
    ws.shutdown()
    http.shutdown()


def _audio(pkg, src, n=N_AUDIO):
    src.set_property("caps", pkg.parse_caps(
        "audio/x-raw,format=S16,rate=16000,channels=1,layout=interleaved"))
    for i in range(n):
        src.push_buffer(pkg.Buffer(np.full((1600, 1), i, np.int16), pts=i * 100_000_000,
                                   duration=100_000_000))
    src.end_of_stream()


def _texts(sink):
    return [bytes(np.asarray(s.buffer.data, np.uint8)).decode() for s in sink.samples]


def test_translationbin_es_pad_through_awstranslate_matches_jax(services):
    ts_uri, tr_uri, seen = services
    out = {}
    for pkg in (fx, tfx):
        tb = pkg.element_factory_make("translationbin")
        tb.set_property("transcriber", "awstranscriber2")
        tb.set_property("transcriber::endpoint-uri", ts_uri)
        pad = tb.request_src_pad(language_code="es-ES", translator_props={
            "endpoint-uri": tr_uri, "access-key": "AKID", "secret-access-key": "sec"})
        src, sink = pkg.element_factory_make("appsrc"), pkg.element_factory_make("appsink")
        p = pkg.Pipeline()
        p.add(src, tb, sink)
        src.link(tb)
        pad.link(sink.pad("sink"))
        _audio(pkg, src)
        p.play_until_eos()
        out[pkg] = _texts(sink)
    assert out[tfx] == [f"es: word {n + 1}" for n in range(N_AUDIO)]
    assert out[fx] == out[tfx][:len(out[fx])]
    assert seen["translate"][-N_AUDIO:] == [f"word {n + 1}" for n in range(N_AUDIO)]


def _caption_run(pkg, ts_uri, frames):
    p = pkg.Pipeline()
    tb = pkg.element_factory_make("transcriberbin", "tb")
    tb.set_property("transcriber", "awstranscriber")
    tb.set_property("transcriber::endpoint-uri", ts_uri)
    tb.set_property("mode", "pop-on")
    asrc, vsrc = pkg.element_factory_make("appsrc"), pkg.element_factory_make("appsrc")
    vsink, asink = pkg.element_factory_make("appsink"), pkg.element_factory_make("appsink")
    for e in (asrc, vsrc, tb, vsink, asink):
        p.add(e)
    asrc.pad("src").link(tb.pad("sink_audio"))
    vsrc.pad("src").link(tb.pad("sink_video"))
    tb.pad("src_video").link(vsink.pad("sink"))
    tb.pad("src_audio").link(asink.pad("sink"))
    _audio(pkg, asrc)
    vsrc.set_property("caps", pkg.parse_caps(
        "video/x-raw,format=RGBA,width=32,height=16,framerate=30/1"))
    for i, f in enumerate(frames):
        vsrc.push_buffer(pkg.Buffer(f, pts=i * 33_333_333, duration=33_333_333))
    vsrc.end_of_stream()
    p.play_until_eos()
    pairs = []
    for s in vsink.samples:
        for m in s.buffer.metas:
            if type(m).__name__ == "VideoCaptionMeta":
                data = bytes(m.data)
                pairs += [(data[i], data[i + 1]) for i in range(0, len(data) - 1, 2)
                          if (data[i], data[i + 1]) != (0x80, 0x80)]
    audio = [np.asarray(s.buffer.data).tobytes() for s in asink.samples]
    return pairs, audio, len(vsink.samples)


def test_transcriberbin_with_awstranscriber_matches_jax(services):
    ts_uri, _, _ = services
    frames = [np.random.default_rng(i).integers(0, 256, (16, 32, 4), dtype=np.uint8)
              for i in range(90)]
    ref_pairs, ref_audio, ref_n = _caption_run(fx, ts_uri, frames)
    pairs, audio, n = _caption_run(tfx, ts_uri, frames)
    assert n == ref_n == len(frames) and audio == ref_audio
    # textwrap and tttocea608 read a payload as str(data), in both packages:
    # the AWS transcriber's UTF-8 bytes (a u8 array) are captioned as that
    # array's text (ROADMAP C.8)
    text = cs.caption_text(pairs)
    assert all(str(np.frombuffer(f"word {k + 1}".encode(), np.uint8)) in text
               for k in range(N_AUDIO)), text
    assert ref_pairs == pairs[:len(ref_pairs)]
