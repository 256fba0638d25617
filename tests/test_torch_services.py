"""The port's speech-service elements (elements/net/services.py) against the
JAX package's.

tests/test_services.py runs on the port with the same inputs and
assertions: Deepgram, Speechmatics, the ElevenLabs synthesizer and voice
cloner against in-process fakes, llamacpp-texttransform's gating and echo
fallback, and its brotli cases.  Then: the audio each transcriber and the
cloner send for F32 tensors equals the JAX package's for the same samples;
llamacpp-texttransform with a model runs it on the selected device and
gives the JAX package's text (it needs `transformers`, and skips without);
and the divergence at EOS: a reply still owed when the stream ends reaches
the port's output (within the element's `latency`), and not the JAX
element's.  The JAX synthesizer's 10 ms reply window explains
test_services.py::test_elevenlabs_synthesizer's failures under load: a
reply later than 10 ms after its text, with EOS next, is lost."""
import base64
import importlib.util
import json
import threading
import time

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_services.py", globals())


def _f32_audio(seed, n=3, samples=800):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((samples, 1)) * 0.6).astype(np.float32) for _ in range(n)]


def _serve(handler):
    from websockets.sync.server import serve

    srv = serve(handler, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"ws://127.0.0.1:{srv.socket.getsockname()[1]}"


def _audio_run(pkg, factory, uri, bufs, caps="audio/x-raw,format=F32,rate=16000,channels=1"):
    p = pkg.parse_launch(f"appsrc name=src ! {factory} name=t url={uri} ! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(caps))
    for i, b in enumerate(bufs):
        p.by_name("src").push_buffer(pkg.Buffer(b, pts=i * 50_000_000))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return [bytes(np.asarray(s.buffer.data, np.uint8)).decode() for s in p.by_name("sink").samples]


@pytest.mark.parametrize("factory", ["deepgramtranscriber", "speechmaticstranscriber"])
def test_transcriber_audio_from_f32_tensors_equals_the_jax_packages(factory):
    """The binary frames each transcriber sends: the port's from F32
    tensors, the JAX package's from the same samples as numpy arrays."""
    sent = {}

    def handler(ws):
        got = sent.setdefault(len(sent), [])
        for raw in ws:
            if isinstance(raw, bytes):
                got.append(raw)
                continue
            msg = json.loads(raw)
            if msg.get("message") == "StartRecognition":
                ws.send(json.dumps({"message": "RecognitionStarted"}))
            elif msg.get("message") == "EndOfStream":
                ws.send(json.dumps({"message": "EndOfTranscript"}))
                return
            elif msg.get("type") == "CloseStream":
                return

    srv, uri = _serve(handler)
    try:
        bufs = _f32_audio(11)
        _audio_run(fx, factory, uri, bufs)
        _audio_run(tfx, factory, uri, [torch.from_numpy(b) for b in bufs])
    finally:
        srv.shutdown()
    ref, got = sent[0], sent[1]
    assert got == ref == [(np.clip(b, -1, 1) * 32767).astype(np.int16).tobytes() for b in bufs]


def test_voicecloner_audio_from_f32_tensors_equals_the_jax_packages():
    def collected(pkg, bufs):
        el = pkg.element_factory_make("elevenlabsvoicecloner")
        src = pkg.element_factory_make("appsrc")
        src.set_property("caps", pkg.parse_caps("audio/x-raw,format=F32,rate=16000,channels=1"))
        p = pkg.Pipeline()
        p.add(src, el)
        src.link(el)
        el.on_event = lambda event: None  # keep the audio: no upload at EOS
        for b in bufs:
            src.push_buffer(pkg.Buffer(b))
        src.end_of_stream()
        p.play_until_eos()
        return bytes(el._audio)

    bufs = _f32_audio(12)
    assert collected(tfx, [torch.from_numpy(b) for b in bufs]) == collected(fx, bufs)


def _slow_synthesizer(delay_s):
    """A fake ElevenLabs stream-input service that answers each text
    `delay_s` late and closes the stream at the empty text."""
    def handler(ws):
        for raw in ws:
            msg = json.loads(raw)
            if "voice_settings" in msg:
                continue
            text = msg.get("text", "")
            if not text:
                return
            time.sleep(delay_s)
            pcm = (np.ones(50, "<i2") * len(text)).tobytes()
            ws.send(json.dumps({"audio": base64.b64encode(pcm).decode()}))

    return _serve(handler)


def _synthesize(pkg, uri, texts):
    p = pkg.parse_launch(f"appsrc name=src ! elevenlabssynthesizer url={uri} ! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps("text/x-raw,format=utf8"))
    for t in texts:
        p.by_name("src").push_buffer(pkg.Buffer(np.frombuffer(t.encode(), np.uint8).copy()))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return [np.asarray(s.buffer.data)[:, 0].tolist() for s in p.by_name("sink").samples]


def test_synthesizer_waits_for_the_audio_owed_at_eos():
    """Replies 0.3 s after each text (past the 10 ms window): the port's
    synthesizer flushes the stream at EOS and waits, within `latency`, for
    what is owed: every text's audio, in order; the JAX element ends with
    the last text's audio still in flight (it takes replies only in the
    10 ms after a text) and loses it."""
    srv, uri = _slow_synthesizer(0.3)
    try:
        texts = ["hello there", "a second line"]
        got = _synthesize(tfx, uri, texts)
        ref = _synthesize(fx, uri, texts)
    finally:
        srv.shutdown()
    assert got == [[len(t)] * 50 for t in texts]
    assert len(ref) < len(texts) and ref == got[:len(ref)]


def test_synthesizer_waits_no_longer_than_its_latency():
    """A service that never answers: the port's synthesizer ends at EOS
    after `latency` (200 ms here), with no output."""
    def handler(ws):
        for _ in ws:
            pass

    srv, uri = _serve(handler)
    try:
        p = tfx.parse_launch(f"appsrc name=src ! elevenlabssynthesizer url={uri} latency=200 "
                             f"! appsink name=sink")
        p.by_name("src").set_property("caps", tfx.parse_caps("text/x-raw,format=utf8"))
        p.by_name("src").push_buffer(tfx.Buffer(np.frombuffer(b"hi", np.uint8).copy()))
        p.by_name("src").end_of_stream()
        t0 = time.monotonic()
        p.play_until_eos()
        waited = time.monotonic() - t0
    finally:
        srv.shutdown()
    assert p.by_name("sink").samples == []
    assert 0.2 <= waited < 5.0


def _slow_deepgram(delay_s):
    def handler(ws):
        n = 0
        for raw in ws:
            if isinstance(raw, str):
                if json.loads(raw).get("type") == "CloseStream":
                    return
                continue
            n += 1
            time.sleep(delay_s)
            ws.send(json.dumps({"type": "Results", "is_final": True,
                                "channel": {"alternatives": [{"transcript": f"final {n}"}]}}))

    return _serve(handler)


def test_transcriber_waits_for_the_transcripts_owed_at_eos():
    """Deepgram answering 0.2 s after each buffer: the port's transcriber
    sends CloseStream at EOS and waits for the service to end the stream:
    every transcript out, in order; the JAX element loses those in flight."""
    bufs = [np.zeros((800, 1), np.int16) for _ in range(3)]
    caps = "audio/x-raw,format=S16,rate=16000,channels=1,layout=interleaved"
    srv, uri = _slow_deepgram(0.2)
    try:
        got = _audio_run(tfx, "deepgramtranscriber", uri, bufs, caps)
        ref = _audio_run(fx, "deepgramtranscriber", uri, bufs, caps)
    finally:
        srv.shutdown()
    assert got == ["final 1", "final 2", "final 3"]
    assert len(ref) < 3 and ref == got[:len(ref)]


@pytest.fixture(scope="module")
def tiny_causal_lm(tmp_path_factory):
    """A seeded two-layer GPT-2 and a word-level tokenizer of 32 words,
    saved where `model-path` can point (built offline)."""
    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import GPT2Config, GPT2LMHeadModel, PreTrainedTokenizerFast

    words = ["[UNK]", "[EOS]"] + [f"w{i}" for i in range(30)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    path = tmp_path_factory.mktemp("tiny_lm")
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="[UNK]",
                            eos_token="[EOS]").save_pretrained(path)
    torch.manual_seed(0)
    GPT2LMHeadModel(GPT2Config(vocab_size=len(words), n_positions=64, n_embd=32, n_layer=2,
                               n_head=2, eos_token_id=1, bos_token_id=1)).save_pretrained(path)
    return str(path)


def test_llamacpp_runs_the_model_on_the_selected_device(tiny_causal_lm):
    """With model-path, greedy (temp=0): the port's element puts the model
    on the selected device (the CPU here) and gives the JAX element's text."""
    def run(pkg):
        p = pkg.parse_launch(f"appsrc name=src ! llamacpp-texttransform name=llm "
                             f"model-path={tiny_causal_lm} temp=0 max-tokens=5 "
                             f"! appsink name=sink")
        p.by_name("src").set_property("caps", pkg.parse_caps("text/x-raw,format=utf8"))
        p.by_name("src").push_buffer(pkg.Buffer(np.frombuffer(b"w3 w7 w1", np.uint8).copy()))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return p, [bytes(np.asarray(s.buffer.data, np.uint8)).decode()
                   for s in p.by_name("sink").samples]

    p, got = run(tfx)
    _, ref = run(fx)
    assert got == ref and len(got) == 1
    assert next(p.by_name("llm")._model.parameters()).device == tfx.device()
