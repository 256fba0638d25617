"""asr-lite and whispertranscriber of the PyTorch port against the JAX package,
on the CPU.

Gates and why:

- speechsynth: bit-equal (the same numpy and scipy code).
- logmel: within LOGMEL_TOL = 1e-4 of the JAX features (f32 FFTs of two
  libraries, then a log and a normalisation); a 300-sample chunk is the
  index-clamp case (JAX clamps out-of-range gathers; the port clamps the
  indices).
- each GRU direction and layer: within GRU_TOL = 1e-5 of the JAX scan's
  hidden states (the port hoists the input products out of the recurrence:
  the same terms summed in another order; states are bounded by 1).
- forward logits: within LOGIT_TOL = 1e-4 at T = 50 and T = 500.
- transcripts: equal to the JAX package's, and to the spoken words.

The JAX side runs as its own tests run it on the CPU.  Torch runs on one
intra-op thread (tests/torch_parity_helpers.py).
"""
import importlib.util
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import asr as jasr
from gst_plugins_rs_tpu.ops import speechsynth as jsynth
from gst_plugins_rs_tpu_torch.models.convert import asr_weights
from gst_plugins_rs_tpu_torch.ops import asr as tasr
from gst_plugins_rs_tpu_torch.ops import asr_gru
from gst_plugins_rs_tpu_torch.ops import speechsynth as tsynth
from torch_parity_helpers import port_on_cpu

LOGMEL_TOL = 1e-4
GRU_TOL = 1e-5
LOGIT_TOL = 1e-4

# the fixed commands of tests/test_asr_quality.py
COMMANDS = [
    (77_000_001, ["open", "door"]),
    (77_000_002, ["volume", "up"]),
    (77_000_003, ["seven", "three", "zero"]),
    (77_000_004, ["hello", "world"]),
    (77_000_005, ["stop"]),
]


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


@pytest.fixture(scope="module")
def weights():
    """The packaged weights: the JAX package's dict and the port's tensors
    carried from the same numpy arrays."""
    with np.load(jasr.DEFAULT_WEIGHTS) as z:
        np_tree = {k: z[k] for k in z.files}
    return {k: jnp.asarray(v) for k, v in np_tree.items()}, asr_weights(np_tree, "cpu")


@pytest.mark.parametrize("words,seed,snr", [
    (["open", "door"], 3, None),
    (["seven", "three", "zero"], 77_000_003, 30),
    (["play", "record", "five"], 123456, 30),
])
def test_speechsynth_bit_equal(words, seed, snr):
    kw = {} if snr is None else {"noise_snr_db": snr}
    a = jsynth.synth_sentence(words, seed=seed, **kw)
    b = tsynth.synth_sentence(words, seed=seed, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_speechsynth_lexicon_equal():
    assert tsynth.LEXICON == jsynth.LEXICON and tsynth.RATE == jsynth.RATE


def test_charset_and_ids_equal():
    assert tasr.CHARS == jasr.CHARS and tasr.N_CLASSES == jasr.N_CLASSES
    text = "open the door seven"
    np.testing.assert_array_equal(tasr.text_to_ids(text), jasr.text_to_ids(text))
    ids = jasr.text_to_ids(text)
    assert tasr.ids_to_text(ids) == jasr.ids_to_text(ids) == text


def test_mel_and_window_equal():
    np.testing.assert_array_equal(tasr._MEL_NP, np.asarray(jasr._MEL))
    np.testing.assert_array_equal(tasr._WINDOW_NP, np.asarray(jasr._WINDOW))


@pytest.mark.parametrize("n", [300, 400, 401, 18964])
def test_logmel_matches_jax(n):
    audio = tsynth.synth_sentence(["seven", "three", "zero"], seed=9, noise_snr_db=30)
    audio = np.resize(audio, n).astype(np.float32)
    ref = np.asarray(jasr.logmel(jnp.asarray(audio)))
    got = tasr.logmel(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < LOGMEL_TOL
    assert np.abs(tasr.logmel_np(audio) - ref).max() < LOGMEL_TOL


def test_logmel_np_matches_jax_logmel_np():
    audio = tsynth.synth_sentence(["seven"], seed=9)
    np.testing.assert_allclose(tasr.logmel_np(audio), jasr.logmel_np(audio), rtol=0, atol=1e-5)


def test_init_weights_bit_equal():
    a, b = jasr.init_weights(5), tasr.init_weights(5)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("direction", ["f", "b"])
def test_gru_direction_matches_jax_scan(weights, layer, direction):
    jw, tw = weights
    D = 40 if layer == 0 else 192
    xs = np.random.RandomState(10 * layer + (direction == "b")).randn(120, D).astype(np.float32)
    ref = np.asarray(jasr._gru_scan(jw, f"gru{layer}{direction}_", jnp.asarray(xs),
                                    reverse=direction == "b"))
    Wx, b, U = tasr.layer_mats(tw, layer)
    hs = asr_gru.bigru(tasr.input_projections(torch.from_numpy(xs)[None], Wx, b), U)
    got = hs[0, 0 if direction == "f" else 1].numpy()
    assert np.abs(got - ref).max() < GRU_TOL


def test_bigru_batches_utterances(weights):
    """Two utterances in one call equal each alone (the kernel's grid rows)."""
    _, tw = weights
    Wx, b, U = tasr.layer_mats(tw, 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 30, 40).astype(np.float32))
    both = asr_gru.bigru(tasr.input_projections(x, Wx, b), U)
    for i in range(2):
        one = asr_gru.bigru(tasr.input_projections(x[i:i + 1], Wx, b), U)
        torch.testing.assert_close(both[i:i + 1], one, rtol=0, atol=1e-6)


def test_bigru_rejects_bad_shapes():
    with pytest.raises(ValueError):
        asr_gru.bigru(torch.zeros(1, 2, 5, 96), torch.zeros(2, 3, 96, 96))
    with pytest.raises(ValueError):
        asr_gru.bigru(torch.zeros(1, 2, 5, 288), torch.zeros(2, 3, 96, 95))


@pytest.mark.parametrize("T", [50, 500])
def test_forward_logits_match_jax(weights, T):
    jw, tw = weights
    feats = np.random.RandomState(T).randn(T, 40).astype(np.float32)
    ref = np.asarray(jasr.forward(jw, jnp.asarray(feats)))
    got = tasr.forward(tw, torch.from_numpy(feats)).numpy()
    assert got.shape == ref.shape == (T, jasr.N_CLASSES)
    assert np.abs(got - ref).max() < LOGIT_TOL


def test_forward_logits_of_speech_match_jax(weights):
    """The padded features of a command, as transcribe runs them."""
    jw, tw = weights
    audio = tsynth.synth_sentence(["volume", "up"], seed=77_000_002, noise_snr_db=30)
    feats, t = tasr.padded_features(torch.from_numpy(audio))
    ref = np.asarray(jasr.forward(jw, jnp.asarray(feats.numpy())))
    got = tasr.forward(tw, feats).numpy()
    assert feats.shape[0] % tasr.BUCKET == 0 and t <= feats.shape[0]
    assert np.abs(got - ref).max() < LOGIT_TOL
    assert tasr.greedy_ids(torch.from_numpy(got[:t])) == jasr.greedy_ids(ref[:t])


@pytest.mark.parametrize("seed,words", COMMANDS)
def test_fixed_commands_transcribed_as_jax(weights, seed, words):
    jw, tw = weights
    audio = tsynth.synth_sentence(words, seed=seed, noise_snr_db=30)
    got = tasr.transcribe(tw, audio)
    assert got == jasr.transcribe(jw, audio) == " ".join(words)


def test_load_weights_equals_carrier(weights):
    _, tw = weights
    loaded = tasr.load_weights(dev="cpu")
    assert sorted(loaded) == sorted(tw)
    for k in tw:
        assert torch.equal(loaded[k], tw[k])


def test_asr_weights_names_missing_keys():
    with pytest.raises(KeyError, match="out_w"):
        asr_weights({k: np.zeros(1) for k in tasr.init_weights(0) if k != "out_w"}, "cpu")


# ---------------------------------------------------------------------------
# whispertranscriber
# ---------------------------------------------------------------------------
def _transcribe_pipeline(fx, audio, chunk_ns, caps="text/x-raw", spb=None):
    p = fx.Pipeline()
    src = fx.element_factory_make("appsrc")
    src.set_property("caps", fx.parse_caps("audio/x-raw,format=F32,rate=16000,channels=1"))
    tr = fx.element_factory_make("whispertranscriber")
    tr.set_property("chunk-duration", chunk_ns)
    cf = fx.element_factory_make("capsfilter")
    cf.set_property("caps", fx.parse_caps(caps))
    sink = fx.element_factory_make("appsink")
    for e in (src, tr, cf, sink):
        p.add(e)
    src.link(tr)
    tr.link(cf)
    cf.link(sink)
    spb = spb or audio.size
    for i in range(0, audio.size, spb):
        src.push_buffer(fx.Buffer(audio[i:i + spb, None], pts=i * 10**9 // 16000))
    src.end_of_stream()
    p.play_until_eos()
    return sink.samples


def test_pipeline_speech_to_text():
    """The mirror of test_asr_quality.py's element test: appsrc(synth
    speech) -> whispertranscriber(builtin) -> appsink."""
    audio = tsynth.synth_sentence(["play", "record", "five"], seed=123456, noise_snr_db=30)
    samples = _transcribe_pipeline(tfx, audio, 10_000_000_000)
    texts = [str(s.buffer.data) for s in samples]
    joined = " ".join(t.strip() for t in texts if t.strip())
    assert joined == "play record five", repr(texts)
    assert all(isinstance(s.buffer.data, str) for s in samples)


def test_chunks_pts_and_json_match_jax():
    """Two sentences in 0.25 s buffers over 1 s chunks: the same texts, PTS,
    durations and caps as the JAX element; the drain emits the tail (a chunk
    shorter than one 400-sample window: the index-clamp case)."""
    a = tsynth.synth_sentence(["open", "door"], seed=77_000_001, noise_snr_db=30)
    b = tsynth.synth_sentence(["stop"], seed=77_000_005, noise_snr_db=30)
    n = a.size + b.size
    audio = np.concatenate([a, b, np.zeros(-(-n // 16000) * 16000 + 250 - n, np.float32)])
    for caps in ("text/x-raw", "application/x-json"):
        ref = _transcribe_pipeline(jfx, audio, 1_000_000_000, caps, spb=4000)
        got = _transcribe_pipeline(tfx, audio, 1_000_000_000, caps, spb=4000)
        assert [s.buffer.data for s in got] == [s.buffer.data for s in ref]
        assert [(s.buffer.pts, s.buffer.duration) for s in got] == \
            [(s.buffer.pts, s.buffer.duration) for s in ref]
        assert got[-1].buffer.duration == 250 * 10**9 // 16000
    assert json.loads(got[0].buffer.data)["lines"][0].keys() == {"text"}


def test_whisper_properties_and_pads_match_jax():
    a = jfx.element_factory_make("whispertranscriber")
    b = tfx.element_factory_make("whispertranscriber")
    pa = {p.name: (p.default, p.type, getattr(p, "choices", None)) for p in a._all_props()}
    pb = {p.name: (p.default, p.type, getattr(p, "choices", None)) for p in b._all_props()}
    assert pa == pb
    assert str(a.SINK_CAPS) == str(b.SINK_CAPS) and str(a.SRC_CAPS) == str(b.SRC_CAPS)
    assert a.latency_additional_ns() == b.latency_additional_ns()


def test_no_model_path_uses_builtin():
    el = tfx.element_factory_make("whispertranscriber")
    el.set_state(tfx.State.PAUSED)
    assert el._asr_weights is not None and el._asr_weights["out_w"].device.type == "cpu"
    el.set_state(tfx.State.NULL)


def test_random_weights_pipeline():
    """The allow-random-weights wiring (transformers' Whisper with random
    weights, token ids as text), as tests/test_whisper.py runs it."""
    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    p = tfx.parse_launch(
        "audiotestsrc wave=sine num-buffers=4 samplesperbuffer=8000 "
        "! audio/x-raw,format=F32,rate=16000,channels=1 "
        "! whispertranscriber allow-random-weights=true "
        "chunk-duration=1000000000 max-new-tokens=4 "
        "! appsink name=sink")
    p.play_until_eos()
    sink = p.by_name("sink")
    texts = [str(s.buffer.data) for s in sink.samples]
    assert len(texts) == 2 and all(texts)
    assert [s.buffer.pts for s in sink.samples] == [0, 1_000_000_000]
    assert sink.caps.structure(0).name == "text/x-raw"
