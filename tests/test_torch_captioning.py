"""The port's live-captioning path against the JAX package's.

Speech goes into transcriberbin (the builtin asr-lite), the video beside
it picks up CEA-608 captions as VideoCaptionMeta, cea608overlay draws them
and one cmafmux a track writes the fragments (chip_smoke.py's
caption_pipeline, phases 4m/5m/6m).  Held to the JAX package on the same
inputs: the caption bytes equal, the overlaid frames within
OVERLAY_LSB_TOL of the JAX package's, the fragmented files equal outside
their mdat payloads, the audio samples bit-equal.  Also: test_whisper.py's
transcriberbin cases and test_asr_quality.py's speech-to-captions case on
the port, the ERROR the bins post where a factory of a later slice is
needed, translationbin's same-language branch, and that the path raises
with no card and no request for the CPU.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu_torch.core.registry import factory_exists
from torch_parity_helpers import mirror_jax_tests, port_on_cpu

# The composite is the same f32 arithmetic in both packages; XLA may fuse
# it into other instructions than torch runs, so a pixel may round one u8
# LSB apart.
OVERLAY_LSB_TOL = 1
W, H = 320, 180
N_FRAMES = 24


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


# TestWhisper and test_asr_quality.py's other classes are held against the
# JAX package in test_torch_asr.py.
MIRRORED = (mirror_jax_tests("test_whisper.py", globals(),
                             skip={"TestWhisper": "test_torch_asr.py"})
            + mirror_jax_tests("test_asr_quality.py", globals(), skip={
                "TestSynth": "test_torch_asr.py", "TestAsrQuality": "test_torch_asr.py",
                "TestWhisperElementBuiltin": "test_torch_asr.py"}))


def _frames(n=N_FRAMES, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (H, W, 4), dtype=np.uint8) for _ in range(n)]


def _run(pkg, tensors=False, frames=None):
    audio = cs.caption_audio()
    frames = _frames() if frames is None else frames
    if tensors:
        audio, frames = torch.from_numpy(audio), [torch.from_numpy(f) for f in frames]
    p = cs.caption_run(cs.caption_pipeline(pkg, audio, frames))
    return p, cs.caption_outputs(p)


def _host(data):
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


@pytest.fixture(scope="module")
def jax_run():
    return _run(fx)[1]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_captioned_recording_matches_jax(jax_run, payload):
    with port_on_cpu():
        p, got = _run(tfx, tensors=payload == "torch")
    ref = jax_run
    assert got["pairs"] == ref["pairs"] and got["pairs"]
    assert all(w in cs.caption_text(got["pairs"]) for w in cs.CAP_WORDS)
    assert len(got["overlaid"]) == len(ref["overlaid"]) == N_FRAMES
    for a, b in zip(got["graded"], ref["graded"]):
        assert np.array_equal(_host(a.data), np.asarray(b.data))
    d = max(int(np.abs(_host(a.data).astype(np.int64) - np.asarray(b.data).astype(np.int64)).max())
            for a, b in zip(got["overlaid"], ref["overlaid"]))
    assert d <= OVERLAY_LSB_TOL
    changed, outside = cs.caption_changes(p, got["graded"], got["overlaid"])
    assert all(changed) and outside == 0
    assert cs.mp4_skeleton(got["video"]) == cs.mp4_skeleton(ref["video"])
    assert got["audio"] == ref["audio"]
    track, samples, frags = cs.check_caption_file(
        got["video"], "uncv", [1000] * N_FRAMES, cs.CAP_FPS * 1000)
    assert (track.width, track.height, frags) == (W, H, 1)
    assert all(s == _host(b.data).tobytes() for s, b in zip(samples, got["overlaid"]))
    durs = [b.data.shape[0] for b in got["audio_in"]]
    assert sum(durs) == cs.caption_audio().shape[0] and len(durs) == 11
    assert cs.check_caption_file(got["audio"], "fpcm", durs, cs.CAP_RATE)[2] == 2
    if d == 0:
        assert got["video"] == ref["video"]


def test_overlay_frames_match_jax_on_both_fields():
    """cea608overlay on frames carrying caption metas of each 608 type,
    against the JAX package: frames within OVERLAY_LSB_TOL, black-background
    on and off."""
    from gst_plugins_rs_tpu.ops import cea608

    pairs = cea608.encode_pop_on(["CAPTIONS ON", "THE CARD"])
    raw = bytes(b for pr in pairs for b in pr)
    s334 = bytes(b for hi, lo in pairs for b in (0x80, hi, lo))
    frames = _frames(4, seed=3)

    def run(pkg, black, ctype, data):
        p = pkg.parse_launch(f"appsrc name=src ! cea608overlay black-background={black} "
                             f"! appsink name=sink")
        p.by_name("src").set_property("caps", pkg.parse_caps(
            f"video/x-raw,format=RGBA,width={W},height={H},framerate=30/1"))
        for i, f in enumerate(frames):
            b = pkg.Buffer(f, pts=i * 33_333_333, duration=33_333_333)
            if i == 1:
                b.add_meta(pkg.core.VideoCaptionMeta(ctype, data))
            p.by_name("src").push_buffer(b)
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return [_host(s.buffer.data) for s in p.by_name("sink").samples]

    for black in ("false", "true"):
        for ctype, data in (("cea608-raw", raw), ("cea608-s334-1a", s334)):
            ref, got = run(fx, black, ctype, data), run(tfx, black, ctype, data)
            assert np.array_equal(got[0], frames[0])
            assert not np.array_equal(got[1], frames[1])
            d = max(int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())
                    for a, b in zip(got, ref))
            assert d <= OVERLAY_LSB_TOL, (black, ctype)


def _caption_bin(pkg, **props):
    p = pkg.Pipeline()
    tb = pkg.element_factory_make("transcriberbin", "tb")
    for k, v in props.items():
        tb.set_property(k, v)
    asrc, vsrc = pkg.element_factory_make("appsrc", "asrc"), pkg.element_factory_make(
        "appsrc", "vsrc")
    asrc.set_property("caps", pkg.parse_caps("audio/x-raw,format=F32,rate=16000,channels=1"))
    vsrc.set_property("caps", pkg.parse_caps(
        f"video/x-raw,format=RGBA,width={W},height={H},framerate=30/1"))
    vsink, asink = pkg.element_factory_make("appsink", "vsink"), pkg.element_factory_make(
        "appsink", "asink")
    for e in (asrc, vsrc, tb, vsink, asink):
        p.add(e)
    asrc.pad("src").link(tb.pad("sink_audio"))
    vsrc.pad("src").link(tb.pad("sink_video"))
    tb.pad("src_video").link(vsink.pad("sink"))
    tb.pad("src_audio").link(asink.pad("sink"))
    asrc.push_buffer(pkg.Buffer(cs.caption_audio(), pts=0))
    vsrc.push_buffer(pkg.Buffer(_frames(1)[0], pts=0, duration=33_333_333))
    asrc.end_of_stream()
    vsrc.end_of_stream()
    return p


@pytest.mark.parametrize("props, factory", [
    ({"translation-languages": "fr=cc1"}, "awstranslate"),
    ({"transcriber": "awstranscriber"}, "awstranscriber"),
])
def test_transcriberbin_missing_factory_posts_error(props, factory):
    """Where the JAX package would build a factory of elements/net, the
    port's transcriberbin posts an ERROR naming it and fails the stream
    with an error flow, with no KeyError out of a streaming thread."""
    assert fx.element_factory_make(factory) is not None  # the JAX package has it
    assert not factory_exists(factory)
    p = _caption_bin(tfx, **props)
    with pytest.raises(RuntimeError, match="flow error"):
        p.play_until_eos()
    errors = [m.structure for m in p.bus.messages(tfx.MessageType.ERROR)]
    assert len(errors) == 1 and errors[0]["factory"] == factory
    assert factory in errors[0]["reason"]
    assert p.by_name("vsink").samples == [] and p.by_name("asink").samples == []


def _translation(pkg, language):
    tb = pkg.element_factory_make("translationbin", "tr")
    tb.set_property("transcriber::chunk-duration", 4_000_000_000)
    pad = tb.request_src_pad(language_code=language)
    src = pkg.element_factory_make("appsrc", "src")
    src.set_property("caps", pkg.parse_caps("audio/x-raw,format=F32,rate=16000,channels=1"))
    sink, raw = pkg.element_factory_make("appsink", "out"), pkg.element_factory_make(
        "appsink", "raw")
    p = pkg.Pipeline()
    for e in (src, tb, sink, raw):
        p.add(e)
    src.link(tb)
    pad.link(sink.pad("sink"))
    tb.pad("src").link(raw.pad("sink"))
    src.push_buffer(pkg.Buffer(cs.caption_audio(), pts=0))
    src.end_of_stream()
    return p


def test_translationbin_same_language_branch_matches_jax():
    """A translate_src pad in the input language passes the transcript on,
    as does the always src pad: the same texts and timestamps as the JAX
    package's."""
    def texts(pkg):
        p = _translation(pkg, "en-US")
        p.play_until_eos()
        return [[(str(s.buffer.data), s.buffer.pts, s.buffer.duration)
                 for s in p.by_name(n).samples] for n in ("out", "raw")]

    ref, got = texts(fx), texts(tfx)
    assert got == ref
    assert all(w in got[0][0][0] for w in cs.CAP_WORDS)


def test_translationbin_missing_translator_posts_error():
    p = _translation(tfx, "es-ES")
    with pytest.raises(RuntimeError, match="flow error"):
        p.play_until_eos()
    errors = [m.structure for m in p.bus.messages(tfx.MessageType.ERROR)]
    assert len(errors) == 1 and errors[0]["factory"] == "awstranslate"
    assert p.by_name("out").samples == [] and p.by_name("raw").samples == []


def test_captioning_path_raises_without_cuda(monkeypatch):
    """No card and no request for the CPU: the path raises instead of
    carrying on on the CPU (the transcriber and the overlay's frame)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tfx.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(tfx, frames=_frames(2))
    ov = tfx.element_factory_make("cea608overlay")
    ov._lines = ["X"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ov._video_chain(ov.sinkpad, tfx.Buffer(_frames(1)[0], pts=0))
