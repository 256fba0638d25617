"""chip_smoke.py's QUIC and cloud paths (phases 4s/4t/5s) at a small size
on the CPU, through the port and through the JAX package.

(a) The camera over RTP over QUIC: four seeded 64x64 frames as JPEG through
rtpjpegpay2 ! quinnroqmux ! quinnquicsink to quinnquicsrc ! quinnroqdemux !
rtpjpegdepay2, each JPEG through imagersdec and the frames through
YOLOX-tiny (one seeded weight tree in both packages).  (b) The dubbed
voice: 1 s of seeded noisy speech through audiornnoise ! S16 16 kHz !
awstranscriber2 ! awstranslate ! awspolly ! ... ! audioloudnorm against
the smoke's fakes of Transcribe, Translate and Polly (every request's
SigV4 checked).  (c) The archive: three seeded 64x48 frames graded through
hsvfilter ! colorlut approx ! cmafmux ! awss3sink (parts of 10,000 bytes)
to the fake S3, read back by awss3src.  Each package passes the smoke's own
checks (quic_check, dub_check, archive_check), but for the JAX
transcriber's tail: its 10 ms reply window may lose the transcripts still
in flight at EOS, which the port waits for, so the JAX run's chain is held
to be a prefix of the port's.  Then the outputs are compared: the JPEGs
byte for byte, the RTP packets but for their timestamps (the camera's live
clock), the decoded frames pixel for pixel, the detections within YOLOX's
gates; the AudioEvents' S16 within 1 (the denoisers agree within 0.25 s16
units, tests/test_torch_rnnoise.py's FAST_TOL, then a rounding), the
transcripts, translations and Polly buffers equal, audioloudnorm on the
port's Polly buffers within LOUDNORM_TOL; the graded frames within 2 LSB
(hsvfilter's and colorlut approx's gates added, as in
tests/test_torch_fuse.py).  And: with no card and no request for the CPU the
three paths raise."""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.models import yolox as jyolox
from torch_parity_helpers import official_checkpoint, port_on_cpu, random_variables, to_jax

SIZE = 64
FRAMES = 4
SECONDS = 1
S16_TOL = 1          # S16 units: the denoisers within 0.25, then a rounding
LOUDNORM_TOL = 1e-6  # the chain resamples in F32 before audioloudnorm (chip_smoke 5s)
# u8 LSBs, the graded frames port against JAX: hsvfilter's 1 LSB enters
# colorlut approx's grade, the two elements' gates add (tests/test_torch_fuse.py)
HSV_APPROX_LSB = 2
PART, BLOCK = 10_000, 8_192


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(flax variables, path of the same weights as an official .pth)."""
    v = random_variables("tiny", seed=2)
    path = official_checkpoint(v, tmp_path_factory.mktemp("yolox") / "tiny.pth")
    return to_jax(v), str(path)


@pytest.fixture(scope="module")
def fakes():
    with cs.cloud_fakes() as f:
        yield f


def _untimed(packet):
    return packet[:4] + packet[8:]


def test_quic_camera_matches_jax(weights, monkeypatch):
    # the JAX element's eager flax init is replaced by a tree of the right
    # structure; weights-path then sets every leaf (tests/test_torch_onvif.py)
    monkeypatch.setattr(jyolox.Yolox, "init", lambda self, rng, x: weights[0])
    jpegs = [cs.jpeg_of(f) for f in cs.camera_frames(FRAMES, size=SIZE)]
    detect = f"yoloxinference engine=fast weights-path={weights[1]}"
    runs = {}
    for pkg in (tfx, fx):
        r = cs.quic_camera(pkg, jpegs, (0.3, 0.3), detect=detect)
        cs.quic_check(r, jpegs, cs.rfc2435_jpegs(pkg, jpegs), pkg.__name__)
        runs[pkg] = r
    t, j = runs[tfx], runs[fx]
    assert t.jpegs == j.jpegs and [_untimed(x) for x in t.packets] == \
        [_untimed(x) for x in j.packets]
    assert {"packets-sent", "packets-lost", "pto-resends"} <= set(t.stats)
    for tf, jf, data in zip(t.frames, j.frames, jpegs):
        assert np.array_equal(tf.numpy(), np.asarray(jf))
        assert np.array_equal(tf.numpy(), cs.jpeg_pixels(data))
    boxes = 0
    for tb, jb in zip(t.out, j.out):
        td, jd = cs.camera_detections(tfx, tb), cs.camera_detections(fx, jb)
        assert cs._detections_within_gates(jd, td), (jd, td)
        boxes += len(td)
    assert boxes > 0


def test_dubbed_voice_matches_jax(fakes):
    voice = cs.noisy_voice()[:SECONDS * cs.VOICE_RATE]
    t = cs.dub_run(tfx, voice, fakes)
    t_out = cs.dub_check(t, cs.dub_front(tfx, voice), "the port")
    j = cs.dub_run(fx, voice, fakes)
    assert not j.refused and len(j.events) == len(t.events)
    tev = np.concatenate([np.frombuffer(e, "<i2") for e in t.events]).astype(np.int32)
    jev = np.concatenate([np.frombuffer(e, "<i2") for e in j.events]).astype(np.int32)
    assert tev.shape == jev.shape and int(np.abs(tev - jev).max()) <= S16_TOL
    # the JAX transcriber's output: a prefix of the port's (its tail may be
    # lost at EOS); the transcripts follow the AudioEvents' bytes
    n = len(j.translated)
    assert n <= len(j.events)
    assert [x for x, _ in j.translated] == [cs.transcript_of(k + 1, e)
                                            for k, e in enumerate(j.events[:n])]
    assert j.synthesized == [cs.translation_of(x) for x, _ in j.translated]
    assert [cs._bytes(b) for b in j.polly] == [cs.polly_pcm(x).tobytes()
                                               for x in j.synthesized]
    # audioloudnorm in both packages on the port's Polly buffers
    ref = cs._samples(cs.dub_back(fx, t.polly))
    assert ref.shape == t_out.shape and float(np.abs(ref - t_out).max()) <= LOUDNORM_TOL


def test_archive_matches_jax(fakes, tmp_path):
    grade = cs.write_grade(tmp_path / "grade.cube")
    frames = cs.origin_frames(3, w=SIZE, h=48, device="cpu")
    graded = {}
    for pkg, src in ((tfx, frames), (fx, [f.numpy() for f in frames])):
        fakes.reset()
        got, _ = cs.archive_run(pkg, src, fakes, grade=grade, part=PART)
        cs.archive_run(pkg, src, grade=grade, path=tmp_path / "take.mp4")
        cs.archive_check(pkg, fakes, got, (tmp_path / "take.mp4").read_bytes(),
                         pkg.__name__, part=PART, block=BLOCK)
        graded[pkg] = [np.asarray(x) for x in got]
    assert all(np.abs(a.astype(int) - b.astype(int)).max() <= HSV_APPROX_LSB
               for a, b in zip(graded[tfx], graded[fx]))


def test_paths_raise_without_cuda(monkeypatch, fakes, tmp_path):
    """No card and no request for the CPU: each path raises instead of
    carrying on on the CPU (imagersdec's frame, the denoiser's and the
    grade's tensors); the QUIC leg itself is host bytes and runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tfx.set_device(None)
    jpegs = [cs.jpeg_of(f) for f in cs.camera_frames(1, size=SIZE)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.quic_camera(tfx, jpegs, (0.3, 0.3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.dub_run(tfx, cs.noisy_voice()[:cs.VOICE_SPB], fakes)
    frames = [np.zeros((48, SIZE, 4), np.uint8)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cs.archive_run(tfx, frames, fakes, grade=cs.write_grade(tmp_path / "g.cube"))
