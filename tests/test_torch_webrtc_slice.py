"""chip_smoke.py's WebRTC paths (phases 4r/5r) at a small size on the CPU,
through the port and through the JAX package.

(a) The WHIP camera: four seeded 64x64 frames as JPEG through rtpjpegpay2 !
whipclientsink into whipserversrc ! rtpjpegdepay2, over ICE, DTLS and
SRTP, each JPEG through imagersdec and the frames through YOLOX-tiny (one
seeded weight tree in both packages).  (b) The denoised voice: 1 s of
seeded noisy speech through audiornnoise ! S16 ! webrtcsink into webrtcsrc
! rtpL16depay2 and the consumer's chain into audioloudnorm, with a
navigation event back over SCTP.  Each package passes the smoke's own
checks (whip_check, voice_check); then the delivered media are compared,
not the wire bytes, which carry random SSRCs, ports and keys: the JPEGs
byte for byte, the decoded frames pixel for pixel, the detections within
YOLOX's gates, the received S16 samples within 1 (the denoisers agree
within 0.25 s16 units, tests/test_torch_rnnoise.py's FAST_TOL, so a
rounding to S16 can differ by 1), and audioloudnorm on the same received
samples within LOUDNORM_TOL (5r's gate: the chain resamples in F32)."""
import numpy as np
import pytest

import chip_smoke as cs
import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.models import yolox as jyolox
from torch_parity_helpers import official_checkpoint, port_on_cpu, random_variables, to_jax

SIZE = 64
FRAMES = 4
SECONDS = 1
S16_TOL = 1          # S16 units: the denoisers within 0.25, then a rounding
LOUDNORM_TOL = 1e-6  # the chain resamples in F32 before audioloudnorm (chip_smoke 5r)


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


def _untimed(packet):
    return packet[:4] + packet[8:]


def test_whip_camera_matches_jax(weights, monkeypatch):
    # the JAX element's eager flax init is replaced by a tree of the right
    # structure; weights-path then sets every leaf (tests/test_torch_onvif.py)
    monkeypatch.setattr(jyolox.Yolox, "init", lambda self, rng, x: weights[0])
    jpegs = [cs.jpeg_of(f) for f in cs.camera_frames(FRAMES, size=SIZE)]
    detect = f"yoloxinference engine=fast weights-path={weights[1]}"
    runs = {}
    for pkg in (tfx, fx):
        r = cs.webrtc_camera(pkg, jpegs, (0.3, 0.3), detect=detect)
        cs.whip_check(r, jpegs, cs.rfc2435_jpegs(pkg, jpegs), pkg.__name__)
        runs[pkg] = r
    t, j = runs[tfx], runs[fx]
    # the packets apart from their RTP timestamps (the camera's live clock)
    assert t.jpegs == j.jpegs and [_untimed(x) for x in t.packets] == \
        [_untimed(x) for x in j.packets]
    for tf, jf, data in zip(t.frames, j.frames, jpegs):
        assert np.array_equal(tf.numpy(), np.asarray(jf))
        assert np.array_equal(tf.numpy(), cs.jpeg_pixels(data))
    boxes = 0
    for tb, jb in zip(t.out, j.out):
        td, jd = cs.camera_detections(tfx, tb), cs.camera_detections(fx, jb)
        assert cs._detections_within_gates(jd, td), (jd, td)
        boxes += len(td)
    assert boxes > 0


def test_voice_matches_jax():
    voice = cs.noisy_voice()[:SECONDS * cs.VOICE_RATE]
    runs = {pkg: cs.voice_run(pkg, voice) for pkg in (tfx, fx)}
    checked = {pkg: cs.voice_check(r, pkg.__name__) for pkg, r in runs.items()}
    (tsent, tgot, tlost), (jsent, jgot, jlost) = checked[tfx], checked[fx]
    assert tlost == jlost and tgot.shape == jgot.shape
    assert int(np.abs(tgot.astype(np.int32) - jgot.astype(np.int32)).max()) <= S16_TOL
    assert len(runs[tfx].received) == len(runs[fx].received)
    # audioloudnorm in both packages on the port's received samples
    ref = cs._samples(cs.voice_plain(fx, runs[tfx].received))
    got = cs._samples(runs[tfx].out)
    assert got.shape == ref.shape and got.shape[0] > 0
    assert float(np.abs(got - ref).max()) <= LOUDNORM_TOL
