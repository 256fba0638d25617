"""The port's rtspsrc2 (elements/net/rtsp.py) and SDP parser (net/sdp.py)
against the JAX package's.

tests/test_rtsp.py runs on the port with the same inputs and assertions.
Then both packages' rtspsrc2 run against the same fake servers: over UDP
(tests/test_rtsp.py's server) and over interleaved TCP with digest
authentication (chip_smoke.py's camera, JPEG in RFC 2435 packets made by
the port's rtpjpegpay2): the same requests, the same RTP packets pushed,
the same caps from the SDP, the same frames out; and chip_smoke.py's
camera path at a small size holds on the CPU."""
from dataclasses import asdict

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.net.sdp import parse_sdp as jparse_sdp
from gst_plugins_rs_tpu_torch.net.sdp import parse_sdp
from torch_parity_helpers import mirror_jax_tests, port_on_cpu

import chip_smoke


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_rtsp.py", globals())

SDP = ("v=0\r\no=- 42 1 IN IP4 10.0.0.2\r\ns=Two streams\r\nc=IN IP4 0.0.0.0\r\nt=0 0\r\n"
       "a=control:*\r\n"
       "m=video 0 RTP/AVP 96\r\na=rtpmap:96 H264/90000\r\n"
       "a=fmtp:96 packetization-mode=1;profile-level-id=42e01f\r\n"
       "a=control:rtsp://10.0.0.2/cam/track1\r\n"
       "m=audio 0 RTP/AVP 97\r\na=rtpmap:97 L16/48000/2\r\na=control:track2\r\n"
       "m=application 0 RTP/AVP 107\r\na=rtpmap:107 vnd.onvif.metadata/90000\r\n")


@pytest.mark.parametrize("text", [SDP, SDP.replace("\r\n", "\n"), chip_smoke.CAM_SDP,
                                  "v=0\r\ns=-\r\n"])
def test_sdp_parses_as_the_jax_packages(text):
    got, ref = parse_sdp(text), jparse_sdp(text)
    assert asdict(got) == asdict(ref)


class Packets:
    """A pipeline tracer: the RTP packets (bytes) as the depayloader's sink
    pad receives them, and the caps it got."""

    def __init__(self, where):
        self.where, self.packets = where, []

    def on_buffer(self, element, pad, buffer):
        if f"{element.name}:{pad.name}" == self.where:
            self.packets.append(chip_smoke._bytes(buffer))
            self.caps = pad.current_caps


def _udp_session(pkg, n=6):
    srv = FakeRtspServer(n_packets=n)  # noqa: F821  (mirrored from tests/test_rtsp.py)
    srv.start()
    p = pkg.parse_launch(f"rtspsrc2 location=rtsp://127.0.0.1:{srv.port}/test "
                         f"timeout=2000000000 num-buffers={n} ! rtppcmadepay2 name=depay "
                         f"! alawdec ! appsink name=sink")
    tap = Packets("depay:sink")
    p.add_tracer(tap)
    p.play_until_eos()
    srv.join(timeout=3)
    audio = np.concatenate([s.buffer.data.numpy() if isinstance(s.buffer.data, torch.Tensor)
                            else np.asarray(s.buffer.data) for s in p.by_name("sink").samples])
    return srv.methods, tap.packets, tap.caps.structure(0).fields, audio


def test_udp_session_pushes_the_jax_packages_packets():
    got, ref = _udp_session(tfx), _udp_session(fx)
    # the keep-alive OPTIONS goes at the first iteration over UDP
    assert got[0] == ref[0] == ["OPTIONS", "DESCRIBE", "SETUP", "PLAY", "OPTIONS", "TEARDOWN"]
    assert got[1] == ref[1] and len(got[1]) == 6
    assert got[2] == ref[2] and got[2]["encoding-name"] == "PCMA"
    assert np.array_equal(got[3], ref[3]) and got[3].shape == (6 * 160, 1)


def _jpegs(n=4, size=64):
    return [chip_smoke.jpeg_of(f) for f in chip_smoke.camera_frames(n, size=size)]


@pytest.fixture(scope="module")
def packets():
    with port_on_cpu():
        return chip_smoke.camera_packets(tfx, _jpegs())


def _camera_session(pkg, packets, password=chip_smoke.CAM_PASSWORD):
    cam = chip_smoke.RtspCamera(packets)
    try:
        p = pkg.parse_launch(
            f"rtspsrc2 name=rtsp location={cam.url} protocols=tcp user-id={cam.user} "
            f"user-pw={password} "
            f"timeout=300000000 num-buffers={len(packets)} ! rtpjpegdepay2 name=depay "
            f"! appsink name=jpegs")
        tap = Packets("depay:sink")
        p.add_tracer(tap)
        p.play_until_eos()
    finally:
        cam.close()
    jpegs = [chip_smoke._bytes(s.buffer) for s in p.by_name("jpegs").samples]
    return (cam.methods, (cam.challenged, cam.signed), tap.packets,
            tap.caps.structure(0).fields, jpegs)


def test_camera_session_pushes_the_jax_packages_packets(packets):
    """Interleaved TCP with digest authentication: the same requests (one
    challenge, then every request signed), every RTP packet the camera sent
    pushed in order, the caps from the SDP's rtpmap, the same JPEG frames."""
    got, ref = _camera_session(tfx, packets), _camera_session(fx, packets)
    assert got[0] == ref[0] == ["OPTIONS", "OPTIONS", "DESCRIBE", "SETUP", "PLAY", "TEARDOWN"]
    assert got[1] == ref[1] == (1, 5)
    assert got[2] == ref[2] == packets
    assert got[3] == ref[3] and got[3]["encoding-name"] == "JPEG" and got[3]["payload"] == 26
    assert got[4] == ref[4] and len(got[4]) == 4


def test_camera_wrong_password_fails_as_the_jax_element(packets):
    errors = []
    for pkg in (tfx, fx):
        with pytest.raises(RuntimeError) as e:
            _camera_session(pkg, packets, password="wrong")
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "401" in errors[0]


def test_smoke_camera_path_holds_on_the_cpu(packets):
    """chip_smoke.py's 4q (a) at 64x64 on the CPU: the whole session, each
    frame decoded by imagersdec (a stream of its own) to its JPEG's pixels
    and to the JAX element's, and one detection buffer a frame."""
    r = chip_smoke.camera_run(tfx, packets, (0.5, 0.5))
    jpegs = _jpegs()
    assert r.methods == ["OPTIONS", "OPTIONS", "DESCRIBE", "SETUP", "PLAY", "TEARDOWN"]
    assert r.error is None and len(r.jpegs) == 4 and len(r.out) == 4
    for frame, data in zip(r.frames, r.jpegs):
        ref = chip_smoke.decode_images(fx, data, caps="image/jpeg")[0]
        assert isinstance(frame, torch.Tensor)
        assert np.array_equal(frame.numpy(), np.asarray(ref))
    assert all(np.array_equal(f.numpy(), chip_smoke.jpeg_pixels(j))
               for f, j in zip(r.frames, jpegs))
    assert r.arrivals and r.t_play <= r.arrivals[0] <= r.t_done


def test_smoke_camera_thresholds_pass_the_set_number_of_candidates():
    """chip_smoke.py's calibration on a 640x640 camera frame: the box
    threshold lies between the CAM_CANDIDATES-th and the next objectness of
    the anchors over the class threshold, so the frame gives that many
    candidates and at least one box."""
    frame = torch.from_numpy(chip_smoke.jpeg_pixels(_jpegs(1, size=640)[0]).copy())
    box, cls = chip_smoke.camera_thresholds(tfx, frame)
    out = chip_smoke.camera_detect(tfx, [frame], (1.0, 1.0))
    t = chip_smoke._tensor_meta(out[0]).data[0]
    passing = (t[:, 4] >= box) & (t[:, 5:].max(-1).values >= cls)
    assert int(passing.sum()) == chip_smoke.CAM_CANDIDATES
    got = chip_smoke.camera_detect(tfx, [frame], (box, cls))
    assert 1 <= len(chip_smoke.camera_detections(tfx, got[0])) <= chip_smoke.CAM_CANDIDATES
