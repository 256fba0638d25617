"""The port's RTP core against the JAX package's RTP tests.

Each test of tests/test_rtp.py and tests/test_rtpbin2.py runs on the port
with the same inputs and the same assertions, with the cases of
tests/test_rtp_surface.py and tests/test_clock.py that need only modules
the port has.  The skipped cases wait for a later slice of elements/net,
each named below.  Then the payloaders' packets and the session's output,
port against the JAX package, byte for byte on seeded input."""
import pytest

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


UDP = "elements/net/udp.py (udpsrc2, ts-udpsink)"
GCC = "elements/net/gccbwe.py and net/gcc.py (rtpgccbwe)"
RTPCODECS = "elements/net/rtpcodecs.py"
RTPVIDEO = "elements/net/rtpvideo.py"
MIRRORED = (mirror_jax_tests("test_rtp.py", globals(), skip={"TestUdpLoopback": UDP})
            + mirror_jax_tests("test_rtpbin2.py", globals(), skip={"TestTwccEndToEnd": GCC})
            + mirror_jax_tests("test_rtp_surface.py", globals(), skip={
                "TestAggregation": RTPCODECS, "TestPictureId": RTPVIDEO,
                "TestKeyframeRecovery": RTPVIDEO, "TestOpusDtx": RTPCODECS,
                "TestAmrWb": RTPCODECS, "TestMp4gAudio": RTPCODECS}))
# tests/test_clock.py: the jitterbuffer's clock-driven cases.  The file's
# other classes drive the core clock, the switching elements, live sources
# and the transcriber, which are not this slice's; tests/test_torch_core.py
# holds the clock scenarios against the JAX package.
OTHER = "not an RTP case"
MIRRORED += mirror_jax_tests("test_clock.py", globals(), skip={
    name: OTHER for name in ("TestClocks", "TestFallbackSwitchClocked", "TestLiveSyncClocked",
                             "TestPipelineClock", "TestLiveSources", "TestPauseResume",
                             "TestTranscriberLatency")})


# ---------------------------------------------------------------------------
# Port against the JAX package on seeded input, byte for byte, from numpy
# and from tensor payloads
# ---------------------------------------------------------------------------
import numpy as np  # noqa: E402
import torch  # noqa: E402

import gst_plugins_rs_tpu as fx  # noqa: E402
import gst_plugins_rs_tpu_torch as tfx  # noqa: E402
from torch_parity_helpers import run_launch  # noqa: E402

FIXED = "ssrc=48879 timestamp-offset=1000 seqnum-offset=65530"  # seqnums wrap
AUDIO = "audio/x-raw,rate={rate},channels={ch},layout=interleaved,format={fmt}"
# name: (caps, payloader, depayloader, payload maker(rng, i), payloader options)
PAYLOADERS = {
    "pcma": ("audio/x-alaw,rate=8000,channels=1", "rtppcmapay2", "rtppcmadepay2",
             lambda rng, i: rng.integers(0, 256, (160, 1), dtype=np.uint8), "max-ptime=20000000"),
    "pcmu": ("audio/x-mulaw,rate=8000,channels=2", "rtppcmupay2", "rtppcmudepay2",
             lambda rng, i: rng.integers(0, 256, (700, 2), dtype=np.uint8), "min-ptime=40000000"),
    "L8": (AUDIO.format(rate=16000, ch=2, fmt="U8"), "rtpL8pay2", "rtpL8depay2",
           lambda rng, i: rng.integers(0, 256, (500, 2), dtype=np.uint8), "max-ptime=10000000"),
    "L16": (AUDIO.format(rate=44100, ch=2, fmt="S16"), "rtpL16pay2", "rtpL16depay2",
            lambda rng, i: rng.integers(-32768, 32768, (441, 2), dtype=np.int16), "mtu=600"),
    "klv": ("meta/x-klv,parsed=true", "rtpklvpay2", "rtpklvdepay2",
            lambda rng, i: rng.integers(0, 256, 100 + 900 * i, dtype=np.uint8), "mtu=400"),
}


def _seeded_buffers(name, tensor, n=5):
    caps, _, _, make, _ = PAYLOADERS[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    bufs = []
    for i in range(n):
        data = make(rng, i)
        bufs.append(dict(data=torch.from_numpy(data) if tensor else data,
                         pts=i * 20_000_000, duration=20_000_000))
    return caps, bufs


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(PAYLOADERS))
def test_payloader_packets_match_jax(name, payload):
    """Each payloader with fixed ssrc and offsets: the JAX package's packets
    byte for byte (headers, payload split, marker, timestamps); through its
    depayloader, the JAX package's media buffers."""
    caps, pay, depay, _, opts = PAYLOADERS[name]
    for tail in (f"{pay} {FIXED} {opts}", f"{pay} {FIXED} {opts} ! {depay}"):
        launch = f"appsrc name=src ! {tail} ! appsink name=sink"
        ref = run_launch(fx, launch, _seeded_buffers(name, False)[1], caps=caps)
        got = run_launch(tfx, launch, _seeded_buffers(name, payload == "torch")[1], caps=caps)
        assert len(got[0]) >= 2 and got == ref


def _session(pkg, packets, latency, mode):
    """appsrc (RTP) ! rtprecv latency=.. timestamping-mode=.. ! appsink: the
    output packets and pts, and the receiver's stats."""
    p = pkg.Pipeline()
    src = pkg.element_factory_make("appsrc", "src")
    src.set_property("caps", pkg.parse_caps(
        "application/x-rtp,media=audio,clock-rate=8000,encoding-name=PCMU"))
    recv = pkg.element_factory_make("rtprecv", "recv")
    recv.set_property("latency", latency)
    recv.set_property("timestamping-mode", mode)
    recv.set_property("rtp-id", "parity")
    sink = pkg.element_factory_make("appsink", "sink")
    for e in (src, recv, sink):
        p.add(e)
    src.pad("src").link(recv.request_sink_pad())
    recv.link(sink)
    for data, pts in packets:
        src.push_buffer(pkg.Buffer(data, pts=pts))
    src.end_of_stream()
    p.play_until_eos()
    stats = recv.get_property("stats")
    return ([(np.asarray(s.buffer.data).tobytes(), s.buffer.pts) for s in sink.samples],
            {k: dict(v.fields) for k, v in stats.fields.items()})


@pytest.mark.parametrize("mode", ["arrival", "rtp", "skew"])
@pytest.mark.parametrize("latency", [0, 60_000_000])
def test_rtprecv_matches_jax(latency, mode):
    """Seeded PCMU packets, reordered, duplicated and with a loss and a
    jittered arrival clock, through rtprecv: the JAX package's packets, pts
    and per-source counters (with no latency the late packets are
    dropped)."""
    from gst_plugins_rs_tpu_torch.net.rtp import RtpPacket

    rng = np.random.default_rng(8)
    order = list(range(24))
    for i in range(0, 22, 5):
        order[i], order[i + 1] = order[i + 1], order[i]
    order.remove(13)
    order.insert(7, 7)
    packets = []
    for k, seq in enumerate(order):
        pkt = RtpPacket(0, (65520 + seq) & 0xFFFF, seq * 160, 77,
                        rng.integers(0, 256, 160, dtype=np.uint8).tobytes())
        packets.append((np.frombuffer(pkt.to_bytes(), np.uint8).copy(),
                        k * 20_000_000 + int(rng.integers(0, 4_000_000))))
    ref = _session(fx, packets, latency, mode)
    got = _session(tfx, [(torch.from_numpy(d), t) for d, t in packets], latency, mode)
    assert len(got[0]) >= 15 and got == ref
