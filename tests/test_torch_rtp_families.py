"""The rest of the port's RTP families against the JAX package's tests.

Each test of tests/test_rtpcodecs.py, test_rtpextra.py, test_raptorq.py,
test_raptorq_scenarios.py, test_gcc_mp2t.py and test_udp_props.py runs on the
port with the same inputs and the same assertions (the localhost UDP cases
with the JAX tests' own timeouts)."""
import pytest

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = (mirror_jax_tests("test_rtpcodecs.py", globals())
            + mirror_jax_tests("test_rtpextra.py", globals())
            + mirror_jax_tests("test_raptorq.py", globals())
            + mirror_jax_tests("test_raptorq_scenarios.py", globals())
            + mirror_jax_tests("test_gcc_mp2t.py", globals())
            + mirror_jax_tests("test_udp_props.py", globals()))


# ---------------------------------------------------------------------------
# Port against the JAX package on seeded input, byte for byte
# ---------------------------------------------------------------------------
import importlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import gst_plugins_rs_tpu as fx  # noqa: E402
import gst_plugins_rs_tpu_torch as tfx  # noqa: E402

PACKAGES = {"jax": fx, "port": tfx}


def _core(pkg):
    return importlib.import_module(f"{pkg.__name__}.core")


def _payload(pkg, data, tensor):
    arr = np.frombuffer(data, np.uint8).copy()
    return torch.from_numpy(arr) if tensor and pkg is tfx else arr


def _rtp_packets(n, seed, first_seq=65_500):
    """n RTP packets, seqnums wrapping, payloads of seeded sizes up to the
    payloaders' 1,388-byte limit."""
    from gst_plugins_rs_tpu.net.rtp import RtpPacket

    rng = np.random.default_rng(seed)
    return [RtpPacket(96, (first_seq + i) & 0xFFFF, 3000 * (i // 6), 0xC0FFEE,
                      rng.integers(0, 256, int(rng.integers(1, 1389)), dtype=np.uint8).tobytes(),
                      marker=i % 6 == 5).to_bytes() for i in range(n)]


def _pads(pkg, element, sinks):
    """Source pads linked to `element`'s sink pads (stream-start, caps and
    segment sent), and a list every src pad's buffers go into as (pad name,
    bytes, pts)."""
    core = _core(pkg)
    segment = importlib.import_module(f"{pkg.__name__}.core.events").Segment
    out = []
    for pad in element.pads.values():
        if pad.direction == core.PadDirection.SRC:
            cap = core.Pad(f"cap-{pad.name}", core.PadDirection.SINK)
            cap.chain_function = (lambda name: lambda p, b: out.append(
                (name, np.asarray(b.data.numpy() if isinstance(b.data, torch.Tensor)
                                  else b.data, np.uint8).tobytes(), b.pts))
                or core.FlowReturn.OK)(pad.name)
            cap.event_function = lambda p, e: True
            pad.link(cap)
    srcs = {}
    for name, caps in sinks.items():
        src = core.Pad(f"h-{name}", core.PadDirection.SRC)
        src.link(element.pad(name))
        src.push_event(core.Event.new_stream_start(f"h-{name}"))
        src.push_event(core.Event.new_caps(pkg.parse_caps(caps)))
        src.push_event(core.Event.new_segment(segment()))
        srcs[name] = src
    return srcs, out


MEDIA_CAPS = "application/x-rtp,media=video,clock-rate=90000,encoding-name=RAW"
FEC_CAPS = "application/x-rtp,raptor-scheme-id=6,repair-window=50000,t=1408"


def _encode(pkg, packets, tensor=False):
    """raptorqenc at its defaults, outside a pipeline (no clock: a block's
    repairs follow its last packet): [(pad, bytes, pts)] in emission order."""
    enc = pkg.element_factory_make("raptorqenc")
    enc.set_state(_core(pkg).State.PLAYING)
    srcs, out = _pads(pkg, enc, {"sink": MEDIA_CAPS})
    for i, pkt in enumerate(packets):
        srcs["sink"].push(pkg.Buffer(_payload(pkg, pkt, tensor), pts=i * 1_000_000))
    srcs["sink"].push_event(_core(pkg).Event.new_eos())
    return out


def _decode(pkg, stream, lost, tensor=False):
    """raptorqdec on an encoder's output in its order, without the media
    packets whose index is in `lost`: (seqnum -> packet bytes, recovered)."""
    dec = pkg.element_factory_make("raptorqdec")
    dec.set_state(_core(pkg).State.PLAYING)
    srcs, out = _pads(pkg, dec, {"sink": MEDIA_CAPS, "fec_0": FEC_CAPS})
    media = 0
    for pad, data, pts in stream:
        if pad == "src":
            media += 1
            if media - 1 in lost:
                continue
        srcs["sink" if pad == "src" else "fec_0"].push(
            pkg.Buffer(_payload(pkg, data, tensor), pts=pts))
    got = {int.from_bytes(d[2:4], "big"): d for _, d, _ in out}
    return got, dec.get_property("stats")["recovered"]


def _seeded_loss(n, seed, k=25, r=5):
    """Up to `r` lost packets in each block of `k`: every block recoverable."""
    rng = np.random.default_rng(seed)
    lost = set()
    for b in range(0, n, k):
        size = min(k, n - b)
        lost |= {b + int(i) for i in rng.choice(size, min(int(rng.integers(0, r + 1)), size),
                                                 replace=False)}
    return lost


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
def test_raptorq_repairs_decode_across_packages(direction, payload):
    """Repair packets of one package's raptorqenc recover the seeded losses
    in the other's raptorqdec; both encoders' streams are equal byte for
    byte, and both decoders give the same packets and count."""
    packets = _rtp_packets(213, seed=21)  # 8 blocks of 25 and a partial one
    tensor = payload == "torch"
    streams = {name: _encode(pkg, packets, tensor) for name, pkg in PACKAGES.items()}
    assert streams["jax"] == streams["port"]
    assert sum(pad == "fec_0" for pad, _, _ in streams["jax"]) == 9 * 5
    enc, dec = direction.split("->")
    lost = _seeded_loss(len(packets), seed=22)
    assert len(lost) > 9
    got, recovered = _decode(PACKAGES[dec], streams[enc], lost, tensor)
    ref, ref_recovered = _decode(PACKAGES[enc], streams[enc], lost)
    assert recovered == ref_recovered == len(lost)
    assert got == ref == {int.from_bytes(p[2:4], "big"): p for p in packets}


def test_jpeg_annex_k_tables_match_jax():
    """The depayloader's Annex K DHT segments, written out as data, equal
    the JAX package's, which it takes from a Pillow encode."""
    from gst_plugins_rs_tpu.elements.net.rtpvideo import _standard_dht as jax_dht
    from gst_plugins_rs_tpu_torch.elements.net.rtpvideo import _standard_dht

    assert _standard_dht() == jax_dht()
    assert len(_standard_dht()) == 4 * 4 + 2 * (17 + 12) + 2 * (17 + 162)


# ---------------------------------------------------------------------------
# The contribution link at a small size, in both packages: raw video over
# RTP (rtpvrawpay2) protected by raptorqenc, seeded losses, raptorqdec,
# ts-jitterbuffer (the recovered packet of a frame's last block comes after
# the frame's marker) and rtpvrawdepay2
# ---------------------------------------------------------------------------
LINK_W, LINK_H = 64, 48
LINK_FRAMES = 12
LINK_RTP = "mtu=1400 ssrc=287454020 timestamp-offset=0 seqnum-offset=65520"


def _dropper(pkg, lost):
    """A pass-through element dropping the media packets whose index
    (in arrival order) is in `lost`."""
    core = _core(pkg)

    class Drop(core.BaseTransform):
        ELEMENT_NAME = "link-drop"
        MODE = core.TransformMode.NEVER_IN_PLACE

        def __init__(self):
            super().__init__("drop")
            self.seen = 0

        def transform(self, inbuf):
            self.seen += 1
            if self.seen - 1 in lost:
                return None
            out = pkg.Buffer(inbuf.data)
            out.copy_metadata_from(inbuf)
            return out

    return Drop()


class _Arrivals:
    """Pipeline tracer: the packets raptorqdec receives, in order."""

    def __init__(self):
        self.packets = []

    def on_buffer(self, element, pad, buf):
        if element.name == "dec":
            self.packets.append((pad.name, np.asarray(buf.data, np.uint8).tobytes()))


def _link(pkg, frames, lost):
    """The link on a TestClock that stays at 0, so every repair waits for
    EOS and the jitterbuffer holds each gap until the repair fills it:
    (raptorqdec's input, output frames, recovered)."""
    p = pkg.Pipeline()
    p.use_clock(_core(pkg).TestClock())
    make = pkg.element_factory_make
    src, pay, enc = make("appsrc", "src"), make("rtpvrawpay2", "pay"), make("raptorqenc", "enc")
    dec, jb, depay = make("raptorqdec", "dec"), make("ts-jitterbuffer", "jb"), \
        make("rtpvrawdepay2", "depay")
    sink, drop = make("appsink", "sink"), _dropper(pkg, lost)
    src.set_property("caps", pkg.parse_caps(
        f"video/x-raw,format=RGBA,width={LINK_W},height={LINK_H},framerate=30/1"))
    for kv in LINK_RTP.split():
        k, v = kv.split("=")
        pay.set_property(k, int(v))
    jb.set_property("latency", 10**10)
    for e in (src, pay, enc, drop, dec, jb, depay, sink):
        p.add(e)
    for a, b in ((src, pay), (pay, enc), (dec, jb), (jb, depay), (depay, sink)):
        a.link(b)
    enc.pad("src").link(drop.pad("sink"))
    drop.pad("src").link(dec.pad("sink"))
    enc.pad("fec_0").link(dec.pad("fec_0"))
    arrivals = _Arrivals()
    p.add_tracer(arrivals)
    for i, f in enumerate(frames):
        src.push_buffer(pkg.Buffer(f, pts=i * 33_333_333, duration=33_333_333))
    src.end_of_stream()
    p.play_until_eos()
    out = [np.asarray(s.buffer.data) if pkg is fx else s.buffer.data for s in sink.samples]
    return arrivals.packets, out, dec.get_property("stats")["recovered"]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_contribution_link_matches_jax(payload):
    """Seeded 64x48 RGBA frames through the link with one seeded loss in
    each 25-packet block: raptorqdec's input (media after the losses, and
    the repairs) equal in both packages, every loss recovered, and every
    frame out bit-equal to the frame in, on the port as in JAX."""
    rng = np.random.default_rng(31)
    frames = [rng.integers(0, 256, (LINK_H, LINK_W, 4), dtype=np.uint8)
              for _ in range(LINK_FRAMES)]
    per_frame = -(-LINK_H // 5)  # five 256-byte lines a 1,388-byte payload
    n = LINK_FRAMES * per_frame
    lost = {b + int(rng.integers(0, min(25, n - b))) for b in range(0, n, 25)}
    ref_in, ref_out, ref_rec = _link(fx, frames, lost)
    got_in, got_out, got_rec = _link(
        tfx, [torch.from_numpy(f) if payload == "torch" else f for f in frames], lost)
    assert got_in == ref_in
    assert sum(pad == "sink" for pad, _ in got_in) == n - len(lost)
    assert got_rec == ref_rec == len(lost)
    assert len(got_out) == len(ref_out) == LINK_FRAMES
    for f, r, g in zip(frames, ref_out, got_out):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(r, f)
        np.testing.assert_array_equal(g.numpy(), f)


def test_smoke_link_over_udp():
    """chip_smoke.py's contribution link at a small size on the CPU, over
    127.0.0.1: ts-udpsrc and udpsrc2 on their own contexts, the seeded
    probe, raptorqdec, ts-jitterbuffer and rtpvrawdepay2; every datagram
    arrives, every drop is recovered, every frame comes back bit-equal."""
    import chip_smoke

    rng = np.random.default_rng(41)
    frames = [torch.from_numpy(rng.integers(0, 256, (36, 160, 4), dtype=np.uint8))
              for _ in range(6)]
    r = chip_smoke.link_run(tfx, frames)
    chip_smoke.link_check(r, "the link on the CPU")
    assert r.n_media == 6 * chip_smoke.vraw_packets(160, 36)
    assert r.expected == len(chip_smoke.link_drops(r.n_media)) > 0
    assert all(o.device.type == "cpu" for o in r.out)


def test_smoke_udp_hop_holds_its_window():
    """chip_smoke.py's UDP hop (6o's stage alone) on the CPU: 3000 datagrams
    of the link's size go ts-udpsink to ts-udpsrc over 127.0.0.1 with the
    sender held to its window; every datagram arrives, and no more than the
    window were ever in flight."""
    import chip_smoke

    rng = np.random.default_rng(43)
    datagrams = [rng.integers(0, 256, chip_smoke.LINK_MTU, dtype=np.uint8).tobytes()
                 for _ in range(3000)]
    seconds, limit, most, waited = chip_smoke.udp_hop(tfx, datagrams)
    assert seconds > 0 and waited >= 0
    assert limit >= 8
    assert 0 < most <= limit


def test_smoke_l24_link_over_udp():
    """chip_smoke.py's L24 link on the CPU: seeded 24-bit stereo at 192 kHz
    through rtpL24pay2, the send window and ts-udpsink to ts-udpsrc !
    rtpL24depay2; every packet arrives and the samples come back equal."""
    import chip_smoke

    rng = np.random.default_rng(47)
    rate = chip_smoke.LINK_AUDIO_RATE
    buffers = [torch.from_numpy(rng.integers(-2**23, 2**23, (rate // 10, 2), dtype=np.int32))
               for _ in range(3)]
    got, sent, received, wall = chip_smoke.audio_link_run(tfx, buffers)
    assert sent == received == 3 * 100
    assert wall > 0
    np.testing.assert_array_equal(got, torch.cat(buffers).numpy())


# ---------------------------------------------------------------------------
# raptorqenc and raptorqdec across threads (the port's locks): a short
# interpreter switch interval makes a lost or doubled update likely
# ---------------------------------------------------------------------------
import collections  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402


@pytest.fixture
def fast_switching():
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def test_raptorqenc_pushes_each_repair_once_beside_the_clock_thread(fast_switching):
    """Repairs armed on the system clock fire on its thread while EOS takes
    and pushes the pending ones on the streaming thread: every repair of
    every block leaves exactly once."""
    from gst_plugins_rs_tpu_torch.core import Buffer, Event, State, SystemClock

    packets = _rtp_packets(60, seed=5)  # 12 blocks of 5
    for attempt in range(10):
        enc = tfx.element_factory_make("raptorqenc")
        enc.set_property("protected-packets", 5)
        enc.set_property("repair-window", 5)  # repairs 1-5 ms after their block
        clock = SystemClock.obtain()
        enc.clock, enc.base_time = clock, clock.now()
        enc.set_state(State.PLAYING)
        srcs, out = _pads(tfx, enc, {"sink": MEDIA_CAPS})
        for pkt in packets:
            srcs["sink"].push(Buffer(np.frombuffer(pkt, np.uint8), pts=0))
        srcs["sink"].push_event(Event.new_eos())
        time.sleep(0.05)  # a repair EOS did not take would fire by now
        sent = collections.Counter((d[12:14], d[17]) for pad, d, _ in out if pad == "fec_0")
        assert len(sent) == 12 * 5 and set(sent.values()) == {1}, (attempt, sent)


def test_raptorqdec_fed_by_two_threads(fast_switching):
    """raptorqdec's media pad fed by one thread and its fec pad by another
    (as two UDP sources feed it), each repair after its block's media:
    every loss recovered, every packet out once."""
    packets = _rtp_packets(2000, seed=9)  # 80 blocks of 25
    stream = _encode(tfx, packets)
    lost = _seeded_loss(len(packets), seed=10, r=1)
    dec = tfx.element_factory_make("raptorqdec")
    dec.set_state(_core(tfx).State.PLAYING)
    srcs, out = _pads(tfx, dec, {"sink": MEDIA_CAPS, "fec_0": FEC_CAPS})
    media = [d for pad, d, _ in stream if pad == "src"]
    repairs = [d for pad, d, _ in stream if pad == "fec_0"]
    passed = threading.Condition()
    state = {"media": 0}
    errors = []

    def feed_media():
        try:
            for i, d in enumerate(media):
                if i not in lost:
                    srcs["sink"].push(tfx.Buffer(np.frombuffer(d, np.uint8)))
                with passed:
                    state["media"] = i + 1
                    passed.notify_all()
        except BaseException as e:  # reported below
            errors.append(e)

    def feed_repairs():
        try:
            for d in repairs:
                block = int.from_bytes(d[12:14], "big")
                end = min(len(media), 25 * (block + 1))
                with passed:
                    assert passed.wait_for(lambda: state["media"] >= end, 30)
                srcs["fec_0"].push(tfx.Buffer(np.frombuffer(d, np.uint8)))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=f) for f in (feed_media, feed_repairs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    got = collections.Counter(d[2:4] for _, d, _ in out)
    assert len(got) == len(packets) and set(got.values()) == {1}
    assert dec.get_property("stats")["recovered"] == len(lost)
