"""The port's webrtcsink and webrtcsrc (elements/net/webrtc.py) and the
signalling server (net/webrtc_signalling.py).

tests/test_webrtc.py runs on the port with the same inputs and assertions,
but for its bundle case, which is written here again.  That case ends the
producer right after its last packets: the producer sends endSession, and
the JAX package's webrtcsrc ends its stream as that message arrives, while
a loaded receive loop may still hold packets in its socket, which are then
lost.  The port's webrtcsrc ends after the datagrams already in its socket
(`PeerConnection.drain`), and holds SRTP that races the key installation
under a lock; `test_stream_ends_after_the_packets_in_flight` slows the
consumer's receive loop to show the first."""
import struct
import threading
import time

import numpy as np
import pytest

import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu_torch.core.element import State
from gst_plugins_rs_tpu_torch.core.parse import parse_caps
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_webrtc.py", globals(),
                            skip={"TestMultiMediaSession": "written here again"})


def wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _run_into(exc):
    def run(p):
        try:
            p.play_until_eos()
        except Exception as e:
            exc.append(e)
    return run


def _consumer_connected(src):
    return src._pc is not None and src._pc._connected.is_set()


def test_audio_and_video_in_one_bundle(server):  # noqa: F811  (the fixture is mirrored)
    """Two media sections (video pt 96 and audio pt 111) in one session:
    a request pad of webrtcsink adds the audio m-line; webrtcsrc fans the
    extra section out on a sometimes pad, demuxed by payload type.  The
    producer ends right after its packets: every packet still arrives."""
    v_src = tfx.element_factory_make("appsrc")
    v_src.set_property("caps", parse_caps(
        "application/x-rtp,media=video,encoding-name=VP8,clock-rate=90000,payload=96"))
    a_src = tfx.element_factory_make("appsrc")
    a_src.set_property("caps", parse_caps(
        "application/x-rtp,media=audio,encoding-name=OPUS,clock-rate=48000,payload=111"))
    sink = tfx.element_factory_make("webrtcsink")
    sink.set_property("signaller-uri", server.uri)
    p_tx = tfx.Pipeline()
    p_tx.add(v_src, a_src, sink)
    v_src.link(sink)
    a_src.pad("src").link(sink.request_sink_pad("audio"))

    src = tfx.element_factory_make("webrtcsrc")
    src.set_property("signaller-uri", server.uri)
    src.set_property("timeout", 20_000_000_000)
    v_sink = tfx.element_factory_make("appsink", "v")
    a_sink = tfx.element_factory_make("appsink", "a")
    p_rx = tfx.Pipeline()
    p_rx.add(src, v_sink, a_sink)
    src.link(v_sink)
    src.on_new_pad = lambda pad: pad.link(a_sink.pad("sink"))

    exc = []
    run = _run_into(exc)
    # prime the sender so both pads' caps are known before sessions start
    p_tx.set_state(State.PLAYING)
    v_pkt0 = _rtp(0, payload=b"\x10" * 20)  # noqa: F821  (mirrored helper)
    v_src.push_buffer(tfx.Buffer(np.frombuffer(v_pkt0, np.uint8)))
    a_src.push_buffer(tfx.Buffer(np.frombuffer(
        struct.pack("!BBHII", 0x80, 111, 0, 0, 0x222) + b"\xa0" * 20, np.uint8)))
    p_tx.run(max_iterations=1)
    assert all(e["media"] is not None for e in sink._extra_pads)

    t_rx = threading.Thread(target=run, args=(p_rx,), daemon=True)
    t_rx.start()
    t_tx = None
    try:
        assert sink.wait_any_connected(20.0)
        wait_for(lambda: _consumer_connected(src) or exc, 20, "the consumer's session")
        assert not exc
        pc = list(sink._sessions.values())[0]
        assert len(pc.medias) == 2 and pc.medias[1]["encoding"] == "OPUS"

        v_pkts = [_rtp(i, payload=b"\x10" * 20) for i in range(1, 6)]  # noqa: F821
        a_pkts = [struct.pack("!BBHII", 0x80, 111, i, i * 960, 0x222) + b"\xa0" * 20
                  for i in range(1, 6)]
        for vp, ap in zip(v_pkts, a_pkts):
            v_src.push_buffer(tfx.Buffer(np.frombuffer(vp, np.uint8)))
            a_src.push_buffer(tfx.Buffer(np.frombuffer(ap, np.uint8)))
        v_src.end_of_stream()
        a_src.end_of_stream()
        t_tx = threading.Thread(target=run, args=(p_tx,), daemon=True)
        t_tx.start()
        t_tx.join(20)
        t_rx.join(20)
        assert not t_tx.is_alive() and not t_rx.is_alive() and not exc
    finally:
        src._rtp_queue.put(None)
        for t in (t_tx, t_rx):
            if t is not None:
                t.join(10)
    v_got = [bytes(np.asarray(s.buffer.data, np.uint8)) for s in v_sink.samples]
    a_got = [bytes(np.asarray(s.buffer.data, np.uint8)) for s in a_sink.samples]
    assert v_got == v_pkts and a_got == a_pkts
    s0 = a_sink.samples[0].caps.structure(0)
    assert s0.get("encoding-name") == "OPUS" and int(s0.get("payload")) == 111


def test_stream_ends_after_the_packets_in_flight(server):  # noqa: F811
    """The producer sends 20 packets and ends its session at once, while
    the consumer's receive loop takes 20 ms a packet: webrtcsrc's stream
    still ends after all 20 (the JAX package's ends with the first few)."""
    appsrc = tfx.element_factory_make("appsrc")
    appsrc.set_property("caps", parse_caps(
        "application/x-rtp,media=audio,encoding-name=L16,clock-rate=48000,payload=96"))
    sink = tfx.element_factory_make("webrtcsink")
    sink.set_property("signaller-uri", server.uri)
    p_tx = tfx.Pipeline()
    p_tx.add(appsrc, sink)
    appsrc.link(sink)
    src = tfx.element_factory_make("webrtcsrc")
    src.set_property("signaller-uri", server.uri)
    src.set_property("timeout", 20_000_000_000)
    appsink = tfx.element_factory_make("appsink")
    p_rx = tfx.Pipeline()
    p_rx.add(src, appsink)
    src.link(appsink)

    exc = []
    run = _run_into(exc)
    p_tx.set_state(State.PLAYING)
    p_tx.run(max_iterations=1)
    t_rx = threading.Thread(target=run, args=(p_rx,), daemon=True)
    t_rx.start()
    try:
        assert sink.wait_any_connected(20.0)
        wait_for(lambda: _consumer_connected(src) or exc, 20, "the consumer's session")
        slow = src._pc._handle_srtp

        def handle(data):
            time.sleep(0.02)
            slow(data)

        src._pc._handle_srtp = handle
        packets = [_rtp(i, payload=bytes([i]) * 64) for i in range(20)]  # noqa: F821
        for pkt in packets:
            appsrc.push_buffer(tfx.Buffer(np.frombuffer(pkt, np.uint8)))
        appsrc.end_of_stream()
        p_tx.run()
        p_tx.set_state(State.NULL)  # sends endSession
        t_rx.join(20)
        assert not t_rx.is_alive() and not exc
    finally:
        src._rtp_queue.put(None)
        t_rx.join(10)
    assert [bytes(np.asarray(s.buffer.data, np.uint8)) for s in appsink.samples] == packets
