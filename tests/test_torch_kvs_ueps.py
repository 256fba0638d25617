"""The port's awskvswebrtcsink, uepswebrtcsink (elements/net/kvs_ueps.py),
webrtcsend and webrtcrecv (elements/net/webrtcbin2.py) and SigV4
(net/sigv4.py).

tests/test_kvs_ueps.py runs on the port with the same inputs and
assertions, but for its master case, which is written here again: the
JAX test sleeps 0.4 s for the sink to connect, while its fake KVS channel
makes the first connection the master, so a viewer that connects first
under load is taken for the master.  Here the viewer connects only once
the channel has its master."""
import base64
import json
import threading
import time

import numpy as np
import pytest
from websockets.sync.client import connect as ws_connect

import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu_torch.core.parse import parse_caps
from gst_plugins_rs_tpu_torch.net.webrtc_peer import PeerConnection
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_kvs_ueps.py", globals(),
                            skip={"test_kvs_master_answers_viewer": "written here again"})


def wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_kvs_master_answers_viewer(kvs):  # noqa: F811  (the fixture is mirrored)
    appsrc = tfx.element_factory_make("appsrc")
    appsrc.set_property("caps", parse_caps(
        "application/x-rtp,media=video,encoding-name=H264,clock-rate=90000,payload=96"))
    sink = tfx.element_factory_make("awskvswebrtcsink")
    sink.set_property("address", kvs.uri)
    p = tfx.Pipeline()
    p.add(appsrc, sink)
    appsrc.link(sink)

    exc = []

    def run():
        try:
            p.play_until_eos()
        except Exception as e:
            exc.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    # the channel's first connection is its master: the viewer goes second
    wait_for(lambda: kvs.master_ws is not None or exc, 20, "the master to connect")
    assert not exc

    got = []
    viewer_pc = PeerConnection(offerer=True)
    viewer_pc.set_media("video", 96, "H264", 90000)
    viewer_pc.on_rtp = got.append
    viewer_pc.start()
    offer = viewer_pc.create_offer("recvonly")
    vws = ws_connect(kvs.uri, open_timeout=5)
    try:
        vws.send(json.dumps({
            "messageType": "SDP_OFFER",
            "messagePayload": base64.b64encode(
                json.dumps({"type": "offer", "sdp": offer}).encode()).decode(),
            "senderClientId": "viewer-1",
        }))
        msg = json.loads(vws.recv(timeout=20))
        assert msg["messageType"] == "SDP_ANSWER"
        answer = json.loads(base64.b64decode(msg["messagePayload"]))["sdp"]
        viewer_pc.handle_answer(answer)
        assert viewer_pc.wait_connected(20.0)
        # the master's side of the session is up before media flows
        wait_for(lambda: sink.connected_count() >= 1, 20, "the master's session")

        packets = [_rtp(i) for i in range(5)]  # noqa: F821  (mirrored helper)
        for pkt in packets:
            appsrc.push_buffer(tfx.Buffer(np.frombuffer(pkt, np.uint8)))
        appsrc.end_of_stream()
        wait_for(lambda: len(got) >= 5, 20, "five packets at the viewer")
        assert got[:5] == packets
    finally:
        viewer_pc.close()
        vws.close()
        t.join(10)
    assert not t.is_alive() and not exc
