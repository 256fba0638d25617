"""The port's quinn elements (elements/net/quinn.py) and its WebTransport
session layer against the JAX package's.

tests/test_quinn_elements.py runs on the port with the same inputs and
assertions: QUIC sink to source over UDP on 127.0.0.1, the mux and demux's
stream and datagram routing, RoQ framing round trips, WebTransport and the
reference's property surface.  Its sources bind the element's default port
(4433, 4445; the JAX file leaves `port` at it), so two workers running the
JAX file and this one at once would collide: here they bind a free port
(`port` 0).  Then RoQ framing and the demux give the same bytes in both
packages, for numpy and tensor payloads, and the sink's stats carry the
port's loss counts."""
import struct

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.elements.net.quinn import QuinnQuicMeta as JMeta
from gst_plugins_rs_tpu_torch.elements.net.quinn import QuinnQuicMeta as TMeta
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests(
    "test_quinn_elements.py", globals(),
    subs=[(r'(\w+)\.set_property\("bind-port", 0\)',
           r'\1.set_property("bind-port", 0); \1.set_property("port", 0)')])


def _packets(seed, n=6):
    rng = np.random.default_rng(seed)
    return [struct.pack("!BBHII", 0x80, 96, i, i * 3000, 0xFACE)
            + rng.integers(0, 256, int(rng.integers(1, 1400)), dtype=np.uint8).tobytes()
            for i in range(n)]


def _mux(pkg, meta_cls, pkts, datagram, tensors=False):
    """appsrc ! quinnroqmux (flow 11, stream or datagram) ! appsink:
    [(bytes, stream_id, datagram)]."""
    p = pkg.Pipeline()
    src, mux, sink = (pkg.element_factory_make(n) for n in ("appsrc", "quinnroqmux", "appsink"))
    src.set_property("caps", pkg.parse_caps("application/x-rtp"))
    p.add(src, mux, sink)
    pad = mux.request_datagram_pad(11) if datagram else mux.request_stream_pad(11)
    src.pad("src").link(pad)
    mux.link(sink)
    for i, x in enumerate(pkts):
        a = np.frombuffer(x, np.uint8).copy()
        src.push_buffer(pkg.Buffer(torch.from_numpy(a) if tensors else a, pts=i))
    src.end_of_stream()
    p.play_until_eos()
    out = []
    for s in sink.samples:
        m = s.buffer.get_meta(meta_cls)
        out.append((np.asarray(s.buffer.data).tobytes(), m.stream_id, m.datagram))
    return out


def _demux(pkg, meta_cls, muxed):
    """The muxed buffers (with their metas) through appsrc ! quinnroqdemux,
    its flow pad linked through request-flow-id-map: [bytes]."""
    import chip_smoke as cs

    p = pkg.Pipeline()
    src, demux, sink = (pkg.element_factory_make(n)
                        for n in ("appsrc", "quinnroqdemux", "appsink"))
    src.set_property("caps", pkg.parse_caps("application/quic+roq"))
    p.add(src, demux, sink)
    src.link(demux)
    cs.roq_link(pkg, demux, sink.pad("sink"))
    for data, sid, dg in muxed:
        # split each stream buffer in two, as a QUIC receiver may hand it over
        parts = [data] if dg else [data[:len(data) // 2], data[len(data) // 2:]]
        for part in parts:
            b = pkg.Buffer(np.frombuffer(part, np.uint8).copy())
            b.add_meta(meta_cls(stream_id=sid, datagram=dg))
            src.push_buffer(b)
    src.end_of_stream()
    p.play_until_eos()
    return [np.asarray(s.buffer.data).tobytes() for s in sink.samples]


@pytest.mark.parametrize("datagram", [False, True], ids=["stream", "datagram"])
@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_roq_framing_and_demux_equal_the_jax_packages(datagram, tensors):
    pkts = _packets(7 + datagram)
    ref = _mux(fx, JMeta, pkts, datagram)
    got = _mux(tfx, TMeta, pkts, datagram, tensors)
    assert got == ref and len(ref) == len(pkts)
    assert _demux(tfx, TMeta, got) == _demux(fx, JMeta, ref) == pkts


def test_sink_stats_count_the_connections_packets():
    """The port's stats: the JAX package's fields, and the packets sent,
    declared lost and sent again after their PTO."""
    import chip_smoke as cs

    jpegs = [cs.jpeg_of(f) for f in cs.camera_frames(2, size=64)]
    r = cs.quic_run(tfx, jpegs, paced=False)
    s = r.stats
    assert {"cwnd", "bytes-in-flight", "srtt-ms", "pto-ms", "closed"} <= set(s)
    assert s["packets-sent"] >= len(r.packets) and s["packets-lost"] >= 0 <= s["pto-resends"]
    assert r.arrived == r.packets
