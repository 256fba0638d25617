"""The port's tracers (utils/tracers.py, GSTPU_TRACERS) against the JAX
package's.

tests/test_tracers.py runs on the port with the same inputs and assertions.
Then the same pipelines, from numpy and from tensor payloads, run in both
packages with every tracer: each writes the same columns and rows, the host
clock's times aside; memory-tracer counts a tensor payload's bytes without
reading it; the pcap writer writes the same packets."""
import json
import logging
import struct

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.utils import tracers as jtracers
from gst_plugins_rs_tpu_torch.utils import tracers
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_tracers.py", globals())

RATE, SPB, N = 48000, 480, 4


def _audio(i):
    t = (np.arange(SPB) + i * SPB) / RATE
    return np.stack([np.sin(2 * np.pi * 440 * t), np.cos(2 * np.pi * 220 * t)], -1).astype(np.float32)


def _run(pkg, spec, tmp_path, label, payload="numpy",
         launch="appsrc name=src ! identity name=mid ! audioconvert name=conv ! fakesink name=out",
         caps=f"audio/x-raw,format=F32,rate={RATE},channels=2,layout=interleaved", buffers=None):
    """`launch` in package `pkg` under GSTPU_TRACERS=`spec` (with {dir}
    standing for tmp_path/label); N buffers go into the appsrc.  Returns
    the tracer directory."""
    import os

    out = tmp_path / label
    out.mkdir()
    os.environ["GSTPU_TRACERS"] = spec.format(dir=out)
    try:
        p = pkg.parse_launch(launch)
    finally:
        del os.environ["GSTPU_TRACERS"]
    src = p.by_name("src")
    src.set_property("caps", pkg.parse_caps(caps))
    dur = SPB * 10**9 // RATE
    for i, data in enumerate(buffers if buffers is not None else [_audio(i) for i in range(N)]):
        if payload == "torch" and pkg is tfx:
            data = torch.from_numpy(np.ascontiguousarray(data))
        src.push_buffer(pkg.Buffer(data, pts=i * dur, duration=dur))
    src.end_of_stream()
    p.play_until_eos()
    for t in p.tracers:
        t.close()
    return out


def _csv(path, drop):
    """The CSV's rows with the named columns (host clock readings) left out."""
    lines = path.read_text().splitlines()
    head = lines[0].split(",")
    keep = [i for i, c in enumerate(head) if c not in drop]
    return [[row.split(",")[i] for i in keep] for row in lines]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_csv_tracers_write_the_jax_packages_rows(tmp_path, payload):
    """pad-push-timings, buffer-lateness and memory-tracer on the same
    pipeline and buffers: the same header and, the host clock's times
    aside, the same rows in both packages."""
    spec = ("pad-push-timings(file={dir}/pads.csv);buffer-lateness(file={dir}/late.csv);"
            "memory-tracer(file={dir}/mem.csv)")
    got = _run(tfx, spec, tmp_path, "port", payload)
    ref = _run(fx, spec, tmp_path, "jax")
    for name, drop in (("pads.csv", {"wallclock"}), ("late.csv", {"wallclock", "lateness"}),
                       ("mem.csv", set())):
        rows = _csv(got / name, drop)
        assert rows == _csv(ref / name, drop), name
        assert len(rows) > 3, name
    assert (got / "mem.csv").read_text() == (ref / "mem.csv").read_text()


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_queue_levels_rows_equal(tmp_path, payload):
    """queue-levels over audiornnoise's adapter (tests/test_tracers.py's
    pipeline, fed by an appsrc): the same rows in both packages."""
    spec = "queue-levels(file={dir}/levels.csv)"
    launch = "appsrc name=src ! audiornnoise name=dn ! fakesink name=out"
    caps = f"audio/x-raw,format=F32,rate={RATE},channels=1,layout=interleaved"
    bufs = [_audio(i)[:300, :1].copy() for i in range(N)]
    got = _run(tfx, spec, tmp_path, "port", payload, launch, caps, bufs)
    ref = _run(fx, spec, tmp_path, "jax", launch=launch, caps=caps, buffers=bufs)
    rows = _csv(got / "levels.csv", {"wallclock"})
    assert rows == _csv(ref / "levels.csv", {"wallclock"})
    assert any(r[0] == "dn" for r in rows[1:])


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_chrome_perfetto_fmt_and_logging_equal(tmp_path, payload, caplog):
    """chrome-tracer and perfetto-tracer: the same events (timestamps
    aside); fmt-tracer: the same lines after the clock; py-tracing: the
    same log records."""
    spec = ("chrome-tracer(file={dir}/trace.json);perfetto-tracer(file={dir}/p.json);"
            "fmt-tracer(file={dir}/fmt.log);py-tracing(level=INFO)")
    with caplog.at_level(logging.INFO, logger="gstpu.trace"):
        got = _run(tfx, spec, tmp_path, "port", payload)
        port_logs = [(r.name, r.getMessage()) for r in caplog.records]
        caplog.clear()
        ref = _run(fx, spec, tmp_path, "jax")
        jax_logs = [(r.name, r.getMessage()) for r in caplog.records]
    assert port_logs == jax_logs and len(port_logs) == 3 * N

    def events(path):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in json.loads(path.read_text())["traceEvents"]]

    for name in ("trace.json", "p.json"):
        assert events(got / name) == events(ref / name) and len(events(got / name)) == 3 * N

    def lines(path):
        return [ln.split(None, 1)[1] for ln in path.read_text().splitlines()]

    assert lines(got / "fmt.log") == lines(ref / "fmt.log")


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_pcap_writer_writes_the_same_packets(tmp_path, payload):
    """pcap-writer on an RTP stream (rtpL16pay2 into a fakesink): the same
    capture in both packages, the per-packet timestamps aside."""
    spec = "pcap-writer(file={dir}/cap.pcap,element=out)"
    launch = ("appsrc name=src ! rtpL16pay2 mtu=400 ssrc=1 timestamp-offset=0 "
              "seqnum-offset=0 ! fakesink name=out")
    caps = f"audio/x-raw,format=S16BE,rate={RATE},channels=2,layout=interleaved"
    bufs = [(_audio(i) * 30000).astype(">i2") for i in range(N)]
    # a tensor holds the samples' values in the host's order
    bufs_port = [b.astype(np.int16) for b in bufs] if payload == "torch" else bufs

    def packets(path):
        data = path.read_bytes()
        out, pos = [], 24
        while pos < len(data):
            incl = struct.unpack_from("<IIII", data, pos)[2]
            out.append(data[pos + 16:pos + 16 + incl])
            pos += 16 + incl
        return data[:24], out

    got = _run(tfx, spec, tmp_path, "port", payload, launch, caps, bufs_port)
    ref = _run(fx, spec, tmp_path, "jax", launch=launch, caps=caps, buffers=bufs)
    assert packets(got / "cap.pcap") == packets(ref / "cap.pcap")
    assert len(packets(got / "cap.pcap")[1]) >= N


def test_memory_tracer_counts_tensor_bytes_without_reading_them():
    """memory-tracer takes a payload's size from `nbytes`, a tensor
    attribute: a tensor whose values cannot be read counts its bytes."""

    class Unreadable(torch.Tensor):
        def __array__(self, *a, **k):
            raise AssertionError("the tracer read the payload")

        def tolist(self):
            raise AssertionError("the tracer read the payload")

    t = tracers.MemoryTracer(file="/dev/null")
    el = type("E", (), {"name": "el"})()
    data = torch.zeros((1080, 1920, 4), dtype=torch.uint8).as_subclass(Unreadable)
    for _ in range(3):
        t.on_buffer(el, None, tfx.Buffer(data))
    t.on_buffer(el, None, tfx.Buffer(torch.zeros(480, 2, dtype=torch.float64)))
    assert t.stats == {"el": [4, 3 * 8_294_400 + 480 * 2 * 8]}


def test_pipeline_installs_tracers_from_the_environment(monkeypatch, tmp_path):
    """The port's Pipeline installs GSTPU_TRACERS' tracers when it is made,
    as the JAX package's does; without the variable it has none."""
    monkeypatch.delenv("GSTPU_TRACERS", raising=False)
    assert tfx.Pipeline().tracers == []
    monkeypatch.setenv("GSTPU_TRACERS", f"memory-tracer(file={tmp_path}/m.csv);"
                                        "pipeline-snapshot")
    p = tfx.Pipeline()
    assert [t.name for t in p.tracers] == ["memory-tracer", "pipeline-snapshot"]
    assert p.tracers[1]._pipeline is p
    assert sorted(tracers.TRACER_CLASSES) == sorted(jtracers.TRACER_CLASSES)
