"""Tracers: observability hooks activated by environment variable.

Rebuild of utils/tracers (SURVEY.md §5; 11 tracer modules activated by
GST_TRACERS, utils/tracers/src/lib.rs:17-55).  Here the env var is
GSTPU_TRACERS with the same mini-language:

    GSTPU_TRACERS='queue-levels(file=/tmp/q.csv);pad-push-timings(file=/tmp/p.csv)'

Tracers hook buffer pushes on every pad (core Element._trace_buffer) and are
installed automatically on every Pipeline.  No tracer reads a payload's
values or waits on the card: sizes come from `nbytes` and shapes (tensor
attributes), every timestamp from a host clock.

- queue-levels:      CSV of adapter/queue fill levels over time
                     (utils/tracers/src/queue_levels/imp.rs analog)
- pad-push-timings:  CSV of per-pad buffer push wall-clock timings
- buffer-lateness:   CSV of buffer PTS vs pipeline wall-clock lateness
- pipeline-snapshot: writes a graphviz .dot of the pipeline graph on demand
                     (dot_file property; SIGUSR1-on-unix analog via snapshot())
- memory-tracer:     per-element buffer/byte counters -> CSV at close
- chrome-tracer:     chrome://tracing / Perfetto JSON of buffer flow
- pcap-writer:       RTP buffers as a Wireshark-loadable pcap capture
"""
from __future__ import annotations

import os
import re
import struct
import time
from typing import Dict, List, Optional

import torch

from ..core.buffer import Buffer


class Tracer:
    name = "tracer"

    def __init__(self, **params: str):
        self.params = params

    def on_buffer(self, element, pad, buffer: Buffer) -> None: ...

    def close(self) -> None: ...


class PadPushTimingsTracer(Tracer):
    name = "pad-push-timings"

    def __init__(self, **params):
        super().__init__(**params)
        self._file = open(params.get("file", "pad_push_timings.csv"), "w")
        self._file.write("wallclock,element,pad,pts,frames\n")
        self._t0 = time.monotonic()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        frames = buffer.n_frames if buffer.data is not None else 0
        self._file.write(
            f"{time.monotonic() - self._t0:.6f},{element.name},{pad.name},"
            f"{'' if buffer.pts is None else buffer.pts},{frames}\n"
        )

    def close(self) -> None:
        self._file.close()


class QueueLevelsTracer(Tracer):
    name = "queue-levels"

    def __init__(self, **params):
        super().__init__(**params)
        self._file = open(params.get("file", "queue_levels.csv"), "w")
        self._file.write("wallclock,element,queue,level_frames\n")
        self._t0 = time.monotonic()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        # sample every adapter-like attribute the element exposes
        t = time.monotonic() - self._t0
        for attr in ("_adapter", "adapter"):
            a = getattr(element, attr, None)
            if a is not None and hasattr(a, "available"):
                self._file.write(f"{t:.6f},{element.name},{attr},{a.available()}\n")
        state = getattr(element, "_state", None)
        if state is not None and hasattr(state, "adapter"):
            self._file.write(f"{t:.6f},{element.name},state.adapter,{state.adapter.available()}\n")

    def close(self) -> None:
        self._file.close()


class BufferLatenessTracer(Tracer):
    name = "buffer-lateness"

    def __init__(self, **params):
        super().__init__(**params)
        self._file = open(params.get("file", "buffer_lateness.csv"), "w")
        self._file.write("wallclock,element,pad,pts,lateness\n")
        self._t0 = time.monotonic()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        t = time.monotonic() - self._t0
        if buffer.pts is None:
            return
        lateness = t - buffer.pts / 1e9
        self._file.write(f"{t:.6f},{element.name},{pad.name},{buffer.pts},{lateness:.6f}\n")

    def close(self) -> None:
        self._file.close()


class PipelineSnapshotTracer(Tracer):
    name = "pipeline-snapshot"

    def __init__(self, **params):
        super().__init__(**params)
        self.dot_file = params.get("dot-file", "pipeline.dot")
        self._pipeline = None

    def attach(self, pipeline) -> None:
        self._pipeline = pipeline

    def snapshot(self, path: Optional[str] = None) -> str:
        """Write the current pipeline graph as graphviz dot; returns the path."""
        p = self._pipeline
        lines = ["digraph pipeline {", "  rankdir=LR;"]
        for e in p.elements:
            lines.append(f'  "{e.name}" [label="{e.ELEMENT_NAME}\\n{e.name}"];')
        for e in p.elements:
            for pad in e.src_pads():
                if pad.peer is not None and pad.peer.element is not None:
                    lines.append(
                        f'  "{e.name}" -> "{pad.peer.element.name}" '
                        f'[label="{pad.name}->{pad.peer.name}"];'
                    )
        lines.append("}")
        out = path or self.dot_file
        with open(out, "w") as f:
            f.write("\n".join(lines) + "\n")
        return out


class MemoryTracer(Tracer):
    """Tracks bytes flowing per element (reference utils/tracers
    memory-tracer analog): cumulative payload bytes and buffer counts,
    dumped as CSV at close."""

    name = "memory-tracer"

    def __init__(self, **params):
        super().__init__(**params)
        self.path = params.get("file", "memory-tracer.csv")
        self.stats: Dict[str, List[int]] = {}

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        data = buffer.data
        nbytes = int(getattr(data, "nbytes", 0)) if data is not None else 0
        if not nbytes and isinstance(data, (str, bytes)):
            nbytes = len(data)
        st = self.stats.setdefault(element.name, [0, 0])
        st[0] += 1
        st[1] += nbytes

    def close(self) -> None:
        with open(self.path, "w") as f:
            f.write("element,buffers,bytes\n")
            for name, (count, nbytes) in sorted(self.stats.items()):
                f.write(f"{name},{count},{nbytes}\n")


class ChromeTracer(Tracer):
    """Emits chrome://tracing / Perfetto-loadable JSON of buffer flow
    (reference utils/tracers chrome-tracer bridge)."""

    name = "chrome-tracer"

    def __init__(self, **params):
        super().__init__(**params)
        self.path = params.get("file", "trace.json")
        self._events: List[dict] = []
        self._t0 = time.perf_counter()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        ts_us = (time.perf_counter() - self._t0) * 1e6
        self._events.append({
            "name": f"{element.name}.{pad.name}",
            "cat": "buffer",
            "ph": "i",  # instant event
            "ts": ts_us,
            "pid": 1,
            "tid": 1,
            "args": {"pts": buffer.pts},
        })

    def close(self) -> None:
        import json as _json

        with open(self.path, "w") as f:
            _json.dump({"traceEvents": self._events}, f)


class PcapWriterTracer(Tracer):
    """Writes buffers flowing through RTP/UDP pads as a pcap capture
    (reference utils/tracers pcap-writer): synthetic Ethernet/IPv4/UDP
    framing around each payload so Wireshark decodes the RTP."""

    name = "pcap-writer"

    def __init__(self, **params):
        super().__init__(**params)
        self.path = params.get("file", "capture.pcap")
        self.element_filter = params.get("element")  # only this element
        self._f = open(self.path, "wb")
        # pcap global header: magic, v2.4, tz 0, sigfigs 0, snaplen, ethernet
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 1))
        self._t0 = time.time()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        if self.element_filter and element.name != self.element_filter:
            return
        caps = pad.current_caps
        name = caps.structure(0).name if caps and caps.structures else ""
        if not name.startswith("application/x-rtp"):
            return
        data = buffer.data
        if isinstance(data, torch.Tensor):
            if data.device.type != "cpu":
                return  # RTP packets are host bytes; a tracer reads nothing back
            data = data.numpy()
        payload = data.tobytes() if hasattr(data, "tobytes") else bytes(data)
        eth = b"\x00" * 12 + b"\x08\x00"
        ip_len = 20 + 8 + len(payload)
        ip = struct.pack(">BBHHHBBH4s4s", 0x45, 0, ip_len, 0, 0, 64, 17, 0,
                         b"\x7f\x00\x00\x01", b"\x7f\x00\x00\x01")
        udp = struct.pack(">HHHH", 5004, 5004, 8 + len(payload), 0)
        frame = eth + ip + udp + payload
        now = time.time()
        self._f.write(struct.pack("<IIII", int(now), int((now % 1) * 1e6),
                                  len(frame), len(frame)))
        self._f.write(frame)

    def close(self) -> None:
        self._f.close()


class FmtTracer(Tracer):
    """Human-readable structured log lines of buffer flow — the
    tracing-subscriber fmt bridge analog (utils/tracers fmttracing).
    Params: file (default stderr), level (default info)."""

    name = "fmt-tracer"

    def __init__(self, **params):
        super().__init__(**params)
        import sys

        path = params.get("file")
        self._file = open(path, "w") if path else sys.stderr
        self._owns = path is not None
        self._t0 = time.monotonic()

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        t = time.monotonic() - self._t0
        pts = "none" if buffer.pts is None else f"{buffer.pts / 1e9:.6f}"
        self._file.write(
            f"{t:10.6f} INFO buffer {element.name}.{pad.name}"
            f" pts={pts} frames={buffer.n_frames}\n")

    def close(self) -> None:
        self._file.flush()
        if self._owns:
            self._file.close()


class PyTracingTracer(Tracer):
    """Bridge buffer flow into the `logging` ecosystem — the rusttracing
    (gst log -> Rust `tracing`) analog: one logger per element under the
    'gstpu.trace' namespace, records carry pad/pts/frames as extras."""

    name = "py-tracing"

    def __init__(self, **params):
        super().__init__(**params)
        import logging

        self._level = getattr(logging, params.get("level", "DEBUG").upper())
        self._logging = logging

    def on_buffer(self, element, pad, buffer: Buffer) -> None:
        self._logging.getLogger(f"gstpu.trace.{element.name}").log(
            self._level, "buffer %s pts=%s frames=%d", pad.name, buffer.pts,
            buffer.n_frames,
            extra={"pad": pad.name, "pts": buffer.pts,
                   "frames": buffer.n_frames})


class PerfettoTracer(ChromeTracer):
    """Perfetto-loadable trace (utils/tracers perfettotracing analog).

    Perfetto's UI ingests the Chrome Trace Event JSON natively, so this
    shares ChromeTracer's writer but defaults to a .perfetto-trace path
    and stamps process/thread metadata records the UI groups by."""

    name = "perfetto-tracer"

    def __init__(self, **params):
        params.setdefault("file", "trace.perfetto-trace.json")
        super().__init__(**params)


TRACER_CLASSES = {
    cls.name: cls
    for cls in (PadPushTimingsTracer, QueueLevelsTracer, BufferLatenessTracer,
                PipelineSnapshotTracer, MemoryTracer, ChromeTracer,
                PcapWriterTracer, FmtTracer, PyTracingTracer, PerfettoTracer)
}

_SPEC_RE = re.compile(r"([a-z-]+)(?:\(([^)]*)\))?")


def parse_tracer_spec(spec: str) -> List[Tracer]:
    """Parse 'name(key=val,key=val);name2' into tracer instances."""
    tracers: List[Tracer] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        m = _SPEC_RE.fullmatch(part)
        if not m:
            raise ValueError(f"bad tracer spec {part!r}")
        name, args = m.group(1), m.group(2)
        if name not in TRACER_CLASSES:
            raise ValueError(f"unknown tracer {name!r} (known: {sorted(TRACER_CLASSES)})")
        params: Dict[str, str] = {}
        if args:
            for kv in args.split(","):
                k, v = kv.split("=", 1)
                params[k.strip()] = v.strip()
        tracers.append(TRACER_CLASSES[name](**params))
    return tracers


def install_from_env(pipeline, env: str = "GSTPU_TRACERS") -> None:
    spec = os.environ.get(env)
    if not spec:
        return
    for tracer in parse_tracer_spec(spec):
        if isinstance(tracer, PipelineSnapshotTracer):
            tracer.attach(pipeline)
        pipeline.add_tracer(tracer)


__all__ = [
    "Tracer",
    "MemoryTracer",
    "ChromeTracer",
    "PcapWriterTracer",
    "PadPushTimingsTracer",
    "QueueLevelsTracer",
    "BufferLatenessTracer",
    "PipelineSnapshotTracer",
    "TRACER_CLASSES",
    "parse_tracer_spec",
    "install_from_env",
]
