"""Remaining threadshare (ts-*) elements.

Parity target: generic/threadshare's element set (lib.rs:21-57).  The
reference's design point — many elements cooperatively scheduled on few
threads — is covered framework-wide by the synchronous scheduler plus
queue worker threads (SURVEY.md §2.3); the ts-* names here provide the
same element surface:

- ts-appsrc / ts-audiotestsrc / ts-queue — context-scheduled variants of
  the core elements (same semantics here; the scheduling substrate is
  the framework's own).
- ts-blocking-adapter — bridges a blocking upstream into a context
  (threadshare/src/blocking_adapter): a thread-decoupling stage.
- ts-clocksync — delays buffers to their running time
  (threadshare/src/clocksync).
- ts-input-selector — N sink pads, forwards the active one
  (threadshare/src/inputselector).
- ts-intersink / ts-intersrc — inter-pipeline bridge over a named
  context channel (threadshare/src/inter).
- ts-rtpdtmfsrc — RFC 4733 telephone-event RTP source
  (threadshare/src/rtpdtmfsrc).
- ts-tcpclientsrc — TCP client source (threadshare/src/tcpclientsrc).
"""
from __future__ import annotations

import socket
import struct
import time
from typing import List, Optional

import numpy as np

from ...core import (
    BaseSrc,
    Buffer,
    Caps,
    Element,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.parse import parse_caps
from ...core.payload import zeros_like_payload
from ..sources import AppSrc, AudioTestSrc
from .basic import Queue
from .io import InterSink, InterSrc


# Shared context selection (threadshare Context::acquire): sources with
# the same non-empty `context` are driven together on one thread per
# context by Pipeline.run; queue-like elements with a `context` drain on
# one shared TaskContext thread per name (core/taskcontext.py).
_CTX_PROPS = [
    Prop("context", "", type="str",
         doc="Context name to share threads with"),
    Prop("context-wait", 5, type="uint", maximum=1000,
         doc="Throttle the context loop to at most once every this many ms"),
]


@register
class TsAppSrc(AppSrc):
    ELEMENT_NAME = "ts-appsrc"
    ELEMENT_DESCRIPTION = "Application-driven source (threadshare analog)"
    SIGNALS = {"push-buffer": "push_buffer", "end-of-stream": "end_of_stream"}
    PROPERTIES = AppSrc.PROPERTIES + _CTX_PROPS + [
        Prop("do-timestamp", False, type="bool",
             doc="Timestamp buffers with the running time on arrival"),
        Prop("max-buffers", 10, type="uint", minimum=1,
             doc="Maximum number of buffers to queue up"),
    ]

    def push_buffer(self, buf: Buffer):
        if self.get_property("do-timestamp") and buf.pts is None \
                and self.clock is not None:
            buf.pts = max(0, self.clock.now() - (self.base_time or 0))
        limit = self.get_property("max-buffers")
        q = getattr(self, "_queue", None)
        while limit and q is not None and len(q) >= limit:
            time.sleep(0.001)  # backpressure like the reference dataqueue
        return super().push_buffer(buf)


@register
class TsAudioTestSrc(AudioTestSrc):
    ELEMENT_NAME = "ts-audiotestsrc"
    ELEMENT_DESCRIPTION = "Test audio source (threadshare analog)"
    PROPERTIES = AudioTestSrc.PROPERTIES + _CTX_PROPS + [
        Prop("buffer-duration", 10, type="uint",
             doc="Buffer duration in ms (alternative to samples-per-buffer)"),
        Prop("do-timestamp", False, type="bool",
             doc="Apply current stream time to buffers"),
        Prop("mute", False, type="bool", mutable="playing", doc="Mute"),
        Prop("samples-per-buffer", 0, type="uint",
             doc="Number of samples per output buffer (alias of "
                 "samplesperbuffer; 0 = use buffer-duration)"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "samples-per-buffer" and value:
            self._props["samplesperbuffer"] = int(value)
        elif name == "buffer-duration":
            self._duration_set = True

    def negotiated(self, caps) -> None:
        super().negotiated(caps)
        # buffer-duration only applies when samples-per-buffer wasn't set;
        # resolved here where the negotiated rate is known
        if getattr(self, "_duration_set", False) \
                and not self.get_property("samples-per-buffer"):
            dur = self.get_property("buffer-duration")
            if dur and self._info is not None:
                self._props["samplesperbuffer"] = max(
                    1, int(dur) * self._info.rate // 1000)

    def create(self):
        buf = super().create()
        if buf is not None and buf is not AudioTestSrc.RETRY \
                and self.get_property("mute"):
            buf.data = zeros_like_payload(buf.data)
        return buf


@register
class TsQueue(Queue):
    ELEMENT_NAME = "ts-queue"
    ELEMENT_DESCRIPTION = "Decoupling queue (threadshare analog)"
    PROPERTIES = Queue.PROPERTIES + _CTX_PROPS


@register
class TsBlockingAdapter(Queue):
    """Adapter that moves a blocking upstream onto its own context thread —
    the queue worker gives exactly that decoupling."""

    ELEMENT_NAME = "ts-blocking-adapter"
    ELEMENT_DESCRIPTION = "Bridges blocking upstreams into the shared context"


@register
class TsInterSink(InterSink):
    ELEMENT_NAME = "ts-intersink"
    ELEMENT_DESCRIPTION = "Inter-pipeline sink over a named context channel"
    PROPERTIES = InterSink.PROPERTIES + [
        Prop("inter-context", "", type="str",
             doc="context name shared with ts-intersrc (alias of "
                 "producer-name, kept in sync)"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "inter-context" and value:
            self._props["producer-name"] = value
        elif name == "producer-name":
            self._props["inter-context"] = value


@register
class TsInterSrc(InterSrc):
    ELEMENT_NAME = "ts-intersrc"
    ELEMENT_DESCRIPTION = "Inter-pipeline source over a named context channel"
    PROPERTIES = InterSrc.PROPERTIES + _CTX_PROPS + [
        Prop("producer-name", "default", type="str", mutable="playing"),
        Prop("inter-context", "", type="str", mutable="playing",
             doc="context name shared with ts-intersink (alias of "
                 "producer-name, kept in sync); switching it mid-run "
                 "re-subscribes to the new producer (threadshare "
                 "inter.rs changing_inter_ctx)"),
        Prop("max-size-buffers", 200, type="uint",
             doc="Maximum number of buffers to queue (0=unlimited)"),
        Prop("max-size-bytes", 1_048_576, type="uint",
             doc="Maximum number of bytes to queue (0=unlimited)"),
        Prop("max-size-time", 1_000_000_000, type="uint64",
             doc="Maximum number of nanoseconds to queue (0=unlimited)"),
        Prop("leaky", "no", type="enum",
             choices=["no", "upstream", "downstream"],
             doc="accepted for parity; the shared channel always drops "
                 "oldest on overflow (the producer must never stall)"),
        Prop("current-level-buffers", 0, type="uint",
             doc="(read) buffers queued in the shared channel"),
        Prop("current-level-bytes", 0, type="uint",
             doc="(read) bytes queued in the shared channel"),
        Prop("current-level-time", 0, type="uint64",
             doc="(read) nanoseconds queued in the shared channel"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "inter-context" and value:
            self._props["producer-name"] = value
        elif name == "producer-name":
            self._props["inter-context"] = value

    def _limits(self):
        return (int(self.get_property("max-size-buffers")),
                int(self.get_property("max-size-bytes")),
                int(self.get_property("max-size-time")))

    def get_property(self, name: str):
        if name.startswith("current-level-"):
            from .io import _channel

            sub = self._sub if self._sub is not None else \
                _channel(super().get_property("producer-name"))
            return {"current-level-buffers": sub.n_buffers,
                    "current-level-bytes": sub.level_bytes,
                    "current-level-time": sub.level_time}[name]
        return super().get_property(name)


@register
class TsClockSync(Element):
    """Delays each buffer until its PTS as running time has elapsed
    (threadshare/src/clocksync; `sync=false` passes through)."""

    ELEMENT_NAME = "ts-clocksync"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Synchronizes buffers to the clock"
    PROPERTIES = [
        Prop("sync", True, type="bool"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
        self._base_time: Optional[float] = None

    def on_ready_to_paused(self) -> None:
        self._base_time = None

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self.get_property("sync") and buf.pts is not None:
            now = time.monotonic()
            if self._base_time is None:
                self._base_time = now - buf.pts / 1e9
            target = self._base_time + buf.pts / 1e9
            delay = target - now
            if delay > 0:
                time.sleep(min(delay, 10.0))
        return self.srcpad.push(buf)


@register
class TsInputSelector(Element):
    """N request sink pads; only the active pad's buffers flow
    (threadshare/src/inputselector)."""

    ELEMENT_NAME = "ts-input-selector"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Forwards the active input, drops the others"
    PROPERTIES = [
        Prop("active-pad", "sink_0", type="str", mutable="playing"),
        # context selects the scheduler thread in the reference; this
        # element is passive here (runs on the caller's thread), the
        # props exist for pipeline-string parity
        *_CTX_PROPS,
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self._sink_count = 0
        self._caps_pushed = False

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        pad_name = name or f"sink_{self._sink_count}"
        self._sink_count += 1
        pad = self.add_pad(
            Pad(pad_name, PadDirection.SINK,
                PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST, Caps.new_any()))
        )
        pad.chain_function = self._chain
        pad.event_function = self._event
        return pad

    def _is_active(self, pad: Pad) -> bool:
        return pad.name == self.get_property("active-pad")

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if not self._is_active(pad):
            return FlowReturn.OK
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, event) -> bool:
        from ...core.events import EventType

        if self._is_active(pad) or event.type in (EventType.STREAM_START, EventType.CAPS,
                                                  EventType.SEGMENT):
            if event.type == EventType.CAPS and self._caps_pushed:
                return True
            if event.type == EventType.CAPS:
                self._caps_pushed = True
            if event.type == EventType.EOS and not self._is_active(pad):
                return True
            return self.srcpad.push_event(event)
        return True


@register
class TsRtpDtmfSrc(BaseSrc):
    """RFC 4733 telephone-event RTP source (threadshare/src/rtpdtmfsrc).

    Queue tones with `queue_dtmf(number, duration_ms)` or the `tones`
    property ("159#" etc.).  Each tone emits packets every `packet-ms`
    with accumulating duration, the final three carrying the E bit, then
    the source idles (EOS when `tones` preset is exhausted).
    """

    ELEMENT_NAME = "ts-rtpdtmfsrc"
    ELEMENT_CLASS = "Source/Network/RTP"
    ELEMENT_DESCRIPTION = "Generates RFC 4733 DTMF telephone-events as RTP"
    SRC_CAPS = Caps.builder("application/x-rtp")
    PROPERTIES = [
        Prop("pt", 101, type="uint"),
        Prop("ssrc", 0, type="uint"),
        Prop("clock-rate", 8000, type="uint"),
        Prop("tones", None, type="str", doc="tone characters 0-9 * # A-D"),
        Prop("tone-duration-ms", 160, type="uint"),
        Prop("packet-ms", 40, type="uint"),
        Prop("volume", 10, type="uint", doc="attenuation dBm0 (0-63)"),
        *_CTX_PROPS,
        Prop("packet-redundancy", 1, type="uint", minimum=1, maximum=5,
             doc="Number of packets sent for DTMF event start and stop"),
        Prop("seqnum", 0, type="uint",
             doc="(read) RTP sequence number of the last emitted packet"),
        Prop("seqnum-offset", -1, type="int", minimum=-1, maximum=65535,
             doc="Offset added to all outgoing seqnums (-1 = random)"),
        Prop("timestamp", 0, type="uint",
             doc="(read) RTP timestamp of the last emitted packet"),
        Prop("timestamp-offset", -1, type="int", minimum=-1,
             doc="Offset added to all outgoing timestamps (-1 = random)"),
    ]

    _CHARS = {**{str(d): d for d in range(10)}, "*": 10, "#": 11,
              "A": 12, "B": 13, "C": 14, "D": 15}

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._pending: List[int] = []
        self._seq = 0
        self._ts = 0

    def queue_dtmf(self, char: str) -> None:
        self._pending.append(self._CHARS[char.upper()])

    def start(self) -> None:
        import random

        tones = self.get_property("tones") or ""
        self._pending = [self._CHARS[c.upper()] for c in tones if c.upper() in self._CHARS]
        so = self.get_property("seqnum-offset")
        to = self.get_property("timestamp-offset")
        self._seq = so if so >= 0 else random.randrange(1 << 16)
        self._ts = to if to >= 0 else random.randrange(1 << 32)

    def fixate(self, caps: Caps) -> Caps:
        return parse_caps(
            f"application/x-rtp,media=audio,encoding-name=TELEPHONE-EVENT,"
            f"clock-rate={self.get_property('clock-rate')},payload={self.get_property('pt')}"
        )

    def create(self):
        if not self._pending:
            return None
        event = self._pending.pop(0)
        rate = self.get_property("clock-rate")
        tone_samples = self.get_property("tone-duration-ms") * rate // 1000
        step = self.get_property("packet-ms") * rate // 1000
        volume = self.get_property("volume") & 0x3F
        pt = self.get_property("pt")
        ssrc = self.get_property("ssrc")
        redundancy = self.get_property("packet-redundancy")
        out = []
        duration = step
        first = True
        while True:
            end = duration >= tone_samples
            dur = min(duration, tone_samples)
            payload = struct.pack("!BBH", event, (0x80 if end else 0) | volume, dur)
            # packet-redundancy: the start packet is sent that many times
            # (distinct seqnums, marker on the first), like the reference
            repeats = redundancy if first else 1
            for i in range(repeats):
                marker = 0x80 if (first and i == 0) else 0
                hdr = struct.pack("!BBHII", 0x80, marker | pt, self._seq & 0xFFFF,
                                  self._ts & 0xFFFFFFFF, ssrc)
                out.append(hdr + payload)
                self._seq += 1
            first = False
            if end:
                # RFC 4733 §2.5.1.4 triple end, extended by redundancy
                for _ in range(1 + redundancy):
                    hdr = struct.pack("!BBHII", 0x80, pt, self._seq & 0xFFFF,
                                      self._ts & 0xFFFFFFFF, ssrc)
                    out.append(hdr + payload)
                    self._seq += 1
                break
            duration += step
        self._ts += tone_samples
        self._props["seqnum"] = (self._seq - 1) & 0xFFFF
        self._props["timestamp"] = (self._ts - tone_samples) & 0xFFFFFFFF
        return Buffer(np.frombuffer(b"".join(
            struct.pack("!H", len(p)) + p for p in out), np.uint8))


@register
class TsTcpClientSrc(BaseSrc):
    """TCP client source (threadshare/src/tcpclientsrc)."""

    ELEMENT_NAME = "ts-tcpclientsrc"
    ELEMENT_CLASS = "Source/Network"
    ELEMENT_DESCRIPTION = "Reads a byte stream from a TCP server"
    SRC_CAPS = Caps.builder("application/octet-stream")
    PROPERTIES = [
        Prop("host", "127.0.0.1", type="str"),
        Prop("port", 4953, type="uint"),
        Prop("blocksize", 4096, type="uint"),
        Prop("caps", None, type="object"),
        Prop("timeout", 5_000_000_000, type="uint64"),
        *_CTX_PROPS,
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        self._sock = socket.create_connection(
            (self.get_property("host"), self.get_property("port")),
            timeout=(self.get_property("timeout") or 5e9) / 1e9,
        )

    def stop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def fixate(self, caps: Caps) -> Caps:
        prop = self.get_property("caps")
        if prop is not None:
            return parse_caps(prop) if isinstance(prop, str) else prop
        return Caps.builder("application/octet-stream")

    def create(self):
        try:
            data = self._sock.recv(self.get_property("blocksize"))
        except socket.timeout:
            return None
        if not data:
            return None
        return Buffer(np.frombuffer(data, np.uint8))
