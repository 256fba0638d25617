"""Misc inventory elements: textahead, streamgrouper, s302mparse, ac4parse,
uriplaylistbin, viuersink, ts-proxysink/ts-proxysrc.

Parity targets:
- text/ahead (textahead/imp.rs: n-ahead lookahead with separator and pango
  attribute spans; defaults n_ahead=1, separator "\\n")
- generic/streamgrouper (streamgrouper/imp.rs: all streams share group-id)
- audio/audioparsers (s302mparse/imp.rs: AES3 header channels/bits parse;
  ac4parse: AC-4 sync framing)
- utils/uriplaylistbin (sequential URI playback with iterations)
- video/viuer (viuersink: terminal video via ANSI half-blocks)
- generic/threadshare proxy (ts-proxysink/ts-proxysrc in-process bridge
  keyed by proxy-context)
"""
from __future__ import annotations

import struct
import sys
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ...core import (
    BaseSink,
    BaseSrc,
    BaseTransform,
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    TransformMode,
    register,
)
from ...core.caps import Structure
from ...core.events import Message, MessageType
from ...core.payload import host_array, host_bytes

TEXT_CAPS = Caps.builder("text/x-raw", format="utf8")


@register
class TextAhead(BaseTransform):
    """Shows upcoming text buffers alongside the current one (karaoke-style
    lookahead; reference text/ahead)."""

    ELEMENT_NAME = "textahead"
    ELEMENT_CLASS = "Text/Filter"
    ELEMENT_DESCRIPTION = "Display upcoming text buffers ahead of time"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = TEXT_CAPS
    PROPERTIES = [
        Prop("n-ahead", 1, type="uint"),
        Prop("n-previous", 0, type="uint"),
        Prop("separator", "\n", type="str"),
        Prop("current-attributes", "", type="str", doc="pango span attributes"),
        Prop("ahead-attributes", "", type="str"),
        Prop("previous-attributes", "", type="str"),
        Prop("buffer-start-segment", False, type="bool", mutable="playing",
             doc="emit a buffer at segment start showing only ahead text"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._pending: Deque[Buffer] = deque()
        self._previous: Deque[str] = deque()
        self._segment_pending = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._pending.clear()
        self._previous.clear()
        self._segment_pending = self.get_property("buffer-start-segment")

    def _span(self, text: str, attrs: str) -> str:
        return f"<span {attrs}>{text}</span>" if attrs else text

    def _compose(self, current: Buffer, ahead: List[str]) -> Buffer:
        sep = self.get_property("separator")
        parts = [self._span(t, self.get_property("previous-attributes"))
                 for t in self._previous]
        parts.append(self._span(str(current.data), self.get_property("current-attributes")))
        parts += [self._span(t, self.get_property("ahead-attributes")) for t in ahead]
        out = Buffer(sep.join(parts))
        out.copy_metadata_from(current)
        out.data = sep.join(parts)
        n_prev = self.get_property("n-previous")
        if n_prev:
            self._previous.append(str(current.data))
            while len(self._previous) > n_prev:
                self._previous.popleft()
        return out

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._pending.append(inbuf)
        if self._segment_pending and self._pending:
            # segment start: a buffer showing the upcoming text only
            self._segment_pending = False
            ahead = [self._span(str(b.data),
                                self.get_property("ahead-attributes"))
                     for b in self._pending]
            out = Buffer(self.get_property("separator").join(ahead), pts=0)
            return out
        if len(self._pending) > self.get_property("n-ahead"):
            cur = self._pending.popleft()
            return self._compose(cur, [str(b.data) for b in self._pending])
        return None

    def drain(self) -> Optional[Buffer]:
        out = None
        while self._pending:
            cur = self._pending.popleft()
            buf = self._compose(cur, [str(b.data) for b in self._pending])
            if self._pending:
                self.srcpad.push(buf)
            else:
                out = buf
        return out


@register
class StreamGrouper(Element):
    """Rewrites stream-start events so all streams share one group id
    (reference generic/streamgrouper)."""

    ELEMENT_NAME = "streamgrouper"
    EXTRA_PAD_TEMPLATES = [
        ('sink_%u', 'sink', 'request', 'ANY'),
        ('src_%u', 'src', 'request', 'ANY'),
    ]
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Makes all incoming streams share a group-id"

    _group_counter = 0

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        StreamGrouper._group_counter += 1
        self.group_id = f"group-{StreamGrouper._group_counter}"
        self._count = 0

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        idx = self._count
        self._count += 1
        sink = Pad(f"sink_{idx}", PadDirection.SINK,
                   PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST, Caps.new_any()))
        src = Pad(f"src_{idx}", PadDirection.SRC,
                  PadTemplate("src_%u", PadDirection.SRC, PadPresence.REQUEST, Caps.new_any()))
        sink.chain_function = lambda pad, buf, s=src: s.push(buf)
        sink.event_function = lambda pad, ev, s=src: s.push_event(self._rewrite(ev))
        sink.query_function = lambda pad, q, s=src: s.peer_query(q) if s.peer else False
        self.add_pad(sink)
        self.add_pad(src)
        return sink

    def request_pad(self, template_name: str = "sink_%u") -> Pad:
        return self.request_sink_pad()

    def _rewrite(self, event: Event) -> Event:
        if event.type == EventType.STREAM_START:
            ev = Event(EventType.STREAM_START, **dict(event.fields))
            ev.fields["group_id"] = self.group_id
            return ev
        return event


S302M_CAPS = Caps.builder("audio/x-smpte-302m")


@register
class S302MParse(BaseTransform):
    """SMPTE ST 302M (AES3-in-MPEG-TS) parser: reads the 4-byte audio
    packet header and publishes channels/depth caps (reference
    s302mparse/imp.rs:76-102: 2-bit channel count 2/4/6/8, 2-bit
    bits-per-sample 16/20/24)."""

    ELEMENT_NAME = "s302mparse"
    ELEMENT_CLASS = "Codec/Parser/Audio"
    ELEMENT_DESCRIPTION = "SMPTE 302M audio parser"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = S302M_CAPS
    SRC_CAPS = S302M_CAPS

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = S302M_CAPS.copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        data = host_bytes(inbuf.data, np.uint8)
        if len(data) < 4:
            return None
        _size, header = struct.unpack_from(">HH", data)
        channels = [2, 4, 6, 8][(header >> 14) & 0b11]
        bits_code = (header >> 4) & 0b11
        if bits_code == 3:
            return None  # reserved bits-per-sample: drop (imp.rs:95)
        depth = [16, 20, 24][bits_code]
        caps = Caps.builder("audio/x-smpte-302m", parsed=True,
                            channels=channels, depth=depth, rate=48000)
        if self.srcpad.current_caps != caps:
            self.out_caps = caps
            self.srcpad.current_caps = caps
            self.srcpad.push_event(Event.new_caps(caps))
        out = Buffer(inbuf.data)
        out.copy_metadata_from(inbuf)
        return out


AC4_CAPS = Caps.builder("audio/x-ac4")


@register
class Ac4Parse(BaseTransform):
    """AC-4 raw frame parser: splits at sync words 0xAC40/0xAC41 (the
    latter carries a trailing CRC16) using the 16/24-bit frame size field
    (reference ac4parse/imp.rs)."""

    ELEMENT_NAME = "ac4parse"
    ELEMENT_CLASS = "Codec/Parser/Audio"
    ELEMENT_DESCRIPTION = "AC-4 audio parser"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = AC4_CAPS
    SRC_CAPS = Caps.builder("audio/x-ac4", framed=True)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _next_frame(self) -> Optional[bytes]:
        buf = self._acc
        while len(buf) >= 2 and not (buf[0] == 0xAC and buf[1] in (0x40, 0x41)):
            del buf[0]  # resync
        if len(buf) < 4:
            return None
        crc = buf[1] == 0x41
        size = struct.unpack_from(">H", buf, 2)[0]
        pos = 4
        if size == 0xFFFF:
            if len(buf) < 7:
                return None
            size = int.from_bytes(buf[4:7], "big")
            pos = 7
        total = pos + size + (2 if crc else 0)
        if len(buf) < total:
            return None
        frame = bytes(buf[:total])
        del buf[:total]
        return frame

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._acc += host_bytes(inbuf.data, np.uint8)
        frame = self._next_frame()
        return Buffer(np.frombuffer(frame, np.uint8)) if frame else None


@register
class UriPlaylistBin(BaseSrc):
    """Sequential playback over a list of URIs (reference
    utils/uriplaylistbin; this implementation reads file:// byte streams —
    decodebin-style demux/decode selection is downstream's job here).

    Reference behavior contract (utils/uriplaylistbin/src/uriplaylistbin/
    imp.rs + tests/uriplaylistbin.rs:113-575, mirrored 1:1 by
    tests/test_uriplaylistbin_scenarios.py):

    - `current-iteration` / `current-uri-index` report the LAST STARTED
      item (tests/uriplaylistbin.rs:359-425: multi_audio ends at index 2,
      iterations=2 ends at iteration 1).
    - one STREAM_COLLECTION + STREAMS_SELECTED message pair per *media
      change* — consecutive identical URIs post no new pair, the
      decodebin3 coalescing the reference tests skip duplicates for
      (tests/uriplaylistbin.rs:214-224,278-302).
    - a failing item posts an ERROR message whose structure carries the
      failing `uri` (assert_error, tests/uriplaylistbin.rs:316-327) and
      ends the stream without advancing the indices.
    - `iterations` is mutable in PLAYING; the new value is honored at the
      next wrap (increase_iterations / decrease_iterations /
      infinite_to_finite, tests/uriplaylistbin.rs:488-553).  Divergence:
      the reference pre-queues upcoming items, so a decrease can land
      after extra iterations were already committed (its decrease test
      expects iteration 2 after setting 1); this bin opens items strictly
      on demand, so the requested count is exact.  The whole reference
      suite is #[ignore]d as racy upstream — this synchronous model runs
      it deterministically.
    - `cache=true` copies remote URIs to `cache-dir` so later iterations
      replay locally; single-pass playlists (iterations=1) skip the cache
      entirely (the reference test expects 0 cached files unless the
      playlist loops, tests/uriplaylistbin.rs:303-310).
    - the `item-started` notification signal fires synchronously as each
      item opens (uri, index, iteration) — the hook the reference tests
      build from bus StreamStart counting (tests/uriplaylistbin.rs:230-237).
    """

    SIGNALS = {"item-started": None}
    ELEMENT_NAME = "uriplaylistbin"
    ELEMENT_CLASS = "Generic/Source/Bin"
    ELEMENT_DESCRIPTION = "Sequentially plays a list of URIs"
    PROPERTIES = [
        Prop("uris", "", type="str", doc="comma-separated uri list"),
        Prop("iterations", 1, type="uint", mutable="playing",
             doc="0 = infinite; honored at the next playlist wrap when "
                 "changed in PLAYING (reference imp.rs iterations prop)"),
        Prop("blocksize", 65536, type="uint", minimum=1),
        Prop("current-uri-index", 0, type="uint64",
             doc="(read) index of the URI currently playing"),
        Prop("current-iteration", 0, type="uint",
             doc="(read) iteration currently playing"),
        Prop("cache", False, type="bool",
             doc="cache remote URIs to disk on first read so later "
                 "iterations replay locally"),
        Prop("cache-dir", None, type="str",
             doc="directory for cached URIs (None = system temp)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._f = None
        self._uri_index = 0
        self._iteration = 0
        self._last_started = (0, 0)  # (iteration, uri index) of last item
        self._last_media: Optional[str] = None
        self._errored = False

    def get_property(self, name: str):
        if name == "current-uri-index":
            return self._last_started[1]
        if name == "current-iteration":
            return self._last_started[0]
        return super().get_property(name)

    def _cache_path(self, uri: str) -> str:
        import hashlib
        import os
        import tempfile

        d = self.get_property("cache-dir") or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, hashlib.sha256(uri.encode()).hexdigest()[:24])

    def _uris(self) -> List[str]:
        return [u.strip() for u in self.get_property("uris").split(",") if u.strip()]

    @property
    def current_uri_index(self) -> int:
        return self._uri_index

    @property
    def current_iteration(self) -> int:
        return self._iteration

    def start(self) -> None:
        self._uri_index = 0
        self._iteration = 0
        self._last_started = (0, 0)
        self._last_media = None
        self._errored = False
        self._f = None

    def stop(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate() if not caps.is_any() else Caps.builder("application/octet-stream")

    def _open_next(self) -> bool:
        uris = self._uris()
        if not uris or self._errored:
            return False
        if self._uri_index >= len(uris):
            self._iteration += 1
            iters = self.get_property("iterations")
            if iters and self._iteration >= iters:
                return False
            self._uri_index = 0
        uri = uris[self._uri_index]
        try:
            if uri.startswith(("http://", "https://")):
                import os
                import urllib.request

                # cache only when the playlist will loop: a single pass
                # never re-reads, so the reference leaves the cache dir
                # empty for iterations=1 (tests/uriplaylistbin.rs:303-310)
                if self.get_property("cache") and \
                        self.get_property("iterations") != 1:
                    cpath = self._cache_path(uri)
                    if not os.path.exists(cpath):
                        with urllib.request.urlopen(uri, timeout=30) as resp, \
                                open(cpath, "wb") as out:
                            out.write(resp.read())
                    self._f = open(cpath, "rb")
                else:
                    self._f = urllib.request.urlopen(uri, timeout=30)
            else:
                path = uri[7:] if uri.startswith("file://") else uri
                self._f = open(path, "rb")
        except OSError as e:  # covers IOError + urllib.error.URLError
            self._errored = True
            self.post_message(Message(
                MessageType.ERROR,
                structure=Structure("error", element=self.name, uri=uri,
                                    reason=f"failed to open {uri}: {e}")))
            return False
        self._last_started = (self._iteration, self._uri_index)
        # decodebin3 analog: new collection + selection only when the
        # underlying media actually changes
        if uri != self._last_media:
            self._last_media = uri
            self.post_message(Message(
                MessageType.STREAM_COLLECTION,
                structure=Structure("stream-collection", uri=uri,
                                    n_streams=1)))
            self.post_message(Message(
                MessageType.STREAMS_SELECTED,
                structure=Structure("streams-selected", uri=uri,
                                    n_streams=1)))
        self.post_message(
            Message(MessageType.ELEMENT,
                    structure=Structure("uri-playlist-item-started",
                                        uri=uri, index=self._uri_index,
                                        iteration=self._iteration))
        )
        for cb in getattr(self, "_signal_handlers", {}).get("item-started", []):
            cb(self, uri, self._uri_index, self._iteration)
        self._uri_index += 1
        return True

    def create(self) -> Optional[Buffer]:
        while True:
            if self._f is None:
                if not self._open_next():
                    return None
            data = self._f.read(self.get_property("blocksize"))
            if data:
                return Buffer(np.frombuffer(data, np.uint8))
            self._f.close()
            self._f = None


@register
class ViuerSink(BaseSink):
    """Terminal video sink: ANSI truecolor half-block rendering (reference
    video/viuer viuersink).  Rendering writes to stdout only when it is a
    TTY; the last rendered string is kept for inspection either way."""

    ELEMENT_NAME = "viuersink"
    ELEMENT_CLASS = "Sink/Video"
    ELEMENT_DESCRIPTION = "Displays video in the terminal"
    PROPERTIES = [
        Prop("width", 80, type="uint", minimum=2, doc="output width in terminal columns"),
        Prop("height", 0, type="uint",
             doc="output height in rows (0 = derived from aspect ratio)"),
        Prop("force-tty", False, type="bool", doc="render even when stdout is not a tty"),
        Prop("truecolor", True, type="bool",
             doc="24-bit SGR colors; false quantizes to the 256-color cube"),
        Prop("use-iterm", False, type="bool",
             doc="accepted for parity: the iTerm inline-image protocol is "
                 "not emitted, half-block rendering is used"),
        Prop("use-kitty", False, type="bool",
             doc="accepted for parity: the kitty graphics protocol is not "
                 "emitted, half-block rendering is used"),
        Prop("use-sixel", False, type="bool",
             doc="accepted for parity: sixel output is not emitted"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.last_render = ""

    def render(self, buffer: Buffer) -> FlowReturn:
        frame = buffer.data
        if getattr(frame, "ndim", None) != 3:
            return FlowReturn.OK
        cols = self.get_property("width")
        h, w = frame.shape[:2]
        want_rows = self.get_property("height")
        rows = max(2, (want_rows * 2 if want_rows
                       else int(h * cols / w / 2) * 2))
        rows += rows % 2
        ys = (np.arange(rows) * h // rows).clip(0, h - 1)
        xs = (np.arange(cols) * w // cols).clip(0, w - 1)
        # the sample grid is taken where the frame lies; only the
        # rows x cols cells are read back to the host
        if isinstance(frame, np.ndarray):
            small = frame[np.ix_(ys, xs)][..., :3]
        else:
            rows_at = torch.as_tensor(ys, device=frame.device)
            cols_at = torch.as_tensor(xs, device=frame.device)
            small = frame[rows_at][:, cols_at][..., :3]
        small = host_array(small).astype(int)
        lines = []
        for r in range(0, rows, 2):
            chars = []
            for c in range(cols):
                tr, tg, tb = small[r, c]
                br, bg, bb = small[r + 1, c]
                if self.get_property("truecolor"):
                    chars.append(
                        f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
                else:  # 256-color cube quantization (16 + 36r + 6g + b)
                    fg = 16 + 36 * (tr * 6 // 256) + 6 * (tg * 6 // 256) + (tb * 6 // 256)
                    bg2 = 16 + 36 * (br * 6 // 256) + 6 * (bg * 6 // 256) + (bb * 6 // 256)
                    chars.append(f"\x1b[38;5;{fg}m\x1b[48;5;{bg2}m▀")
            lines.append("".join(chars) + "\x1b[0m")
        self.last_render = "\n".join(lines)
        if self.get_property("force-tty") or sys.stdout.isatty():
            sys.stdout.write(self.last_render + "\n")
        return FlowReturn.OK


# in-process proxy bridge keyed by proxy-context (threadshare ts-proxy*)
# proxy channels reuse the accounted InterChannel container so
# ts-proxysrc can report/limit queue levels like the reference dataqueue
from .io import InterChannel as _ProxyChannel  # noqa: E402

_PROXY_QUEUES: Dict[str, "_ProxyChannel"] = {}
_PROXY_CAPS: Dict[str, Caps] = {}


def _proxy_channel(name: str) -> "_ProxyChannel":
    return _PROXY_QUEUES.setdefault(name, _ProxyChannel())


@register
class TsProxySink(BaseSink):
    ELEMENT_NAME = "ts-proxysink"
    ELEMENT_CLASS = "Sink/Generic"
    ELEMENT_DESCRIPTION = "In-process bridge sink (pairs with ts-proxysrc)"
    PROPERTIES = [Prop("proxy-context", "", type="str", mutable="ready")]

    def on_caps(self, caps: Caps) -> None:
        _PROXY_CAPS[self.get_property("proxy-context")] = caps

    def render(self, buffer: Buffer) -> FlowReturn:
        _proxy_channel(self.get_property("proxy-context")).push("buffer", buffer)
        return FlowReturn.OK

    def on_event(self, event) -> None:
        if event.type == EventType.EOS:
            _proxy_channel(self.get_property("proxy-context")).push("eos", None)


@register
class TsProxySrc(BaseSrc):
    ELEMENT_NAME = "ts-proxysrc"
    ELEMENT_CLASS = "Source/Generic"
    ELEMENT_DESCRIPTION = "In-process bridge source (pairs with ts-proxysink)"
    PROPERTIES = [
        Prop("proxy-context", "", type="str", mutable="ready"),
        Prop("context", "", type="str",
             doc="Context name to share threads with (source groups are "
                 "driven per-context by Pipeline.run)"),
        Prop("context-wait", 5, type="uint", maximum=1000,
             doc="Throttle the context loop to at most once per this many ms"),
        Prop("max-size-buffers", 200, type="uint",
             doc="Maximum number of buffers to queue (0=unlimited)"),
        Prop("max-size-bytes", 1_048_576, type="uint",
             doc="Maximum number of bytes to queue (0=unlimited)"),
        Prop("max-size-time", 1_000_000_000, type="uint64",
             doc="Maximum number of nanoseconds to queue (0=unlimited)"),
        Prop("leaky", "no", type="enum",
             choices=["no", "upstream", "downstream"],
             doc="accepted for parity; the proxy channel always drops "
                 "oldest on overflow (the producer must never stall)"),
        Prop("current-level-buffers", 0, type="uint",
             doc="(read) buffers queued in the proxy channel"),
        Prop("current-level-bytes", 0, type="uint",
             doc="(read) bytes queued in the proxy channel"),
        Prop("current-level-time", 0, type="uint64",
             doc="(read) nanoseconds queued in the proxy channel"),
    ]

    def start(self) -> None:
        ch = _proxy_channel(self.get_property("proxy-context"))
        ch.max_buffers = int(self.get_property("max-size-buffers"))
        ch.max_bytes = int(self.get_property("max-size-bytes"))
        ch.max_time = int(self.get_property("max-size-time"))

    def get_property(self, name: str):
        if name.startswith("current-level-"):
            ch = _proxy_channel(super().get_property("proxy-context"))
            return {"current-level-buffers": ch.n_buffers,
                    "current-level-bytes": ch.level_bytes,
                    "current-level-time": ch.level_time}[name]
        return super().get_property(name)

    def negotiate(self) -> Caps:
        caps = _PROXY_CAPS.get(self.get_property("proxy-context"))
        return caps if caps is not None else super().negotiate()

    def create(self):
        item = _proxy_channel(self.get_property("proxy-context")).pop()
        if item is None:
            return BaseSrc.RETRY
        kind, payload = item
        return None if kind == "eos" else payload


__all__ = [
    "TextAhead", "StreamGrouper", "S302MParse", "Ac4Parse",
    "UriPlaylistBin", "ViuerSink", "TsProxySink", "TsProxySrc",
]
