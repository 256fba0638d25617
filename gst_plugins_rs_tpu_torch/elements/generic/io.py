"""File and in-process bridge elements: rsfilesrc, rsfilesink, intersink,
intersrc, and zlib (de)compression.

Parity targets: generic/file (rsfilesrc/rsfilesink, 935 LoC),
generic/inter (intersink/intersrc in-process bridge,
generic/inter/src/sink/mod.rs:9), generic/compress (zlib/deflate and
brotli enc/dec).

Payloads: rsfilesink and the compressors are byte elements.  They read a
payload that lies on the device back to the host once (`host_bytes`) and
emit host numpy uint8 buffers.  intersink/intersrc pass the buffer object
on, so a payload on the device stays there.
"""
from __future__ import annotations

import zlib
from collections import deque
from typing import Dict, Optional

import numpy as np

from ...core import (
    BaseSink,
    BaseSrc,
    BaseTransform,
    Buffer,
    Caps,
    FlowReturn,
    Prop,
    TransformMode,
    register,
)
from ...core.payload import host_bytes


@register
class FileSrc(BaseSrc):
    ELEMENT_NAME = "rsfilesrc"
    ELEMENT_CLASS = "Source/File"
    ELEMENT_DESCRIPTION = "Reads a file as raw byte buffers"
    SEEK_FORMAT = "bytes"
    PROPERTIES = [
        Prop("location", None, type="str", mutable="ready"),
        Prop("blocksize", 65536, type="uint", minimum=1, mutable="ready"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._f = None
        self._offset = 0

    def start(self) -> None:
        loc = self.get_property("location")
        if loc is None:
            raise RuntimeError(f"{self.name}: no location set")
        self._f = open(loc, "rb")
        self._offset = int(self.segment.start)  # pre-roll seeks start here
        if self._offset:
            self._f.seek(self._offset)

    def stop(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate() if not caps.is_any() else Caps.builder("application/octet-stream")

    def is_seekable(self) -> bool:
        return True

    def do_seek(self, segment) -> bool:
        """Byte-domain repositioning (filesrc is FORMAT_BYTES seekable;
        send Event.new_seek(..., fmt='bytes')).  A seek before the file
        is open is remembered and applied at start()."""
        if self._f is not None:
            self._f.seek(int(segment.start))
        self._offset = int(segment.start)
        return True

    def position_ns(self):
        return self._offset  # byte domain

    def duration_ns(self):
        # byte domain: "duration" is the file size
        import os

        loc = self.get_property("location")
        try:
            return os.path.getsize(loc) if loc else None
        except OSError:
            return None

    def create(self) -> Optional[Buffer]:
        want = self.get_property("blocksize")
        stop = self.segment.stop
        if stop is not None:
            want = min(want, int(stop) - self._offset)
            if want <= 0:
                return None
        data = self._f.read(want)
        if not data:
            return None
        buf = Buffer(np.frombuffer(data, np.uint8), offset=self._offset)
        self._offset += len(data)
        return buf


@register
class FileSink(BaseSink):
    ELEMENT_NAME = "rsfilesink"
    ELEMENT_CLASS = "Sink/File"
    ELEMENT_DESCRIPTION = "Writes incoming buffer payloads to a file"
    PROPERTIES = [Prop("location", None, type="str", mutable="ready")]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._f = None

    def on_null_to_ready(self) -> None:
        loc = self.get_property("location")
        if loc is None:
            raise RuntimeError(f"{self.name}: no location set")
        self._f = open(loc, "wb")

    def on_ready_to_null(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def render(self, buffer: Buffer) -> FlowReturn:
        self._f.write(host_bytes(buffer.data))
        return FlowReturn.OK


# ---------------------------------------------------------------------------
# inter: in-process bridge between pipelines (generic/inter)
# ---------------------------------------------------------------------------
class InterSubscription:
    """One consumer's view of an InterChannel: its own queue, levels and
    eviction limits (the StreamProducer consumer slot,
    generic/inter/src/sink/mod.rs:9).  When limits are exceeded the OLDEST
    buffer is dropped — a slow consumer must never stall the producer."""

    def __init__(self):
        self.items: deque = deque()
        self.level_bytes = 0
        self.level_time = 0
        self.n_buffers = 0
        self.max_buffers = 0
        self.max_bytes = 0
        self.max_time = 0
        self.dropped = 0

    def _account(self, item, sign: int) -> None:
        kind, payload = item
        if kind == "buffer":
            self.n_buffers += sign
            data = getattr(payload, "data", None)
            self.level_bytes += sign * int(getattr(data, "nbytes", 0) or 0)
            self.level_time += sign * (int(payload.duration or 0)
                                       if getattr(payload, "duration", None) else 0)

    def _full(self) -> bool:
        return ((self.max_buffers and self.n_buffers >= self.max_buffers)
                or (self.max_bytes and self.level_bytes >= self.max_bytes)
                or (self.max_time and self.level_time >= self.max_time))

    def push(self, kind, payload) -> None:
        if kind == "buffer":
            while self._full():
                evicted = False
                for i, item in enumerate(self.items):
                    if item[0] == "buffer":
                        del self.items[i]
                        self._account(item, -1)
                        self.dropped += 1
                        evicted = True
                        break
                if not evicted:
                    break
        item = (kind, payload)
        self.items.append(item)
        self._account(item, +1)

    def pop(self):
        if not self.items:
            return None
        item = self.items.popleft()
        self._account(item, -1)
        return item


class InterChannel:
    """Named producer→consumers broadcast channel (the StreamProducer
    analog).  Every subscription receives every buffer/event from its
    subscribe time on — N intersrc consumers fan out from one intersink
    (threadshare/tests/inter.rs one_to_many_up_first).  The first
    subscriber adopts the channel's default subscription, which also
    buffers anything produced before any consumer existed (the
    down-first/up-first startup orders both work)."""

    def __init__(self):
        self.caps: Optional[Caps] = None
        self._default = InterSubscription()
        self.subs = [self._default]
        self._default_claimed = False

    def push(self, kind, payload) -> None:
        for sub in list(self.subs):
            sub.push(kind, payload)

    def subscribe(self) -> InterSubscription:
        if not self._default_claimed:
            self._default_claimed = True
            return self._default
        sub = InterSubscription()
        self.subs.append(sub)
        return sub

    def unsubscribe(self, sub: InterSubscription) -> None:
        if sub is self._default:
            # the default slot becomes claimable again with a FRESH backlog;
            # without this the departed consumer's queue would keep
            # accumulating every future buffer as a ghost subscriber
            self._default_claimed = False
            self.subs.remove(self._default)
            self._default = InterSubscription()
            self.subs.append(self._default)
        elif sub in self.subs:
            self.subs.remove(sub)

    # -- legacy single-consumer surface (delegates to the default sub) -----
    def pop(self):
        return self._default.pop()

    def _prop(name):
        def get(self):
            return getattr(self._default, name)

        def set_(self, v):
            setattr(self._default, name, v)

        return property(get, set_)

    items = _prop("items")
    level_bytes = _prop("level_bytes")
    level_time = _prop("level_time")
    n_buffers = _prop("n_buffers")
    max_buffers = _prop("max_buffers")
    max_bytes = _prop("max_bytes")
    max_time = _prop("max_time")
    dropped = _prop("dropped")
    del _prop


_CHANNELS: Dict[str, InterChannel] = {}


def _channel(name: str) -> InterChannel:
    return _CHANNELS.setdefault(name, InterChannel())


# Downstream event types an intersink may forward (reference default: EOS
# only; gaps/flushes stay pipeline-local).
_FORWARDABLE = ("eos", "gap", "custom-downstream")


@register
class InterSink(BaseSink):
    ELEMENT_NAME = "intersink"
    ELEMENT_CLASS = "Sink/Generic"
    ELEMENT_DESCRIPTION = "Send buffers to an intersrc in the same process"
    PROPERTIES = [
        Prop("producer-name", "default", type="str", mutable="ready"),
        Prop("event-types", ["eos"], type="object",
             doc="downstream event type names forwarded to consumers "
                 f"(of {_FORWARDABLE}); reference default is EOS only"),
        Prop("sync", False, type="bool",
             doc="wait for each buffer's running time before forwarding "
                 "(reference defaults true; false here so non-live "
                 "pipelines free-run, matching this framework's sinks)"),
    ]

    def on_caps(self, caps: Caps) -> None:
        _channel(self.get_property("producer-name")).caps = caps

    def render(self, buffer: Buffer) -> FlowReturn:
        if self.get_property("sync") and buffer.pts is not None \
                and self.clock is not None:
            target = (self.base_time or 0) + buffer.pts
            if self.clock.now() < target:
                self.clock.new_single_shot_id(target).wait()
        _channel(self.get_property("producer-name")).push("buffer", buffer)
        return FlowReturn.OK

    def on_event(self, event) -> None:
        from ...core import EventType

        wanted = self.get_property("event-types") or []
        if isinstance(wanted, str):
            wanted = [w.strip() for w in wanted.split(",") if w.strip()]
        ch = _channel(self.get_property("producer-name"))
        if event.type == EventType.EOS and "eos" in wanted:
            ch.push("eos", None)
        elif event.type == EventType.GAP and "gap" in wanted:
            ch.push("event", event)
        elif event.type == EventType.CUSTOM_DOWNSTREAM \
                and "custom-downstream" in wanted:
            ch.push("event", event)


@register
class InterSrc(BaseSrc):
    ELEMENT_NAME = "intersrc"
    ELEMENT_CLASS = "Source/Generic"
    ELEMENT_DESCRIPTION = "Receive buffers from an intersink in the same process"
    PROPERTIES = [
        Prop("producer-name", "default", type="str", mutable="ready"),
        Prop("event-types", [], type="object",
             doc="upstream event type names forwarded to the producer "
                 "(accepted for parity; this runtime has no upstream "
                 "event path across the bridge yet)"),
        Prop("max-buffers", 0, type="uint64",
             doc="Maximum number of buffers to queue (0=unlimited)"),
        Prop("max-bytes", 0, type="uint64",
             doc="Maximum number of bytes to queue (0=unlimited)"),
        Prop("max-time", 500_000_000, type="uint64",
             doc="Maximum number of nanoseconds to queue (0=unlimited)"),
    ]

    _sub: Optional[InterSubscription] = None
    _sub_for: Optional[str] = None

    def _limits(self):
        return (int(self.get_property("max-buffers")),
                int(self.get_property("max-bytes")),
                int(self.get_property("max-time")))

    def _ensure_sub(self) -> InterSubscription:
        """Each intersrc holds its OWN channel subscription so several
        consumers fan out from one producer; switching producer-name (or
        the ts inter-context alias) re-subscribes to the new channel
        (threadshare/tests/inter.rs changing_inter_ctx)."""
        name = self.get_property("producer-name")
        if self._sub is None or self._sub_for != name:
            if self._sub is not None and self._sub_for is not None:
                _channel(self._sub_for).unsubscribe(self._sub)
            self._sub = _channel(name).subscribe()
            self._sub_for = name
            (self._sub.max_buffers, self._sub.max_bytes,
             self._sub.max_time) = self._limits()
        return self._sub

    def start(self) -> None:
        self._ensure_sub()

    def negotiate(self) -> Caps:
        caps = _channel(self.get_property("producer-name")).caps
        if caps is not None:
            return caps
        return super().negotiate()

    def create(self):
        item = self._ensure_sub().pop()
        if item is None:
            return BaseSrc.RETRY
        kind, payload = item
        if kind == "eos":
            return None
        if kind == "event":
            self.srcpad.push_event(payload)
            return BaseSrc.RETRY
        return payload


# ---------------------------------------------------------------------------
# compression (generic/compress; zlib + raw deflate)
# ---------------------------------------------------------------------------
_COMPRESS_FORMATS = ["zlib", "deflate"]


def _compressed_media_type(fmt: str) -> str:
    return f"application/x-{fmt}-compressed"


def _install_seek_refusal(element) -> None:
    """Compressed streams are not byte-seekable: refuse upstream SEEK
    events on the src pad (compress/tests test_*_seek_refused)."""
    from ...core import EventType

    def on_src_event(pad, event):
        if event.type == EventType.SEEK:
            return False
        return element.sinkpad.push_event(event)

    element.srcpad.event_function = on_src_event


def _wrap_compressed_caps(media_type, caps, filter_=None):
    """Sink -> src caps: wrap the input caps in an `original-caps` field on
    the compressed media type (reference compress_caps_helper.rs:13-66)."""
    from ...core.caps import Structure

    if caps.is_any() or not caps.structures:
        out = Caps.builder(media_type)
    else:
        out = Caps([Structure(media_type, **{"original-caps": Caps([s.copy()])})
                    for s in caps.structures])
    return out if filter_ is None else filter_.intersect(out)


def _unwrap_compressed_caps(caps, filter_=None):
    """Src -> sink caps: recover `original-caps`; ANY when absent."""
    inner = []
    for s in (caps.structures if not caps.is_any() else []):
        oc = s.get("original-caps")
        if oc is not None:
            inner.extend(st.copy() for st in oc.structures)
    if inner:
        out = Caps(inner)
    elif not caps.is_any() and caps.structures:
        # no original-caps recorded (e.g. legacy application/octet-stream
        # payloads): pass the caps through unchanged
        out = caps.copy()
    else:
        out = Caps.new_any()
    return out if filter_ is None else filter_.intersect(out)


@register
class CompressEnc(BaseTransform):
    ELEMENT_NAME = "compressenc"
    ELEMENT_CLASS = "Codec/Encoder"
    ELEMENT_DESCRIPTION = "Compresses buffer payloads (zlib/deflate)"
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("format", "zlib", type="enum", choices=_COMPRESS_FORMATS, mutable="ready"),
        Prop("level", 9, type="int", minimum=-1, maximum=9, mutable="ready"),
    ]

    def transform_caps(self, direction, caps, filter_=None):
        from ...core import PadDirection

        media = _compressed_media_type(self.get_property("format"))
        if direction == PadDirection.SINK:
            return _wrap_compressed_caps(media, caps, filter_)
        return _unwrap_compressed_caps(caps, filter_)

    def transform(self, inbuf: Buffer) -> Buffer:
        raw = host_bytes(inbuf.data)
        wbits = 15 if self.get_property("format") == "zlib" else -15
        c = zlib.compressobj(self.get_property("level"), zlib.DEFLATED, wbits)
        payload = c.compress(raw) + c.flush()
        out = Buffer(np.frombuffer(payload, np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class CompressDec(BaseTransform):
    ELEMENT_NAME = "compressdec"
    ELEMENT_CLASS = "Codec/Decoder"
    ELEMENT_DESCRIPTION = "Decompresses buffer payloads (zlib/deflate)"
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [Prop("format", "zlib", type="enum", choices=_COMPRESS_FORMATS, mutable="ready")]

    def __init__(self, name=None):
        super().__init__(name)
        self._obj = None
        self._partial = b""
        self._ready: deque = deque()
        _install_seek_refusal(self)

    def start(self) -> None:
        self._obj = None
        self._partial = b""
        self._ready.clear()

    def transform_caps(self, direction, caps, filter_=None):
        from ...core import PadDirection

        media = _compressed_media_type(self.get_property("format"))
        if direction == PadDirection.SINK:
            return _unwrap_compressed_caps(caps, filter_)
        return _wrap_compressed_caps(media, caps, filter_)

    # streaming reassembly: arbitrary-sized input chunks accumulate until a
    # whole compressed stream decodes; one output buffer per stream, several
    # streams per input chunk supported (the reference's GstAdapter +
    # flate2::Decompress boundary detection, compress/tests:260-315)
    def submit_input_buffer(self, buf: Buffer) -> None:
        from ...core import Message, MessageType, Structure

        wbits = 15 if self.get_property("format") == "zlib" else -15
        data = host_bytes(buf.data)
        while data:
            if self._obj is None:
                self._obj = zlib.decompressobj(wbits)
                self._partial = b""
            try:
                self._partial += self._obj.decompress(data)
            except zlib.error as e:
                # integrity failure (zlib adler32 / bad codes): drop the
                # stream, no output (compress/tests corruption_detected)
                self.post_message(Message(
                    MessageType.ERROR,
                    structure=Structure("error", element=self.name,
                                        reason=f"corrupt stream: {e}")))
                self._obj = None
                self._partial = b""
                return
            if not self._obj.eof:
                return  # stream incomplete: wait for more input
            out = Buffer(np.frombuffer(self._partial, np.uint8))
            out.copy_metadata_from(buf)
            self._ready.append(out)
            data = self._obj.unused_data
            self._obj = None
            self._partial = b""

    def generate_output(self):
        return self._ready.popleft() if self._ready else None


__all__ = ["FileSrc", "FileSink", "InterSink", "InterSrc", "CompressEnc", "CompressDec"]

def _format_alias(base, name, fmt, desc):
    """Per-format factory names as the reference registers them
    (generic/compress/src/lib.rs: zlibcompress, deflatecompress, ...)."""

    class _Alias(base):
        ELEMENT_NAME = name
        ELEMENT_DESCRIPTION = desc

        def __init__(self, iname=None, _fmt=fmt):
            super().__init__(iname)
            self.set_property("format", _fmt)

    _Alias.__name__ = name
    return register(_Alias)


ZlibCompress = _format_alias(CompressEnc, "zlibcompress", "zlib", "Compresses with zlib")
ZlibDecompress = _format_alias(CompressDec, "zlibdecompress", "zlib", "Decompresses zlib")
DeflateCompress = _format_alias(CompressEnc, "deflatecompress", "deflate", "Compresses with raw deflate")
DeflateDecompress = _format_alias(CompressDec, "deflatedecompress", "deflate", "Decompresses raw deflate")

__all__ += ["ZlibCompress", "ZlibDecompress", "DeflateCompress", "DeflateDecompress"]



@register
class BrotliCompress(BaseTransform):
    """Brotli encoder (codecs/brotli.py: libbrotlienc via ctypes, full
    RFC 7932; stored-block fallback without the C library)."""

    ELEMENT_NAME = "brotlicompress"
    ELEMENT_CLASS = "Codec/Encoder"
    ELEMENT_DESCRIPTION = "Compresses buffers into brotli streams"
    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = Caps.builder("application/x-brotli-compressed")

    def transform_caps(self, direction, caps, filter_=None):
        from ...core import PadDirection

        if direction == PadDirection.SINK:
            return _wrap_compressed_caps(
                "application/x-brotli-compressed", caps, filter_)
        return _unwrap_compressed_caps(caps, filter_)
    PROPERTIES = [
        Prop("level", 6, type="uint", maximum=11, mutable="playing",
             doc="Brotli compression level (0=fastest, 11=best ratio)"),
    ]

    def transform(self, inbuf: Buffer) -> Buffer:
        from ...codecs import brotli

        out = Buffer(np.frombuffer(
            brotli.compress(host_bytes(inbuf.data),
                            quality=self.get_property("level")), np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class BrotliDecompress(BaseTransform):
    """Brotli decoder (codecs/brotli.py: libbrotlidec via ctypes, full
    RFC 7932 incl. entropy coding and the static dictionary).  Streams
    split across input buffers reassemble; structural corruption fails
    the chain with a flow error (compress/tests
    brotli_structural_corruption_flow_error)."""

    SINK_CAPS = Caps.builder("application/x-brotli-compressed")
    ELEMENT_NAME = "brotlidecompress"
    ELEMENT_CLASS = "Codec/Decoder"
    ELEMENT_DESCRIPTION = "Decompresses brotli streams"
    MODE = TransformMode.NEVER_IN_PLACE

    def __init__(self, name=None):
        super().__init__(name)
        self._pending = b""
        self._ready: deque = deque()
        _install_seek_refusal(self)

    def start(self) -> None:
        self._pending = b""
        self._ready.clear()

    def transform_caps(self, direction, caps, filter_=None):
        from ...core import PadDirection

        if direction == PadDirection.SINK:
            return _unwrap_compressed_caps(caps, filter_)
        return _wrap_compressed_caps(
            "application/x-brotli-compressed", caps, filter_)

    def submit_input_buffer(self, buf: Buffer) -> None:
        from ...codecs import brotli
        from ...core.element import FlowError, FlowReturn

        self._pending += host_bytes(buf.data)
        while self._pending:
            try:
                payload, consumed = brotli.decompress_stream(self._pending)
            except brotli.TruncatedStream:
                return  # incomplete: wait for more input
            except ValueError as e:
                self._pending = b""
                raise FlowError(FlowReturn.ERROR,
                                f"{self.name}: corrupt brotli stream: {e}")
            out = Buffer(np.frombuffer(payload, np.uint8))
            out.copy_metadata_from(buf)
            self._ready.append(out)
            self._pending = self._pending[consumed:]

    def generate_output(self):
        return self._ready.popleft() if self._ready else None
