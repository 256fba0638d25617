"""decodebin: typefind a byte stream and auto-plug parsers/decoders.

The capability the reference delegates to the C core's decodebin3 /
uridecodebin3 (which fallbacksrc and uriplaylistbin wrap, SURVEY.md §2.2):
identify the stream by magic bytes (core/typefind.py), instantiate the
matching demuxer/decoder chain from the element registry, keep plugging
until no further decoder applies, and expose the terminal stream(s),
auto-linking to whatever decodebin itself was linked to.

Plugging table (caps name -> factory): FLAC -> claxondec, FLV ->
rsflvdemux (then alaw/mulaw decoders for its audio streams), images ->
imagersdec/gifdec/rswebpdec, SCC/MCC -> caption parsers, mp3 ADUs pass
through.  Unknown or terminal caps are exposed as-is.

The table names factories that this package may not register (yet).  When
the stream needs one of those, decodebin posts an ERROR message on the bus
that names the missing factory, exposes nothing and answers every buffer
with FlowReturn.ERROR.  A payload on the device is read back to the host
once for typefinding; the stream continues as host bytes.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ...core import (
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
)
from ...core.caps import Structure
from ...core.events import Message, MessageType, Segment
from ...core.payload import host_bytes
from ...core.registry import element_factory_make, factory_exists, register
from ...core.typefind import typefind

# caps name -> decoder/parser factory to plug next
_PLUG = {
    "audio/x-flac": "claxondec",
    "video/x-flv": "rsflvdemux",
    "image/png": "imagersdec",
    "image/jpeg": "imagersdec",
    "image/gif": "gifdec",
    "image/webp": "rswebpdec",
    "application/x-scc": "sccparse",
    "application/x-mcc": "mccparse",
    "audio/x-alaw": "alawdec",
    "audio/x-mulaw": "mulawdec",
}


@register
class DecodeBin(Element):
    ELEMENT_NAME = "decodebin"
    ELEMENT_CLASS = "Generic/Bin/Decoder"
    ELEMENT_DESCRIPTION = "Typefinds and auto-plugs decoders"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._head: List[bytes] = []
        self._chain_entry: Optional[Pad] = None  # first plugged element's sink
        self._children: List[Element] = []
        self._pending_peer: Optional[Pad] = None
        self._src_count = 0
        self._failed = False

    def on_paused_to_ready(self) -> None:
        from ...core.element import State

        for c in self._children:
            c.set_state(State.NULL)
        self._children = []
        self._chain_entry = None
        self._head = []
        self._src_count = 0
        self._failed = False

    def link(self, downstream) -> None:
        sink = next((p for p in downstream.sink_pads() if p.peer is None), None)
        if sink is None and hasattr(downstream, "request_sink_pad"):
            sink = downstream.request_sink_pad()
        self._pending_peer = sink

    # -- plugging ----------------------------------------------------------------
    def _expose(self, src: Pad, caps: Optional[Caps]) -> None:
        """Terminal stream: ghost it out via a forwarding pad."""
        name = f"src_{self._src_count}"
        self._src_count += 1
        ghost = Pad(name, PadDirection.SRC,
                    PadTemplate("src_%u", PadDirection.SRC, PadPresence.SOMETIMES,
                                Caps.new_any()))
        self.add_pad(ghost)
        inner = Pad(f"{name}_inner", PadDirection.SINK,
                    PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        inner.element = self
        inner.chain_function = lambda pad, buf: ghost.push(buf)
        inner.event_function = lambda pad, ev: ghost.push_event(ev)
        src.peer = inner
        inner.peer = src
        if self._pending_peer is not None and self._pending_peer.peer is None:
            ghost.link(self._pending_peer)

    def _plug(self, caps_name: str, upstream_src: Pad, caps: Optional[Caps]) -> bool:
        """Attach the next element for caps_name to upstream_src, or expose.
        False when the factory the stream needs is not registered: the
        bus gets an ERROR naming it and nothing is exposed."""
        factory = _PLUG.get(caps_name)
        if factory is None:
            self._expose(upstream_src, caps)
            return True
        if not factory_exists(factory):
            self._failed = True
            self.post_message(Message(
                MessageType.ERROR,
                structure=Structure(
                    "error", element=self.name, factory=factory, caps=caps_name,
                    reason=f"missing decoder factory {factory!r} for {caps_name}")))
            return False
        from ...core.element import State

        child = element_factory_make(factory, f"{self.name}-{factory}{len(self._children)}")
        child.parent = self.parent
        self._children.append(child)
        # watch the child's src pads: when data arrives with new caps,
        # continue plugging
        self._watch_children_of(child)
        sink = next((p for p in child.sink_pads() if p.peer is None), None)
        upstream_src.link(sink)
        child.set_state(State.PLAYING if self.state >= 3 else State.PAUSED)
        return True

    def _watch_children_of(self, child: Element) -> None:
        """Defer the child's output: when its src pad pushes caps, decide
        whether to plug further or expose."""
        original_add = child.add_pad

        def hook_src(pad: Pad) -> None:
            if pad.direction != PadDirection.SRC or pad.peer is not None:
                return
            probe = Pad(f"{pad.name}_probe", PadDirection.SINK,
                        PadTemplate("probe", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
            probe.element = self
            state = {"routed": False}

            def on_event(p, ev):
                if ev.type == EventType.CAPS and not state["routed"]:
                    state["routed"] = True
                    caps = ev.get("caps")
                    pad.peer = None
                    probe.peer = None
                    if not self._plug(caps.structure(0).name, pad, caps):
                        return False
                    return pad.push_event(ev)
                if state["routed"]:
                    return pad.push_event(ev)
                return True

            def on_chain(p, buf):
                if not state["routed"]:
                    # caps never arrived: expose raw
                    state["routed"] = True
                    pad.peer = None
                    probe.peer = None
                    self._expose(pad, None)
                return pad.push(buf)

            probe.event_function = on_event
            probe.chain_function = on_chain
            pad.peer = probe
            probe.peer = pad

        for pad in child.src_pads():
            hook_src(pad)

        def add_pad_hooked(pad: Pad):
            out = original_add(pad)
            hook_src(out)
            return out

        child.add_pad = add_pad_hooked  # dynamic (sometimes) pads

    # -- input -------------------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._failed:
            return FlowReturn.ERROR
        if self._chain_entry is None:
            d = buf.data
            head = d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
            self._head.append(head)
            data = b"".join(self._head)
            caps_str = typefind(data)
            if caps_str is None and len(data) < 4096:
                return FlowReturn.OK  # need more bytes
            from ...core.parse import parse_caps

            caps = parse_caps(caps_str) if caps_str else Caps.builder("application/octet-stream")
            entry = Pad("typefind_src", PadDirection.SRC,
                        PadTemplate("t", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
            entry.element = self
            if not self._plug(caps.structure(0).name, entry, caps):
                self._head = []
                return FlowReturn.ERROR
            self._chain_entry = entry.peer
            self._chain_entry_pad = entry
            self._chain_entry.send_event(Event.new_stream_start(f"{self.name}-typefind"))
            self._chain_entry.send_event(Event.new_caps(caps))
            self._chain_entry.send_event(Event.new_segment(Segment()))
            buf = Buffer(np.frombuffer(data, np.uint8), pts=buf.pts)
            self._head = []
        return self._chain_entry.chain(buf)

    def _event(self, pad: Pad, event: Event) -> bool:
        if self._failed:
            return event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT)
        if event.type == EventType.EOS and self._chain_entry is None and self._head:
            # short stream: force typefind on what we have
            data = b"".join(self._head)
            self._head = []
            from ...core.parse import parse_caps

            caps_str = typefind(data) or "application/octet-stream"
            caps = parse_caps(caps_str)
            entry = Pad("typefind_src", PadDirection.SRC,
                        PadTemplate("t", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
            entry.element = self
            if not self._plug(caps.structure(0).name, entry, caps):
                return False
            self._chain_entry = entry.peer
            self._chain_entry.send_event(Event.new_stream_start(f"{self.name}-typefind"))
            self._chain_entry.send_event(Event.new_caps(caps))
            self._chain_entry.send_event(Event.new_segment(Segment()))
            self._chain_entry.chain(Buffer(np.frombuffer(data, np.uint8)))
        if event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT):
            return True
        if self._chain_entry is not None:
            return self._chain_entry.send_event(event)
        return True


__all__ = ["DecodeBin"]
