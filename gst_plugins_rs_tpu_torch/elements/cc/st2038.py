"""SMPTE ST-2038 ancillary data elements: st2038ancdemux, st2038ancmux,
st2038anctocc, cctost2038anc, st2038combiner, st2038extractor.

Parity family: video/closedcaption st2038* (mod.rs registrations; ANC
packet layout in ops/st2038.py per st2038anc_utils.rs).  ST-334 DID 0x61
carries captions: SDID 0x01 = CEA-708 CDP, SDID 0x02 = CEA-608 line-21
pairs (st2038anctocc/imp.rs:91).

Buffers on meta/x-st-2038 caps hold one or more packed ANC packets;
combiner/extractor move them between streams and a St2038AncMeta attached
to video buffers (the reference uses GstAncillaryMeta).
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Meta,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    TransformMode,
    register,
)
from ...core.events import Segment
from ...core.payload import host_array, host_bytes
from ...ops import st2038

ST2038_CAPS = Caps.builder("meta/x-st-2038")
CEA608_CAPS = Caps.builder("closedcaption/x-cea-608", format="raw")
CEA708_CDP_CAPS = Caps.builder("closedcaption/x-cea-708", format="cdp")


class St2038AncMeta(Meta):
    """ANC packets attached to a video buffer (GstAncillaryMeta analog)."""

    api = "st2038-anc"

    def __init__(self, packets: Optional[List[st2038.AncPacket]] = None):
        self.packets: List[st2038.AncPacket] = list(packets or [])


def _payload(buf: Buffer) -> bytes:
    return host_bytes(buf.data, np.uint8)


@register
class St2038AncDemux(Element):
    """Splits an ST-2038 stream into per-(DID,SDID,line) sometimes pads
    plus a passthrough 'src' pad (reference st2038ancdemux)."""

    ELEMENT_NAME = "st2038ancdemux"
    EXTRA_PAD_TEMPLATES = [
        ('anc_%02x_%02x_at_%u_%u', 'src', 'sometimes', 'meta/x-st-2038'),
    ]
    ELEMENT_CLASS = "Metadata/Demuxer"
    ELEMENT_DESCRIPTION = "Splits ST-2038 ancillary streams per DID/SDID"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, ST2038_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, ST2038_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._typed: Dict[str, Pad] = {}

    def _typed_pad(self, pkt: st2038.AncPacket) -> Pad:
        name = f"anc_{pkt.did:02x}_{pkt.sdid:02x}_at_{pkt.line_number}_{pkt.horizontal_offset}"
        if name not in self._typed:
            pad = Pad(name, PadDirection.SRC,
                      PadTemplate("anc_%02x_%02x_at_%u_%u", PadDirection.SRC,
                                  PadPresence.SOMETIMES, ST2038_CAPS))
            self.add_pad(pad)
            self._typed[name] = pad
        return self._typed[name]

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        ret = FlowReturn.OK
        if self.srcpad.peer is not None:
            ret = self.srcpad.push(buf)
        for pkt in st2038.unpack_all(_payload(buf)):
            tp = self._typed_pad(pkt)
            if tp.peer is not None:
                out = Buffer(np.frombuffer(
                    st2038.pack(pkt.did, pkt.sdid, pkt.data, c_not_y=pkt.c_not_y,
                                line_number=pkt.line_number,
                                horizontal_offset=pkt.horizontal_offset), np.uint8))
                out.pts = buf.pts
                out.duration = buf.duration
                tp.push(out)
        return ret

    def _event(self, pad: Pad, event: Event) -> bool:
        ok = True
        for p in self.src_pads():
            if p.peer is not None:
                ok = p.push_event(event) and ok
        return ok

    def typed_pad_for(self, did: int, sdid: int, line: int = 9, hoff: int = 0) -> Pad:
        """Pre-create a typed pad so it can be linked before data flows."""
        return self._typed_pad(st2038.AncPacket(False, line, hoff, did, sdid, b""))


@register
class St2038AncMux(Element):
    """Merges ANC streams from request pads into one, ordered by pts
    (reference st2038ancmux)."""

    ELEMENT_NAME = "st2038ancmux"
    ELEMENT_CLASS = "Metadata/Muxer"
    ELEMENT_DESCRIPTION = "Merges ST-2038 ancillary streams"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, ST2038_CAPS))
        )
        self._count = 0
        self._started = False
        self._eos = 0

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        idx = self._count
        self._count += 1
        pad = Pad(name or f"sink_{idx}", PadDirection.SINK,
                  PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST, ST2038_CAPS))
        pad.chain_function = self._chain
        pad.event_function = self._event
        return self.add_pad(pad)

    def request_pad(self, template_name: str = "sink_%u") -> Pad:
        return self.request_sink_pad()

    def _ensure_started(self) -> None:
        if not self._started:
            self._started = True
            self.srcpad.push_event(Event.new_stream_start(f"{self.name}-src"))
            self.srcpad.push_event(Event.new_caps(ST2038_CAPS))
            self.srcpad.push_event(Event.new_segment(Segment()))

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._ensure_started()
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._eos += 1
            if self._eos == len(self.sink_pads()):
                return self.srcpad.push_event(event)
            return True
        return True


@register
class St2038AncToCc(Element):
    """Extracts closed captions from ANC packets onto per-kind sometimes
    pads: SDID 0x02 -> CEA-608 pairs on `src_cea608`, SDID 0x01 -> CDP
    bytes on `src_cea708` (st2038anctocc/imp.rs:91; both can flow
    simultaneously).  The pads appear when data of that kind first
    arrives; an element linked before that (gst `!` semantics) is
    attached to the first compatible pad as it appears."""

    ELEMENT_NAME = "st2038anctocc"
    ELEMENT_CLASS = "Metadata/Converter"
    ELEMENT_DESCRIPTION = "Extracts closed captions from ST-2038 ancillary data"
    EXTRA_PAD_TEMPLATES = [
        ("src_cea608", "src", "sometimes", "closedcaption/x-cea-608"),
        ("src_cea708", "src", "sometimes", "closedcaption/x-cea-708"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                            ST2038_CAPS)))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._pending_peers: List[Pad] = []
        self._sticky: List[Event] = []  # stream-start/segment replayed on new pads

    def link(self, downstream) -> None:
        sink = next((p for p in downstream.sink_pads() if p.peer is None), None)
        if sink is not None:
            self._pending_peers.append(sink)

    def _ensure_pad(self, kind: str) -> Pad:
        name = f"src_cea{kind}"
        if name in self.pads:
            return self.pads[name]
        caps = CEA608_CAPS if kind == "608" else CEA708_CDP_CAPS
        pad = Pad(name, PadDirection.SRC,
                  PadTemplate(name, PadDirection.SRC, PadPresence.SOMETIMES,
                              caps))
        self.add_pad(pad)
        for peer in self._pending_peers:
            if peer.peer is None and caps.can_intersect(peer.pad_template_caps()):
                pad.link(peer)
                break
        pad.push_event(Event.new_stream_start(f"{self.name}-{name}"))
        pad.push_event(Event.new_caps(caps))
        for ev in self._sticky:
            pad.push_event(ev)
        pad.current_caps = caps
        return pad

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.SEGMENT:
            self._sticky = [event]
        ok = True
        for p in self.src_pads():
            ok = p.push_event(event) and ok
        return ok

    def _chain(self, pad: Pad, inbuf: Buffer) -> FlowReturn:
        pairs = []
        cdp = b""
        for pkt in st2038.unpack_all(_payload(inbuf)):
            if pkt.did != 0x61:
                continue
            if pkt.sdid == 0x02 and len(pkt.data) >= 3:
                # ST-334-1 EIA-608: field/line byte + cc pair
                pairs.append((pkt.data[1], pkt.data[2]))
            elif pkt.sdid == 0x01:
                cdp += pkt.data
        ret = FlowReturn.OK
        if pairs:
            out = Buffer(np.asarray(pairs, np.uint8).reshape(-1, 2),
                         pts=inbuf.pts, duration=inbuf.duration)
            ret = self._ensure_pad("608").push(out)
        if cdp:
            out = Buffer(np.frombuffer(cdp, np.uint8),
                         pts=inbuf.pts, duration=inbuf.duration)
            r708 = self._ensure_pad("708").push(out)
            if ret in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                ret = r708
        return FlowReturn.OK if ret == FlowReturn.NOT_LINKED else ret


@register
class CcToSt2038Anc(BaseTransform):
    """Wraps CEA-608 pairs (or CDP bytes) into ST-2038 ANC packets
    (reference cctost2038anc)."""

    ELEMENT_NAME = "cctost2038anc"
    ELEMENT_CLASS = "Metadata/Converter"
    ELEMENT_DESCRIPTION = "Wraps closed captions into ST-2038 ancillary data"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = Caps([CEA608_CAPS.structure(0).copy(), CEA708_CDP_CAPS.structure(0).copy()])
    SRC_CAPS = ST2038_CAPS
    PROPERTIES = [
        Prop("line-number", 9, type="uint", maximum=2047),
        Prop("horizontal-offset", 0, type="uint", maximum=4095),
        Prop("c-not-y", False, type="bool"),
        Prop("c-not-y-channel", False, type="bool", mutable="playing",
             doc="reference name for c-not-y (kept in sync)"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "c-not-y-channel":
            self._props["c-not-y"] = value
        elif name == "c-not-y":
            self._props["c-not-y-channel"] = value

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (ST2038_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Buffer:
        kw = dict(
            c_not_y=self.get_property("c-not-y"),
            line_number=self.get_property("line-number"),
            horizontal_offset=self.get_property("horizontal-offset"),
        )
        if self.in_caps.structure(0).name == "closedcaption/x-cea-608":
            pairs = host_array(inbuf.data, np.uint8).reshape(-1, 2)
            data = b"".join(
                st2038.pack(0x61, 0x02, bytes([0x80, hi, lo]), **kw)
                for hi, lo in pairs
            )
        else:
            data = st2038.pack(0x61, 0x01, _payload(inbuf), **kw)
        out = Buffer(np.frombuffer(data, np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class St2038Combiner(Element):
    """Attaches ANC buffers to time-matching video buffers as
    St2038AncMeta (reference st2038combiner)."""

    ELEMENT_NAME = "st2038combiner"
    ELEMENT_CLASS = "Metadata/Combiner"
    ELEMENT_DESCRIPTION = "Combines ST-2038 ancillary data with video"
    PROPERTIES = [
        Prop("drop-late-st2038", False, type="bool", mutable="playing",
             doc="drop ANC buffers whose running time precedes the current "
                 "video frame instead of attaching them to it"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        # pad names per the reference (st2038anc/combiner: video on `sink`,
        # ANC stream on `st2038`)
        self.video_pad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.anc_pad = self.add_pad(
            Pad("st2038", PadDirection.SINK,
                PadTemplate("st2038", PadDirection.SINK, PadPresence.ALWAYS, ST2038_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.video_pad.chain_function = self._video_chain
        self.video_pad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
        self.anc_pad.chain_function = self._anc_chain
        self.anc_pad.event_function = lambda pad, ev: True
        self._pending: deque = deque()

    def _anc_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._pending.append(buf)
        return FlowReturn.OK

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        packets: List[st2038.AncPacket] = []
        start = buf.pts or 0
        end = start + (buf.duration or 0)
        drop_late = self.get_property("drop-late-st2038")
        while self._pending and (self._pending[0].pts or 0) <= end:
            anc = self._pending.popleft()
            if drop_late and (anc.pts or 0) < start:
                continue  # late ANC: dropped, not attached to this frame
            packets.extend(st2038.unpack_all(_payload(anc)))
        if packets:
            buf.add_meta(St2038AncMeta(packets))
        return self.srcpad.push(buf)


@register
class St2038Extractor(Element):
    """Passes video through while re-emitting attached St2038AncMeta on a
    sometimes `st2038` src pad (reference st2038extractor pad layout:
    sink/src video passthrough + optional st2038 src)."""

    ELEMENT_NAME = "st2038extractor"
    EXTRA_PAD_TEMPLATES = [
        ('st2038', 'src', 'sometimes', 'meta/x-st-2038'),
    ]
    ELEMENT_CLASS = "Metadata"
    ELEMENT_DESCRIPTION = "Extracts ST-2038 ancillary data from video buffers"
    PROPERTIES = [
        Prop("always-add-st2038-pad", False, type="bool", mutable="playing",
             doc="add the st2038 pad at start even before any ancillary "
                 "data was seen"),
        Prop("remove-ancillary-meta", False, type="bool", mutable="playing",
             doc="strip St2038AncMeta from outgoing video buffers"),
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
        self.sinkpad.event_function = self._event
        self._anc_pad: Optional[Pad] = None
        self._anc_started = False

    def on_ready_to_paused(self) -> None:
        if self.get_property("always-add-st2038-pad"):
            self._ensure_anc_pad()

    def _ensure_anc_pad(self) -> Pad:
        if self._anc_pad is None:
            self._anc_pad = self.add_pad(
                Pad("st2038", PadDirection.SRC,
                    PadTemplate("st2038", PadDirection.SRC,
                                PadPresence.SOMETIMES, ST2038_CAPS))
            )
            self.notify_pad_added(self._anc_pad)
        return self._anc_pad

    def notify_pad_added(self, pad: Pad) -> None:
        cb = getattr(self, "on_pad_added", None)
        if cb:
            cb(pad)

    def _anc_push(self, pad: Pad, buf: Buffer) -> None:
        if not self._anc_started:
            self._anc_started = True
            pad.push_event(Event.new_stream_start(f"{self.name}-st2038"))
            pad.push_event(Event.new_caps(ST2038_CAPS))
            pad.push_event(Event.new_segment(Segment()))
        pad.push(buf)

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        meta = buf.get_meta(St2038AncMeta)
        if meta is not None and meta.packets:
            data = b"".join(
                st2038.pack(p.did, p.sdid, p.data, c_not_y=p.c_not_y,
                            line_number=p.line_number,
                            horizontal_offset=p.horizontal_offset)
                for p in meta.packets
            )
            anc = Buffer(np.frombuffer(data, np.uint8),
                         pts=buf.pts, duration=buf.duration)
            self._anc_push(self._ensure_anc_pad(), anc)
            if self.get_property("remove-ancillary-meta"):
                buf.metas.remove(meta)
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS and self._anc_pad is not None \
                and self._anc_started:
            self._anc_pad.push_event(Event.new_eos())
        return self.srcpad.push_event(event)


__all__ = [
    "St2038AncMeta", "St2038AncDemux", "St2038AncMux", "St2038AncToCc",
    "CcToSt2038Anc", "St2038Combiner", "St2038Extractor",
]
