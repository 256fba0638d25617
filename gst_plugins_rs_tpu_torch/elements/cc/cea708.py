"""CEA-708 elements: tttocea708, cea608tocea708, cea708mux, cea708overlay,
cdpserviceinject.

Parity targets: video/closedcaption (tttocea708/, cea608tocea708/,
cea708mux/, cea708overlay/, cdpserviceinject/ registrations in lib.rs).
Caps: closedcaption/x-cea-708 with format=cc_data (packed triplets) or
format=cdp (SMPTE 334-2 framing); codec in ops/cea708.py.

cea608tocea708 embeds the original 608 pairs as cc_type-0 compatibility
triplets AND translates the decoded captions into service-1 DTVCC text
(the reference writes both, cea608tocea708/imp.rs).  cea708overlay reuses
the cea608overlay glyph-atlas compositor for the device blend.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core import (
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
    video_caps_template,
)
from ..._device import device
from ...core.caps import Structure
from ...core.events import Segment
from ...core.payload import host_array, host_bytes
from ...core.video import RGB_FORMATS
from ...ops import cea608, cea708
from .elements import CEA608_CAPS, TEXT_CAPS

CCDATA_CAPS = Caps.builder("closedcaption/x-cea-708", format="cc_data")
CDP_CAPS = Caps.builder("closedcaption/x-cea-708", format="cdp")
CEA708_CAPS = Caps(
    [Structure("closedcaption/x-cea-708", format="cc_data"),
     Structure("closedcaption/x-cea-708", format="cdp")]
)


def _payload(buf: Buffer) -> bytes:
    return host_bytes(buf.data, np.uint8)


def _cc_data_of(buf: Buffer, caps: Caps) -> bytes:
    data = _payload(buf)
    if caps.structure(0).get("format") == "cdp":
        data, _seq = cea708.parse_cdp(data)
    return data


@register
class TtToCea708(BaseTransform):
    """text -> DTVCC service blocks as cc_data (reference tttocea708)."""

    ELEMENT_NAME = "tttocea708"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts timed text to CEA-708 captions"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = CCDATA_CAPS
    _NEVER = (1 << 64) - 1
    PROPERTIES = [
        Prop("service", 1, type="uint", minimum=1, maximum=63,
             doc="alias of service-number (kept in sync)"),
        Prop("service-number", 1, type="uint", minimum=1, maximum=63,
             doc="DTVCC service the packets are written to"),
        Prop("mode", "roll-up", type="enum", mutable="playing",
             choices=["pop-on", "roll-up", "paint-on"],
             doc="selects window geometry and the 608 compatibility "
                 "encoding; DTVCC text always travels as displayed windows"),
        Prop("origin-row", -1, type="int", minimum=-1, maximum=14,
             mutable="playing", doc="origin row (-1 = automatic bottom)"),
        Prop("origin-column", 0, type="uint", maximum=31, mutable="playing"),
        Prop("roll-up-rows", 2, type="uint", maximum=31, mutable="playing",
             doc="window row count in roll-up mode"),
        Prop("roll-up-timeout", _NEVER, type="uint64", mutable="playing",
             doc="ns without text after which windows are deleted"),
        Prop("cea608-channel", 0, type="uint", maximum=4,
             doc="also write CEA-608 compatibility bytes on this channel "
                 "(0 = disabled; 1 and 3 supported)"),
        Prop("speaker-prefix", None, type="str",
             doc="prefix added on the line after an "
                 "rstranscribe/speaker-change event"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._seq = 0
        self._prefix_next = False
        self._last_text_pts: Optional[int] = None

    def property_changed(self, name, value) -> None:
        if name == "service":
            self._props["service-number"] = value
        elif name == "service-number":
            self._props["service"] = value

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CCDATA_CAPS if direction == PadDirection.SINK else TEXT_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def sink_event(self, event) -> bool:
        if event.type == EventType.CUSTOM_DOWNSTREAM:
            if event.get("name") == "rstranscribe/speaker-change":
                self._prefix_next = True
                return False
            if event.get("name") == "rstranscribe/final-transcript":
                return False
        return True

    def _compat_608(self, lines: List[str]) -> List[bytes]:
        """CEA-608 compatibility triplets: channel 1 rides field 1
        (cc_type 0), channel 3 rides field 2 (cc_type 1)."""
        chan = self.get_property("cea608-channel")
        if chan not in (1, 3):
            return []
        cc_type = 0 if chan == 1 else 1
        if self.get_property("mode") == "pop-on":
            pairs = cea608.encode_pop_on(lines)
        else:
            pairs = []
            for line in lines:
                pairs.extend(cea608.encode_roll_up(
                    line, rows=max(2, min(4, self.get_property("roll-up-rows")))))
        return [cea708.cc_data_triplet(cc_type, hi, lo) for hi, lo in pairs]

    def transform(self, inbuf: Buffer) -> Buffer:
        text = str(inbuf.data)
        if self._prefix_next and self.get_property("speaker-prefix"):
            text = self.get_property("speaker-prefix") + text
        self._prefix_next = False
        lines = text.split("\n")
        trips: List[bytes] = self._compat_608(lines)
        timeout = self.get_property("roll-up-timeout")
        if (timeout != self._NEVER and inbuf.pts is not None
                and self._last_text_pts is not None
                and inbuf.pts - self._last_text_pts > timeout):
            blk = cea708.service_block(
                self.get_property("service-number"), bytes([cea708.DLW, 0xFF]))
            trips += cea708.pack_dtvcc_packet(blk, sequence=self._seq & 0x3)
            self._seq += 1
        self._last_text_pts = inbuf.pts
        # origin-row maps to the anchor vertical (75 steps over 15 rows),
        # origin-column to anchor horizontal (210 cells over 32 columns)
        row = self.get_property("origin-row")
        anchor_v = 122 if row < 0 else min(74, row * 5)
        anchor_h = min(209, self.get_property("origin-column") * 6)
        rows = self.get_property("roll-up-rows") \
            if self.get_property("mode") != "pop-on" else 0
        blocks = cea708.encode_pop_on_text(
            lines, service=self.get_property("service-number"),
            anchor_vertical=anchor_v, anchor_horizontal=anchor_h,
            row_count=rows,
        )
        for blk in blocks:
            trips += cea708.pack_dtvcc_packet(blk, sequence=self._seq & 0x3)
            self._seq += 1
        out = Buffer(np.frombuffer(b"".join(trips), np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class Cea608ToCea708(BaseTransform):
    """608 pairs -> cc_data with 608 compatibility triplets + service-1
    DTVCC translation of the decoded captions (reference cea608tocea708)."""

    ELEMENT_NAME = "cea608tocea708"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts CEA-608 captions to CEA-708"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CEA608_CAPS
    SRC_CAPS = CCDATA_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._dec = cea608.Cea608Decoder()
        self._seq = 0

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._dec = cea608.Cea608Decoder()
        self._seq = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CCDATA_CAPS if direction == PadDirection.SINK else CEA608_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Buffer:
        pairs = host_array(inbuf.data, np.uint8).reshape(-1, 2)
        trips: List[bytes] = []
        for hi, lo in pairs:
            trips.append(cea708.cc_data_triplet(0, int(hi), int(lo)))  # 608 compat
            self._dec.push_pair(int(hi), int(lo))
        for ev in self._dec.take_events():
            if ev is not None:
                for blk in cea708.encode_pop_on_text(ev.lines, service=1):
                    trips += cea708.pack_dtvcc_packet(blk, sequence=self._seq & 0x3)
                    self._seq += 1
        out = Buffer(np.frombuffer(b"".join(trips), np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class Cea708Mux(Element):
    """Merges per-service cc_data streams into one, re-sequencing DTVCC
    packets (reference cea708mux)."""

    ELEMENT_NAME = "cea708mux"
    ELEMENT_CLASS = "Muxer/ClosedCaption"
    ELEMENT_DESCRIPTION = "Muxes CEA-708 caption streams"
    PROPERTIES = [
        Prop("force-live", False, type="bool",
             doc="always operate in live mode and aggregate on timeout"),
        Prop("max-time", (1 << 64) - 1, type="uint64",
             doc="maximum time captions may be stored before output; this "
                 "mux forwards immediately (store time 0), so any bound "
                 "holds"),
    ]
    # GstCea708MuxSinkPad surface (reference rsclosedcaption other-types)
    PAD_PROPERTIES = {
        "sink": [
            Prop("discarded-services", None, type="object", mutable="playing",
                 doc="list of DTVCC service numbers dropped from this "
                     "pad's cc_data before muxing"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, CCDATA_CAPS))
        )
        self._count = 0
        self._started = False
        self._eos = 0

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        idx = self._count
        self._count += 1
        pad = Pad(name or f"sink_{idx}", PadDirection.SINK,
                  PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST, CEA708_CAPS))
        pad.chain_function = self._chain
        pad.event_function = self._event
        return self.add_pad(pad)

    def request_pad(self, template_name: str = "sink_%u") -> Pad:
        return self.request_sink_pad()

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if not self._started:
            self._started = True
            self.srcpad.push_event(Event.new_stream_start(f"{self.name}-src"))
            self.srcpad.push_event(Event.new_caps(CCDATA_CAPS))
            self.srcpad.push_event(Event.new_segment(Segment()))
        data = _cc_data_of(buf, pad.current_caps or CCDATA_CAPS)
        discard = pad._props.get("discarded-services")
        if discard:
            from ...ops.cea708 import filter_dtvcc_services

            data = filter_dtvcc_services(data, discard)
        out = Buffer(np.frombuffer(data, np.uint8), pts=buf.pts, duration=buf.duration)
        return self.srcpad.push(out)

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._eos += 1
            if self._eos == len(self.sink_pads()):
                return self.srcpad.push_event(event)
            return True
        return True


@register
class CdpServiceInject(BaseTransform):
    """Wraps/rewrites caption streams as CDP with a service information
    section (reference cdpserviceinject)."""

    ELEMENT_NAME = "cdpserviceinject"
    ELEMENT_CLASS = "Filter/ClosedCaption"
    ELEMENT_DESCRIPTION = "Injects service descriptors into CDP caption streams"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CEA708_CAPS
    SRC_CAPS = CDP_CAPS
    PROPERTIES = [
        Prop("service", 1, type="uint", minimum=1, maximum=6),
        Prop("language", "eng", type="str"),
        Prop("fps", 30, type="uint"),
        Prop("services", None, type="object", mutable="playing",
             doc="list of (service, language) entries to describe in the "
                 "CDP service-information section; overrides "
                 "service/language when set"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._seq = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CDP_CAPS if direction == PadDirection.SINK else CEA708_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _service_entries(self):
        services = self.get_property("services")
        if services:
            out = []
            for entry in services:
                if isinstance(entry, (tuple, list)):
                    svc, lang = entry[0], entry[1]
                elif hasattr(entry, "get"):
                    svc = entry.get("service") or entry.get("service-number") or 1
                    lang = entry.get("language") or "eng"
                else:
                    continue
                out.append((int(svc), str(lang)))
            if out:
                return out
        return [(self.get_property("service"), self.get_property("language"))]

    def _service_info(self) -> bytes:
        # svc_info section body: reserved|start|change|complete + count,
        # then per service: caption_service_number + 6 descriptor bytes
        # (language + digital flags)
        entries = self._service_entries()
        body = bytes([0xF0 | (len(entries) & 0x0F)])
        for svc, language in entries:
            lang = language.encode("ascii", "replace")[:3].ljust(3)
            body += bytes([svc & 0x1F]) + lang + \
                bytes([0xC0 | (svc & 0x3F), 0xFF, 0x7F])
        return body

    def transform(self, inbuf: Buffer) -> Buffer:
        cc = _cc_data_of(inbuf, self.in_caps)
        cdp = cea708.build_cdp(
            cc, sequence=self._seq & 0xFFFF, fps=self.get_property("fps"),
            service_info=self._service_info(),
        )
        self._seq += 1
        out = Buffer(np.frombuffer(cdp, np.uint8))
        out.copy_metadata_from(inbuf)
        return out


@register
class Cea708Overlay(Element):
    """Renders DTVCC service captions over video on device (reference
    cea708overlay); reuses the cea608overlay glyph compositor."""

    ELEMENT_NAME = "cea708overlay"
    ELEMENT_CLASS = "Video/Overlay/Subtitle"
    ELEMENT_DESCRIPTION = "Renders CEA-708 captions over video on device"
    PROPERTIES = [
        Prop("service", 1, type="uint", minimum=1, maximum=6),
        Prop("scale", 2, type="uint", minimum=1, maximum=8),
        Prop("cea608-channel", -1, type="int", minimum=-1, maximum=4,
             mutable="playing",
             doc="render this 608 channel from the compatibility bytes "
                 "when the selected service carries no DTVCC text "
                 "(-1 = automatic, 0 = disabled)"),
        Prop("safe-title-width", 0.8, type="float", minimum=0.0, maximum=1.0,
             mutable="playing",
             doc="ratio of the video width used as the caption safe area"),
        Prop("safe-title-height", 0.8, type="float", minimum=0.0, maximum=1.0,
             mutable="playing",
             doc="ratio of the video height used as the caption safe area"),
        Prop("timeout", (1 << 64) - 1, type="uint64",
             minimum=16_000_000_000, mutable="playing",
             doc="erase the overlay when no cc data arrived for this long"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        from .overlay import Cea608Overlay  # shares the atlas/composite

        vid_caps = video_caps_template(
            tuple(f for f in RGB_FORMATS if RGB_FORMATS[f][1] == np.uint8))
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, vid_caps))
        )
        self.ccpad = self.add_pad(
            Pad("cc_sink", PadDirection.SINK,
                PadTemplate("cc_sink", PadDirection.SINK, PadPresence.ALWAYS, CEA708_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, vid_caps))
        )
        self._renderer = Cea608Overlay(f"{self.name}-render")
        self.sinkpad.chain_function = self._video_chain
        self.sinkpad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
        self.ccpad.chain_function = self._cc_chain
        self.ccpad.event_function = lambda pad, ev: True
        self._decoders: Dict[int, cea708.ServiceDecoder] = {}
        self._dec608 = cea608.Cea608Decoder()
        self._lines: List[str] = []
        self._lines_608: List[str] = []
        self._last_cc_pts: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        self._renderer.set_property("scale", self.get_property("scale"))
        self._renderer.on_ready_to_paused()
        self._decoders = {}
        self._dec608 = cea608.Cea608Decoder()
        self._lines = []
        self._lines_608 = []
        self._last_cc_pts = None

    def _cc_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = _cc_data_of(buf, pad.current_caps or CCDATA_CAPS)
        triplets = cea708.parse_cc_data(data)
        cea708.decode_dtvcc(triplets, self._decoders)
        svc = self._decoders.get(self.get_property("service"))
        if svc is not None:
            for caption in svc.take_captions():
                self._lines = caption
        # 608 compatibility fallback channel
        chan = self.get_property("cea608-channel")
        if chan != 0:
            want_type = 1 if chan in (3, 4) else 0
            for valid, cc_type, hi, lo in triplets:
                if valid and cc_type == want_type:
                    self._dec608.push_pair(int(hi), int(lo))
            for ev in self._dec608.take_events():
                self._lines_608 = [] if ev is None else ev.lines
        if buf.pts is not None:
            self._last_cc_pts = buf.pts
        return FlowReturn.OK

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        timeout = self.get_property("timeout")
        if (timeout != (1 << 64) - 1 and buf.pts is not None
                and self._last_cc_pts is not None
                and buf.pts - self._last_cc_pts > timeout):
            self._lines = []
            self._lines_608 = []
        lines = self._lines or self._lines_608
        if not lines:
            return self.srcpad.push(buf)
        from .overlay import _composite

        frame = torch.as_tensor(buf.data, device=device())
        h, w = int(frame.shape[0]), int(frame.shape[1])
        # render into the safe-title area: mask built for the scaled
        # region, then padded back to the frame so captions sit inside it
        sw = max(0.1, float(self.get_property("safe-title-width")))
        sh = max(0.1, float(self.get_property("safe-title-height")))
        ih, iw = int(h * sh), int(w * sw)
        mask, box = self._renderer._render_mask(tuple(lines), ih, iw, frame.device)
        y0, x0 = (h - ih) // 2, (w - iw) // 2
        full_mask = torch.zeros((h, w), dtype=mask.dtype, device=frame.device)
        full_box = torch.zeros((h, w), dtype=box.dtype, device=frame.device)
        full_mask[y0:y0 + ih, x0:x0 + iw] = mask
        full_box[y0:y0 + ih, x0:x0 + iw] = box
        mask, box = full_mask, full_box
        out = Buffer(_composite(frame, mask, box))
        out.copy_metadata_from(buf)
        return self.srcpad.push(out)


__all__ = ["TtToCea708", "Cea608ToCea708", "Cea708Mux", "CdpServiceInject",
           "Cea708Overlay"]
