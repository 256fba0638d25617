"""ONVIF metadata streaming elements: onvifmetadatapay, onvifmetadatadepay,
onvifmetadataparse, onvifmetadatacombiner, onvifmetadataextractor,
onvifmetadataoverlay.

Parity target: net/onvif (6 elements, lib.rs:121-129).  Metadata travels as
application/x-onvif-metadata XML buffers; pay/depay wrap it in RTP
(encoding-name VND.ONVIF.METADATA per the ONVIF streaming spec), parse
splits a concatenated XML stream into per-frame buffers, combiner attaches
metadata to matching video buffers as OnvifXMLFrameMeta, extractor does
the reverse, and overlay draws the bounding boxes on the device (a mask
built there by slicing, then one f32 blend, like cea608overlay): a frame on
the card is never read back, only the box list is host data.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..._device import device
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
    QueryType,
    SECOND,
    TransformMode,
    register,
    video_caps_template,
)
from ...core.caps import Structure
from ...core.payload import host_bytes
from ...core.video import RGB_FORMATS
from ...net.rtp import RtpPacket
from ..analytics.onvif import ONVIF_NS, OnvifXMLFrameMeta, parse_metadata_xml
from .rtppay import RtpBaseDepay, RtpBasePay

META_CAPS = Caps.builder("application/x-onvif-metadata")


def _text_of(buf: Buffer) -> str:
    d = buf.data
    return d if isinstance(d, str) else host_bytes(d, np.uint8).decode("utf-8", "replace")


@register
class OnvifMetadataPay(RtpBasePay):
    ELEMENT_NAME = "onvifmetadatapay"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload ONVIF metadata XML into RTP packets"
    SINK_CAPS = META_CAPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="application",
            **{"encoding-name": "VND.ONVIF.METADATA", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        data = _text_of(buf).encode()
        maxp = self.max_payload_size()
        for pos in range(0, len(data), maxp):
            self.queue_packet(
                data[pos : pos + maxp], pts=buf.pts, duration=buf.duration,
                marker=pos + maxp >= len(data),
            )


@register
class OnvifMetadataDepay(RtpBaseDepay):
    ELEMENT_NAME = "onvifmetadatadepay"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload ONVIF metadata XML from RTP packets"
    SRC_CAPS = META_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc: List[bytes] = []
        self._acc_pts: Optional[int] = None

    def media_structure(self, s: Structure) -> Structure:
        return Structure("application/x-onvif-metadata")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if not self._acc:
            self._acc_pts = out.pts
        self._acc.append(pkt.payload)
        if not pkt.marker:
            return None
        xml = b"".join(self._acc).decode("utf-8", "replace")
        self._acc.clear()
        out.data = xml
        out.pts = self._acc_pts
        return out


@register
class OnvifMetadataParse(BaseTransform):
    """Splits concatenated MetadataStream documents into one buffer per
    Frame, with pts from UtcTime (reference onvifmetadataparse aligns
    UtcTime to running time)."""

    ELEMENT_NAME = "onvifmetadataparse"
    ELEMENT_CLASS = "Metadata/Parser"
    ELEMENT_DESCRIPTION = "Parses ONVIF metadata streams into timed frames"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = META_CAPS
    SRC_CAPS = Caps.builder("application/x-onvif-metadata", parsed=True)
    PROPERTIES = [
        Prop("latency", (1 << 64) - 1, type="uint64",
             doc="max reordering latency to report (u64 max = automatic: "
                 "6s for unparsed input, 0 for parsed)"),
        Prop("max-lateness", 200_000_000, type="uint64",
             doc="drop frames whose UtcTime pts lags the newest seen frame "
                 "by more than this"),
    ]

    def latency_additional_ns(self) -> int:
        lat = self.get_property("latency")
        return 6_000_000_000 if lat == (1 << 64) - 1 else lat

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else META_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._out: deque = deque()

    @staticmethod
    def _utc_to_ns(utc: str) -> int:
        t = utc.rstrip("Z").split("T")[1]
        h, m, s = t.split(":")
        return int((int(h) * 3600 + int(m) * 60 + float(s)) * SECOND)

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            root = ET.fromstring(_text_of(inbuf))
            for frame in root.iter(f"{{{ONVIF_NS}}}Frame"):
                stream = ET.Element(f"{{{ONVIF_NS}}}MetadataStream")
                va = ET.SubElement(stream, f"{{{ONVIF_NS}}}VideoAnalytics")
                va.append(frame)
                pts = self._utc_to_ns(frame.get("UtcTime", "1970-01-01T00:00:00Z"))
                # max-lateness: frames older than the newest seen by more
                # than the bound are dropped instead of reordered
                newest = getattr(self, "_newest_pts", None)
                if newest is not None and \
                        newest - pts > self.get_property("max-lateness"):
                    continue
                self._newest_pts = pts if newest is None else max(newest, pts)
                self._out.append(Buffer(ET.tostring(stream, encoding="unicode"), pts=pts))
        return self._out.popleft() if self._out else None


@register
class OnvifMetadataCombiner(Element):
    """Attaches metadata-stream frames to time-matching video buffers
    (reference onvifmetadatacombiner: media pad + meta pad -> media with
    OnvifXMLFrameMeta)."""

    ELEMENT_NAME = "onvifmetadatacombiner"
    ELEMENT_CLASS = "Metadata/Combiner"
    ELEMENT_DESCRIPTION = "Combines ONVIF metadata with media buffers"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.media_pad = self.add_pad(
            Pad("media", PadDirection.SINK,
                PadTemplate("media", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.meta_pad = self.add_pad(
            Pad("meta", PadDirection.SINK,
                PadTemplate("meta", PadDirection.SINK, PadPresence.ALWAYS, META_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.media_pad.chain_function = self._media_chain
        self.media_pad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
        self.meta_pad.chain_function = self._meta_chain
        self.meta_pad.event_function = lambda pad, ev: True
        self.meta_pad.query_function = self._meta_query
        self._pending_meta: deque = deque()

    def _meta_query(self, pad: Pad, query) -> bool:
        """The meta pad answers caps queries with its own template: the
        default proxy would answer with the media branch's downstream caps,
        which no metadata stream (onvifmetadataparse's output) intersects."""
        if query.type == QueryType.CAPS:
            f = query.fields.get("filter")
            query.result["caps"] = META_CAPS if f is None else f.intersect(META_CAPS)
            return True
        return self._default_query(pad, query)

    def _meta_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        self._pending_meta.append(buf)
        return FlowReturn.OK

    def _media_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        frames = []
        # attach all metadata with pts <= this media buffer's end time
        end = (buf.pts or 0) + (buf.duration or 0)
        while self._pending_meta and (self._pending_meta[0].pts or 0) <= end:
            frames.append(_text_of(self._pending_meta.popleft()))
        if frames:
            buf.add_meta(OnvifXMLFrameMeta(frames))
        return self.srcpad.push(buf)


@register
class OnvifMetadataExtractor(BaseTransform):
    """Splits OnvifXMLFrameMeta out of media buffers: the media passes
    through unchanged on `src` while each attached XML frame goes out as
    a metadata buffer on the always `meta_src` pad (the reference's
    onvifmetadataextractor pad shape)."""

    ELEMENT_NAME = "onvifmetadataextractor"
    ELEMENT_CLASS = "Metadata"
    ELEMENT_DESCRIPTION = "Extracts ONVIF XML metadata from buffers"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PROPERTIES = [
        Prop("remove-onvif-metadata", False, type="bool",
             doc="strip OnvifXMLFrameMeta from the consumed buffers"),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self.meta_srcpad = self.add_pad(
            Pad("meta_src", PadDirection.SRC,
                PadTemplate("meta_src", PadDirection.SRC, PadPresence.ALWAYS,
                            META_CAPS)))
        self._meta_started = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._meta_started = False

    def sink_event(self, event: Event) -> bool:
        # mirror stream-terminating events onto the metadata branch
        if event.type in (EventType.EOS, EventType.FLUSH_START,
                          EventType.FLUSH_STOP) and self.meta_srcpad.peer:
            self.meta_srcpad.push_event(event)
        return True

    def transform_ip(self, buf: Buffer) -> Buffer:
        meta = buf.get_meta(OnvifXMLFrameMeta)
        if meta is not None and meta.frames and self.meta_srcpad.peer is not None:
            if not self._meta_started:
                self._meta_started = True
                from ...core.events import Segment

                self.meta_srcpad.push_event(
                    Event.new_stream_start(f"{self.name}-meta"))
                self.meta_srcpad.push_event(Event.new_caps(META_CAPS))
                self.meta_srcpad.push_event(
                    Event.new_segment(self.segment or Segment()))
            out = Buffer("\n".join(meta.frames), pts=buf.pts,
                         duration=buf.duration)
            self.meta_srcpad.push(out)
        if meta is not None and self.get_property("remove-onvif-metadata"):
            buf.metas.remove(meta)
        return buf


@register
class OnvifMetadataOverlay(BaseTransform):
    """Draws ONVIF bounding boxes over video on the device
    `gst_plugins_rs_tpu_torch.set_device` selects, where a frame that
    arrives elsewhere is moved first (reference onvifmetadataoverlay renders
    labels+boxes with pango/cairo; here box edges are composited in one f32
    blend)."""

    ELEMENT_NAME = "onvifmetadataoverlay"
    ELEMENT_CLASS = "Filter/Effect/Video"
    ELEMENT_DESCRIPTION = "Overlays ONVIF metadata bounding boxes on video"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(tuple(f for f in RGB_FORMATS if RGB_FORMATS[f][1] == np.uint8))
    SRC_CAPS = video_caps_template(tuple(f for f in RGB_FORMATS if RGB_FORMATS[f][1] == np.uint8))
    PROPERTIES = [
        Prop("thickness", 2, type="uint", minimum=1, maximum=16),
        Prop("font-desc", "monospace 12", type="str",
             doc="label font description; this renderer draws box edges "
                 "on device and has no text rasterizer, the value is "
                 "recorded for pipeline parity"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def transform(self, inbuf: Buffer) -> Buffer:
        meta = inbuf.get_meta(OnvifXMLFrameMeta)
        if meta is None or not meta.frames:
            out = Buffer(inbuf.data)
            out.copy_metadata_from(inbuf)
            return out
        frame = torch.as_tensor(inbuf.data, device=self._device)
        h, w = frame.shape[:2]
        mask = torch.zeros((h, w, 1), dtype=torch.float32, device=frame.device)
        t = self.get_property("thickness")
        for xml in meta.frames:
            rel = parse_metadata_xml(xml)
            for od in rel.od:
                x0, y0 = max(od.x, 0), max(od.y, 0)
                x1, y1 = min(od.x + od.w, w), min(od.y + od.h, h)
                if x1 <= x0 or y1 <= y0:
                    continue
                mask[y0 : y0 + t, x0:x1] = 1.0
                mask[max(y1 - t, 0) : y1, x0:x1] = 1.0
                mask[y0:y1, x0 : x0 + t] = 1.0
                mask[y0:y1, max(x1 - t, 0) : x1] = 1.0
        f = frame.to(torch.float32)
        color = torch.zeros((frame.shape[-1],), dtype=torch.float32, device=frame.device)
        color[1] = 255.0  # green boxes
        out_frame = (f * (1.0 - mask) + color * mask).to(torch.uint8)
        out = Buffer(out_frame)
        out.copy_metadata_from(inbuf)
        return out


__all__ = [
    "OnvifMetadataPay", "OnvifMetadataDepay", "OnvifMetadataParse",
    "OnvifMetadataCombiner", "OnvifMetadataExtractor", "OnvifMetadataOverlay",
]


@register
class RtpOnvifMetadataPay(OnvifMetadataPay):
    """The reference registers this under rtponvifmetadatapay (net/onvif)."""

    ELEMENT_NAME = "rtponvifmetadatapay"


@register
class RtpOnvifMetadataDepay(OnvifMetadataDepay):
    ELEMENT_NAME = "rtponvifmetadatadepay"
