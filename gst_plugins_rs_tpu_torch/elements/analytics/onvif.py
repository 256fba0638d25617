"""ONVIF metadata <-> analytics relation metadata conversion.

Parity targets: analytics/analytics/src/relationmeta2onvifmeta (imp.rs:61;
XML shape imp.rs:282-430: tt:MetadataStream > VideoAnalytics > Frame
[UtcTime] > Transformation (Translate -1,-1 / Scale 2/w,2/h) + Object >
Appearance > Shape > BoundingBox + Class > Type[Likelihood]) and
onvifmeta2relationmeta (imp.rs:32).  Both are ANY-caps passthroughs
exchanging an OnvifXMLFrameMeta attached to buffers (the reference's
custom meta, lib.rs registration).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Meta,
    Prop,
    SECOND,
    TransformMode,
    register,
)
from .meta import AnalyticsRelationMeta

ONVIF_NS = "http://www.onvif.org/ver10/schema"
ET.register_namespace("tt", ONVIF_NS)


class OnvifXMLFrameMeta(Meta):
    """ONVIF XML metadata frames attached to a buffer (the reference's
    OnvifXMLFrameMeta custom meta)."""

    api = "onvif-xml-frame"

    def __init__(self, frames: Optional[List[str]] = None):
        self.frames: List[str] = list(frames or [])


def _utc_of(pts: Optional[int]) -> str:
    ns = pts or 0
    secs, rem = divmod(ns, SECOND)
    h, m, s = secs // 3600, secs // 60 % 60, secs % 60
    return f"1970-01-01T{h:02d}:{m:02d}:{s:02d}.{rem // 1_000_000:03d}Z"


def build_metadata_xml(
    meta: Optional[AnalyticsRelationMeta], pts: Optional[int], width: int, height: int
) -> str:
    root = ET.Element(f"{{{ONVIF_NS}}}MetadataStream")
    va = ET.SubElement(root, f"{{{ONVIF_NS}}}VideoAnalytics")
    frame = ET.SubElement(va, f"{{{ONVIF_NS}}}Frame", UtcTime=_utc_of(pts))
    tr = ET.SubElement(frame, f"{{{ONVIF_NS}}}Transformation")
    ET.SubElement(tr, f"{{{ONVIF_NS}}}Translate", x="-1", y="-1")
    ET.SubElement(
        tr, f"{{{ONVIF_NS}}}Scale",
        x=f"{2.0 / width:.5f}", y=f"{2.0 / height:.5f}",
    )
    if meta is not None:
        for od in meta.od:
            obj = ET.SubElement(frame, f"{{{ONVIF_NS}}}Object", ObjectId=str(od.id))
            app = ET.SubElement(obj, f"{{{ONVIF_NS}}}Appearance")
            shape = ET.SubElement(app, f"{{{ONVIF_NS}}}Shape")
            ET.SubElement(
                shape, f"{{{ONVIF_NS}}}BoundingBox",
                left=str(od.x), top=str(od.y),
                right=str(od.x + od.w), bottom=str(od.y + od.h),
            )
            cls = ET.SubElement(app, f"{{{ONVIF_NS}}}Class")
            t = ET.SubElement(
                cls, f"{{{ONVIF_NS}}}Type", Likelihood=str(od.loc_conf_lvl)
            )
            t.text = od.object_type or "Unknown"
    return ET.tostring(root, encoding="unicode")


def parse_metadata_xml(xml: str) -> AnalyticsRelationMeta:
    meta = AnalyticsRelationMeta()
    root = ET.fromstring(xml)
    for obj in root.iter(f"{{{ONVIF_NS}}}Object"):
        bbox = obj.find(f".//{{{ONVIF_NS}}}BoundingBox")
        if bbox is None:
            continue
        left = float(bbox.get("left", 0))
        top = float(bbox.get("top", 0))
        right = float(bbox.get("right", 0))
        bottom = float(bbox.get("bottom", 0))
        typ = obj.find(f".//{{{ONVIF_NS}}}Type")
        label = (typ.text or "Unknown") if typ is not None else "Unknown"
        conf = float(typ.get("Likelihood", 1.0)) if typ is not None else 1.0
        meta.add_od_mtd(
            label, int(left), int(top), int(right - left), int(bottom - top), conf
        )
    return meta


@register
class RelationMeta2OnvifMeta(BaseTransform):
    ELEMENT_NAME = "relationmeta2onvifmeta"
    ELEMENT_CLASS = "Metadata"
    ELEMENT_DESCRIPTION = "Converts analytics relation meta to ONVIF XML meta"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    PROPERTIES = [
        Prop("time-source", "clock", type="enum",
             choices=["clock", "running-time", "clock-time"],
             doc="UtcTime source: clock = wall time at buffer handling, "
                 "running-time = the buffer's running time is UTC, "
                 "clock-time = the pipeline clock is UTC"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._width = 0
        self._height = 0

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        s = incaps.structure(0)
        self._width = s.get("width", 2)
        self._height = s.get("height", 2)

    def _utc_ns(self, buf: Buffer) -> Optional[int]:
        mode = self.get_property("time-source")
        if mode == "running-time":
            return buf.pts
        if mode == "clock-time":
            if self.clock is not None:
                return self.clock.now()
            return buf.pts
        import time as _t

        return _t.time_ns()

    def transform_ip(self, buf: Buffer) -> Buffer:
        rel = buf.get_meta(AnalyticsRelationMeta)
        xml = build_metadata_xml(rel, self._utc_ns(buf),
                                 self._width or 2, self._height or 2)
        buf.add_meta(OnvifXMLFrameMeta([xml]))
        return buf


@register
class OnvifMeta2RelationMeta(BaseTransform):
    ELEMENT_NAME = "onvifmeta2relationmeta"
    ELEMENT_CLASS = "Metadata"
    ELEMENT_DESCRIPTION = "Converts ONVIF XML meta to analytics relation meta"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False

    def transform_ip(self, buf: Buffer) -> Buffer:
        for meta in list(buf.iter_meta(OnvifXMLFrameMeta)):
            for xml in meta.frames:
                buf.add_meta(parse_metadata_xml(xml))
        return buf


__all__ = [
    "OnvifXMLFrameMeta", "RelationMeta2OnvifMeta", "OnvifMeta2RelationMeta",
    "build_metadata_xml", "parse_metadata_xml", "ONVIF_NS",
]
