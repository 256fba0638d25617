"""handdetectiontensordec: MediaPipe-style palm detection tensor decoder.

The port of gst_plugins_rs_tpu/elements/analytics/handdetection.py.  The
decode is host work, as in the JAX element: a tensor that arrives on the
device is read back once per buffer, and rows under the confidence
threshold are dropped in one numpy step before the per-row loop.

Parity target: analytics/analytics/src/handdetectiontensordec/imp.rs (810
LoC): consumes a `palm-detection-out` f32 tensor with rows
[score, cx, cy, size, kp0_x, kp0_y, kp2_x, kp2_y] (normalized), derives the
palm rotation from keypoints 0->2 (pi/2 + atan2), expands the rotated-rect
size by 2.9x with the center shifted along the rotation (imp.rs:200-206),
validates candidates (size/center/keypoint-span/visibility windows,
imp.rs:272-337), scales to pixels, runs score-sorted greedy NMS capped at
max-hands, and emits ORIENTED od metadata + hand classification relations.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core import BaseTransform, Buffer, Prop, TransformMode, VideoInfo, register
from ...core.events import Event, EventType
from .meta import AnalyticsRelationMeta, RelTypes, TensorDataType, TensorMeta

PALM_DETECTION_OUT_ID = "palm-detection-out"
HAND_CLASS_LABEL = "hand"
PALM_MIN_RR_SIZE_NORM = 0.06
PALM_MAX_RR_SIZE_NORM = 1.40
PALM_MIN_VISIBLE_BBOX_RATIO = 0.5
PALM_MIN_KP_SPAN_RATIO = 0.15
PALM_MAX_KP_SPAN_RATIO = 1.60


@dataclass
class OrientedOdMtd:
    """Oriented object-detection metadata entry (rotation in radians)."""

    id: int
    object_type: str
    x: int
    y: int
    w: int
    h: int
    rotation: float
    loc_conf_lvl: float


def _valid_candidate(cx, cy, rr, box_size, kp0, kp2) -> bool:
    vals = [cx, cy, rr, box_size, *kp0, *kp2]
    if not all(math.isfinite(v) for v in vals):
        return False
    if not (PALM_MIN_RR_SIZE_NORM <= rr <= PALM_MAX_RR_SIZE_NORM):
        return False
    if not (0.0 <= cx <= 1.0 and 0.0 <= cy <= 1.0):
        return False
    if box_size <= 0.0:
        return False
    span = math.hypot(kp2[0] - kp0[0], kp2[1] - kp0[1])
    ratio = span / box_size
    if not (PALM_MIN_KP_SPAN_RATIO <= ratio <= PALM_MAX_KP_SPAN_RATIO):
        return False
    half = rr * 0.5
    x0, y0, x1, y1 = cx - half, cy - half, cx + half, cy + half
    area = max(x1 - x0, 0.0) * max(y1 - y0, 0.0)
    if area <= 0.0:
        return False
    ix0, iy0 = max(x0, 0.0), max(y0, 0.0)
    ix1, iy1 = min(x1, 1.0), min(y1, 1.0)
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    return inter / area >= PALM_MIN_VISIBLE_BBOX_RATIO


def _iou(a, b) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    ua = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return inter / ua if ua > 0 else 0.0


@register
class HandDetectionTensorDec(BaseTransform):
    ELEMENT_NAME = "handdetectiontensordec"
    ELEMENT_CLASS = "Filter/Analyzer/Video"
    ELEMENT_DESCRIPTION = "Decodes palm detection tensors into oriented hand boxes"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = True

    PROPERTIES = [
        Prop("confidence-threshold", 0.15, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("max-hands", 2, type="uint", minimum=1, maximum=8, mutable="playing"),
        Prop("nms-iou-threshold", 0.2, minimum=0.0, maximum=1.0, mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._video_size = None

    def sink_event(self, event: Event) -> bool:
        if event.type == EventType.CAPS:
            try:
                info = VideoInfo.from_caps(event.get("caps"))
                self._video_size = (info.width, info.height)
            except Exception:  # noqa: BLE001 - non-video caps: no scaling
                self._video_size = None
        return True

    def transform_ip(self, buf: Buffer) -> Buffer:
        tensor = None
        for m in buf.iter_meta(TensorMeta):
            for t in m.tensors:
                if (
                    t.id == PALM_DETECTION_OUT_ID
                    and t.data_type == TensorDataType.FLOAT32
                    and len(t.dims) >= 2
                    and t.dims[-1] == 8
                ):
                    tensor = t
                    break
            if tensor:
                break
        if tensor is None:
            return buf

        data = tensor.data
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()  # the one read-back of the buffer
        rows = np.asarray(data).reshape(-1, 8)
        thr = self.get_property("confidence-threshold")
        rows = rows[~(rows[:, 0] < thr)]  # the loop's own skip (a NaN score stays)
        candidates = []
        for det in rows:
            score = float(det[0])
            if score < thr:
                continue
            bcx, bcy, bsize = float(det[1]), float(det[2]), float(det[3])
            kp0 = (float(det[4]), float(det[5]))
            kp2 = (float(det[6]), float(det[7]))
            if bsize <= 0.0:
                continue
            rotation = math.pi / 2 + math.atan2(kp2[1] - kp0[1], kp2[0] - kp0[0])
            rr = 2.9 * bsize
            cx = bcx + 0.5 * bsize * math.sin(rotation)
            cy = bcy - 0.5 * bsize * math.cos(rotation)
            if not _valid_candidate(cx, cy, rr, bsize, kp0, kp2):
                continue
            if self._video_size is not None:
                w, h = self._video_size
                cx, cy, rr = cx * w, cy * h, rr * max(w, h)
            half = rr / 2.0
            candidates.append((score, rotation, (cx - half, cy - half, cx + half, cy + half)))

        # score-sorted greedy NMS capped at max-hands (imp.rs:400-430)
        candidates.sort(key=lambda c: -c[0])
        iou_thr = self.get_property("nms-iou-threshold")
        selected = []
        for c in candidates:
            if any(_iou(c[2], k[2]) > iou_thr for k in selected):
                continue
            selected.append(c)
            if len(selected) >= self.get_property("max-hands"):
                break

        rmeta = AnalyticsRelationMeta()
        for score, rotation, (x0, y0, x1, y1) in selected:
            fx0, fy0 = math.floor(x0), math.floor(y0)
            fx1, fy1 = math.ceil(x1), math.ceil(y1)
            if fx1 <= fx0 or fy1 <= fy0:
                continue
            if self._video_size is not None:
                w, h = self._video_size
                if fx1 <= 0 or fy1 <= 0 or fx0 >= w or fy0 >= h:
                    continue
            od = OrientedOdMtd(
                rmeta._next_id,
                HAND_CLASS_LABEL,
                int(fx0),
                int(fy0),
                int(fx1 - fx0),
                int(fy1 - fy0),
                rotation - math.pi / 2,
                score,
            )
            rmeta._next_id += 1
            rmeta.od.append(od)  # type: ignore[arg-type]
            cm = rmeta.add_one_cls_mtd(score, HAND_CLASS_LABEL)
            rmeta.set_relation(RelTypes.RELATE_TO, od.id, cm.id)
        buf.add_meta(rmeta)
        return buf


__all__ = ["HandDetectionTensorDec", "OrientedOdMtd", "PALM_DETECTION_OUT_ID"]
