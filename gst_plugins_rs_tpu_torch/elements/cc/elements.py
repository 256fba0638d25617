"""CEA-608 closed-caption text elements: tttocea608, cea608tott,
cea608tojson, tttojson, jsontovtt, ccdetect.

Parity family: video/closedcaption (24 elements, 29.5k LoC).  This module
covers the text<->608 conversion chain; SCC/MCC file formats live in
files.py and the on-video compositor in overlay.py.

Caption byte pairs flow as closedcaption/x-cea-608, format=raw buffers
carrying a [N, 2] uint8 array of pairs (the reference paces one pair per
video frame; here a buffer may carry the whole caption's pairs with pts
spaced by the framerate property — noted divergence, the timing contract
per pair is identical).
"""
from __future__ import annotations

import json
from collections import deque
from fractions import Fraction
from typing import Optional

import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    register,
)
from ...core.caps import Structure
from ...core.events import Message, MessageType
from ...core.payload import host_array
from ...ops import cea608

CEA608_CAPS = Caps.builder("closedcaption/x-cea-608", format="raw")
TEXT_CAPS = Caps.builder("text/x-raw", format="utf8")
JSON_CAPS = Caps.builder("application/x-json")


def pairs_to_array(pairs) -> np.ndarray:
    return np.asarray(pairs, np.uint8).reshape(-1, 2)


@register
class TtToCea608(BaseTransform):
    """text -> CEA-608 byte pairs (reference tttocea608/imp.rs; default mode
    RollUp2, imp.rs:25)."""

    ELEMENT_NAME = "tttocea608"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts timed text to CEA-608 closed captions"
    MODE = TransformMode.NEVER_IN_PLACE
    # the reference takes plain timed text AND its JSON record format
    SINK_CAPS = Caps([TEXT_CAPS.structure(0).copy(),
                      JSON_CAPS.structure(0).copy()])
    SRC_CAPS = CEA608_CAPS
    _NEVER = (1 << 64) - 1

    PROPERTIES = [
        Prop("mode", "roll-up2", type="enum",
             choices=["pop-on", "paint-on", "roll-up2", "roll-up3", "roll-up4"]),
        Prop("framerate", "30/1", type="str", doc="pair pacing for pts spacing"),
        Prop("origin-row", -1, type="int", minimum=-1, maximum=14,
             mutable="playing", doc="Origin row (-1 = automatic)"),
        Prop("origin-column", 0, type="uint", maximum=31, mutable="playing",
             doc="Origin column (indent PAC + tab offsets)"),
        Prop("roll-up-timeout", _NEVER, type="uint64", mutable="playing",
             doc="ns without text after which display memory is erased "
                 "in roll-up mode (u64 max = never)"),
        Prop("speaker-prefix", None, type="str",
             doc="prefix added on the line after an "
                 "rstranscribe/speaker-change event"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._prefix_next = False
        self._last_text_pts: Optional[int] = None

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CEA608_CAPS if direction == PadDirection.SINK
               else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _frame_dur(self) -> int:
        f = Fraction(self.get_property("framerate"))
        return int(SECOND * f.denominator // f.numerator)

    def sink_event(self, event) -> bool:
        from ...core.events import EventType

        if event.type == EventType.CUSTOM_DOWNSTREAM:
            name = event.get("name")
            if name == "rstranscribe/speaker-change":
                self._prefix_next = True
                return False  # consumed
            if name == "rstranscribe/final-transcript":
                return False
        return True

    def _position(self):
        """(base_row, column) from origin-row/origin-column."""
        row = self.get_property("origin-row")
        return (14 if row < 0 else max(1, row)), self.get_property("origin-column")

    def _input_text(self, inbuf: Buffer) -> str:
        text = str(inbuf.data)
        if self.in_caps is not None \
                and self.in_caps.structure(0).name == "application/x-json":
            rec = json.loads(text)
            if "lines" in rec:
                return "\n".join(l.get("text", "") if isinstance(l, dict)
                                  else str(l) for l in rec["lines"])
            return str(rec.get("text", ""))
        return text

    def transform(self, inbuf: Buffer) -> Buffer:
        text = self._input_text(inbuf)
        if self._prefix_next and self.get_property("speaker-prefix"):
            text = self.get_property("speaker-prefix") + text
        self._prefix_next = False
        mode = self.get_property("mode")
        row, col = self._position()
        pairs = []
        # roll-up-timeout: erase stale display memory before new text
        timeout = self.get_property("roll-up-timeout")
        if (mode.startswith("roll-up") and timeout != self._NEVER
                and inbuf.pts is not None and self._last_text_pts is not None
                and inbuf.pts - self._last_text_pts > timeout):
            pairs.extend(cea608.erase_displayed())
        self._last_text_pts = inbuf.pts
        if mode == "pop-on":
            pairs += cea608.encode_pop_on(text.split("\n"), base_row=row, column=col)
        elif mode == "paint-on":
            pairs += [cea608.control_pair(cea608.RCL)] + \
                cea608.encode_pop_on(text.split("\n"), base_row=row, column=col)[1:]
        else:
            rows = int(mode[-1])
            for line in text.split("\n"):
                pairs.extend(cea608.encode_roll_up(line, rows=rows,
                                                   base_row=row, column=col))
        out = Buffer(pairs_to_array(pairs))
        out.pts = inbuf.pts
        out.duration = len(pairs) * self._frame_dur()
        return out


class _Cea608DecodeBase(BaseTransform):
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CEA608_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._dec = cea608.Cea608Decoder()
        self._out: deque = deque()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else CEA608_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._dec = cea608.Cea608Decoder()
        self._out.clear()

    def caption_buffer(self, caption: cea608.Caption, pts) -> Optional[Buffer]:
        raise NotImplementedError

    def generate_output(self) -> Optional[Buffer]:
        if not self._out:
            inbuf = self.take_queued_buffer()
            if inbuf is None:
                return None
            for hi, lo in host_array(inbuf.data, np.uint8).reshape(-1, 2):
                self._dec.push_pair(int(hi), int(lo))
            for ev in self._dec.take_events():
                if ev is not None:
                    b = self.caption_buffer(ev, inbuf.pts)
                    if b is not None:
                        self._out.append(b)
        return self._out.popleft() if self._out else None

    def drain(self) -> Optional[Buffer]:
        self._dec.flush()
        for ev in self._dec.take_events():
            if ev is not None:
                b = self.caption_buffer(ev, None)
                if b is not None:
                    return b
        return None


@register
class Cea608ToTt(_Cea608DecodeBase):
    """CEA-608 -> timed text (reference cea608tott/imp.rs: pop-on captions
    emitted at EOC, roll-up rows at CR)."""

    ELEMENT_NAME = "cea608tott"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts CEA-608 closed captions to timed text"
    SRC_CAPS = TEXT_CAPS

    def caption_buffer(self, caption: cea608.Caption, pts) -> Buffer:
        return Buffer("\n".join(caption.lines), pts=pts)


@register
class Cea608ToJson(_Cea608DecodeBase):
    """CEA-608 -> JSON caption records (reference cea608tojson/imp.rs)."""

    ELEMENT_NAME = "cea608tojson"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts CEA-608 closed captions to JSON"
    SRC_CAPS = JSON_CAPS
    PROPERTIES = [
        Prop("unbuffered", False, type="bool",
             doc="emit at display time instead of buffering to compute "
                 "durations (this implementation always emits at display "
                 "time; true is the native path, false is accepted)"),
    ]

    def caption_buffer(self, caption: cea608.Caption, pts) -> Buffer:
        rec = {"mode": caption.mode, "lines": [{"text": t} for t in caption.lines]}
        return Buffer(json.dumps(rec), pts=pts)


@register
class TtToJson(BaseTransform):
    """timed text -> JSON records (reference tttojson/)."""

    ELEMENT_NAME = "tttojson"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts timed text to JSON"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = JSON_CAPS
    PROPERTIES = [
        Prop("mode", "roll-up2", type="enum",
             choices=["pop-on", "paint-on", "roll-up2", "roll-up3", "roll-up4"],
             doc="caption mode recorded in the JSON records"),
    ]

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (JSON_CAPS if direction == PadDirection.SINK else TEXT_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Buffer:
        rec = {"text": str(inbuf.data), "mode": self.get_property("mode")}
        if inbuf.duration is not None:
            rec["duration"] = inbuf.duration
        out = Buffer(json.dumps(rec))
        out.copy_metadata_from(inbuf)
        return out


def _vtt_ts(ns: int) -> str:
    ms = ns // 1_000_000
    return f"{ms // 3600000:02d}:{ms // 60000 % 60:02d}:{ms // 1000 % 60:02d}.{ms % 1000:03d}"


@register
class JsonToVtt(BaseTransform):
    """JSON caption records -> WebVTT cues (reference jsontovtt/)."""

    ELEMENT_NAME = "jsontovtt"
    ELEMENT_CLASS = "Generic/Converter"
    ELEMENT_DESCRIPTION = "Converts JSON captions to WebVTT"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = JSON_CAPS
    SRC_CAPS = Caps.builder("application/x-subtitle-vtt")
    PROPERTIES = [
        Prop("default-duration", 2 * SECOND, type="uint64",
             doc="cue duration when the record has none"),
        Prop("set-line-attribute", False, type="bool", mutable="playing",
             doc="set the line attribute on cues from the lowest visible "
                 "row in the record"),
        Prop("timeout", (1 << 64) - 1, type="uint64",
             minimum=16_000_000, mutable="playing",
             doc="erase-text timeout; cues here always carry explicit end "
                 "times, so this only bounds a record with no duration"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sent_header = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._sent_header = False

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else JSON_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Buffer:
        rec = json.loads(str(inbuf.data))
        text = rec.get("text") or "\n".join(l["text"] for l in rec.get("lines", []))
        pts = inbuf.pts or 0
        dur = inbuf.duration or rec.get("duration") or self.get_property("default-duration")
        timeout = self.get_property("timeout")
        if timeout != (1 << 64) - 1:
            dur = min(dur, timeout)
        settings = ""
        if self.get_property("set-line-attribute"):
            rows = [l.get("row") for l in rec.get("lines", [])
                    if isinstance(l, dict) and l.get("row") is not None]
            if rows:
                settings = f" line:{min(rows)}"
        cue = f"{_vtt_ts(pts)} --> {_vtt_ts(pts + dur)}{settings}\n{text}\n\n"
        if not self._sent_header:
            cue = "WEBVTT\n\n" + cue
            self._sent_header = True
        out = Buffer(cue, pts=pts, duration=dur)
        return out


@register
class CCDetect(BaseTransform):
    """Detects presence of closed-caption data, posting a `cc-detect`
    element message on change (reference ccdetect/: window-based presence
    with cc608/cc708 notify properties)."""

    ELEMENT_NAME = "ccdetect"
    ELEMENT_CLASS = "Filter/Analysis"
    ELEMENT_DESCRIPTION = "Detects closed caption presence"
    MODE = TransformMode.ALWAYS_IN_PLACE
    SINK_CAPS = Caps([Structure("closedcaption/x-cea-608", format="raw"),
                      Structure("closedcaption/x-cea-708")])
    SRC_CAPS = SINK_CAPS
    PROPERTIES = [
        Prop("window", 10 * SECOND, type="uint64",
             doc="no-data interval after which presence flips off"),
        Prop("cc608", False, type="bool",
             doc="(read) whether CEA-608 captions have been detected"),
        Prop("cc708", False, type="bool",
             doc="(read) whether CEA-708 cc_data has been detected"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.cc608 = False
        self.cc708 = False
        self._last_data_pts: Optional[int] = None
        self._is_708 = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self.cc608 = False
        self.cc708 = False
        self._last_data_pts = None

    def get_property(self, name: str):
        if name == "cc608":
            return self.cc608
        if name == "cc708":
            return self.cc708
        return super().get_property(name)

    def set_caps(self, in_caps: Caps, out_caps: Caps) -> None:
        self._is_708 = "708" in in_caps.structure(0).name

    def _set_presence(self, present: bool) -> None:
        changed = (present != (self.cc708 if self._is_708 else self.cc608))
        if self._is_708:
            self.cc708 = present
        else:
            self.cc608 = present
        if changed:
            self.post_message(
                Message(MessageType.ELEMENT,
                        structure=Structure("cc-detect", cc608=self.cc608,
                                            cc708=self.cc708))
            )

    def transform_ip(self, buf: Buffer) -> Buffer:
        data = host_array(buf.data, np.uint8)
        if self._is_708:
            has_data = data.size > 0
        else:
            has_data = bool((data.reshape(-1, 2) != 0x80).any())
        if has_data:
            self._last_data_pts = buf.pts
            self._set_presence(True)
        elif (
            (self.cc708 if self._is_708 else self.cc608)
            and buf.pts is not None
            and self._last_data_pts is not None
            and buf.pts - self._last_data_pts > self.get_property("window")
        ):
            self._set_presence(False)
        return buf


__all__ = [
    "TtToCea608", "Cea608ToTt", "Cea608ToJson", "TtToJson", "JsonToVtt",
    "CCDetect", "CEA608_CAPS",
]
