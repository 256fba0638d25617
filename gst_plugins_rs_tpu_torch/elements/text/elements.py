"""Text elements: regex replace, wrap, accumulate, JSON encode/parse.

Parity targets: text/regex (455 LoC regex transform), text/wrap (984,
textwrap), text/accumulate (2063, textaccumulate rolling captions),
text/json (1767, jsongstenc/jsongstparse).  Text buffers carry Python str
payloads in `Buffer.data` (host control plane — no device work here).
"""
from __future__ import annotations

import json
import re
import textwrap
from typing import List, Optional

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Prop,
    TransformMode,
    register,
)

TEXT_CAPS = Caps.builder("text/x-raw", format="utf8")
JSON_CAPS = Caps.builder("application/x-json")


class _TextTransform(BaseTransform):
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = TEXT_CAPS
    MODE = TransformMode.NEVER_IN_PLACE


@register
class TextRegex(_TextTransform):
    ELEMENT_NAME = "regex"
    ELEMENT_CLASS = "Text/Filter"
    ELEMENT_DESCRIPTION = "Applies regex replacement operations on text buffers"
    PROPERTIES = [
        Prop("pattern", "", type="str", mutable="playing"),
        Prop("replacement", "", type="str", mutable="playing"),
        Prop("commands", None, type="object", mutable="playing",
             doc="list of command entries applied in order; each is a "
                 "mapping/structure with operation ('replace-all'), "
                 "pattern and replacement — the reference's GstValueArray "
                 "of command structures"),
    ]

    def transform(self, inbuf: Buffer) -> Buffer:
        text = str(inbuf.data)
        commands = self.get_property("commands")
        if commands:
            for cmd in commands:
                get = cmd.get if hasattr(cmd, "get") else \
                    (lambda k, c=cmd: dict(c).get(k))
                pattern = get("pattern")
                if pattern:
                    text = re.sub(pattern, get("replacement") or "", text)
        pattern = self.get_property("pattern")
        if pattern:
            text = re.sub(pattern, self.get_property("replacement"), text)
        out = Buffer(text)
        out.copy_metadata_from(inbuf)
        return out


@register
class TextWrap(_TextTransform):
    ELEMENT_NAME = "textwrap"
    ELEMENT_CLASS = "Text/Filter"
    ELEMENT_DESCRIPTION = "Wraps text buffers to a column limit"
    PROPERTIES = [
        Prop("columns", 32, type="uint", minimum=1, mutable="playing"),
        Prop("lines", 0, type="uint", mutable="playing",
             doc="Split output into buffers of this many lines (0 = one buffer)"),
        Prop("accumulate-time", 0, type="uint64", mutable="playing",
             doc="cut-off time (ns) for input text accumulation before a "
                 "wrapped buffer is emitted (0 = wrap each buffer alone)"),
        Prop("dictionary", None, type="str", mutable="playing",
             doc="path to a hyphenation dictionary ('word=hy-phen-ation' "
                 "lines; the reference uses hyphenation-rs TeX patterns)"),
    ]

    def __init__(self, name=None):
        super().__init__(name)
        self._acc_text: List[str] = []
        self._acc_pts = None
        self._hyph: Optional[dict] = None
        self._hyph_path: Optional[str] = None

    def _hyphenate(self, text: str) -> str:
        path = self.get_property("dictionary")
        if not path:
            return text
        if self._hyph is None or self._hyph_path != path:
            self._hyph = {}
            self._hyph_path = path
            try:
                for line in open(path, encoding="utf-8"):
                    if "=" in line:
                        word, hyph = line.strip().split("=", 1)
                        self._hyph[word] = hyph.replace("-", "­")
            except OSError:
                pass
        return " ".join(self._hyph.get(w, w) for w in text.split(" "))

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        acc_t = self.get_property("accumulate-time")
        text = self._hyphenate(str(inbuf.data))
        if acc_t:
            if self._acc_pts is None:
                self._acc_pts = inbuf.pts or 0
            self._acc_text.append(text)
            end = (inbuf.pts or 0) + (inbuf.duration or 0)
            if end - self._acc_pts < acc_t:
                return None  # keep accumulating
            text = " ".join(self._acc_text)
            pts = self._acc_pts
            self._acc_text, self._acc_pts = [], None
            out = Buffer(textwrap.fill(text, width=self.get_property("columns")),
                         pts=pts, duration=end - pts)
            return out
        wrapped = textwrap.fill(text, width=self.get_property("columns"))
        out = Buffer(wrapped)
        out.copy_metadata_from(inbuf)
        return out

    def drain(self) -> Optional[Buffer]:
        if not self._acc_text:
            return None
        text = " ".join(self._acc_text)
        pts = self._acc_pts
        self._acc_text, self._acc_pts = [], None
        return Buffer(textwrap.fill(text, width=self.get_property("columns")),
                      pts=pts)


@register
class TextAccumulate(_TextTransform):
    ELEMENT_NAME = "textaccumulate"
    ELEMENT_CLASS = "Text/Filter"
    ELEMENT_DESCRIPTION = "Accumulates text across buffers (rolling captions)"
    PROPERTIES = [
        Prop("drain-on-final", True, type="bool", mutable="playing"),
        Prop("separator", " ", type="str", mutable="ready"),
        Prop("drain-on-final-transcripts", True, type="bool",
             doc="drain fully on rstranscribe/final-transcript events"),
        Prop("drain-on-speaker-change", True, type="bool",
             doc="drain fully on rstranscribe/speaker-change events"),
        Prop("latency", 3_000, type="int", minimum=-1,
             doc="ms of accumulation (-1 = full-sentence accumulation with "
                 "retimestamping)"),
        Prop("lateness", 0, type="uint",
             doc="ms input timestamps are shifted forward"),
        Prop("no-timeout", False, type="bool",
             doc="only emit full sentences (timestamps may shift forward)"),
        Prop("timeout-terminators", r"\,\s|\:\s|\;\s", type="str",
             doc="regex of preferred break points on timeout drains"),
        Prop("incomplete-sentence-threshold", -1, type="int", minimum=-1,
             doc="ms after which an incomplete sentence drains up to the "
                 "last terminator (-1 = don't)"),
        Prop("incomplete-sentence-limit", -1, type="int", minimum=-1,
             doc="ms of queued text that forces a full drain (-1 = never)"),
        Prop("extend-duration", False, type="bool",
             doc="extend an item's duration to the start of the next one"),
        Prop("extended-duration-gap", 500, type="uint",
             doc="ms preserved between items when extend-duration is set"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc: List[str] = []
        self._first_pts: Optional[int] = None
        self._acc_dur = 0
        self._prev_out: Optional[Buffer] = None

    def start(self) -> None:
        self._acc = []
        self._first_pts = None
        self._acc_dur = 0
        self._prev_out = None

    def latency_additional_ns(self) -> int:
        lat = self.get_property("latency")
        return max(0, lat) * 1_000_000

    def sink_event(self, event) -> bool:
        from ...core.events import EventType

        if event.type == EventType.CUSTOM_DOWNSTREAM:
            name = event.get("name")
            if (name == "rstranscribe/final-transcript"
                    and self.get_property("drain-on-final-transcripts")) or \
               (name == "rstranscribe/speaker-change"
                    and self.get_property("drain-on-speaker-change")):
                residue = self.drain()
                if residue is not None:
                    self.srcpad.push(residue)
                return False
        return True

    def _emit(self, text: str, pts, dur) -> Buffer:
        out = Buffer(text, pts=pts, duration=dur)
        if self.get_property("extend-duration") and self._prev_out is not None:
            prev = self._prev_out
            if prev.pts is not None and pts is not None:
                gap = self.get_property("extended-duration-gap") * 1_000_000
                prev.duration = max(prev.duration or 0, pts - prev.pts - gap)
        self._prev_out = out
        return out

    def _drain_to_terminator(self) -> Optional[Buffer]:
        import re as _re

        joined = self.get_property("separator").join(self._acc)
        matches = list(_re.finditer(self.get_property("timeout-terminators"),
                                    joined))
        if not matches:
            return None
        cut = matches[-1].end()
        head, rest = joined[:cut].rstrip(), joined[cut:].lstrip()
        pts = self._first_pts
        self._acc = [rest] if rest else []
        self._first_pts = None if not rest else pts
        self._acc_dur = 0
        return self._emit(head, pts, None)

    def transform(self, inbuf: Buffer) -> Buffer:
        pts = inbuf.pts
        late = self.get_property("lateness")
        if pts is not None and late:
            pts = pts + late * 1_000_000
        if self._first_pts is None:
            self._first_pts = pts
        self._acc.append(str(inbuf.data))
        self._acc_dur += (inbuf.duration or 0)
        # full-sentence / threshold machinery only engages when asked
        lat = self.get_property("latency")
        thr = self.get_property("incomplete-sentence-threshold")
        lim = self.get_property("incomplete-sentence-limit")
        if lat < 0 or self.get_property("no-timeout"):
            if lim >= 0 and self._acc_dur >= lim * 1_000_000:
                out = self._emit(
                    self.get_property("separator").join(self._acc),
                    self._first_pts, inbuf.duration)
                self._acc, self._first_pts, self._acc_dur = [], None, 0
                return out
            if thr >= 0 and self._acc_dur >= thr * 1_000_000:
                drained = self._drain_to_terminator()
                if drained is not None:
                    return drained
            return None  # keep accumulating until a drain event
        out = self._emit(self.get_property("separator").join(self._acc),
                         self._first_pts, inbuf.duration)
        return out

    def drain(self) -> Optional[Buffer]:
        if not self._acc or not self.get_property("drain-on-final"):
            return None
        text = self.get_property("separator").join(self._acc)
        self._acc = []
        return Buffer(text, pts=self._first_pts)


class _ConvertCaps(BaseTransform):
    """Transform with different sink/src media types: propose the opposite
    template wholesale."""

    def transform_caps(self, direction, caps, filter_):
        from ...core import PadDirection

        out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out


@register
class JsonGstEnc(_ConvertCaps):
    ELEMENT_NAME = "jsongstenc"
    ELEMENT_CLASS = "Text/Encoder"
    ELEMENT_DESCRIPTION = "Wraps buffers into newline-delimited JSON"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = JSON_CAPS

    def transform(self, inbuf: Buffer) -> Buffer:
        record = {"text": str(inbuf.data)}
        if inbuf.pts is not None:
            record["pts"] = inbuf.pts
        if inbuf.duration is not None:
            record["duration"] = inbuf.duration
        out = Buffer(json.dumps(record) + "\n")
        out.copy_metadata_from(inbuf)
        return out


@register
class JsonGstParse(_ConvertCaps):
    ELEMENT_NAME = "jsongstparse"
    ELEMENT_CLASS = "Text/Parser"
    ELEMENT_DESCRIPTION = "Parses newline-delimited JSON back into text buffers"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = JSON_CAPS
    SRC_CAPS = TEXT_CAPS

    def transform(self, inbuf: Buffer) -> Buffer:
        record = json.loads(str(inbuf.data))
        out = Buffer(
            record.get("text", ""),
            pts=record.get("pts"),
            duration=record.get("duration"),
        )
        return out


__all__ = ["TextRegex", "TextWrap", "TextAccumulate", "JsonGstEnc", "JsonGstParse"]
