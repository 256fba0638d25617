"""translationbin: audio in, transcribed + per-language translated text out.

Parity target: video/closedcaption/src/translationbin/imp.rs — wires a
transcriber element into a tee; each request src pad adds a translator
for its target language:

    audio -> <transcriber> -> tee -> <translator lang A> -> src_a
                                  -> <translator lang B> -> src_b

Properties mirror the reference: language-code (input), transcriber
factory via `transcriber` (reference exposes a `transcriber` object
property), translator per pad via `translator` (default awstranslate).
Pads are requested with `request_src_pad(language_code=...)` or the
textual `src_%u` form plus the pad's language property.

The port: where the transcriber or a translator the pads need is not
registered in the port (the default translator `awstranslate` belongs to a
slice still to come), the bin posts an ERROR message naming the factory,
builds nothing, answers every buffer with FlowReturn.ERROR and passes
events on to its src pad.
"""
from __future__ import annotations

from typing import List, Optional

from ...core import (
    Buffer,
    Caps,
    Element,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.registry import element_factory_make
from .transcriberbin import post_missing_factory


@register
class TranslationBin(Element):
    ELEMENT_NAME = "translationbin"
    ELEMENT_CLASS = "Audio/Text/Bin"
    ELEMENT_DESCRIPTION = "Transcribes audio and translates it per output pad"
    EXTRA_PAD_TEMPLATES = [
        ("translate_src_%u", "src", "request", "text/x-raw"),
    ]
    PROPERTIES = [
        Prop("transcriber", "whispertranscriber", type="str"),
        Prop("translator", "awstranslate", type="str"),
        Prop("language-code", "en-US", type="str", doc="input language"),
        # latency budget split (translationbin/imp.rs); the sum is what
        # this bin reports on latency queries
        Prop("lateness", 0, type="uint",
             doc="ms to offset transcription timestamps by"),
        Prop("transcribe-latency", 1_000, type="uint",
             doc="ms allowed for transcription"),
        Prop("translate-latency", 500, type="uint",
             doc="ms allowed for translation"),
        Prop("textaccumulate-latency", 3_000, type="uint",
             doc="ms allowed for text segmentation"),
    ]
    # GstTranslationBinTranslationSrcPad surface (reference rsclosedcaption
    # other-types): per-pad target language + the translator element in use
    PAD_PROPERTIES = {
        "translate_src": [
            Prop("language-code", "fr-FR", type="str", mutable="ready",
                 doc="target language of this output pad"),
            Prop("translator", None, type="object",
                 doc="read-only: the translator element serving this pad "
                     "(None for same-language passthrough branches)"),
        ],
    }

    def latency_additional_ns(self) -> int:
        return (self.get_property("transcribe-latency")
                + self.get_property("translate-latency")
                + self.get_property("textaccumulate-latency")
                + self.get_property("lateness")) * 1_000_000

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS,
                            Caps.builder("audio/x-raw")))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                            Caps.builder("text/x-raw")))
        )
        self._requests: List[dict] = []  # {"pad", "language", "translator_props"}
        self._children: List[Element] = []
        self._transcriber = None
        self._built = False
        self._forwarded = {}

    def set_property(self, name: str, value) -> None:
        if name.startswith("transcriber::"):
            self._forwarded[name.split("::", 1)[1]] = value
            return
        super().set_property(name, value)

    def request_src_pad(self, language_code: Optional[str] = None,
                        translator_props: Optional[dict] = None) -> Pad:
        pad = self.add_pad(
            Pad(f"translate_src_{len(self._requests)}", PadDirection.SRC,
                PadTemplate("translate_src_%u", PadDirection.SRC,
                            PadPresence.REQUEST, Caps.builder("text/x-raw")))
        )
        self._requests.append({
            "pad": pad,
            "language": language_code,
            "translator_props": translator_props or {},
        })
        if language_code is not None:
            pad._props["language-code"] = language_code
        return pad

    def pad_property_changed(self, pad: Pad, name: str, value) -> None:
        if name == "language-code":
            for req in self._requests:
                if req["pad"] is pad:
                    req["language"] = value

    def _build(self) -> None:
        if self._built:
            return
        self._built = True
        base = self.get_property("language-code").split("-")[0]
        translated = any(r["language"] is not None and r["language"].split("-")[0] != base
                         for r in self._requests)
        if post_missing_factory(self, self.get_property("transcriber"), "transcriber") or (
                translated and post_missing_factory(
                    self, self.get_property("translator"), "translator")):
            self.sinkpad.chain_function = lambda pad, buf: FlowReturn.ERROR
            self.sinkpad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
            return
        self._transcriber = element_factory_make(
            self.get_property("transcriber"), f"{self.name}-transcriber")
        for k, v in self._forwarded.items():
            self._transcriber.set_property(k, v)
        self._children = [self._transcriber]
        self.sinkpad.chain_function = (
            lambda pad, buf: self._transcriber.sink_pads()[0].chain(buf))
        self.sinkpad.event_function = (
            lambda pad, ev: self._transcriber.sink_pads()[0].send_event(ev))

        # tee semantics: transcriber src fans out to each request branch
        branches = []
        for req in self._requests:
            lang = req["language"]
            outer = req["pad"]
            if lang is None or lang.split("-")[0] == \
                    self.get_property("language-code").split("-")[0]:
                translator = None  # passthrough branch (same language)
            else:
                translator = element_factory_make(
                    self.get_property("translator"),
                    f"{self.name}-translate-{outer.name}")
                translator.set_property("input-language-code",
                                        self.get_property("language-code").split("-")[0])
                translator.set_property("output-language-code", lang.split("-")[0])
                for k, v in req["translator_props"].items():
                    translator.set_property(k, v)
                self._children.append(translator)
            outer._props["translator"] = translator
            branches.append((translator, outer))

        def fanout_chain(pad: Pad, buf: Buffer) -> FlowReturn:
            # the always src pad carries the untranslated transcript
            if self.srcpad.peer is not None:
                ret = self.srcpad.push(buf)
                if ret not in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                    return ret
            for translator, outer in branches:
                if translator is None:
                    ret = outer.push(buf)
                else:
                    ret = translator.sink_pads()[0].chain(buf)
                if ret not in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                    return ret
            return FlowReturn.OK

        def fanout_event(pad: Pad, ev) -> bool:
            if self.srcpad.peer is not None:
                self.srcpad.push_event(ev)
            for translator, outer in branches:
                if translator is None:
                    outer.push_event(ev)
                else:
                    translator.sink_pads()[0].send_event(ev)
            return True

        inner = Pad("tee_inner", PadDirection.SINK,
                    PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        inner.element = self
        inner.chain_function = fanout_chain
        inner.event_function = fanout_event
        tsrc = self._transcriber.src_pads()[0]
        tsrc.peer = inner
        inner.peer = tsrc

        # each translator's src forwards to its outer pad
        for translator, outer in branches:
            if translator is None:
                continue
            out_inner = Pad(f"{outer.name}_inner", PadDirection.SINK,
                            PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS,
                                        Caps.new_any()))
            out_inner.element = self
            out_inner.chain_function = (
                lambda pad, buf, outer=outer: outer.push(buf))
            out_inner.event_function = (
                lambda pad, ev, outer=outer: outer.push_event(ev))
            src = translator.src_pads()[0]
            src.peer = out_inner
            out_inner.peer = src

    def on_ready_to_paused(self) -> None:
        from ...core.element import State

        self._build()
        for c in self._children:
            c.set_state(State.PAUSED)

    def on_paused_to_playing(self) -> None:
        from ...core.element import State

        for c in self._children:
            c.set_state(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        from ...core.element import State

        for c in self._children:
            c.set_state(State.READY)
