"""transcriberbin: transcribe audio and inject closed captions into video.

Parity target: video/closedcaption/src/transcriberbin/imp.rs (3 942 LoC).
Reference topology per audio stream (imp.rs:500-607): transcriber ->
textwrap(lines=2) -> tttocea608|tttocea708 -> ccconverter -> ccmux ->
cccombiner, which attaches the caption data to the video buffers as
VideoCaptionMeta; audio and video both pass through on their own src
pads.  This rebuild composes the same in-repo elements around an internal
caption combiner (ccconverter/cccombiner are external C elements in the
reference's world — here their role is the meta-attach step below).

Property surface (imp.rs:21-37 defaults):
  passthrough (false, mutable playing — bypasses transcription),
  latency (4 s), lateness (0), translate-latency (500 ms),
  accumulate-time (0), mode (roll-up2), caption-source (both),
  input-lang-code (en-US), mux-method (cea608).

caption-source semantics (CaptionSource, imp.rs:21): `inband` keeps only
pre-existing VideoCaptionMeta on the incoming video; `transcription`
strips inband metas and attaches only transcribed captions; `both`
merges.

Pads: sink_audio / sink_video in, src_audio / src_video out
(imp.rs:2616-2640) — audio passes through, video carries captions.

Downstream rendering: cea608overlay consumes the attached
VideoCaptionMeta directly (cea608overlay/imp.rs:264-285 model).

The default transcriber is whispertranscriber, which needs `model-path`
(same model gating as the reference's whisper.cpp models).  Properties
prefixed `transcriber::` are forwarded to the transcriber (child-proxy
analog).  Multi-language translation channels live in translationbin.

The port: the bin builds its children by factory name when it goes to
PAUSED.  Where a factory it needs is not registered in the port (the
default translator `awstranslate` and `awstranscriber` belong to a slice
still to come), the bin posts an ERROR message on the bus that names the
factory, builds nothing, and answers every buffer with FlowReturn.ERROR;
audio and video events pass on.  Caption bytes are host numpy arrays;
audio and video payloads pass through as they came (tensors on the card
stay there).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    SECOND,
    VideoCaptionMeta,
    register,
)
from ...core.caps import Structure
from ...core.events import Message, MessageType
from ...core.payload import host_bytes
from ...core.registry import element_factory_make, factory_exists

MS = SECOND // 1000


def post_missing_factory(element: Element, factory: str, role: str) -> bool:
    """True, after an ERROR message on the bus naming it, when `factory`
    is not registered in the port."""
    if factory_exists(factory):
        return False
    element.post_message(Message(
        MessageType.ERROR,
        structure=Structure(
            "error", element=element.name, factory=factory,
            reason=f"missing {role} factory {factory!r}")))
    return True


@register
class TranscriberBin(Element):
    ELEMENT_NAME = "transcriberbin"
    ELEMENT_CLASS = "Audio/Video/Text/Bin"
    ELEMENT_DESCRIPTION = "Transcribes audio and muxes captions into video"
    PROPERTIES = [
        Prop("transcriber", "whispertranscriber", type="str",
             doc="factory name of the transcriber element"),
        Prop("passthrough", False, type="bool", mutable="playing",
             doc="bypass transcription; video and audio pass unchanged"),
        Prop("latency", 4 * SECOND, type="uint64", doc="transcription latency"),
        Prop("lateness", 0, type="uint64", doc="shift captions later by this"),
        Prop("translate-latency", 500 * MS, type="uint64"),
        Prop("accumulate-time", 0, type="uint64",
             doc="text accumulation window before caption encoding"),
        Prop("mode", "roll-up2", type="enum",
             choices=["pop-on", "paint-on", "roll-up2", "roll-up3", "roll-up4"]),
        Prop("caption-source", "both", type="enum",
             choices=["inband", "transcription", "both"]),
        Prop("input-lang-code", "en-US", type="str"),
        Prop("mux-method", "cea608", type="enum", choices=["cea608", "cea708"]),
        Prop("cc-caps", None, type="object",
             doc="expected closed-caption format as caps "
                 "(closedcaption/x-cea-608 or x-cea-708); setting this "
                 "drives mux-method"),
        Prop("translation-languages", "", type="str",
             doc="per-language caption channels 'lang=cc1,lang=cc3' "
                 "(parse_language_pair analog, transcriberbin/imp.rs:70-120; "
                 "languages other than input-lang-code get a translator); "
                 "'' = transcript on cc1 only"),
        Prop("translator", "awstranslate", type="str",
             doc="factory name of the per-language translator element"),
    ]
    # GstTranscriberSinkPad surface (reference rsclosedcaption other-types;
    # transcriberbin/imp.rs sink-pad ParamSpecs).  This bin carries one
    # audio channel, so the pad properties alias the element-level ones
    # where an element property exists and hold per-channel config
    # otherwise.
    PAD_PROPERTIES = {
        "sink_audio": [
            Prop("language-code", "en-US", type="str", mutable="playing",
                 doc="input language (aliases input-lang-code)"),
            Prop("mode", "roll-up2", type="enum",
                 choices=["pop-on", "paint-on", "roll-up2", "roll-up3",
                          "roll-up4"], mutable="playing",
                 doc="caption mode (aliases the element property)"),
            Prop("passthrough", False, type="bool", mutable="playing",
                 doc="bypass transcription (aliases the element property)"),
            Prop("translation-languages", "", type="str", mutable="playing",
                 doc="per-language caption channels (aliases the element "
                     "property)"),
            Prop("transcriber", None, type="object", mutable="ready",
                 doc="a transcriber ELEMENT INSTANCE to use instead of "
                     "constructing one from the factory-name property"),
            Prop("language-filters", None, type="object", mutable="ready",
                 doc="map of language codes to filter bin descriptions "
                     "applied to that language's text branch"),
            Prop("subtitle-languages", None, type="object", mutable="ready",
                 doc="map of language codes to subtitle output config"),
            Prop("synthesis-languages", None, type="object", mutable="ready",
                 doc="map of language codes to speech-synthesis config "
                     "(synthesis channels are not wired in this bin; "
                     "see IGNORED_PADS rationale)"),
            Prop("transcription-mix-matrix", None, type="object",
                 mutable="ready",
                 doc="initial mix matrix for the transcriber's input "
                     "audioconvert (applied as channel weights)"),
        ],
    }

    def pad_property_changed(self, pad, name: str, value) -> None:
        if pad is not getattr(self, "audio_pad", None):
            return
        alias = {"language-code": "input-lang-code", "mode": "mode",
                 "passthrough": "passthrough",
                 "translation-languages": "translation-languages"}
        if name in alias:
            self.set_property(alias[name], value)
        elif name == "transcriber" and value is not None:
            self._transcriber_override = value

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        any_t = lambda n, d: PadTemplate(n, d, PadPresence.ALWAYS, Caps.new_any())
        self.audio_pad = self.add_pad(
            Pad("sink_audio", PadDirection.SINK, any_t("sink_audio", PadDirection.SINK)))
        self.video_pad = self.add_pad(
            Pad("sink_video", PadDirection.SINK, any_t("sink_video", PadDirection.SINK)))
        # video src first so Element.link / textual pipelines pick the
        # video path by default (`transcriberbin ! cea608overlay`)
        self.video_srcpad = self.add_pad(
            Pad("src_video", PadDirection.SRC, any_t("src_video", PadDirection.SRC)))
        self.audio_srcpad = self.add_pad(
            Pad("src_audio", PadDirection.SRC, any_t("src_audio", PadDirection.SRC)))
        # "src" alias kept for src_video so `transcriberbin ! cea608overlay`
        # textual pipelines link the video path by default
        self.srcpad = self.video_srcpad
        # raw transcript text as it leaves the transcriber, before caption
        # encoding and video-clock synchronization (the reference ghost-pads
        # the transcriber's unsynced pads, imp.rs:2975-2980)
        self.unsynced_srcpad = self.add_pad(
            Pad("unsynced_src", PadDirection.SRC,
                PadTemplate("unsynced_src", PadDirection.SRC,
                            PadPresence.SOMETIMES,
                            Caps.builder("text/x-raw"))))
        self._children = []
        self._transcriber = None
        self._built = False
        self._forwarded_props = {}
        # bounded so a stalled/absent video branch cannot leak forever
        self._pending_cc = deque(maxlen=512)  # (pts, ctype, bytes, field)
        # route caps queries per stream (audio sink <-> audio src, video
        # sink <-> video src) — the element-level default would proxy every
        # sink to the FIRST src pad
        self.audio_pad.query_function = self._proxy_caps(self.audio_srcpad)
        self.video_pad.query_function = self._proxy_caps(self.video_srcpad)
        # downstream latency queries arrive at the src pads: forward
        # upstream through the matching sink pad and add the transcription
        # latency property (imp.rs latency reporting)
        self.video_srcpad.query_function = self._src_query_for(self.video_pad)
        self.audio_srcpad.query_function = self._src_query_for(self.audio_pad)

    def _src_query_for(self, sinkpad: Pad):
        from ...core import QueryType

        def q(pad: Pad, query) -> bool:
            if query.type == QueryType.LATENCY:
                if sinkpad.peer is not None:
                    sinkpad.peer_query(query)
                query.result.setdefault("live", False)
                lat = self.get_property("latency")
                query.result["min_latency"] = (
                    query.result.get("min_latency", 0) + lat)
                if query.result.get("max_latency") is not None:
                    query.result["max_latency"] += lat
                return True
            return self._default_query(pad, query)

        return q

    def _proxy_caps(self, srcpad: Pad):
        from ...core import QueryType

        def q(pad: Pad, query) -> bool:
            if query.type == QueryType.CAPS:
                tmpl = pad.pad_template_caps()
                if srcpad.peer is not None:
                    query.result["caps"] = srcpad.peer_query_caps(tmpl)
                else:
                    query.result["caps"] = tmpl
                return True
            return self._default_query(pad, query)

        return q

    def set_property(self, name: str, value) -> None:
        if name.startswith("transcriber::"):
            self._forwarded_props[name.split("::", 1)[1]] = value
            if self._transcriber is not None:
                self._transcriber.set_property(name.split("::", 1)[1], value)
            return
        super().set_property(name, value)
        if name == "cc-caps" and value is not None:
            caps = value
            if isinstance(caps, str):
                from ...core.parse import parse_caps

                caps = parse_caps(caps)
                self._props["cc-caps"] = caps
            self._props["mux-method"] = \
                "cea708" if "708" in caps.structure(0).name else "cea608"

    # -- graph construction -------------------------------------------------
    def _missing_factory(self, factory: str, role: str) -> bool:
        """True, after an ERROR message naming it, when `factory` is not
        registered; the bin then fails every buffer."""
        if not post_missing_factory(self, factory, role):
            return False
        fail = lambda pad, buf: FlowReturn.ERROR  # noqa: E731
        self.audio_pad.chain_function = self.video_pad.chain_function = fail
        self.audio_pad.event_function = lambda pad, ev: self.audio_srcpad.push_event(ev)
        self.video_pad.event_function = self._video_event
        return True

    def _build(self) -> None:
        if self._built:
            return
        self._built = True
        override = getattr(self, "_transcriber_override", None)
        if override is None and self._missing_factory(
                self.get_property("transcriber"), "transcriber"):
            return
        self._transcriber = override if override is not None else \
            element_factory_make(
                self.get_property("transcriber"), f"{self.name}-transcriber")
        for k, v in self._forwarded_props.items():
            self._transcriber.set_property(k, v)
        if "language-code" in self._transcriber._props and \
                "language-code" not in self._forwarded_props:
            try:
                self._transcriber.set_property(
                    "language-code", self.get_property("input-lang-code"))
            except Exception:
                pass
        mux_method = self.get_property("mux-method")
        self._children = [self._transcriber]

        def _cc_caps_query(pad, query):
            from ...core import QueryType

            if query.type == QueryType.CAPS:
                query.result["caps"] = pad.pad_template_caps()
                return True
            return False

        def make_channel(tag: str, field: int, translator_lang: Optional[str]):
            """textwrap -> tttoceaX08 -> collector; optional translator up
            front (CaptionChannel, transcriberbin/imp.rs:500-607)."""
            chain = []
            if translator_lang is not None:
                tr = element_factory_make(
                    self.get_property("translator"),
                    f"{self.name}-translate-{translator_lang}")
                try:
                    tr.set_property("output-language-code", translator_lang)
                    tr.set_property(
                        "input-language-code",
                        self.get_property("input-lang-code").split("-")[0])
                except KeyError:
                    pass  # translator without language props (e.g. identity)
                chain.append(tr)
            wrap = element_factory_make("textwrap", f"{self.name}-wrap-{tag}")
            wrap.set_property("lines", 2)  # reference textwrap lines=2
            chain.append(wrap)
            if mux_method == "cea708":
                toccx = element_factory_make(
                    "tttocea708", f"{self.name}-to708-{tag}")
            else:
                toccx = element_factory_make(
                    "tttocea608", f"{self.name}-to608-{tag}")
                toccx.set_property("mode", self.get_property("mode"))
            chain.append(toccx)
            for a, b in zip(chain, chain[1:]):
                a.link(b)
            ccsink = Pad(f"cc_collect_{tag}", PadDirection.SINK,
                         PadTemplate("cc_collect", PadDirection.SINK,
                                     PadPresence.ALWAYS, Caps.new_any()))
            ccsink.element = self
            ccsink.chain_function = (
                lambda pad, buf, f=field: self._cc_chain(pad, buf, f))
            ccsink.event_function = lambda pad, ev: True
            ccsink.query_function = _cc_caps_query
            src = chain[-1].src_pads()[0]
            src.peer = ccsink
            ccsink.peer = src
            self._children.extend(chain)
            return chain[0].sink_pads()[0]

        # parse translation-languages 'lang=cc1,lang=cc3'
        spec = self.get_property("translation-languages")
        channels: list = []
        input_base = self.get_property("input-lang-code").split("-")[0]
        if spec:
            for part in spec.split(","):
                lang, _, cc = part.strip().partition("=")
                cc = (cc or "cc1").lower()
                if cc not in ("cc1", "cc3"):
                    raise ValueError(
                        f"{self.name}: unknown 608 channel {cc!r} "
                        "(valid: cc1, cc3)")
                field = 1 if cc == "cc1" else 2
                needs_tr = lang.split("-")[0] != input_base
                channels.append((lang, field, lang if needs_tr else None))
        else:
            channels.append((input_base, 1, None))
        if any(tr is not None for _, _, tr in channels) and self._missing_factory(
                self.get_property("translator"), "translator"):
            self._children = [self._transcriber]
            return
        fanout = [make_channel(f"{lang}", field, tr)
                  for lang, field, tr in channels]

        # audio -> transcriber -> (fan out to every caption channel)
        self.audio_pad.chain_function = self._audio_chain
        self.audio_pad.event_function = self._audio_event
        tsrc = self._transcriber.src_pads()[0]
        tee = Pad("cc_tee", PadDirection.SINK,
                  PadTemplate("cc_tee", PadDirection.SINK,
                              PadPresence.ALWAYS, Caps.new_any()))
        tee.element = self
        tee.chain_function = lambda pad, buf: self._tee_chain(fanout, buf)
        def tee_event(pad, ev):
            if self.unsynced_srcpad.peer is not None:
                self.unsynced_srcpad.push_event(ev)
            return all([p.send_event(ev) for p in fanout]) or True
        tee.event_function = tee_event
        tee.query_function = _cc_caps_query
        tsrc.peer = tee
        tee.peer = tsrc
        for c in self._children:
            c.parent = self.parent

        self.video_pad.chain_function = self._video_chain
        self.video_pad.event_function = self._video_event

    def _tee_chain(self, fanout, buf: Buffer) -> FlowReturn:
        ret = FlowReturn.OK
        if self.unsynced_srcpad.peer is not None:
            self.unsynced_srcpad.push(buf)
        for pad in fanout:
            r = pad.chain(buf)
            if r != FlowReturn.OK:
                ret = r
        return ret

    # -- audio path ---------------------------------------------------------
    def _audio_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if not self.get_property("passthrough"):
            self._transcriber.sink_pads()[0].chain(buf)
        return self.audio_srcpad.push(buf)

    def _audio_event(self, pad: Pad, ev: Event) -> bool:
        if not self.get_property("passthrough"):
            self._transcriber.sink_pads()[0].send_event(ev)
        return self.audio_srcpad.push_event(ev)

    # -- caption collection ---------------------------------------------------
    def _cc_chain(self, pad: Pad, buf: Buffer, field: int = 1) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        ctype = ("cea708-raw" if self.get_property("mux-method") == "cea708"
                 else "cea608-raw")
        pts = buf.pts
        if pts is not None:
            pts += self.get_property("lateness")
        self._pending_cc.append((pts, ctype, data, field))
        return FlowReturn.OK

    # -- video path (the cccombiner role: attach caption meta) ---------------
    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        source = self.get_property("caption-source")
        if self.get_property("passthrough"):
            return self.video_srcpad.push(buf)
        out = Buffer(buf.data, pts=buf.pts, duration=buf.duration,
                     offset=buf.offset, offset_end=buf.offset_end)
        out.copy_metadata_from(buf)
        if source == "transcription":
            out.metas = [m for m in out.metas
                         if not isinstance(m, VideoCaptionMeta)]
        if source == "inband":
            self._pending_cc.clear()  # transcription output is unused
        if source in ("transcription", "both"):
            end = None
            if buf.pts is not None and buf.duration is not None:
                end = buf.pts + buf.duration
            chunks = []  # (data, field)
            ctype = None
            while self._pending_cc:
                pts, t, data, fld = self._pending_cc[0]
                if end is not None and pts is not None and pts >= end:
                    break
                self._pending_cc.popleft()
                chunks.append((data, fld))
                ctype = t
            if chunks:
                if ctype == "cea608-raw" and any(f == 2 for _, f in chunks):
                    # cc3 channels ride field 2: S334-1A triplets with the
                    # field marker byte (0x80 = field 1)
                    tri = bytearray()
                    for data, fld in chunks:
                        marker = 0x80 if fld == 1 else 0x00
                        for i in range(0, len(data) - 1, 2):
                            tri += bytes((marker, data[i], data[i + 1]))
                    out.add_meta(VideoCaptionMeta("cea608-s334-1a", bytes(tri)))
                else:
                    out.add_meta(VideoCaptionMeta(
                        ctype, b"".join(d for d, _ in chunks)))
        return self.video_srcpad.push(out)

    def _video_event(self, pad: Pad, ev: Event) -> bool:
        return self.video_srcpad.push_event(ev)

    # -- lifecycle -----------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        from ...core.element import State

        self._build()
        self._pending_cc.clear()
        for c in self._children:
            c.parent = self.parent
            c.set_state(State.PAUSED)

    def on_paused_to_playing(self) -> None:
        from ...core.element import State

        for c in self._children:
            c.set_state(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        from ...core.element import State

        for c in self._children:
            c.set_state(State.READY)

    def latency_additional_ns(self) -> int:
        return self.get_property("latency")


__all__ = ["TranscriberBin"]
