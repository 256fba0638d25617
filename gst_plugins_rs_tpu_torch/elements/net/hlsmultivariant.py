"""hlsmultivariantsink: HLS multivariant (master) playlist sink.

Parity target: net/hlsmultivariantsink/src/imp.rs.  Request pads named
`audio_%u`/`video_%u` each carry one pre-muxed stream; the pad is
configured with a `variant` or `alternate-rendition` structure (a dict
here, a gst::Structure in the reference, imp.rs:738-925):

- variant: {uri, bandwidth, codecs?, audio?, video?, is-i-frame?} — an
  EXT-X-STREAM-INF entry.  Two pads given the SAME uri share one inner
  sink (muxed audio+video variant, imp.rs:829-838).
- alternate-rendition: {media_type?, uri, group_id, name, language?,
  default?, autoselect?, forced?} — an EXT-X-MEDIA entry (one rendition
  per inner sink; muxed A/V renditions are unsupported, imp.rs:164-171).

Paths follow the reference's two modes (imp.rs:586-620): when the pad's
`playlist-location`/`segment-location` (+ `init-segment-location` for
cmaf) are set they are used verbatim (absolute mode, all-or-nothing);
otherwise everything is derived relative to the multivariant playlist
location from the structure's `uri`, which must then contain a
directory component ("hi/video.m3u8" → "<master dir>/hi/video.m3u8" +
"<master dir>/hi/segment%05d.m4s").

Validation at READY→PAUSED (imp.rs:1798-1859): at least one variant;
every rendition's group_id must be referenced by some variant's
audio/video attribute; rendition names must be unique.

The multivariant playlist is EXT-X-VERSION 6 for cmaf, 4 for mpegts
(imp.rs:1874-1878).  Each variant/rendition runs an in-repo hlssink3
byte-stream segmenter underneath, mirroring the reference's hlscmafsink/
hlssink3 children.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

from ...core import (
    Caps,
    Element,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...net import hls
from .hlssink import DEFAULT_TARGET_DURATION, HlsSink3

DEFAULT_INIT_LOCATION = "init%05d.mp4"
DEFAULT_CMAF_LOCATION = "segment%05d.m4s"
DEFAULT_TS_LOCATION = "segment%05d.ts"


class HlsMultivariantSinkPad(Pad):
    """Request pad carrying per-stream configuration, the analog of the
    reference's pad properties (imp.rs:707-735)."""

    def __init__(self, name: str, template: PadTemplate, element):
        super().__init__(name, PadDirection.SINK, template)
        self._owner = element
        self._settings: Dict[str, Optional[str]] = {
            "playlist-location": None,
            "init-segment-location": None,
            "segment-location": None,
        }
        self._structure: Optional[dict] = None
        self._kind: Optional[str] = None
        self.sink: Optional[HlsSink3] = None

    def set_property(self, name: str, value) -> None:
        if name in ("variant", "alternate-rendition"):
            self._kind = name
            self._structure = dict(value)
            self._owner._configure_pad(self, name, self._structure)
        elif name in self._settings:
            self._settings[name] = value
            if self.sink is not None:
                target = {"playlist-location": "playlist-location",
                          "init-segment-location": "init-location",
                          "segment-location": "location"}[name]
                self.sink.set_property(target, value)
        else:
            raise KeyError(f"{self.name}: unknown pad property {name!r}")

    def get_property(self, name: str):
        if name in ("variant", "alternate-rendition"):
            return dict(self._structure) if self._structure else None
        return self._settings[name]


@register
class HlsMultivariantSink(Element):
    ELEMENT_NAME = "hlsmultivariantsink"
    ELEMENT_CLASS = "Sink/Muxer"
    ELEMENT_DESCRIPTION = "HTTP Live Streaming sink"
    SIGNALS = {
        "get-init-stream": None,
        "get-fragment-stream": None,
        "get-playlist-stream": None,
        "get-multivariant-playlist-stream": None,
        "delete-fragment": None,
    }
    # HlsMultivariantSinkPad surface (reference hlsmultivariantsink
    # other-types; imp.rs:707-735).  HlsMultivariantSinkPad.set_property
    # implements the behavior; this declaration makes the surface
    # introspectable (registry pad-properties + parity audit).
    PAD_PROPERTIES = {
        kind: [
            Prop("variant", None, type="object", mutable="ready",
                 doc="variant-stream structure: {uri, bandwidth, codecs?, "
                     "audio?, video?, is-i-frame?}"),
            Prop("alternate-rendition", None, type="object", mutable="ready",
                 doc="EXT-X-MEDIA structure: {media_type?, uri, group_id, "
                     "name, language?, default?, autoselect?, forced?}"),
            Prop("playlist-location", None, type="str", mutable="ready",
                 doc="media playlist path for this stream"),
            Prop("init-segment-location", None, type="str", mutable="ready",
                 doc="CMAF init segment path for this stream"),
            Prop("segment-location", None, type="str", mutable="ready",
                 doc="media segment path pattern for this stream"),
        ]
        for kind in ("audio", "video")
    }
    PROPERTIES = [
        Prop("playlist-location", "master.m3u8", type="str"),
        Prop("multivariant-playlist-location", "", type="str",
             doc="reference name for playlist-location (kept in sync)"),
        Prop("variant-playlist-pattern", "variant%u.m3u8", type="str",
             doc="legacy attribute-kwargs pads: per-variant playlist path"),
        Prop("segment-pattern", "variant%u_segment%%05d.m4s", type="str",
             doc="legacy attribute-kwargs pads: per-variant segment path"),
        Prop("target-duration", DEFAULT_TARGET_DURATION, type="uint", minimum=1),
        Prop("playlist-length", 5, type="uint"),
        Prop("max-files", 10, type="uint"),
        Prop("playlist-type", "unspecified", type="enum",
             choices=["unspecified", "event", "vod"]),
        Prop("muxer-type", "cmaf", type="enum", choices=["cmaf", "mpegts"],
             doc="segment container for the variants (selects the default "
                 "segment suffix; variants take pre-muxed byte streams)"),
        Prop("send-keyframe-requests", True, type="bool"),
    ]
    EXTRA_PAD_TEMPLATES = [
        ("audio_%u", "sink", "request", "ANY"),
        ("video_%u", "sink", "request", "ANY"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "multivariant-playlist-location" and value:
            self._props["playlist-location"] = value
        elif name == "playlist-location":
            self._props["multivariant-playlist-location"] = value

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._variants: List[hls.Variant] = []
        self._alternatives: List[hls.AlternativeMedia] = []
        self._sinks: List[HlsSink3] = []
        self._sink_by_uri: Dict[str, HlsSink3] = {}
        self._pad_count = {"audio": 0, "video": 0, "sink": 0}

    # -- pads -----------------------------------------------------------------
    def request_pad(self, template_name: str = "video_%u") -> Pad:
        media = template_name.split("_")[0]
        if media not in ("audio", "video"):
            media = "video"
        n = self._pad_count[media]
        self._pad_count[media] += 1
        pad = HlsMultivariantSinkPad(
            f"{media}_{n}",
            PadTemplate(f"{media}_%u", PadDirection.SINK, PadPresence.REQUEST,
                        Caps.new_any()),
            self,
        )
        return self.add_pad(pad)

    def request_sink_pad(self, name: Optional[str] = None, *, bandwidth: int = 0,
                         width: int = 0, height: int = 0, codecs: str = "") -> Pad:
        """Legacy convenience: a video variant configured from the
        variant-playlist-pattern/segment-pattern element properties."""
        idx = self._pad_count["sink"]
        self._pad_count["sink"] += 1
        pad = self.request_pad("video_%u")
        pattern = self.get_property("variant-playlist-pattern")
        pad.set_property("playlist-location", pattern.replace("%u", str(idx)))
        seg = self.get_property("segment-pattern") \
            .replace("%u", str(idx)).replace("%%", "%")
        if self.get_property("muxer-type") == "mpegts" and seg.endswith(".m4s"):
            seg = seg[:-4] + ".ts"
        pad.set_property("segment-location", seg)
        pad.set_property("init-segment-location",
                         os.path.join(os.path.dirname(seg) or ".",
                                      DEFAULT_INIT_LOCATION))
        pad.set_property("variant", {
            "uri": pattern.replace("%u", str(idx)),
            "bandwidth": bandwidth or 1_000_000,
            "width": width, "height": height, "codecs": codecs,
        })
        return pad

    # -- per-pad configuration (imp.rs:738-925) ---------------------------------
    def _new_inner(self, label: str) -> HlsSink3:
        inner = HlsSink3(f"{self.name}-{label}")
        for prop in ("target-duration", "playlist-length", "max-files",
                     "playlist-type", "send-keyframe-requests"):
            inner.set_property(prop, self.get_property(prop))
        inner.parent = self.parent
        # route the child's stream-request signals through this element
        for sig in ("get-init-stream", "get-fragment-stream",
                    "get-playlist-stream", "delete-fragment"):
            handler = self.signal_handler(sig)
            if handler is not None and sig in inner._all_signals():
                inner.connect(sig, handler)
        self._sinks.append(inner)
        return inner

    def _setup_paths(self, pad: HlsMultivariantSinkPad, inner: HlsSink3,
                     uri: str) -> None:
        settings = pad._settings
        if any(settings.values()):
            # absolute mode: all paths must be given (imp.rs:474-518)
            missing = [k for k in ("playlist-location", "segment-location")
                       if not settings[k]]
            if self.get_property("muxer-type") == "cmaf" \
                    and not settings["init-segment-location"]:
                missing.append("init-segment-location")
            if missing:
                raise ValueError(
                    f"{self.name}: absolute paths need every location set, "
                    f"missing {missing}")
            inner.set_property("playlist-location", settings["playlist-location"])
            inner.set_property("location", settings["segment-location"])
            if settings["init-segment-location"]:
                inner.set_property("init-location",
                                   settings["init-segment-location"])
            return
        # relative mode: derive everything from the master location + uri
        master = self.get_property("playlist-location")
        root = os.path.dirname(master)
        playlist = os.path.join(root, uri) if root else uri
        seg_root = os.path.dirname(playlist)
        if not seg_root:
            raise ValueError(
                f"{self.name}: uri {uri!r} must be relative to the "
                "multivariant playlist (needs a directory component)")
        inner.set_property("playlist-location", playlist)
        if self.get_property("muxer-type") == "cmaf":
            inner.set_property("init-location",
                               os.path.join(seg_root, DEFAULT_INIT_LOCATION))
            inner.set_property("location",
                               os.path.join(seg_root, DEFAULT_CMAF_LOCATION))
        else:
            inner.set_property("location",
                               os.path.join(seg_root, DEFAULT_TS_LOCATION))
        os.makedirs(seg_root, exist_ok=True)

    def _configure_pad(self, pad: HlsMultivariantSinkPad, kind: str,
                       s: dict) -> None:
        uri = s.get("uri")
        if not uri:
            raise ValueError(f"{self.name}: {kind} needs a uri")
        if kind == "variant":
            if "bandwidth" not in s:
                raise ValueError(f"{self.name}: variant needs a bandwidth")
            inner = self._sink_by_uri.get(uri)
            muxed = inner is not None
            if not muxed:
                inner = self._new_inner(f"variant-{uri.replace('/', '_')}")
                self._setup_paths(pad, inner, uri)
                self._sink_by_uri[uri] = inner
                self._variants.append(hls.Variant(
                    uri, int(s["bandwidth"]),
                    int(s.get("width", 0)), int(s.get("height", 0)),
                    s.get("codecs") or "",
                    audio=s.get("audio") or "", video=s.get("video") or "",
                    is_i_frame=bool(s.get("is-i-frame", False)),
                ))
            if self.get_property("muxer-type") == "mpegts" \
                    and pad.name.startswith("video") and s.get("is-i-frame"):
                inner.set_property("i-frames-only", True)
        else:  # alternate-rendition
            inner = self._new_inner(f"rendition-{uri.replace('/', '_')}")
            self._setup_paths(pad, inner, uri)
            self._alternatives.append(hls.AlternativeMedia(
                media_type=s.get("media_type", "audio"),
                group_id=s["group_id"],
                name=s["name"],
                uri=uri,
                language=s.get("language") or "",
                default=bool(s.get("default", False)),
                autoselect=bool(s.get("autoselect", False)),
                forced=bool(s.get("forced", False)),
            ))
        pad.sink = inner
        pad.chain_function = lambda p, buf, s_=inner: s_.sinkpad.chain(buf)
        pad.event_function = lambda p, ev, s_=inner: s_.sinkpad.send_event(ev)

    # -- validation + master playlist ----------------------------------------------
    def _validate(self) -> None:
        if not self._variants:
            raise ValueError(f"{self.name}: empty variant stream")
        audio_groups = {v.audio for v in self._variants if v.audio}
        video_groups = {v.video for v in self._variants if v.video}
        for alt in self._alternatives:
            groups = audio_groups if alt.media_type == "audio" else video_groups
            if alt.group_id not in groups:
                raise ValueError(
                    f"{self.name}: no matching GROUP-ID {alt.group_id!r} "
                    "for alternate rendition in variant stream")
        names = [a.name for a in self._alternatives]
        if len(set(names)) < len(names):
            raise ValueError(
                f"{self.name}: duplicate NAME not allowed in alternate "
                "rendition")

    def _write_master(self) -> None:
        version = 6 if self.get_property("muxer-type") == "cmaf" else 4
        content = hls.master_playlist(self._variants, self._alternatives,
                                      version=version)
        path = self.get_property("playlist-location")
        handler = self.signal_handler("get-multivariant-playlist-stream")
        if handler is not None:
            stream = handler(self, path)
            if stream is not None:
                stream.write(content.encode())
                return
        hls.write_atomic(path, content)

    # -- state ------------------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        from ...core.element import State

        self._validate()
        for s in self._sinks:
            s.parent = self.parent
            s.set_state(State.PAUSED)
        self._write_master()

    def on_paused_to_playing(self) -> None:
        from ...core.element import State

        for s in self._sinks:
            s.set_state(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        from ...core.element import State

        for s in self._sinks:
            s.set_state(State.READY)


__all__ = ["HlsMultivariantSink", "HlsMultivariantSinkPad"]
