"""dashsink2: DASH sink writing fragmented-MP4 representations + MPD.

Parity target: net/dashsink2 (dashsink2/imp.rs:37; props mpd-root-path,
mpd-filename, target-duration, imp.rs:132-175).  Like hlscmafsink, each
request pad embeds a DASHMP4Mux: the muxer's header buffer becomes the
representation's init segment and each fragment a media segment; at EOS a
static-profile MPD is written with one AdaptationSet per media type
(SegmentTemplate with SegmentTimeline).
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ...core import (
    Buffer,
    BufferFlags,
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
    SECOND,
    register,
)
from ...core.element import State
from ...core.payload import host_bytes
from ..mux.isobmff import _SINK_CAPS as MUX_SINK_CAPS, DASHMP4Mux


class _Representation:
    def __init__(self, idx: int, mux: DASHMP4Mux):
        self.idx = idx
        self.mux = mux
        self.kind = "audio"
        self.init_written = False
        self.seg_index = 1  # DASH segment numbers are 1-based
        self.segments: List[int] = []  # durations in ns
        self.acc = bytearray()
        self.acc_dur = 0
        self.bandwidth = 128000
        self.caps_fields = {}


@register
class DashSink2(Element):
    ELEMENT_NAME = "dashsink2"
    ELEMENT_CLASS = "Sink/Muxer"
    SIGNALS = {
        # request signals: the app supplies a writable file-like object
        # for each artifact instead of this sink opening files itself
        "get-init-stream": None,
        "get-segment-stream": None,
        "get-manifest-stream": None,
    }
    ELEMENT_DESCRIPTION = "DASH sink writing fMP4 representations and an MPD"
    EXTRA_PAD_TEMPLATES = [
        ("audio_%u", "sink", "request", "ANY"),
        ("video_%u", "sink", "request", "ANY"),
    ]
    PROPERTIES = [
        Prop("mpd-root-path", ".", type="str"),
        Prop("mpd-filename", "manifest.mpd", type="str"),
        Prop("target-duration", 4, type="uint", minimum=1, doc="segment seconds"),
        Prop("dynamic", False, type="bool",
             doc="write a dynamic (live) MPD instead of static; the MPD is "
                 "rewritten after every segment"),
        Prop("minimum-update-period", 0, type="uint64",
             doc="ns between client MPD refreshes (dynamic MPDs; "
                 "0 = target-duration)"),
        Prop("min-buffer-time", 0, type="uint64",
             doc="ns of minBufferTime (0 = target-duration)"),
        Prop("utc-timing-url", None, type="str",
             doc="UTCTiming element with urn:mpeg:dash:utc:http-iso:2014"),
        Prop("latency", 0, type="uint64",
             doc="extra ns of latency to report downstream"),
        Prop("sync", False, type="bool",
             doc="accepted; segment writes follow the muxer output"),
    ]

    def latency_additional_ns(self) -> int:
        return self.get_property("latency")

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._reps: List[_Representation] = []
        self._eos_count = 0

    # -- pads ------------------------------------------------------------------
    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        idx = len(self._reps)
        mux = DASHMP4Mux(f"{self.name}-mux{idx}")
        rep = _Representation(idx, mux)
        self._reps.append(rep)
        pad = Pad(name or f"sink_{idx}", PadDirection.SINK,
                  PadTemplate("sink_%u", PadDirection.SINK, PadPresence.REQUEST, MUX_SINK_CAPS))
        mux_sink = mux.pad("sink")
        pad.chain_function = lambda p, buf: mux_sink.chain(buf)
        pad.event_function = lambda p, ev: self._sink_event(rep, ev)
        pad.query_function = lambda p, q: mux_sink.query(q)
        inner = Pad(f"inner_{idx}", PadDirection.SINK,
                    PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        inner.chain_function = lambda p, buf, r=rep: self._mux_output(r, buf)
        inner.event_function = lambda p, ev, r=rep: self._mux_event(r, ev)
        inner.element = self
        mux.srcpad.peer = inner
        inner.peer = mux.srcpad
        return self.add_pad(pad)

    def request_pad(self, template_name: str = "sink_%u") -> Pad:
        media = template_name.split("_")[0]
        if media in ("audio", "video"):
            n = sum(1 for p in self.sink_pads() if p.name.startswith(media))
            return self.request_sink_pad(f"{media}_{n}")
        return self.request_sink_pad()

    def _sink_event(self, rep: _Representation, event: Event) -> bool:
        if event.type == EventType.CAPS:
            s = event.get("caps").structure(0)
            rep.kind = "audio" if s.name.startswith("audio") else "video"
            rep.caps_fields = dict(s.fields)
            if rep.kind == "audio":
                rep.bandwidth = s.get("rate", 48000) * s.get("channels", 2) * 4 * 8
            else:
                rep.bandwidth = s.get("width", 1280) * s.get("height", 720) * 3
        return rep.mux.pad("sink").send_event(event)

    # -- state ----------------------------------------------------------------
    def _set_muxes(self, state: State) -> None:
        for rep in self._reps:
            rep.mux.set_state(state)

    def on_null_to_ready(self) -> None:
        for rep in self._reps:
            rep.mux.set_property(
                "fragment-duration", self.get_property("target-duration") * SECOND
            )
        self._set_muxes(State.READY)

    def on_ready_to_paused(self) -> None:
        self._set_muxes(State.PAUSED)
        self._eos_count = 0
        for rep in self._reps:
            rep.init_written = False
            rep.seg_index = 1
            rep.segments = []
            rep.acc = bytearray()
            rep.acc_dur = 0

    def on_paused_to_playing(self) -> None:
        self._set_muxes(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        self._set_muxes(State.READY)

    def on_ready_to_null(self) -> None:
        self._set_muxes(State.NULL)

    # -- segment/manifest writing ------------------------------------------------
    def _root(self) -> str:
        return self.get_property("mpd-root-path")

    def _open_out(self, signal: str, path: str, mode: str = "wb"):
        """get-*-stream request signals: a connected handler provides the
        output stream; otherwise a file opens at `path`."""
        handler = self.signal_handler(signal)
        if handler is not None:
            stream = handler(self, path)
            if stream is not None:
                return stream
        return open(path, mode)

    def _mux_output(self, rep: _Representation, buf: Buffer) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        if buf.has_flag(BufferFlags.HEADER):
            path = os.path.join(self._root(), f"init_{rep.idx}.mp4")
            with self._open_out("get-init-stream", path) as f:
                f.write(data)
            rep.init_written = True
            return FlowReturn.OK
        rep.acc += data
        rep.acc_dur += buf.duration or 0
        if not buf.has_flag(BufferFlags.DELTA_UNIT):
            self._write_segment(rep)
            if self.get_property("dynamic"):
                self._write_mpd()  # live profile: manifest tracks segments
        return FlowReturn.OK

    def _write_segment(self, rep: _Representation) -> None:
        if not rep.acc:
            return
        path = os.path.join(self._root(), f"seg_{rep.idx}_{rep.seg_index}.m4s")
        with self._open_out("get-segment-stream", path) as f:
            f.write(bytes(rep.acc))
        rep.segments.append(rep.acc_dur)
        rep.seg_index += 1
        rep.acc = bytearray()
        rep.acc_dur = 0

    def _mux_event(self, rep: _Representation, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._write_segment(rep)
            self._eos_count += 1
            if self._eos_count == len(self._reps):
                self._write_mpd()
        return True

    def _write_mpd(self) -> None:
        ts = 1000  # MPD timescale (ms units)
        total = max((sum(r.segments) for r in self._reps), default=0)

        def dur_iso(ns: int) -> str:
            return f"PT{ns / SECOND:.3f}S"

        dynamic = self.get_property("dynamic")
        min_buf = self.get_property("min-buffer-time") or \
            self.get_property("target-duration") * SECOND
        mpd_attrs = (
            'type="dynamic" '
            'profiles="urn:mpeg:dash:profile:isoff-live:2011" '
            f'minimumUpdatePeriod="{dur_iso(self.get_property("minimum-update-period") or self.get_property("target-duration") * SECOND)}" '
        ) if dynamic else (
            'type="static" '
            'profiles="urn:mpeg:dash:profile:isoff-on-demand:2011" '
            f'mediaPresentationDuration="{dur_iso(total)}" '
        )
        lines = [
            '<?xml version="1.0" encoding="utf-8"?>',
            '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" '
            + mpd_attrs
            + f'minBufferTime="{dur_iso(min_buf)}">',
        ]
        if self.get_property("utc-timing-url"):
            lines.append(
                '  <UTCTiming schemeIdUri="urn:mpeg:dash:utc:http-iso:2014" '
                f'value="{self.get_property("utc-timing-url")}"/>')
        lines.append("  <Period>")
        for kind in ("video", "audio"):
            reps = [r for r in self._reps if r.kind == kind]
            if not reps:
                continue
            lines.append(f'    <AdaptationSet mimeType="{kind}/mp4">')
            for r in reps:
                attrs = f'id="{r.idx}" bandwidth="{r.bandwidth}"'
                if kind == "video":
                    attrs += (f' width="{r.caps_fields.get("width", 0)}"'
                              f' height="{r.caps_fields.get("height", 0)}"')
                else:
                    attrs += f' audioSamplingRate="{r.caps_fields.get("rate", 48000)}"'
                lines.append(f"      <Representation {attrs}>")
                lines.append(
                    f'        <SegmentTemplate timescale="{ts}" '
                    f'initialization="init_{r.idx}.mp4" '
                    f'media="seg_{r.idx}_$Number$.m4s" startNumber="1">'
                )
                lines.append("          <SegmentTimeline>")
                for d in r.segments:
                    lines.append(f'            <S d="{d * ts // SECOND}"/>')
                lines.append("          </SegmentTimeline>")
                lines.append("        </SegmentTemplate>")
                lines.append("      </Representation>")
            lines.append("    </AdaptationSet>")
        lines += ["  </Period>", "</MPD>", ""]
        path = os.path.join(self._root(), self.get_property("mpd-filename"))
        with self._open_out("get-manifest-stream", path, "w") as f:
            f.write("\n".join(lines))


__all__ = ["DashSink2"]
