"""HLS sink elements: hlscmafsink, hlssink3, hlswebvttsink,
hlsmultivariantsink.

Parity targets: net/hlssink3 (hlsbasesink.rs + hlscmafsink/ + hlssink3/ +
hlswebvttsink/) and net/hlsmultivariantsink.  Defaults from
hlsbasesink.rs:23-29 (playlist.m3u8, max-files 10, playlist-length 5,
endlist on).

hlscmafsink embeds a CMAFMux exactly like the reference embeds cmafmux:
raw audio/video goes in, the muxer's HEADER buffer becomes the init
segment (init-location) and each fragment becomes one media segment
(location pattern), with the playlist rewritten atomically after every
segment and an `hls-segment-added` element message posted
(hlsbasesink.rs:658).

hlssink3 diverges from the reference (which muxes MPEG-TS): there is no
MPEG-TS muxer in this framework yet, so it accepts a pre-muxed byte
stream (HEADER-flagged init + fragment buffers, e.g. from any fmp4 muxer)
and segments it; same playlist machinery.
"""
from __future__ import annotations

import os
from typing import Optional

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
from ...core.caps import Structure
from ...core.payload import host_bytes
from ...core.events import Message, MessageType
from ...net import hls
from ..mux.isobmff import _SINK_CAPS as MUX_SINK_CAPS, CMAFMux

DEFAULT_TARGET_DURATION = 15  # hlssink3 target-duration default (seconds)


class _HlsBase(Element):
    """Shared segment/playlist machinery (hlsbasesink.rs analog)."""

    SIGNALS = {
        # request signals (hlsbasesink.rs): the app supplies writable
        # streams; unhandled ones fall back to plain files
        "get-fragment-stream": None,
        "get-playlist-stream": None,
        "delete-fragment": None,
    }
    PROPERTIES = [
        Prop("playlist-location", "playlist.m3u8", type="str"),
        Prop("playlist-root", None, type="str"),
        Prop("location", "segment%05d.m4s", type="str"),
        Prop("target-duration", DEFAULT_TARGET_DURATION, type="uint", minimum=1),
        Prop("playlist-length", 5, type="uint"),
        Prop("max-files", 10, type="uint"),
        Prop("enable-endlist", True, type="bool"),
        Prop("playlist-type", "unspecified", type="enum",
             choices=["unspecified", "event", "vod"],
             doc="EXT-X-PLAYLIST-TYPE: event/vod playlists are append-only "
                 "with full history; unspecified keeps the sliding window"),
        Prop("latency", 0, type="uint64",
             doc="extra ns of latency to report downstream"),
        Prop("sync", False, type="bool",
             doc="clock-sync segment writes (accepted; writes happen as "
                 "segments complete, pacing belongs to upstream)"),
        Prop("send-keyframe-requests", True, type="bool",
             doc="send an upstream force-key-unit event when a new segment "
                 "should start"),
        # GstHlsBaseSink surface (reference hlssink3 other-types)
        Prop("enable-program-date-time", False, type="bool",
             doc="write EXT-X-PROGRAM-DATE-TIME per segment"),
        Prop("pdt-follows-pipeline-clock", True, type="bool",
             doc="true: PDT = first-segment wallclock + pipeline segment "
                 "durations (immune to wallclock drift); false: each "
                 "segment stamps the current wallclock"),
        Prop("program-date-time-reference", "pipeline", type="enum",
             choices=["pipeline", "system"],
             doc="source of the PDT epoch: pipeline clock mapped to UTC at "
                 "the first segment, or the system wallclock"),
        Prop("single-media-file", None, type="str", mutable="ready",
             doc="write all segments into this one file; playlist entries "
                 "use EXT-X-BYTERANGE addressing"),
    ]

    def latency_additional_ns(self) -> int:
        return self.get_property("latency")

    def _playlist_type(self):
        t = self.get_property("playlist-type")
        return None if t == "unspecified" else t

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._playlist: Optional[hls.MediaPlaylist] = None
        self._seg_index = 0
        self._pdt_base = None  # datetime of the first segment
        self._pdt_elapsed_ns = 0  # pipeline time since the first segment
        self._smf = None  # single-media-file handle
        self._smf_offset = 0

    def _segment_pdt(self, duration_ns: int) -> Optional[str]:
        """EXT-X-PROGRAM-DATE-TIME for the segment being added."""
        if not self.get_property("enable-program-date-time"):
            return None
        from datetime import datetime, timezone

        now = datetime.now(timezone.utc)
        if self._pdt_base is None:
            self._pdt_base = now
        if self.get_property("pdt-follows-pipeline-clock") \
                and self.get_property("program-date-time-reference") == "pipeline":
            from datetime import timedelta

            stamp = self._pdt_base + timedelta(
                microseconds=self._pdt_elapsed_ns / 1000)
        else:
            stamp = now
        self._pdt_elapsed_ns += duration_ns
        return stamp.isoformat(timespec="milliseconds").replace("+00:00", "+00:00")

    def _uri(self, path: str) -> str:
        root = self.get_property("playlist-root")
        base = os.path.basename(path)
        return f"{root.rstrip('/')}/{base}" if root else base

    def _init_playlist(self, init_uri: Optional[str]) -> None:
        self._playlist = hls.MediaPlaylist(
            target_duration=self.get_property("target-duration"),
            playlist_length=self.get_property("playlist-length"),
            max_files=self.get_property("max-files"),
            init_uri=init_uri,
            enable_endlist=self.get_property("enable-endlist"),
            playlist_type=self._playlist_type(),
            i_frames_only=bool(self._props.get("i-frames-only")),
        )
        self._seg_index = 0

    def _open_out(self, signal: str, path: str):
        handler = self.signal_handler(signal)
        if handler is not None:
            stream = handler(self, path)
            if stream is not None:
                return stream
        return open(path, "wb")

    def _write_segment(self, data: bytes, duration_ns: int) -> None:
        pdt = self._segment_pdt(duration_ns)
        single = self.get_property("single-media-file")
        if single:
            # all segments appended to one file; the playlist addresses
            # them with EXT-X-BYTERANGE (GstHlsBaseSink single-media-file)
            if self._smf is None:
                self._smf = self._open_out("get-fragment-stream", single)
                self._smf_offset = 0
            self._smf.write(data)
            self._smf.flush()
            self._seg_index += 1
            seg = hls.Segment(self._uri(single), duration_ns / SECOND, None,
                              date_time=pdt,
                              byterange=(len(data), self._smf_offset))
            self._smf_offset += len(data)
            assert self._playlist is not None
            self._playlist.add_segment(seg)
            self._write_playlist()
            self.post_message(
                Message(
                    MessageType.ELEMENT,
                    structure=Structure(
                        "hls-segment-added",
                        location=single,
                        running_time=None,
                        duration=duration_ns,
                    ),
                )
            )
            return
        path = self.get_property("location") % self._seg_index
        self._seg_index += 1
        with self._open_out("get-fragment-stream", path) as f:
            f.write(data)
        assert self._playlist is not None
        evicted = self._playlist.add_segment(
            hls.Segment(self._uri(path), duration_ns / SECOND, path,
                        date_time=pdt)
        )
        for old in evicted:
            handler = self.signal_handler("delete-fragment")
            if handler is not None:
                handler(self, old)
                continue
            try:
                os.remove(old)
            except OSError:
                pass
        self._write_playlist()
        self.post_message(
            Message(
                MessageType.ELEMENT,
                structure=Structure(
                    "hls-segment-added",
                    location=path,
                    running_time=None,
                    duration=duration_ns,
                ),
            )
        )

    def _write_playlist(self) -> None:
        handler = self.signal_handler("get-playlist-stream")
        if handler is not None:
            stream = handler(self, self.get_property("playlist-location"))
            if stream is not None:
                with stream as f:
                    f.write(self._playlist.render().encode())
        else:
            hls.write_atomic(self.get_property("playlist-location"),
                             self._playlist.render())
        iframe_loc = self._props.get("iframe-playlist-location")
        if iframe_loc and self._playlist is not None:
            # I-frame playlist: same segments flagged EXT-X-I-FRAMES-ONLY
            # (whole-segment entries; no per-keyframe byteranges kept)
            ip = hls.MediaPlaylist(
                target_duration=self._playlist.target_duration,
                playlist_length=self._playlist.playlist_length,
                max_files=self._playlist.max_files,
                init_uri=self._playlist.init_uri,
                enable_endlist=self._playlist.ended,
                playlist_type=self._playlist.playlist_type,
                i_frames_only=True,
            )
            ip.segments = list(self._playlist.segments)
            ip.media_sequence = self._playlist.media_sequence
            ip.ended = self._playlist.ended
            hls.write_atomic(iframe_loc, ip.render())

    def _finish_playlist(self) -> None:
        if self._smf is not None:
            try:
                self._smf.close()
            finally:
                self._smf = None
        if self._playlist is not None:
            self._playlist.end()
            self._write_playlist()


@register
class HlsCmafSink(_HlsBase):
    ELEMENT_NAME = "hlscmafsink"
    ELEMENT_CLASS = "Sink/Muxer"
    SIGNALS = {
        "get-init-stream": None,
        "new-playlist": "new_playlist",
        "get-fragment-stream": None,
        "get-playlist-stream": None,
        "delete-fragment": None,
    }
    ELEMENT_DESCRIPTION = "HLS sink writing CMAF segments (embeds cmafmux)"
    PROPERTIES = [
        Prop("init-location", "init%05d.mp4", type="str"),
        Prop("location", "segment%05d.m4s", type="str"),
        Prop("playlist-root-init", None, type="str",
             doc="URI root for the init segment (playlist-root applies to "
                 "media segments)"),
        Prop("iframe-playlist-location", None, type="str",
             doc="write an EXT-X-I-FRAMES-ONLY playlist here listing each "
                 "segment (whole-segment byteranges — this muxer keeps no "
                 "per-keyframe offsets)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._mux = CMAFMux(f"{self.name}-mux")
        mux_sink = self._mux.pad("sink")
        # our public sink pad proxies straight into the embedded muxer
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, MUX_SINK_CAPS))
        )
        self.sinkpad.chain_function = lambda pad, buf: mux_sink.chain(buf)
        self.sinkpad.event_function = lambda pad, ev: mux_sink.send_event(ev)
        self.sinkpad.query_function = lambda pad, q: mux_sink.query(q)
        # collect the muxer output on an internal pad
        inner = Pad("inner_sink", PadDirection.SINK,
                    PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        inner.chain_function = self._mux_output
        inner.event_function = self._mux_event
        inner.element = self
        self._mux.srcpad.peer = inner
        inner.peer = self._mux.srcpad
        self._frag_acc = bytearray()
        self._frag_dur = 0

    def on_null_to_ready(self) -> None:
        from ...core.element import State

        self._mux.set_property(
            "fragment-duration", self.get_property("target-duration") * SECOND
        )
        self._mux.set_state(State.READY)

    def on_ready_to_paused(self) -> None:
        from ...core.element import State

        self._mux.set_state(State.PAUSED)
        self._init_playlist(None)
        self._frag_acc = bytearray()
        self._frag_dur = 0

    def on_paused_to_playing(self) -> None:
        from ...core.element import State

        self._mux.set_state(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        from ...core.element import State

        self._mux.set_state(State.READY)

    def on_ready_to_null(self) -> None:
        from ...core.element import State

        self._mux.set_state(State.NULL)

    def _mux_output(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        if buf.has_flag(BufferFlags.HEADER):
            path = self.get_property("init-location") % 0
            with self._open_out("get-init-stream", path) as f:
                f.write(data)
            init_root = self.get_property("playlist-root-init")
            self._playlist.init_uri = (
                f"{init_root.rstrip('/')}/{os.path.basename(path)}"
                if init_root else self._uri(path))
            self._write_playlist()
            return FlowReturn.OK
        self._frag_acc += data
        self._frag_dur += buf.duration or 0
        if not buf.has_flag(BufferFlags.DELTA_UNIT):
            # fragment boundary: moof-starting buffer closes a segment
            self._write_segment(bytes(self._frag_acc), self._frag_dur)
            self._frag_acc = bytearray()
            self._frag_dur = 0
        return FlowReturn.OK

    def new_playlist(self) -> None:
        """`new-playlist` action: finish the current playlist and start a
        fresh one (hlscmafsink/imp.rs:270-274)."""
        self._finish_playlist()
        init_uri = self._playlist.init_uri if self._playlist else None
        self._init_playlist(init_uri)

    def _mux_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            if self._frag_acc:
                self._write_segment(bytes(self._frag_acc), self._frag_dur)
                self._frag_acc = bytearray()
            self._finish_playlist()
            self.post_message(Message(MessageType.EOS))
        return True


class _ByteStreamHlsSink(_HlsBase):
    """Segments a pre-muxed byte stream at non-DELTA boundaries."""

    STREAM_CAPS = Caps.new_any()

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, self.STREAM_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._acc = bytearray()
        self._dur = 0

    def on_ready_to_paused(self) -> None:
        self._init_playlist(None)
        self._acc = bytearray()
        self._dur = 0

    def _flush_segment(self) -> None:
        if self._acc:
            self._write_segment(bytes(self._acc), self._dur or self.get_property("target-duration") * SECOND)
            self._acc = bytearray()
            self._dur = 0

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = self._payload(buf)
        if buf.has_flag(BufferFlags.HEADER):
            path = self.get_property("init-location") % 0 if "init-location" in self._props else None
            if path:
                with open(path, "wb") as f:
                    f.write(data)
                self._playlist.init_uri = self._uri(path)
            return FlowReturn.OK
        if not buf.has_flag(BufferFlags.DELTA_UNIT):
            self._flush_segment()
            if self.get_property("send-keyframe-requests"):
                from ...core import Event as _Event

                self.sinkpad.push_event(_Event(
                    EventType.CUSTOM_UPSTREAM, name="GstForceKeyUnit",
                    **{"all-headers": True}))
        elif self._props.get("i-frames-only"):
            return FlowReturn.OK  # EXT-X-I-FRAMES-ONLY: delta units dropped
        self._acc += data
        self._dur += buf.duration or 0
        return FlowReturn.OK

    def _payload(self, buf: Buffer) -> bytes:
        d = buf.data
        return d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._flush_segment()
            self._finish_playlist()
            self.post_message(Message(MessageType.EOS))
        return True


@register
class HlsSink3(_ByteStreamHlsSink):
    """Two input modes like the reference (hlssink3/imp.rs, which embeds
    mpegtsmux): the always `sink` pad segments an already-muxed byte
    stream; the request `audio`/`video` pads feed elementary streams into
    an embedded mpegtsmux whose TS output is cut into segments at
    PSI-carrying boundaries once target-duration has accumulated."""

    ELEMENT_NAME = "hlssink3"
    ELEMENT_CLASS = "Sink/Muxer"
    ELEMENT_DESCRIPTION = "HLS sink segmenting a pre-muxed stream"
    PROPERTIES = [
        Prop("location", "segment%05d.ts", type="str"),
        Prop("init-location", "init%05d.mp4", type="str"),
        Prop("i-frames-only", False, type="bool",
             doc="EXT-X-I-FRAMES-ONLY playlist: only keyframe buffers are "
                 "segmented, delta units are dropped"),
    ]
    STREAM_CAPS = Caps(
        [Structure("video/quicktime"), Structure("video/mpegts"),
         Structure("application/octet-stream")]
    )
    EXTRA_PAD_TEMPLATES = [
        ("audio", "sink", "request", "ANY"),
        ("video", "sink", "request", "ANY"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._tsmux = None
        self._seg_start_pts: Optional[int] = None
        self._last_pts: Optional[int] = None

    # -- embedded mpegtsmux (elementary-stream input mode) -------------------
    def _ensure_tsmux(self):
        if self._tsmux is not None:
            return self._tsmux
        from ..mux.tsmux import MpegTsMux

        self._tsmux = MpegTsMux(f"{self.name}-tsmux")
        # PSI before every PES so any output buffer can start a segment
        # (TS segments must lead with PAT/PMT; the reference's mpegtsmux
        # gets the same effect from si-interval alignment)
        self._tsmux.set_property("pat-interval", 1)
        self._tsmux.parent = self.parent
        self._tsmux.state = self.state
        inner = Pad("inner_sink", PadDirection.SINK,
                    PadTemplate("inner", PadDirection.SINK,
                                PadPresence.ALWAYS, Caps.new_any()))
        inner.chain_function = self._ts_output
        inner.event_function = self._event
        inner.element = self
        self._tsmux.srcpad.peer = inner
        inner.peer = self._tsmux.srcpad
        return self._tsmux

    def request_pad(self, template_name: str = "video") -> Pad:
        media = "audio" if "audio" in template_name else "video"
        if media in self.pads:
            raise ValueError(f"{self.name}: pad {media} already requested")
        mux = self._ensure_tsmux()
        muxpad = mux.request_sink_pad()
        pad = Pad(media, PadDirection.SINK,
                  PadTemplate(media, PadDirection.SINK, PadPresence.REQUEST,
                              Caps.new_any()))
        pad.chain_function = lambda p, b: muxpad.chain(b)
        pad.event_function = lambda p, ev: muxpad.send_event(ev)
        return self.add_pad(pad)

    def _ts_output(self, pad: Pad, buf: Buffer) -> FlowReturn:
        """Collect embedded-muxer TS output; cut a segment at each
        PSI-carrying (non-DELTA) buffer once target-duration is full."""
        if buf.pts is not None:
            if self._seg_start_pts is None:
                self._seg_start_pts = buf.pts
            self._last_pts = buf.pts
        target_ns = self.get_property("target-duration") * SECOND
        span = 0 if self._seg_start_pts is None or self._last_pts is None \
            else self._last_pts - self._seg_start_pts
        if not buf.has_flag(BufferFlags.DELTA_UNIT) and self._acc \
                and span >= target_ns:
            self._dur = span
            self._flush_segment()
            self._seg_start_pts = buf.pts
        self._acc += self._payload(buf)
        return FlowReturn.OK

    def _flush_segment(self) -> None:
        super()._flush_segment()
        self._seg_start_pts = None

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS and self._acc \
                and self._seg_start_pts is not None \
                and self._last_pts is not None:
            self._dur = max(self._last_pts - self._seg_start_pts,
                            SECOND // 10)
        return super()._event(pad, event)

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._seg_start_pts = None
        self._last_pts = None
        if self._tsmux is not None:
            from ...core.element import State

            self._tsmux.parent = self.parent
            self._tsmux.set_state(State.PAUSED)

    def on_paused_to_playing(self) -> None:
        if self._tsmux is not None:
            from ...core.element import State

            self._tsmux.set_state(State.PLAYING)

    def on_paused_to_ready(self) -> None:
        if self._tsmux is not None:
            from ...core.element import State

            self._tsmux.set_state(State.READY)


@register
class HlsWebVttSink(_ByteStreamHlsSink):
    ELEMENT_NAME = "hlswebvttsink"
    ELEMENT_CLASS = "Sink/Subtitle"
    ELEMENT_DESCRIPTION = "HLS sink writing WebVTT subtitle segments"
    PROPERTIES = [
        Prop("location", "segment%05d.vtt", type="str"),
        Prop("enable-timestamp-map", True, type="bool",
             doc="prefix each segment with an X-TIMESTAMP-MAP header"),
        Prop("mpegts-time-offset", 0, type="uint64",
             doc="MPEGTS value (90 kHz units) for the X-TIMESTAMP-MAP"),
    ]
    STREAM_CAPS = Caps.builder("application/x-subtitle-vtt")

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        # one VTT cue buffer per segment
        data = self._payload(buf)
        if self.get_property("enable-timestamp-map") and buf.pts is not None:
            # RFC 8216 §3.5: map the cue timeline onto the MPEG-TS one
            mpegts = self.get_property("mpegts-time-offset") \
                + buf.pts * 90_000 // 1_000_000_000
            header = b"WEBVTT\n"
            if data.startswith(header):
                data = (b"WEBVTT\nX-TIMESTAMP-MAP=LOCAL:00:00:00.000,"
                        + f"MPEGTS:{mpegts}\n".encode() + data[len(header):])
        self._acc += data
        self._dur += buf.duration or 0
        self._flush_segment()
        return FlowReturn.OK


__all__ = ["HlsCmafSink", "HlsSink3", "HlsWebVttSink"]

