"""rsflvdemux: FLV container demuxer.

Parity target: mux/flavors (rsflvdemux, flvdemux/mod.rs:23; 1747 LoC
nom-based parser).  Parses the FLV header and tag stream, exposes
sometimes src pads `audio` / `video` with caps mapped from the FLV codec
ids, and forwards tag payloads with millisecond timestamps as pts.

Codec id mapping (FLV spec / flvdemux/imp.rs):
  audio 0/3 raw PCM -> audio/x-raw S16; 2 MP3 -> audio/mpeg V1 L3;
  7 A-law / 8 mu-law -> audio/x-alaw|x-mulaw @8000; 10 AAC -> audio/mpeg V4
  (AudioSpecificConfig from AACPacketType 0 exposed as codec_data)
  video 2 Sorenson -> video/x-flash-video; 7 AVC -> video/x-h264
  (avcC from AVCPacketType 0 exposed as codec_data)
"""
from __future__ import annotations

import struct
from typing import Dict, Optional

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
)
from ...core.caps import Structure
from ...core.events import Segment
from ...core.payload import host_bytes
from ...core.registry import register

FLV_CAPS = Caps.builder("video/x-flv")
MSECOND = 1_000_000

_AUDIO_RATES = {0: 5512, 1: 11025, 2: 22050, 3: 44100}


@register
class FlvDemux(Element):
    ELEMENT_NAME = "rsflvdemux"
    ELEMENT_CLASS = "Codec/Demuxer"
    ELEMENT_DESCRIPTION = "Demuxes FLV streams"
    EXTRA_PAD_TEMPLATES = [
        ("audio", "src", "sometimes", "ANY"),
        ("video", "src", "sometimes", "ANY"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, FLV_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._acc = bytearray()
        self._header_parsed = False
        self._out_pads: Dict[str, Pad] = {}

    def on_ready_to_paused(self) -> None:
        self._acc = bytearray()
        self._header_parsed = False

    # -- output pads -----------------------------------------------------------
    def _ensure_pad(self, kind: str, caps: Caps) -> Pad:
        if kind in self._out_pads:
            return self._out_pads[kind]
        pad = Pad(kind, PadDirection.SRC,
                  PadTemplate(kind, PadDirection.SRC, PadPresence.SOMETIMES, Caps.new_any()))
        self.add_pad(pad)
        if self._pending_peer is not None and self._pending_peer.peer is None:
            if caps.can_intersect(self._pending_peer.pad_template_caps()):
                pad.link(self._pending_peer)
        elif self._pending_element is not None and hasattr(self._pending_element, "request_sink_pad"):
            # downstream muxer-style element: one request pad per stream
            peer = self._pending_element.request_sink_pad()
            if caps.can_intersect(peer.pad_template_caps()):
                pad.link(peer)
        if pad.peer is not None:
            pad.push_event(Event.new_stream_start(f"{self.name}-{kind}"))
            pad.push_event(Event.new_caps(caps))
            pad.push_event(Event.new_segment(Segment()))
        self._out_pads[kind] = pad
        return pad

    _pending_peer: Optional[Pad] = None
    _pending_element = None

    def link(self, downstream) -> None:
        if hasattr(downstream, "request_sink_pad"):
            # defer: request one pad per demuxed stream as it appears
            self._pending_element = downstream
            return
        self._pending_peer = next(
            (p for p in downstream.sink_pads() if p.peer is None), None
        )

    # -- parsing -----------------------------------------------------------------
    def _audio_caps(self, flags: int, codec_data: Optional[bytes]) -> Caps:
        fmt = flags >> 4
        rate = _AUDIO_RATES[(flags >> 2) & 0x3]
        channels = 2 if flags & 0x1 else 1
        if fmt == 2:
            return Caps([Structure("audio/mpeg", mpegversion=1, layer=3,
                                   rate=rate, channels=channels)])
        if fmt == 7:
            return Caps([Structure("audio/x-alaw", rate=8000, channels=channels)])
        if fmt == 8:
            return Caps([Structure("audio/x-mulaw", rate=8000, channels=channels)])
        if fmt == 10:
            f = {"mpegversion": 4, "rate": rate, "channels": channels}
            if codec_data is not None:
                f["codec_data"] = codec_data
            return Caps([Structure("audio/mpeg", **f)])
        if fmt in (0, 3):
            width = 16 if flags & 0x2 else 8
            return Caps([Structure("audio/x-raw", format=f"S{width}" if width == 16 else "U8",
                                   rate=rate, channels=channels, layout="interleaved")])
        return Caps([Structure("audio/x-flv-unknown", format=fmt)])

    def _video_caps(self, codec: int, codec_data: Optional[bytes]) -> Caps:
        if codec == 2:
            return Caps([Structure("video/x-flash-video", flvversion=1)])
        if codec == 7:
            f = {"stream-format": "avc", "alignment": "au"}
            if codec_data is not None:
                f["codec_data"] = codec_data
            return Caps([Structure("video/x-h264", **f)])
        return Caps([Structure("video/x-flv-unknown", codec=codec)])

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        d = buf.data
        self._acc += host_bytes(d, np.uint8)
        return self._drain_tags()

    def _drain_tags(self) -> FlowReturn:
        if not self._header_parsed:
            if len(self._acc) < 9:
                return FlowReturn.OK
            if self._acc[:3] != b"FLV":
                raise ValueError("not an FLV stream")
            hdr_size = struct.unpack_from(">I", self._acc, 5)[0]
            if len(self._acc) < hdr_size + 4:
                return FlowReturn.OK
            del self._acc[: hdr_size + 4]  # header + first prev-tag-size
            self._header_parsed = True
        ret = FlowReturn.OK
        while len(self._acc) >= 11:
            tag_type = self._acc[0]
            size = int.from_bytes(self._acc[1:4], "big")
            if len(self._acc) < 11 + size + 4:
                break
            ts = int.from_bytes(self._acc[4:7], "big") | (self._acc[7] << 24)
            body = bytes(self._acc[11 : 11 + size])
            del self._acc[: 11 + size + 4]
            r = self._handle_tag(tag_type, ts, body)
            if r not in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                ret = r
        return ret

    def _handle_tag(self, tag_type: int, ts_ms: int, body: bytes) -> FlowReturn:
        if not body:
            return FlowReturn.OK
        if tag_type == 8:  # audio
            flags = body[0]
            payload = body[1:]
            codec_data = None
            if flags >> 4 == 10:  # AAC: packet type byte
                if payload and payload[0] == 0:
                    codec_data = payload[1:]
                    self._ensure_pad("audio", self._audio_caps(flags, codec_data))
                    return FlowReturn.OK
                payload = payload[1:]
            pad = self._ensure_pad("audio", self._audio_caps(flags, None))
            if pad.peer is None:
                return FlowReturn.NOT_LINKED
            return pad.push(Buffer(np.frombuffer(payload, np.uint8), pts=ts_ms * MSECOND))
        if tag_type == 9:  # video
            flags = body[0]
            frame_type, codec = flags >> 4, flags & 0x0F
            payload = body[1:]
            codec_data = None
            if codec == 7:  # AVC: packet type + composition time offset
                if len(payload) < 4:
                    return FlowReturn.OK
                if payload[0] == 0:
                    codec_data = payload[4:]
                    self._ensure_pad("video", self._video_caps(codec, codec_data))
                    return FlowReturn.OK
                payload = payload[4:]
            pad = self._ensure_pad("video", self._video_caps(codec, None))
            if pad.peer is None:
                return FlowReturn.NOT_LINKED
            out = Buffer(np.frombuffer(payload, np.uint8), pts=ts_ms * MSECOND)
            if frame_type != 1:
                out.set_flag(BufferFlags.DELTA_UNIT)
            return pad.push(out)
        return FlowReturn.OK  # script/metadata tags (AMF) skipped

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.EOS:
            self._drain_tags()
            ok = True
            for p in self._out_pads.values():
                if p.peer is not None:
                    ok = p.push_event(event) and ok
            return ok
        if event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT):
            return True
        ok = True
        for p in self._out_pads.values():
            if p.peer is not None:
                ok = p.push_event(event) and ok
        return ok


__all__ = ["FlvDemux"]
