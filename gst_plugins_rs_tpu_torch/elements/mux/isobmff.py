"""ISO-BMFF muxer elements: isofmp4mux / cmafmux / dashmp4mux / onviffmp4mux
(fragmented) and isomp4mux / onvifmp4mux (non-fragmented).

Parity targets: reference mux/isobmff/src/isobmff/fmp4mux/imp.rs (6011 LoC)
and mp4mux/imp.rs (3154 LoC); registration + ranks mod.rs:137-172.  Box
serialization is host control plane (mux.bmff) — the media payloads arrive
as tensors on the card and are converted to bytes exactly once here, at the file
boundary.

The port: a payload may be a torch.Tensor on the card, and it is read back
to the host exactly once, when it becomes a sample (`_Stream.to_sample`):
one device-to-host copy a frame or buffer.  A video frame that is not
uint8 is clipped and cast on its device before that copy, and audio is cast
to the caps' sample type there.  Configuring a stream reads no payload back
unless its sample entry is built from the first frame (AC-3 and E-AC-3).
The fragmented muxers cut on the streaming thread and on the clock thread
(the `latency` deadline); both take the aggregator's lock before the
muxer's own, so the two threads never wait on each other in turn.

Behavioral notes vs the reference:
- Raw PCM audio is written as ipcm/fpcm + pcmC (boxes.rs:1458-1463,
  2537-2563), raw video as uncv + uncC (ISO/IEC 23001-17,
  uncompressed.rs:256-318), and compressed streams get avc1+avcC /
  av01+av1C / vp09+vpcC / mp4a+esds / Opus+dOps entries from their caps
  (boxes.rs get_audio_fourcc/get_video_fourcc).
- Fragments follow the reference's GOP-queue strategy (fmp4mux/imp.rs
  ChunkStrategy): whole GOPs queue per stream and fragments cut only at
  finalized-GOP boundaries — late keyframes extend the previous fragment,
  sparse streams start GOPs at their true PTS (tfdt jumps holes), chunked
  mode emits fragment-interior chunks on the chunk clock, and a clock-armed
  `latency` deadline cuts with the data on hand when a stream lags
  (tests/test_fmp4_scenarios.py mirrors the reference suite 1:1).
- header-update-mode: none/rewrite never re-send the header mid-stream
  (incompatible caps changes are ignored); caps re-sends a fresh init
  segment on incompatible changes at GOP boundaries; update re-pushes the
  finalized header (real durations) at EOS, and rewrite is approximated the
  same way (push-only downstreams cannot seek back).
- The non-fragmented muxer assembles in memory and emits the whole file at
  EOS (the reference instead rewrites the mdat size via seekable downstream;
  byte-identical layout, different streaming behavior).
- onviffmp4mux/onvifmp4mux don't yet stamp ONVIF UTC times (no wall-clock
  source is wired to the muxers); they mux identically to their ISO siblings.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...core import (
    Buffer,
    BufferFlags,
    Caps,
    FlowReturn,
    Prop,
    SECOND,
)
from ...core.aggregator import Aggregator, AggregatorPad
from ...core.audio import AudioInfo
from ...core.buffer import Meta
from ...core.caps import IntRange, Structure, ValueList
from ...core.events import Event, EventType, Segment
from ...core.payload import host_array, host_bytes
from ...core.registry import register
from ...core.video import VideoInfo
from ...mux import bmff

AUDIO_FORMATS = ["S16", "S24LE", "S32", "F32", "F64"]
# formats with an uncC mapping (bmff._UNCC — the reference's full
# ISO/IEC 23001-17 set from uncompressed.rs:455-770)
VIDEO_FORMATS = [
    "RGB", "RGBA", "ABGR", "BGR", "BGRA", "ARGB", "RGBx", "BGRx", "xRGB",
    "xBGR", "r210", "GRAY8", "GRAY16_BE", "IYU2", "v308", "AYUV", "YUY2",
    "YVYU", "UYVY", "VYUY", "Y444", "I420", "YV12", "Y42B", "Y41B", "GBR",
    "RGBP", "BGRP", "NV12", "NV21", "NV16", "NV61",
]
COMPRESSED_RAW_CAPS = [
    "application/x-zlib-compressed",
    "application/x-deflate-compressed",
    "application/x-brotli-compressed",
]

_SINK_CAPS = Caps(
    [
        Structure(
            "audio/x-raw",
            format=ValueList(AUDIO_FORMATS),
            rate=IntRange(1, 2_822_400),
            channels=IntRange(1, 64),
            layout="interleaved",
        ),
        Structure(
            "video/x-raw",
            format=ValueList(VIDEO_FORMATS),
            width=IntRange(1, 16384),
            height=IntRange(1, 16384),
        ),
        # compressed inputs (boxes.rs get_audio_fourcc/get_video_fourcc)
        Structure("video/x-h264", **{"stream-format": ValueList(["avc", "avc3"])}),
        Structure("video/x-h265", **{"stream-format": ValueList(["hvc1", "hev1"])}),
        Structure("video/x-h266", **{"stream-format": ValueList(["vvc1", "vvi1"])}),
        Structure("video/x-av1"),
        Structure("video/x-vp8"),
        Structure("video/x-vp9"),
        Structure("audio/mpeg", mpegversion=4),
        Structure("audio/x-opus"),
        Structure("audio/x-ac3", framed=True),
        Structure("audio/x-eac3", framed=True),
        Structure("audio/x-flac", framed=True),
        # generically-compressed uncompressed video (compressenc upstream;
        # ISO/IEC 23001-17 Amd.2 restricted scheme)
        *[Structure(n) for n in COMPRESSED_RAW_CAPS],
    ]
)


def _split_annexb(data: bytes):
    """Split an Annex-B byte stream into raw NAL units."""
    nals, i, start = [], 0, None
    while i + 2 < len(data):
        if data[i] == 0 and data[i + 1] == 0 and (
                data[i + 2] == 1 or
                (i + 3 < len(data) and data[i + 2] == 0 and data[i + 3] == 1)):
            if start is not None:
                # trailing_zero_8bits before the next start code are padding
                nals.append(data[start:i].rstrip(b"\x00"))
            i += 3 if data[i + 2] == 1 else 4
            start = i
        else:
            i += 1
    if start is not None:
        nals.append(data[start:])
    return [n for n in nals if n]


# caps whose sample entry is built from the stream's first frame
_FIRST_FRAME_CAPS = ("audio/x-ac3", "audio/x-eac3")


def _first_frame(caps: Caps, buf: Optional[Buffer]) -> Optional[bytes]:
    """The first frame's bytes where the sample entry needs them (the AC-3
    and E-AC-3 headers); None otherwise, so a raw frame is not read back
    to configure its stream."""
    if buf is None or caps.structure(0).name not in _FIRST_FRAME_CAPS:
        return None
    return host_bytes(buf.data, np.uint8)


class FMP4KeyframeMeta(Meta):
    """Custom meta marking a fragment header whose first sample is a
    keyframe (reference CustomMeta 'FMP4KeyframeMeta',
    fmp4mux/imp.rs:3541; consumed by hlscmafsink for segment splitting)."""

    api = "fmp4-keyframe"

    def __init__(self, pts: Optional[int] = None):
        self.pts = pts


class _Gop:
    """One queued GOP: a sync sample and its following delta units.

    The fmp4 muxer queues whole GOPs and cuts fragments only at GOP
    boundaries (fmp4mux/imp.rs:1655-1729 ChunkStrategy::None: a stream is
    fragment-filled once a FINALIZED GOP ends at/after the fragment end).
    `final` = the GOP's end is known (next keyframe arrived, or EOS)."""

    __slots__ = ("samples", "start_ts", "dur_ts", "final")

    def __init__(self, start_ts: int):
        self.samples: List[Tuple[bytes, int, bool]] = []  # (data, dur_ts, sync)
        self.start_ts = start_ts
        self.dur_ts = 0
        self.final = False

    @property
    def end_ts(self) -> int:
        return self.start_ts + self.dur_ts


class _Stream:
    """Per-sink-pad muxing state."""

    def __init__(self, pad: AggregatorPad, track_id: int):
        self.pad = pad
        self.track_id = track_id
        self.tags: dict = {}  # language-code / image-orientation from TAG events
        self.kind: Optional[str] = None  # "audio" | "video"
        self.ainfo: Optional[AudioInfo] = None
        self.vinfo: Optional[VideoInfo] = None
        self.timescale = 0
        self.frame_dur_ts = 0  # per video frame, track timescale
        self.track: Optional[bmff.TrackConfig] = None
        self.configured_caps: Optional[Caps] = None
        self.pending_caps: Optional[Caps] = None  # caps change awaiting a keyframe
        # serialization: the change only applies to buffers pushed AFTER the
        # caps event — this many already-queued pad buffers drain first
        self.pending_caps_after = 0
        self.pending_retag = False  # tag change awaiting a GOP-boundary header
        # queued-but-unassigned GOPs (video) / samples (sync-only streams)
        self.gops: List[_Gop] = []
        # pending (staged for the next cut) samples
        self.pending: List[Tuple[bytes, int, bool]] = []  # (data, dur_ts, sync)
        self.decode_ts = 0  # cumulative decode time of first pending sample
        self.pending_dur = 0  # sum of pending durations (ts units)
        # non-fragmented accumulation
        self.table = bmff.SampleTable()
        self.current_desc = 1  # active stsd sample_description_index

    # -- GOP queue (fragmented path) ----------------------------------------
    @property
    def intra_only(self) -> bool:
        """Audio / metadata streams: every sample is a sync point, so a
        fragment may cut anywhere (the reference drains partial GOPs for
        intra-only streams)."""
        return not (self.track is not None and self.track.handler == "vide")

    def queue_sample(self, data: bytes, dur_ts: int, sync: bool,
                     pts_ts: Optional[int] = None) -> None:
        """Queue one sample.  pts_ts (track-timescale units) lets a sparse
        stream's NEW GOP start later than the cumulative end (late first
        keyframe / gaps between GOPs); contiguous streams stay on the
        cumulative clock so duration rounding never drifts."""
        start = self.queued_end_ts
        if self.intra_only:
            # sparse starts: the stream's first sample, or a hole of at
            # least one sample (sub-sample pts jitter stays on the
            # cumulative clock so duration rounding never drifts)
            if pts_ts is not None and (
                    (pts_ts > start and not self.gops and not self.pending
                     and not self.decode_ts)
                    or pts_ts >= start + dur_ts):
                start = pts_ts
            g = _Gop(start)
            g.samples.append((data, dur_ts, True))
            g.dur_ts = dur_ts
            g.final = True
            self.gops.append(g)
            return
        if not sync and not self.gops and not self.pending \
                and not self.decode_ts:
            # delta units before the stream's first keyframe cannot be
            # decoded: dropped (fmp4mux's pre-first-GOP discard —
            # tests/fmp4_tests.rs test_multi_stream_late_key_frame)
            return
        if sync or not self.gops:
            if self.gops:
                self.gops[-1].final = True
            if pts_ts is not None and pts_ts > start:
                start = pts_ts
            self.gops.append(_Gop(start))
        g = self.gops[-1]
        g.samples.append((data, dur_ts, sync))
        g.dur_ts += dur_ts

    def finalize_gops(self) -> None:
        """EOS / forced drain: all queued GOP ends become known."""
        for g in self.gops:
            g.final = True

    @property
    def queued_end_ts(self) -> int:
        if self.gops:
            return self.gops[-1].end_ts
        return self.decode_ts + self.pending_dur

    def stage_up_to(self, cut_ts: Optional[int]) -> None:
        """Move queued samples into `pending` for the next cut.

        cut_ts = None stages everything.  Video streams move whole GOPs
        with end <= cut_ts (at least one if the first final GOP overshoots
        — the long-GOP fragment extension, fmp4mux/imp.rs:1684-1729);
        intra-only streams split GOP-lessly at the boundary."""
        while self.gops:
            g = self.gops[0]
            if cut_ts is None or g.end_ts <= cut_ts:
                self._stage_gop(g)
                continue
            if self.intra_only or not g.final:
                break
            if not self.pending and g.start_ts < cut_ts:
                # late keyframe: the whole (finalized) GOP extends the
                # fragment past its target end
                self._stage_gop(g)
            break

    def _stage_gop(self, g: "_Gop") -> None:
        if not self.pending and g.start_ts > self.decode_ts:
            # sparse stream: the fragment's decode time jumps to the GOP
            # start (tfdt follows the actual timeline, not the sample sum)
            self.decode_ts = g.start_ts
        self.pending.extend(g.samples)
        self.pending_dur += g.dur_ts
        assert self.gops[0] is g
        self.gops.pop(0)

    def stage_chunk_up_to(self, cut_ts: int) -> None:
        """Chunk staging: split GOP-lessly at the boundary (a chunk's first
        buffer may be a delta unit — ChunkStrategy::Duration)."""
        while self.gops:
            g = self.gops[0]
            if g.end_ts <= cut_ts:
                self._stage_gop(g)
                continue
            while g.samples and g.start_ts < cut_ts:
                if not self.pending and g.start_ts > self.decode_ts:
                    self.decode_ts = g.start_ts
                data, dur, sync = g.samples.pop(0)
                self.pending.append((data, dur, sync))
                self.pending_dur += dur
                g.start_ts += dur
                g.dur_ts -= dur
            break

    def _apply_tags(self, s) -> None:
        """Per-track language (mdhd) and video orientation (tkhd matrix)
        from caps fields or TAG events (reference boxes.rs:1137-1231)."""
        if self.track is None:
            return
        lang = s.get("language", None) or self.tags.get("language-code")
        if lang:
            self.track.language = str(lang)
        orient = (s.get("image-orientation", None)
                  or self.tags.get("image-orientation"))
        if orient and self.track.handler == "vide":
            try:
                self.track.orientation = int(str(orient).replace("rotate-", ""))
            except ValueError:
                pass

    def configure(self, caps: Caps, first_frame: Optional[bytes] = None) -> None:
        self.configured_caps = caps
        s = caps.structure(0)
        if s.name == "audio/x-ac3":
            if first_frame is None:
                return  # dac3 needs the first syncframe; retried with a peek
            self.kind = "caudio"
            rate = s.get("rate", 48000)
            self.timescale = rate
            self.frame_dur_ts = 1536  # AC-3 frame = 1536 samples
            entry = bmff.ac3_sample_entry(first_frame)
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "soun", entry,
                default_sample_duration=self.frame_dur_ts,
            )
            return
        if s.name == "audio/x-eac3":
            if first_frame is None:
                return  # dec3 needs the first syncframe; retried with a peek
            self.kind = "caudio"
            rate = s.get("rate", 48000)
            self.timescale = rate
            _, _, numblks, _, _, _, _ = bmff.parse_eac3_header(first_frame)
            self.frame_dur_ts = numblks * 256
            entry = bmff.eac3_sample_entry(first_frame)
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "soun", entry,
                default_sample_duration=self.frame_dur_ts,
            )
            return
        if s.name in ("video/x-h264", "video/x-h265", "video/x-h266",
                      "video/x-av1", "video/x-vp8", "video/x-vp9"):
            self.kind = "cvideo"
            w, h = s.get("width", 0), s.get("height", 0)
            fps = s.get("framerate")
            self.timescale = 90000
            self.frame_dur_ts = 0  # per-buffer durations
            if fps is not None:
                self.frame_dur_ts = 90000 * fps.denominator // fps.numerator
            codec_data = s.get("codec_data", b"")
            fmt = s.get("stream-format")
            if s.name == "video/x-h264":
                fourcc = b"avc3" if fmt == "avc3" else b"avc1"
                entry = bmff.avc1_sample_entry(w, h, codec_data, fourcc=fourcc)
            elif s.name == "video/x-h265":
                fourcc = b"hev1" if fmt == "hev1" else b"hvc1"
                if codec_data[:1] != b"\x01":
                    # raw parameter-set NALs instead of a ready hvcC: build
                    # the record from VPS/SPS/PPS (bmff.hvcc_from_parameter_sets)
                    nals = _split_annexb(codec_data)
                    by_type = {((n[0] >> 1) & 0x3F): n for n in nals if len(n) > 2}
                    if 33 not in by_type:
                        raise ValueError(
                            "video/x-h265 needs codec_data: either a ready "
                            "hvcC record or Annex-B VPS/SPS/PPS parameter "
                            "sets (none found)")
                    codec_data = bmff.hvcc_from_parameter_sets(
                        by_type.get(32, b""), by_type[33],
                        by_type.get(34, b""))
                entry = bmff.hvc1_sample_entry(w, h, codec_data, fourcc=fourcc)
            elif s.name == "video/x-h266":
                fourcc = b"vvi1" if fmt == "vvi1" else b"vvc1"
                entry = bmff.vvc1_sample_entry(w, h, codec_data, fourcc=fourcc)
            elif s.name == "video/x-av1":
                entry = bmff.av01_sample_entry(w, h, codec_data)
            elif s.name == "video/x-vp8":
                entry = bmff.vp08_sample_entry(w, h)
            else:
                entry = bmff.vp09_sample_entry(w, h)
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "vide", entry, width=w, height=h,
                default_sample_duration=self.frame_dur_ts,
            )
            return
        if s.name == "audio/x-flac":
            self.kind = "caudio"
            codec_data = s.get("codec_data", b"")
            from ...codecs import flac as _flac

            if codec_data[:4] == b"fLaC":
                info, _ = _flac.parse_header(codec_data)
                streaminfo = codec_data[8:8 + 34]
            elif len(codec_data) >= 34:
                info, _ = _flac.parse_header(
                    b"fLaC" + bytes([0x80, 0, 0, len(codec_data)]) + codec_data)
                streaminfo = codec_data[:34]
            else:
                return  # need STREAMINFO codec_data
            self.timescale = info.rate
            self.frame_dur_ts = info.max_block
            entry = bmff.flac_sample_entry(info.channels, info.rate, streaminfo)
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "soun", entry,
                default_sample_duration=self.frame_dur_ts,
            )
            return
        if s.name in ("audio/mpeg", "audio/x-opus"):
            self.kind = "caudio"
            rate = s.get("rate", 48000)
            ch = s.get("channels", 2)
            self.timescale = rate
            if s.name == "audio/mpeg":
                entry = bmff.mp4a_sample_entry(ch, rate, s.get("codec_data", b""))
                self.frame_dur_ts = 1024  # AAC frame
            else:
                entry = bmff.opus_sample_entry(ch, rate)
                self.frame_dur_ts = rate * 20 // 1000  # 20 ms default
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "soun", entry,
                default_sample_duration=self.frame_dur_ts,
            )
            return
        if s.name == "audio/x-raw":
            self.kind = "audio"
            self.ainfo = AudioInfo.from_caps(caps)
            self.timescale = self.ainfo.rate
            entry = bmff.pcm_sample_entry(
                self.ainfo.format, self.ainfo.channels, self.ainfo.rate
            )
            self.track = bmff.TrackConfig(
                self.track_id, self.timescale, "soun", entry
            )
        elif s.name == "video/x-raw" or s.name in (
                "application/x-zlib-compressed",
                "application/x-deflate-compressed",
                "application/x-brotli-compressed"):
            compression = None
            if s.name != "video/x-raw":
                # generically-compressed raw video: the real format rides in
                # original-caps (reference uncompressed.rs:80-91); samples
                # are opaque compressed payloads
                compression = s.name.split("/")[1][2:].rsplit("-", 1)[0]
                inner = s.get("original-caps")
                if inner is None:
                    raise ValueError(
                        f"{s.name} caps need an original-caps field")
                self.kind = "cvideo"
                self.vinfo = VideoInfo.from_caps(inner)
            else:
                self.kind = "video"
                self.vinfo = VideoInfo.from_caps(caps)
            fps = self.vinfo.fps
            # conventional exact pairing: ts = fps_n*1000, frame dur = fps_d*1000
            mul = 1000 if fps.numerator < 1000 else 1
            self.timescale = fps.numerator * mul
            self.frame_dur_ts = fps.denominator * mul
            entry = bmff.uncv_sample_entry(
                self.vinfo.format, self.vinfo.width, self.vinfo.height,
                compression=compression,
            )
            self.track = bmff.TrackConfig(
                self.track_id,
                self.timescale,
                "vide",
                entry,
                width=self.vinfo.width,
                height=self.vinfo.height,
                default_sample_duration=self.frame_dur_ts,
            )
        else:
            raise ValueError(f"unsupported mux input caps: {caps!r}")

    def to_sample(self, buf: Buffer) -> Tuple[bytes, int, bool]:
        """The buffer as (sample bytes, duration in the track's timescale,
        sync); the payload's one read-back to the host."""
        if self.kind == "audio":
            d = buf.data
            if isinstance(d, torch.Tensor):
                d = d.to(torch.from_numpy(np.empty(0, self.ainfo.dtype)).dtype)
            arr = host_array(d)
            if arr.dtype != self.ainfo.dtype:
                arr = arr.astype(self.ainfo.dtype)
            data = arr.tobytes()
            # frames from byte count (S24LE packs 3-byte samples in uint8)
            return data, len(data) // self.ainfo.bpf, True
        if self.kind in ("caudio", "cvideo"):
            data = host_bytes(buf.data, np.uint8)
            if buf.duration is not None:
                dur = buf.duration * self.timescale // SECOND
            else:
                dur = self.frame_dur_ts or self.timescale // 30
            sync = not buf.has_flag(BufferFlags.DELTA_UNIT)
            return data, dur, sync
        d = buf.data
        if isinstance(d, torch.Tensor) and d.dtype != torch.uint8:
            d = d.clamp(0, 255).to(torch.uint8)
        arr = host_array(d)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        sync = not buf.has_flag(BufferFlags.DELTA_UNIT)
        return arr.tobytes(), self.frame_dur_ts, sync

    @property
    def end_ns(self) -> int:
        """Running time covered by everything consumed so far."""
        return (self.decode_ts + self.pending_dur) * SECOND // self.timescale


class _MuxBase(Aggregator):
    """Shared pad/stream bookkeeping for both muxer families."""

    def sink_event(self, pad, event) -> bool:
        from ...core.events import EventType

        if event.type == EventType.CAPS:
            # caps changes after configuration wait for the next keyframe
            # (fmp4mux: allowed at GOP boundaries only,
            # tests/fmp4_tests.rs test_caps_change_at_gop_boundary*)
            st = self._streams.get(pad.name)
            new = event.get("caps")
            if st is not None and st.track is not None \
                    and st.configured_caps is not None \
                    and new != st.configured_caps:
                st.pending_caps = new
                st.pending_caps_after = len(getattr(pad, "queue", ()) or ())
            return True
        if event.type == EventType.GAP:
            # a gap extends the previous sample's duration so the timeline
            # stays contiguous (fmp4_tests.rs test_gap_events)
            st = self._streams.get(pad.name)
            dur = event.get("duration")
            if st is not None and dur and st.timescale:
                gap_ts = int(dur) * st.timescale // SECOND
                if st.gops and st.gops[-1].samples:
                    g = st.gops[-1]
                    data, sdur, sync = g.samples[-1]
                    g.samples[-1] = (data, sdur + gap_ts, sync)
                    g.dur_ts += gap_ts
                elif st.pending:
                    data, sdur, sync = st.pending[-1]
                    st.pending[-1] = (data, sdur + gap_ts, sync)
                    st.pending_dur += gap_ts
                else:
                    st.decode_ts += gap_ts
            return True
        if event.type == EventType.TAG:
            st = self._streams.get(pad.name)
            if st is not None:
                tags = event.get("tags") or {
                    k: v for k, v in event.fields.items() if k != "tags"}
                old = (st.tags.get("language-code"),
                       st.tags.get("image-orientation"))
                st.tags.update(tags)
                new = (st.tags.get("language-code"),
                       st.tags.get("image-orientation"))
                if (st.track is not None and new != old
                        and self._prop_specs.get("header-update-mode")
                        and self.get_property("header-update-mode") == "caps"):
                    # track-metadata change mid-stream: refresh the init
                    # header at the next GOP boundary (fmp4_tests.rs
                    # test_language_change_at_gop_boundary)
                    st.pending_retag = True
            return True
        return super().sink_event(pad, event)

    SINK_TEMPLATE_CAPS = _SINK_CAPS
    SINGLE_STREAM = False
    VARIANT = "iso-fragmented"  # src caps "variant" field (fmp4mux/imp.rs:4146-4153)
    MAJOR_BRAND = b"iso6"
    COMPAT_BRANDS: Tuple[bytes, ...] = (b"iso6",)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._streams: Dict[str, _Stream] = {}
        self._next_track_id = 1
        self._header_sent = False
        self._bytes_pushed = 0
        if self.SINGLE_STREAM:
            pad = self.request_sink_pad("sink")
            self._stream_for(pad)

    def request_sink_pad(self, name: Optional[str] = None) -> AggregatorPad:
        if self.SINGLE_STREAM and self._streams:
            raise ValueError(f"{self.ELEMENT_NAME} is single-stream (one sink pad)")
        pad = super().request_sink_pad(name)
        self._stream_for(pad)
        return pad

    def _stream_for(self, pad: AggregatorPad) -> _Stream:
        if pad.name not in self._streams:
            self._streams[pad.name] = _Stream(pad, self._next_track_id)
            self._next_track_id += 1
        return self._streams[pad.name]

    def active_streams(self) -> List[_Stream]:
        return [self._streams[p.name] for p in self.agg_pads()]

    def _apply_trak_override(self, st: _Stream) -> None:
        """Per-pad trak-timescale property (GstFMP4MuxPad/GstRsMP4MuxPad):
        rescale the configured track to the requested units/second."""
        tts = int(st.pad._props.get("trak-timescale", 0) or 0)
        if not tts or st.track is None or not st.timescale \
                or tts == st.timescale:
            return
        old = st.timescale
        if st.frame_dur_ts:
            st.frame_dur_ts = st.frame_dur_ts * tts // old
        if st.track.default_sample_duration:
            st.track.default_sample_duration = \
                st.track.default_sample_duration * tts // old
        st.track.timescale = tts
        st.timescale = tts

    def _apply_pad_overrides(self, st: _Stream) -> None:
        self._apply_trak_override(st)
        # GstRsMP4MuxPad image-sequence: ISO/IEC 23008-12 image sequences
        # use the 'pict' handler instead of 'vide'
        if st.pad._props.get("image-sequence") and st.track is not None \
                and st.track.handler == "vide":
            st.track.handler = "pict"

    def _ensure_configured(self) -> bool:
        for st in self.active_streams():
            if st.track is None:
                if st.pad.current_caps is None:
                    return False
                first = _first_frame(st.pad.current_caps, st.pad.peek_buffer())
                st.configure(st.pad.current_caps, first_frame=first)
                if st.track is None:
                    return False  # needs the first frame (AC-3 dac3)
                self._apply_pad_overrides(st)
                st._apply_tags(st.pad.current_caps.structure(0))
                ct = self.get_property("precision-clock-type")
                if (ct in (None, "none")) and "tai-precision-timestamps" in \
                        self._props and self.get_property("tai-precision-timestamps"):
                    ct = "unknown"  # taic clock box via the TAI property
                if ct and ct != "none":
                    # ISO/IEC 23001-17 taic inside the sample entry
                    # (precision_timestamps.rs)
                    st.track.sample_entry = bmff.append_to_sample_entry(
                        st.track.sample_entry,
                        bmff.taic_box(
                            time_uncertainty=self.get_property(
                                "precision-clock-time-uncertainty")
                            or bmff.TAIC_TIME_UNCERTAINTY_UNKNOWN,
                            clock_type=ct,
                        ),
                    )
        return True

    def _src_caps(self) -> Caps:
        return Caps.builder("video/quicktime", variant=self.VARIANT)

    def _push_bytes(
        self, data: bytes, *, pts: Optional[int], duration: Optional[int], flags: BufferFlags
    ) -> FlowReturn:
        buf = Buffer(
            np.frombuffer(data, np.uint8),
            pts=pts,
            duration=duration,
            offset=self._bytes_pushed,
            flags=flags,
        )
        self._bytes_pushed += len(data)
        return self.finish_buffer(buf)

    def on_paused_to_ready(self) -> None:
        self._header_sent = False
        self._bytes_pushed = 0
        for st in self._streams.values():
            st.pending.clear()
            st.decode_ts = 0
            st.pending_dur = 0
            st.table = bmff.SampleTable()


class FMP4Mux(_MuxBase):
    """Fragmented-MP4 muxer core (reference fmp4mux/imp.rs)."""

    ELEMENT_CLASS = "Muxer"
    PROPERTIES = [
        # defaults: fmp4mux/imp.rs:146-160
        Prop("fragment-duration", 10 * SECOND, type="uint64", minimum=1,
             doc="target fragment duration in ns (DEFAULT_FRAGMENT_DURATION)"),
        Prop("chunk-duration", 0, type="uint64",
             doc="0 = no chunking; else emit moof+mdat every chunk"),
        Prop("header-update-mode", "none", type="enum",
             choices=["none", "rewrite", "update", "caps"]),
        Prop("write-edts-mode", "auto", type="enum",
             choices=["auto", "always", "never"],
             doc="edit lists: auto writes elst only when the stream starts "
                 "past zero (DEFAULT_WRITE_EDTS_MODE=Auto, fmp4mux/imp.rs:153)"),
        Prop("write-mfra", False, type="bool"),
        Prop("precision-clock-type", "none", type="enum",
             choices=["none", "unknown", "can-sync", "cannot-sync"],
             doc="write ISO 23001-17 taic boxes into the sample entries"),
        Prop("precision-clock-time-uncertainty", 0, type="uint64",
             doc="taic time uncertainty in ns (0 = unknown)"),
        Prop("write-mehd", False, type="bool"),
        Prop("movie-timescale", 0, type="uint", doc="0 = auto (1000)"),
        Prop("start-fragment-sequence-number", 1, type="uint", minimum=1),
        Prop("offset-to-zero", False, type="bool",
             doc="shift all timestamps so the stream starts at zero "
                 "(recording use; suppresses the edit list the nonzero "
                 "start would otherwise get)"),
        # GstFMP4Mux base surface (reference isobmff other-types;
        # fmp4mux/imp.rs:160-199 defaults)
        Prop("chunk-mode", "none", type="enum",
             choices=["none", "duration", "keyframe"],
             doc="chunk on duration (needs chunk-duration) or on every "
                 "keyframe; none = duration when chunk-duration is set"),
        Prop("interleave-bytes", 0, type="uint64",
             doc="mdat interleave granularity between streams in bytes "
                 "(0 = use interleave-time)"),
        Prop("interleave-time", 250_000_000, type="uint64",
             doc="mdat interleave granularity between streams in ns; each "
                 "traf carries one trun per interleave run and runs lay "
                 "out round-robin"),
        Prop("manual-split", False, type="bool",
             doc="disable duration-based splitting; fragments/chunks cut "
                 "only on FMP4MuxSplitNow custom downstream events"),
        Prop("send-force-keyunit", True, type="bool",
             doc="send upstream force-keyunit events requesting keyframes "
                 "at upcoming fragment boundaries"),
        Prop("decode-time-offset", 0, type="int",
             doc="signed ns offset applied to every tfdt (clamped at 0)"),
        Prop("enable-keyframe-meta", False, type="bool",
             doc="attach FMP4KeyframeMeta to fragment headers that start "
                 "on a keyframe (single-stream; consumed by hlscmafsink)"),
        Prop("latency", 0, type="uint64", mutable="ready",
             doc="live deadline: with a clock and latency > 0, a fragment "
                 "whose boundary passed this long ago on the clock is cut "
                 "with the data on hand instead of waiting for lagging "
                 "streams (the aggregator timeout path, fmp4_tests.rs "
                 "test_live_timeout); 0 = wait for data forever"),
    ]
    # GstFMP4MuxPad surface
    PAD_PROPERTIES = {
        "sink": [
            Prop("trak-timescale", 0, type="uint", mutable="ready",
                 doc="track timescale override (units/s, 0 = automatic)"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._seq = 1
        self._frag_start_ns = 0
        self._chunk_start_ns = 0
        self._first_pts: Optional[int] = None
        self._mfra: Dict[int, List[bmff.MfraEntry]] = {}
        self._total_dur_ts: Dict[int, int] = {}
        self._timeout_id = None
        self._armed_deadline: Optional[int] = None
        # guards muxer state between the streaming thread (aggregate/drain)
        # and the clock callback thread (_on_timeout); taken after the
        # aggregator's lock on both
        self._flow_lock = threading.RLock()

    def on_ready_to_paused(self) -> None:
        # header-update-mode semantics: none/rewrite never re-send the
        # header mid-stream (incompatible caps changes are ignored); caps
        # re-sends a fresh init segment downstream on incompatible changes;
        # update re-pushes the finalized header at EOS.  rewrite's
        # seek-back-and-overwrite is approximated by the EOS re-push like
        # update (this runtime's downstreams are push-only).
        self._seq = self.get_property("start-fragment-sequence-number")
        self._frag_start_ns = 0
        self._chunk_start_ns = 0
        self._first_pts = None
        self._mfra = {}
        self._total_dur_ts = {}

    # -- header ------------------------------------------------------------
    def _movie_timescale(self) -> int:
        ts = self.get_property("movie-timescale")
        return ts if ts else 1000

    def _header_bytes(self, *, final: bool) -> bytes:
        streams = self.active_streams()
        tracks = [st.track for st in streams]
        duration = 0
        if final:
            mts = self._movie_timescale()
            durs = [
                self._total_dur_ts.get(st.track_id, 0) * mts // st.timescale
                for st in streams
            ]
            duration = max(durs) if durs else 0
        mode = self.get_property("write-edts-mode")
        for st in streams:
            if st.track is None:
                continue
            start = 0 if self.get_property("offset-to-zero") \
                else (self._first_pts or 0)
            if mode == "always" or (mode == "auto" and start > 0):
                media_time = start * st.timescale // SECOND
                st.track.elst = [(0, media_time)]
            else:
                st.track.elst = None
        hdr = bmff.ftyp(self.MAJOR_BRAND, 0, list(self.COMPAT_BRANDS))
        extra = b""
        if getattr(self, "ONVIF", False):
            # cstb with the UTC start of the earliest stream (boxes.rs:2440)
            extra = bmff.onvif_meta_box(self._first_pts or 0)
        hdr += bmff.moov(
            tracks,
            self._movie_timescale(),
            fragmented=True,
            duration=duration,
            write_mehd=self.get_property("write-mehd") and final,
            extra_boxes=extra,
        )
        return hdr

    def _send_header(self) -> FlowReturn:
        self.srcpad.push_event(Event.new_caps(self._src_caps()))
        self.srcpad.push_event(Event.new_segment(Segment()))
        self._header_sent = True
        # HEADER|DISCONT on the init segment (fmp4_tests.rs
        # test_buffer_flags_single_stream: stream header flags)
        return self._push_bytes(
            self._header_bytes(final=False), pts=0, duration=None,
            flags=BufferFlags.HEADER | BufferFlags.DISCONT,
        )

    # -- fragments -----------------------------------------------------------
    def _interleave_runs(self, st: _Stream):
        """Split a stream's pending samples into interleave-bounded runs
        (GstFMP4Mux interleave-bytes/-time; one trun per run, mdat
        round-robin across tracks — fmp4mux/imp.rs:3221-3230)."""
        il_bytes = self.get_property("interleave-bytes")
        il_time = self.get_property("interleave-time")
        il_ts = il_time * st.timescale // SECOND if il_time else 0
        runs = []
        cur, cur_bytes, cur_dur = [], 0, 0
        for d, dur, sync in st.pending:
            cur.append(bmff.FragmentSample(len(d), dur, sync))
            cur_bytes += len(d)
            cur_dur += dur
            if (il_bytes and cur_bytes >= il_bytes) or \
                    (not il_bytes and il_ts and cur_dur >= il_ts):
                runs.append((cur, cur_bytes, len(runs)))
                cur, cur_bytes, cur_dur = [], 0, 0
        if cur:
            runs.append((cur, cur_bytes, len(runs)))
        # carve the data per run
        blob = b"".join(d for d, _dur, _s in st.pending)
        out, off = [], 0
        for samples, nbytes, _i in runs:
            out.append((samples, blob[off:off + nbytes]))
            off += nbytes
        return out

    def _cut(self, *, fragment_boundary: bool) -> FlowReturn:
        streams = [st for st in self.active_streams() if st.pending]
        if not streams:
            return FlowReturn.OK
        frags = []
        start_ns = min(st.decode_ts * SECOND // st.timescale for st in streams)
        end_ns = max(st.end_ns for st in streams)
        dto = self.get_property("decode-time-offset")
        starts_on_keyframe = all(st.pending[0][2] for st in streams)
        for st in streams:
            runs = self._interleave_runs(st) if len(streams) > 1 else None
            samples = [bmff.FragmentSample(len(d), dur, sync) for d, dur, sync in st.pending]
            tfdt = st.decode_ts
            if dto:
                # decode-time-offset: signed ns applied to the tfdt
                # (fmp4mux/imp.rs:3396-3403), clamped — tfdt is unsigned
                tfdt = max(0, tfdt + dto * st.timescale // SECOND)
            frags.append(
                bmff.TrackFragment(
                    st.track_id,
                    tfdt,
                    samples,
                    b"".join(d for d, _dur, _s in st.pending),
                    runs=runs,
                )
            )
            self._mfra.setdefault(st.track_id, []).append(
                bmff.MfraEntry(st.decode_ts, self._bytes_pushed)
            )
            st.decode_ts += st.pending_dur
            self._total_dur_ts[st.track_id] = st.decode_ts
            st.pending.clear()
            st.pending_dur = 0
        data = bmff.moof(self._seq, frags)
        if self.VARIANT == "dash":
            # DASH media segments are prefixed with styp (brands.rs:322-328)
            data = bmff.styp(b"msdh", 0, [b"msdh", b"msix"]) + data
        self._seq += 1
        # the chunk that STARTS a fragment is the non-delta one (reference
        # fragment headers carry no DELTA_UNIT, continuation chunk headers
        # do — fmp4_tests.rs test_chunking_single_stream flags)
        flags = (BufferFlags.NONE if start_ns <= self._frag_start_ns
                 else BufferFlags.DELTA_UNIT)
        buf = Buffer(
            np.frombuffer(data, np.uint8),
            pts=start_ns, duration=end_ns - start_ns,
            offset=self._bytes_pushed, flags=flags,
        )
        if (self.get_property("enable-keyframe-meta")
                and len(self._streams) == 1 and starts_on_keyframe):
            # FMP4KeyframeMeta for hlscmafsink (fmp4mux/imp.rs:3467,3541)
            buf.add_meta(FMP4KeyframeMeta(pts=start_ns))
        self._bytes_pushed += len(data)
        ret = self.finish_buffer(buf)
        if fragment_boundary:
            self._frag_start_ns = end_ns
            self._request_keyunit(end_ns)
            self._arm_timeout()  # live deadline rolls to the new fragment
        return ret

    def _consume_pad_queue(self, st: _Stream) -> None:
        """Drain a pad's queued buffers into the GOP queue, honoring the
        caps-event serialization (pending_caps applies only to buffers
        pushed AFTER the caps event)."""
        while st.pad.has_buffer():
            buf = st.pad.pop_buffer()
            if st.pending_caps is not None and st.pending_caps_after > 0:
                st.pending_caps_after -= 1
            elif st.pending_caps is not None:
                self._apply_caps_change(st, buf)
            data, dur, sync = st.to_sample(buf)
            pts_ts = None if buf.pts is None else \
                buf.pts * st.timescale // SECOND
            st.queue_sample(data, dur, sync, pts_ts=pts_ts)

    # -- live timeout (aggregate(timeout=true), fmp4mux test_live_timeout) --
    def on_playing_to_paused(self) -> None:
        self._unarm_timeout()

    def on_paused_to_playing(self) -> None:
        self._arm_timeout()

    def _unarm_timeout(self) -> None:
        if self._timeout_id is not None:
            self._timeout_id.unschedule()
            self._timeout_id = None
        self._armed_deadline = None

    def _arm_timeout(self) -> None:
        lat = self.get_property("latency")
        if not lat or self.clock is None or self._first_pts is None:
            return
        deadline = (self._frag_start_ns
                    + self.get_property("fragment-duration") + lat)
        if self._armed_deadline == deadline and self._timeout_id is not None:
            return
        self._unarm_timeout()
        cid = self.clock.new_single_shot_id(self.base_time + deadline)
        self._timeout_id = cid
        self._armed_deadline = deadline
        cid.wait_async(self._on_timeout)

    def _on_timeout(self, cid) -> None:
        with self._agg_lock, self._flow_lock:
            if cid is not self._timeout_id or cid._unscheduled:
                return
            self._timeout_id = None
            self._armed_deadline = None
            self._timeout_cut()

    def _timeout_cut(self) -> None:
        # the regular aggregate path only runs when EVERY pad has data; on
        # deadline the lagging pads stop gating — consume what's queued
        for st in self.active_streams():
            self._consume_pad_queue(st)
        live = [s for s in self.active_streams()
                if not s.pad.is_inactive() or s.pending or s.gops]
        if live and self._header_sent:
            # deadline passed: cut the fragment with the data on hand; a
            # lagging stream's missing tail is simply absent (its next
            # fragment's tfdt jumps over the hole)
            frag_end = self._frag_start_ns + \
                self.get_property("fragment-duration")
            for s in live:
                s.finalize_gops()
            cut_ns = self._select_cut(live, frag_end)
            for s in live:
                s.stage_up_to(cut_ns * s.timescale // SECOND)
            if any(s.pending for s in live):
                self._cut(fragment_boundary=True)
        self._arm_timeout()

    def _request_keyunit(self, frag_start_ns: int) -> None:
        """send-force-keyunit: ask upstream video encoders for a keyframe
        at the NEXT fragment boundary (fmp4mux/imp.rs:3262-3315)."""
        if self.get_property("manual-split") or \
                not self.get_property("send-force-keyunit"):
            return
        target = frag_start_ns + self.get_property("fragment-duration")
        for st in self.active_streams():
            if st.track is not None and st.track.handler == "vide" \
                    and st.pad.peer is not None:
                st.pad.push_event(Event(
                    EventType.CUSTOM_UPSTREAM, name="GstForceKeyUnit",
                    **{"running-time": target, "all-headers": True,
                       "count": self._seq}))

    def _apply_caps_change(self, st: _Stream, buf: Buffer) -> FlowReturn:
        """Reconfigure a stream on a mid-stream caps change.  Only legal on
        a keyframe (GOP boundary).  A COMPATIBLE change (same sample entry)
        is adopted silently in any mode; an INCOMPATIBLE one cuts the
        current fragment and emits a fresh init header when
        header-update-mode=caps, and is IGNORED otherwise (fmp4mux
        test_caps_change_at_gop_boundary / _not_allowed / _compatible)."""
        import copy

        from ...core.element import FlowError

        if buf.has_flag(BufferFlags.DELTA_UNIT):
            raise FlowError(
                FlowReturn.ERROR,
                f"{self.name}: caps change within a GOP (next buffer is a "
                "delta unit) is not supported")
        new_caps = st.pending_caps
        st.pending_caps = None
        snapshot = {k: copy.deepcopy(getattr(st, k, None))
                    for k in ("track", "timescale", "configured_caps",
                              "kind", "frame_dur_ts", "ainfo")}
        old_entry = st.track.sample_entry
        old_ts = st.timescale
        first = _first_frame(new_caps, buf)
        st.configure(new_caps, first_frame=first)
        incompatible = st.track.sample_entry != old_entry
        if incompatible and self.get_property("header-update-mode") != "caps":
            # the running header cannot be replaced in this mode: the change
            # is dropped and muxing continues under the old configuration
            # (fmp4_tests.rs test_caps_change_at_gop_boundary_not_allowed)
            for k, v in snapshot.items():
                setattr(st, k, v)
            return FlowReturn.OK
        if incompatible:
            # roll back, close the running fragment under the OLD config
            # (the staged samples' durations are in the old timescale),
            # then adopt the new config and re-header
            for k, v in snapshot.items():
                setattr(st, k, v)
            for s in self.active_streams():
                s.finalize_gops()
                s.stage_up_to(None)
            ret = self._cut(fragment_boundary=True)
            if ret != FlowReturn.OK:
                return ret
            st.configure(new_caps, first_frame=first)
        st._apply_tags(new_caps.structure(0))
        if st.timescale != old_ts and old_ts:
            st.decode_ts = st.decode_ts * st.timescale // old_ts
        if incompatible:
            # downstream needs a new init segment (HEADER, and DISCONT —
            # the decode chain restarts: fmp4_tests.rs caps_changed_verify)
            return self._push_bytes(
                self._header_bytes(final=False), pts=None, duration=None,
                flags=BufferFlags.HEADER | BufferFlags.DISCONT)
        return FlowReturn.OK

    # -- aggregation ------------------------------------------------------------
    def sink_event(self, pad, event) -> bool:
        if event.type == EventType.CUSTOM_DOWNSTREAM \
                and event.get("name") == "FMP4MuxSplitNow":
            # manual-split protocol (reference SplitNowEvent, mod.rs:659-678):
            # buffers after this event start a new fragment (chunk=false)
            # or chunk (chunk=true)
            self._cut(fragment_boundary=not event.get("chunk", False))
            return True
        return super().sink_event(pad, event)

    def aggregate(self, timeout: bool) -> FlowReturn:
        with self._flow_lock:
            return self._aggregate_locked(timeout)

    def _aggregate_locked(self, timeout: bool) -> FlowReturn:
        if not self._ensure_configured():
            return FlowReturn.OK
        if not self._header_sent:
            ret = self._send_header()
            if ret != FlowReturn.OK:
                return ret
        # consume the earliest queued buffer to keep streams interleaved
        candidates = [
            (st.pad.peek_buffer().pts or 0, st)
            for st in self.active_streams()
            if st.pad.has_buffer()
        ]
        if not candidates:
            return FlowReturn.OK
        _pts, st = min(candidates, key=lambda c: c[0])
        buf = st.pad.pop_buffer()
        manual = self.get_property("manual-split")
        frag_dur = self.get_property("fragment-duration")
        if self._first_pts is None:
            self._first_pts = buf.pts or 0
            # the fragment grid starts at the EARLIEST PTS, not zero: a
            # stream starting at/after the first boundary would otherwise
            # never fill a fragment and queue GOPs unboundedly (the
            # reference bases the grid on the first buffer; write-edts-mode
            # auto records the nonzero start in the elst).  With
            # offset-to-zero the timestamps themselves shift to zero.
            if self.get_property("offset-to-zero"):
                self._frag_start_ns = 0
                self._chunk_start_ns = 0
            else:
                self._frag_start_ns = self._first_pts
                self._chunk_start_ns = self._first_pts
            # earliest PTS known -> announce the SECOND fragment's start to
            # upstream encoders (fmp4mux/imp.rs:2085-2103)
            if not manual:
                self._request_keyunit(self._frag_start_ns)
            self._arm_timeout()
        if self.get_property("offset-to-zero") and self._first_pts:
            shift = self._first_pts
            out = Buffer(buf.data,
                         pts=None if buf.pts is None else buf.pts - shift,
                         dts=None if buf.dts is None else buf.dts - shift,
                         duration=buf.duration, offset=buf.offset,
                         offset_end=buf.offset_end, flags=buf.flags)
            out.metas = list(buf.metas)
            buf = out
        if st.pending_caps is not None and st.pending_caps_after > 0:
            st.pending_caps_after -= 1  # pre-event buffer: old caps still apply
        elif st.pending_caps is not None:
            ret = self._apply_caps_change(st, buf)
            if ret != FlowReturn.OK:
                return ret
        elif st.pending_retag and not buf.has_flag(BufferFlags.DELTA_UNIT):
            # language/orientation tag change: cut at this GOP boundary and
            # refresh the init header (test_language_change_at_gop_boundary)
            st.pending_retag = False
            for s in self.active_streams():
                s.finalize_gops()
                s.stage_up_to(None)
            ret = self._cut(fragment_boundary=True)
            if ret != FlowReturn.OK:
                return ret
            st._apply_tags(st.configured_caps.structure(0))
            ret = self._push_bytes(
                self._header_bytes(final=False), pts=None, duration=None,
                flags=BufferFlags.HEADER | BufferFlags.DISCONT)
            if ret != FlowReturn.OK:
                return ret
        data, dur, sync = st.to_sample(buf)
        # chunk-mode=keyframe: every keyframe starts a new chunk
        # (ChunkStrategy::Keyframe, fmp4mux/imp.rs:133,3028); a keyframe
        # at/after the fragment end also closes the fragment
        if (not manual and sync and (st.pending or st.gops)
                and self.get_property("chunk-mode") == "keyframe"
                and st.track is not None and st.track.handler == "vide"):
            key_ns = st.queued_end_ts * SECOND // st.timescale
            frag_boundary = key_ns >= self._frag_start_ns + frag_dur
            for s in self.active_streams():
                s.stage_up_to(None)
            ret = self._cut(fragment_boundary=frag_boundary)
            if ret != FlowReturn.OK:
                return ret
        pts_ts = None if buf.pts is None else buf.pts * st.timescale // SECOND
        st.queue_sample(data, dur, sync, pts_ts=pts_ts)

        if manual:
            st.stage_up_to(None)  # cuts arrive via FMP4MuxSplitNow only
            return FlowReturn.OK
        chunk_dur = self.get_property("chunk-duration")
        if self.get_property("chunk-mode") == "duration" and not chunk_dur:
            raise RuntimeError(
                f"{self.name}: chunk-mode=duration requires chunk-duration")

        def _live():
            return [s for s in self.active_streams()
                    if not s.pad.is_inactive() or s.pending or s.gops]

        if chunk_dur:
            return self._aggregate_chunked(_live, frag_dur, chunk_dur)
        # several fragments may become due from one consumed buffer (a very
        # late keyframe releases every fragment the sparse stream was
        # blocking — fmp4_tests.rs test_multi_stream_late_key_frame_skips_*)
        live = _live()
        while live:
            frag_end = self._frag_start_ns + frag_dur
            if not all(self._stream_fragment_filled(s, frag_end)
                       for s in live):
                break
            cut_ns = self._select_cut(live, frag_end)
            for s in live:
                s.stage_up_to(cut_ns * s.timescale // SECOND)
            if not any(s.pending for s in live):
                break  # nothing stageable (all data past the cut)
            ret = self._cut(fragment_boundary=True)
            if ret != FlowReturn.OK:
                return ret
            live = _live()
        return FlowReturn.OK

    def _aggregate_chunked(self, _live, frag_dur: int,
                           chunk_dur: int) -> FlowReturn:
        """chunk-duration mode (ChunkStrategy::Duration): chunk-sized cuts
        that split GOP-lessly; the fragment closes at the first KEYFRAME
        at/after the fragment end (chunks already shipped the data up to
        the target, so — unlike fragment-only mode — the boundary can only
        move FORWARD to the next key: fmp4_tests.rs
        test_chunking_single_stream*_gops_after_fragment_end_*)."""
        ret = FlowReturn.OK
        while True:
            live = _live()
            if not live:
                return ret
            frag_end = self._frag_start_ns + frag_dur
            chunk_end = self._chunk_start_ns + chunk_dur
            key_pos = self._next_fragment_key_pos(live, frag_end)
            if key_pos is not None and key_pos <= self._chunk_start_ns:
                # fragment closes exactly at the last chunk's end: no
                # closing chunk needed, the next chunk starts the fragment
                self._frag_start_ns = key_pos
                self._request_keyunit(key_pos)
                continue
            if key_pos is not None and key_pos <= chunk_end:
                # closing chunk [chunk_start, key_pos)
                for s in live:
                    s.stage_chunk_up_to(key_pos * s.timescale // SECOND)
                if not any(s.pending for s in live):
                    return ret
                self._chunk_start_ns = key_pos
                ret = self._cut(fragment_boundary=True)
                if ret != FlowReturn.OK:
                    return ret
                continue
            # normal chunk [chunk_start, chunk_end): cut once every live
            # stream has queued past the chunk end
            if not all(s.queued_end_ts * SECOND // s.timescale >= chunk_end
                       for s in live):
                return ret
            # The leader (first) stream drains up to the nominal chunk end
            # — a sample straddling the boundary is included — and the
            # chunk's ACTUAL end is wherever its drain landed; the other
            # streams then drain to that end and the next chunk target
            # rolls from it, not from the nominal grid
            # (fmp4mux/imp.rs:2307-2330 dequeue_end_pts / :3606
            # chunk_start_pts = chunk_end_pts).
            leader = live[0]
            leader.stage_chunk_up_to(chunk_end * leader.timescale // SECOND)
            actual_end_ns = max(
                chunk_end,
                (leader.decode_ts + leader.pending_dur) * SECOND
                // leader.timescale,
            )
            for s in live[1:]:
                s.stage_chunk_up_to(actual_end_ns * s.timescale // SECOND)
            if not any(s.pending for s in live):
                return ret
            self._chunk_start_ns = actual_end_ns
            ret = self._cut(fragment_boundary=False)
            if ret != FlowReturn.OK:
                return ret

    def _next_fragment_key_pos(self, live, frag_end_ns: int) -> Optional[int]:
        """Where the current fragment will close in chunk mode: the start
        of the leader video stream's first sync-headed GOP at/after the
        fragment end (None = keyframe not seen yet).  Audio-only: the
        fragment target itself."""
        video = [s for s in live if not s.intra_only]
        if not video:
            return frag_end_ns
        s = video[0]
        end_ts = frag_end_ns * s.timescale // SECOND
        for g in s.gops:
            if g.samples and g.samples[0][2] and g.start_ts >= end_ts:
                return g.start_ts * SECOND // s.timescale
        if s.pad.is_inactive():
            return frag_end_ns
        return None

    def _stream_fragment_filled(self, st: _Stream, frag_end_ns: int) -> bool:
        """fmp4mux/imp.rs:1655-1729: a stream has enough data for the
        current fragment once a FINALIZED GOP ends at/after the fragment
        end (video), or — intra-only — once its queued data reaches the
        boundary.  A first GOP starting after the fragment end also counts
        (sparse/late stream: it contributes nothing to this fragment)."""
        end_ts = frag_end_ns * st.timescale // SECOND
        if st.pad.is_inactive():
            st.finalize_gops()
            return True
        if st.intra_only:
            return st.queued_end_ts >= end_ts
        if st.gops and st.gops[0].start_ts >= end_ts:
            return True
        return any(g.final and g.end_ts >= end_ts for g in st.gops)

    def _select_cut(self, live: List[_Stream], frag_end_ns: int) -> int:
        """The fragment's actual end: GOP-aligned on the video stream(s).

        The largest final-GOP end <= the target among video streams; if the
        first video GOP overshoots, its end (fragment extension — the
        long-GOP case).  Audio-only: the target itself."""
        video = [s for s in live if not s.intra_only and s.gops]
        if not video:
            return frag_end_ns
        cuts = []
        for s in video:
            end_ts = frag_end_ns * s.timescale // SECOND
            aligned = [g.end_ts for g in s.gops if g.final and g.end_ts <= end_ts]
            if aligned:
                cuts.append(max(aligned) * SECOND // s.timescale)
            else:
                g = s.gops[0]
                if g.final and g.start_ts < end_ts:
                    cuts.append(g.end_ts * SECOND // s.timescale)
        return min(cuts) if cuts else frag_end_ns

    def drain(self) -> None:
        with self._flow_lock:
            self._drain_locked()

    def _drain_locked(self) -> None:
        self._unarm_timeout()
        if not self._header_sent:
            if not self._ensure_configured():
                return
            self._send_header()
        # consume anything still queued (EOS arrived with partial queues)
        for st in self.active_streams():
            self._consume_pad_queue(st)
            st.finalize_gops()
        # emit complete fragments first (the reference's drain keeps the
        # fragment grid: fmp4_tests.rs test_caps_change_within_gop expects
        # the reduced GOP and the following full GOP as separate fragments)
        frag_dur = self.get_property("fragment-duration")
        if not self.get_property("manual-split"):
            while True:
                live = [s for s in self.active_streams()
                        if s.pending or s.gops]
                if not live:
                    break
                frag_end = self._frag_start_ns + frag_dur
                if not all(self._stream_fragment_filled(s, frag_end)
                           for s in live):
                    break
                cut_ns = self._select_cut(live, frag_end)
                for s in live:
                    s.stage_up_to(cut_ns * s.timescale // SECOND)
                if not any(s.pending for s in live):
                    break
                if self._cut(fragment_boundary=True) != FlowReturn.OK:
                    return
        for st in self.active_streams():
            st.stage_up_to(None)
        self._cut(fragment_boundary=True)
        if self.get_property("write-mfra"):
            # DEFAULT_WRITE_MFRA=false (fmp4mux/imp.rs:149)
            self._push_bytes(
                bmff.mfra(sorted(self._mfra.items())),
                pts=None, duration=None, flags=BufferFlags.NONE,
            )
        if self.get_property("header-update-mode") in ("update", "rewrite"):
            # update: re-push the finalized header; rewrite: approximated
            # the same way (push-only downstreams cannot seek back)
            self._push_bytes(
                self._header_bytes(final=True),
                pts=0, duration=None,
                flags=BufferFlags.HEADER | BufferFlags.DISCONT,
            )


class MP4Mux(_MuxBase):
    """Non-fragmented MP4 muxer core (reference mp4mux/imp.rs).

    Assembles ftyp + mdat + moov in memory and emits the file at EOS; the
    reference instead streams mdat and rewrites its size header, which needs
    a seekable sink.  Chunking: one chunk per input buffer, run-length
    collapsed into stsc by the writer.
    """

    ELEMENT_CLASS = "Muxer"
    MAJOR_BRAND = b"iso4"  # brands.rs:338-339
    COMPAT_BRANDS = (b"iso4", b"mp41", b"mp42", b"isom")
    PROPERTIES = [
        Prop("movie-timescale", 0, type="uint", doc="0 = auto (1000)"),
        Prop("precision-clock-type", "none", type="enum",
             choices=["none", "unknown", "can-sync", "cannot-sync"]),
        Prop("precision-clock-time-uncertainty", 0, type="uint64"),
        # GstRsMP4Mux base surface (reference isobmff other-types)
        Prop("extra-brands", "", type="str", mutable="ready",
             doc="comma-separated 4-character brand codes appended to the "
                 "ftyp compatible brands (e.g. 'duke,sook')"),
        Prop("interleave-bytes", 0, type="uint64",
             doc="chunk interleave granularity in bytes (0 = use "
                 "interleave-time)"),
        Prop("interleave-time", 500_000_000, type="uint64",
             doc="chunk interleave granularity in ns: consecutive samples "
                 "of one stream share a chunk until this bound"),
        Prop("tai-precision-timestamps", False, type="bool", mutable="ready",
             doc="write ISO/IEC 23001-17 taic clock boxes into the sample "
                 "entries (per-sample TAI aux data is not emitted — "
                 "documented divergence)"),
    ]
    # GstRsMP4MuxPad surface
    PAD_PROPERTIES = {
        "sink": [
            Prop("trak-timescale", 0, type="uint", mutable="ready",
                 doc="track timescale override (units/s, 0 = automatic)"),
            Prop("image-sequence", False, type="bool", mutable="ready",
                 doc="write this video track as an ISO/IEC 23008-12 image "
                     "sequence ('pict' handler) instead of 'vide'"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._mdat: List[bytes] = []
        self._mdat_len = 0
        self._cur_st: Optional[_Stream] = None
        self._cur_chunk_bytes = 0
        self._cur_chunk_dur = 0  # track timescale units

    def on_ready_to_paused(self) -> None:
        self._mdat = []
        self._mdat_len = 0
        self._cur_st = None
        self._cur_chunk_bytes = 0
        self._cur_chunk_dur = 0

    def _chunk_full(self, st: _Stream) -> bool:
        il_b = self.get_property("interleave-bytes")
        if il_b:
            return self._cur_chunk_bytes >= il_b
        il_t = self.get_property("interleave-time")
        if il_t and st.timescale:
            return self._cur_chunk_dur * SECOND // st.timescale >= il_t
        return True  # no interleave bound: one chunk per buffer

    def aggregate(self, timeout: bool) -> FlowReturn:
        if not self._ensure_configured():
            return FlowReturn.OK
        # interleave scheduling (GstRsMP4Mux interleave-bytes/-time): keep
        # draining the current stream into one chunk until the bound, then
        # switch to the stream with the earliest queued pts
        if (self._cur_st is not None and self._cur_st.pad.has_buffer()
                and not self._chunk_full(self._cur_st)):
            st = self._cur_st
        else:
            candidates = [
                (st.pad.peek_buffer().pts or 0, st)
                for st in self.active_streams()
                if st.pad.has_buffer()
            ]
            if not candidates:
                return FlowReturn.OK
            _pts, st = min(candidates, key=lambda c: c[0])
        buf = st.pad.pop_buffer()
        if st.pending_caps is not None and st.pending_caps_after > 0:
            st.pending_caps_after -= 1
        elif st.pending_caps is not None:
            self._apply_caps_change(st, buf)
        self._append(st, buf)
        return FlowReturn.OK

    def _apply_caps_change(self, st: _Stream, buf: Buffer) -> None:
        """Non-fragmented caps change: the new configuration becomes an
        ADDITIONAL stsd entry and stsc switches sample_description_index
        from this sample on (mp4_tests.rs test_caps_change_with_*).  The
        track keeps its original timescale; the new nominal frame duration
        is rescaled into it."""
        import copy

        new_caps = st.pending_caps
        st.pending_caps = None
        keep = {k: copy.deepcopy(getattr(st, k, None))
                for k in ("track", "timescale", "configured_caps", "kind",
                          "frame_dur_ts", "ainfo", "vinfo")}
        first = _first_frame(new_caps, buf)
        st.configure(new_caps, first_frame=first)
        new_entry = st.track.sample_entry
        new_ts, new_dur = st.timescale, st.frame_dur_ts
        new_ainfo = st.ainfo
        if keep["kind"] == "audio" and (
                new_ts != keep["timescale"]
                or (new_ainfo is not None and keep["ainfo"] is not None
                    and (new_ainfo.bpf != keep["ainfo"].bpf
                         or new_ainfo.format != keep["ainfo"].format))):
            # an audio rate/format change cannot be represented in ONE mp4
            # track: the mdhd timescale and the sample byte layout are
            # per-track, so the already-written samples would contradict
            # the new entry.  Reject instead of writing garbage.
            from ...core.element import FlowError

            for k, v in keep.items():
                setattr(st, k, v)
            raise FlowError(
                FlowReturn.ERROR,
                f"{self.name}: raw-audio rate/format changes are not "
                "representable in a single mp4 track")
        for k, v in keep.items():
            setattr(st, k, v)
        st.configured_caps = new_caps
        entries = [st.track.sample_entry, *st.track.extra_sample_entries]
        if new_entry in entries:
            st.current_desc = entries.index(new_entry) + 1
        else:
            st.track.extra_sample_entries.append(new_entry)
            st.current_desc = len(entries) + 1
        if new_ts and new_ts != st.timescale and new_dur:
            st.frame_dur_ts = new_dur * st.timescale // new_ts
        elif new_dur:
            st.frame_dur_ts = new_dur

    def _append(self, st: _Stream, buf: Buffer) -> None:
        data, dur, sync = st.to_sample(buf)
        if st is self._cur_st and st.table.chunks \
                and st.table.desc(len(st.table.chunks) - 1) == st.current_desc \
                and not self._chunk_full(st):
            # extend the open chunk (consecutive in mdat by construction)
            off, n = st.table.chunks[-1]
            st.table.chunks[-1] = (off, n + 1)
            self._cur_chunk_bytes += len(data)
            self._cur_chunk_dur += dur
        else:
            while len(st.table.chunk_desc) < len(st.table.chunks):
                st.table.chunk_desc.append(1)
            st.table.chunks.append((self._mdat_len, 1))
            st.table.chunk_desc.append(st.current_desc)
            self._cur_st = st
            self._cur_chunk_bytes = len(data)
            self._cur_chunk_dur = dur
        st.table.sizes.append(len(data))
        st.table.durations.append(dur)
        st.table.sync.append(sync)
        self._mdat.append(data)
        self._mdat_len += len(data)

    def drain(self) -> None:
        if not self._ensure_configured():
            return
        for st in self.active_streams():
            while st.pad.has_buffer():
                buf = st.pad.pop_buffer()
                if st.pending_caps is not None and st.pending_caps_after > 0:
                    st.pending_caps_after -= 1
                elif st.pending_caps is not None:
                    self._apply_caps_change(st, buf)
                self._append(st, buf)
        streams = self.active_streams()
        mts = self.get_property("movie-timescale") or 1000
        brands = list(self.COMPAT_BRANDS)
        extra = self.get_property("extra-brands") or ""
        for b in extra.split(","):
            b = b.strip()
            if len(b) == 4:
                brands.append(b.encode("ascii"))
        ftyp = bmff.ftyp(self.MAJOR_BRAND, 0, brands)
        # rebase chunk offsets: absolute = ftyp + mdat header + relative
        base = len(ftyp) + 8
        tables = []
        for st in streams:
            t = st.table
            t.chunks = [(off + base, n) for off, n in t.chunks]
            tables.append(t)
        dur = max((t.total_duration * mts // st.timescale
                   for st, t in zip(streams, tables)), default=0)
        data = (
            ftyp
            + bmff.box(b"mdat", b"".join(self._mdat))
            + bmff.moov([st.track for st in streams], mts, duration=dur, tables=tables,
                        extra_boxes=(bmff.onvif_meta_box(0)
                                     if getattr(self, "ONVIF", False) else b""))
        )
        self.srcpad.push_event(Event.new_caps(self._src_caps()))
        self.srcpad.push_event(Event.new_segment(Segment()))
        self._push_bytes(data, pts=0, duration=None, flags=BufferFlags.NONE)


# ---------------------------------------------------------------------------
# Registered variants (mod.rs:137-172; brands brands.rs:305-352)
# ---------------------------------------------------------------------------
@register(rank=256)
class ISOFMP4Mux(FMP4Mux):
    ELEMENT_NAME = "isofmp4mux"
    ELEMENT_DESCRIPTION = "ISO fragmented MP4 muxer"
    VARIANT = "iso-fragmented"


@register(rank=256)
class CMAFMux(FMP4Mux):
    ELEMENT_NAME = "cmafmux"
    ELEMENT_DESCRIPTION = "CMAF fragmented MP4 muxer (single stream)"
    SINGLE_STREAM = True
    VARIANT = "cmaf"
    MAJOR_BRAND = b"cmf2"
    COMPAT_BRANDS = (b"iso6", b"cmfc", b"cmf2")


@register(rank=256)
class DASHMP4Mux(FMP4Mux):
    ELEMENT_NAME = "dashmp4mux"
    ELEMENT_DESCRIPTION = "DASH fragmented MP4 muxer (single stream)"
    SINGLE_STREAM = True
    VARIANT = "dash"
    MAJOR_BRAND = b"msdh"
    COMPAT_BRANDS = (b"dums", b"msdh", b"iso6")


@register(rank=256)
class ONVIFFMP4Mux(FMP4Mux):
    ELEMENT_NAME = "onviffmp4mux"
    ELEMENT_DESCRIPTION = "ONVIF fragmented MP4 muxer (UTC start tagging via cstb)"
    VARIANT = "onvif"
    ONVIF = True


@register(rank=64)
class ISOMP4Mux(MP4Mux):
    ELEMENT_NAME = "isomp4mux"
    ELEMENT_DESCRIPTION = "ISO MP4 muxer"


@register(rank=64)
class ONVIFMP4Mux(MP4Mux):
    ELEMENT_NAME = "onvifmp4mux"
    ELEMENT_DESCRIPTION = "ONVIF MP4 muxer (UTC start tagging via cstb)"
    ONVIF = True


__all__ = [
    "FMP4Mux",
    "MP4Mux",
    "ISOFMP4Mux",
    "CMAFMux",
    "DASHMP4Mux",
    "ONVIFFMP4Mux",
    "ISOMP4Mux",
    "ONVIFMP4Mux",
]
