"""HLS media playlist (m3u8) writer with sliding-window semantics.

From-scratch equivalent of the m3u8-rs usage in the reference hlssink3
(net/hlssink3/src/playlist.rs): EXTM3U/EXT-X-VERSION/TARGETDURATION/
MEDIA-SEQUENCE/EXT-X-MAP/EXTINF entries, playlist-length window, max-files
segment deletion, optional ENDLIST (hlsbasesink.rs defaults:
playlist-length 5, max-files 10, endlist on).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class Segment:
    uri: str
    duration_s: float
    path: Optional[str] = None  # on-disk path for max-files deletion
    #: ISO-8601 wallclock of the segment start -> EXT-X-PROGRAM-DATE-TIME
    #: (hlsbasesink enable-program-date-time)
    date_time: Optional[str] = None
    #: (length, offset) into a single media file -> EXT-X-BYTERANGE
    #: (hlsbasesink single-media-file)
    byterange: Optional[tuple] = None


class MediaPlaylist:
    def __init__(
        self,
        *,
        target_duration: int,
        playlist_length: int = 5,
        max_files: int = 10,
        init_uri: Optional[str] = None,
        enable_endlist: bool = True,
        playlist_type: Optional[str] = None,
        i_frames_only: bool = False,
    ):
        self.target_duration = target_duration
        self.playlist_length = playlist_length
        self.max_files = max_files
        self.init_uri = init_uri
        self.enable_endlist = enable_endlist
        self.playlist_type = playlist_type  # None | "event" | "vod"
        self.i_frames_only = i_frames_only
        self.segments: List[Segment] = []
        self.media_sequence = 0
        self.ended = False

    def add_segment(self, seg: Segment) -> List[str]:
        """Add a segment; returns paths of segments evicted past max-files."""
        self.segments.append(seg)
        evicted: List[str] = []
        if self.playlist_type in ("event", "vod"):
            return evicted  # append-only playlists never evict (RFC 8216)
        # window: playlist shows the last `playlist_length` segments, files
        # beyond `max_files` get deleted (hlsbasesink.rs)
        while len(self.segments) > max(self.max_files, self.playlist_length):
            old = self.segments.pop(0)
            self.media_sequence += 1
            if old.path:
                evicted.append(old.path)
        return evicted

    def end(self) -> None:
        self.ended = True

    def render(self) -> str:
        if self.playlist_type in ("event", "vod"):
            visible = self.segments  # full history for EVENT/VOD
        else:
            visible = self.segments[-self.playlist_length :] if self.playlist_length else self.segments
        seq = self.media_sequence + (len(self.segments) - len(visible))
        target = max(
            self.target_duration,
            int(math.ceil(max((s.duration_s for s in visible), default=0))),
        )
        version = 6 if self.init_uri else 3
        if version < 4 and any(s.byterange for s in visible):
            version = 4  # EXT-X-BYTERANGE needs protocol version 4
        lines = [
            "#EXTM3U",
            f"#EXT-X-VERSION:{version}",
            f"#EXT-X-TARGETDURATION:{target}",
            f"#EXT-X-MEDIA-SEQUENCE:{seq}",
        ]
        if self.playlist_type in ("event", "vod"):
            lines.append(f"#EXT-X-PLAYLIST-TYPE:{self.playlist_type.upper()}")
        if self.i_frames_only:
            lines.append("#EXT-X-I-FRAMES-ONLY")
        if self.init_uri:
            lines.append(f'#EXT-X-MAP:URI="{self.init_uri}"')
        for s in visible:
            if s.date_time:
                lines.append(f"#EXT-X-PROGRAM-DATE-TIME:{s.date_time}")
            lines.append(f"#EXTINF:{s.duration_s:.3f},")
            if s.byterange:
                length, offset = s.byterange
                lines.append(f"#EXT-X-BYTERANGE:{length}@{offset}")
            lines.append(s.uri)
        if self.ended and self.enable_endlist:
            lines.append("#EXT-X-ENDLIST")
        return "\n".join(lines) + "\n"


@dataclass
class Variant:
    uri: str
    bandwidth: int
    width: int = 0
    height: int = 0
    codecs: str = ""
    is_audio_only: bool = False
    audio: str = ""  # GROUP-ID of the audio renditions for this variant
    video: str = ""  # GROUP-ID of the video renditions
    is_i_frame: bool = False


@dataclass
class AlternativeMedia:
    """EXT-X-MEDIA rendition (RFC 8216 §4.3.4.1; the reference's
    AlternateRendition, hlsmultivariantsink/src/imp.rs:162-179)."""

    media_type: str  # "audio" | "video" | "subtitles" | "closed-captions"
    group_id: str
    name: str
    uri: str = ""
    language: str = ""
    default: bool = False
    autoselect: bool = False
    forced: bool = False

    def line(self) -> str:
        attrs = [f"TYPE={self.media_type.upper()}",
                 f'GROUP-ID="{self.group_id}"',
                 f'NAME="{self.name}"']
        if self.language:
            attrs.append(f'LANGUAGE="{self.language}"')
        attrs.append("DEFAULT=" + ("YES" if self.default else "NO"))
        attrs.append("AUTOSELECT=" + ("YES" if self.autoselect else "NO"))
        if self.forced:
            attrs.append("FORCED=YES")
        if self.uri:
            attrs.append(f'URI="{self.uri}"')
        return "#EXT-X-MEDIA:" + ",".join(attrs)


def master_playlist(variants: List[Variant],
                    alternatives: List[AlternativeMedia] = (),
                    version: int = 6) -> str:
    """Multivariant (master) playlist (hlsmultivariantsink analog):
    EXT-X-MEDIA renditions first, then the variant streams with their
    AUDIO/VIDEO group references."""
    lines = ["#EXTM3U", f"#EXT-X-VERSION:{version}"]
    for a in alternatives:
        lines.append(a.line())
    for v in variants:
        attrs = [f"BANDWIDTH={v.bandwidth}"]
        if v.width and v.height:
            attrs.append(f"RESOLUTION={v.width}x{v.height}")
        if v.codecs:
            attrs.append(f'CODECS="{v.codecs}"')
        if v.audio:
            attrs.append(f'AUDIO="{v.audio}"')
        if v.video:
            attrs.append(f'VIDEO="{v.video}"')
        if v.is_i_frame:
            attrs.append(f'URI="{v.uri}"')
            lines.append("#EXT-X-I-FRAME-STREAM-INF:" + ",".join(attrs))
        else:
            lines.append("#EXT-X-STREAM-INF:" + ",".join(attrs))
            lines.append(v.uri)
    return "\n".join(lines) + "\n"


def write_atomic(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


__all__ = ["MediaPlaylist", "Segment", "Variant", "master_playlist", "write_atomic"]
