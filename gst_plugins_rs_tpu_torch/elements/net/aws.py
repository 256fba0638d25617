"""AWS elements: S3 sources/sinks, Polly TTS, Translate, Transcribe.

Parity targets: net/aws (awss3src, awss3sink, awss3putobjectsink,
awss3hlssink, awspolly, awstranslate, awstranscriber2,
awstranscribeparse).  The reference rides the AWS SDK; here the REST/
event-stream protocols are in-repo (net/sigv4.py, net/s3.py,
net/eventstream.py).  `endpoint-uri` points the S3/REST calls at any
compatible server — tests use in-process fakes; production use signs
against real AWS endpoints with the same code.

Property names follow the reference registry
(docs/plugins/gst_plugins_cache.json `aws` entries); the subset
implemented covers the data path (uri/bucket/key/credentials/
endpoint-uri/part-size/flush-interval-*), not the SDK retry tuning.

The port: the sinks take a payload's raw bytes through one read-back
(`core/payload.host_bytes`, never value-cast: a float tensor's bytes as
they lie); awstranscriber2 reads its audio back once and converts F32 to
S16 in numpy, so the AudioEvents equal the JAX package's.  The sources
and awspolly emit host arrays, as in the JAX package; the element after
them uploads.  Divergence from the JAX package: at EOS awstranscriber2
ends the Transcribe stream (the empty AudioEvent) and waits, within its
`latency`, for the transcripts still owed (until the service ends the
stream), and pushes them, on every text pad, before EOS; the JAX element
loses a transcript still in flight at EOS.
"""
from __future__ import annotations

import json
import threading
import urllib.request
from typing import List, Optional, Tuple

import numpy as np

from ...core import (
    BaseSink,
    BaseSrc,
    BaseTransform,
    Buffer,
    Caps,
    Event,
    EventType,
    FlowReturn,
    Prop,
    register,
)
from ...core.events import Segment
from ...core.basetransform import TransformMode
from ...core.parse import parse_caps
from ...core.payload import host_array, host_bytes
from ...net import sigv4
from ...net.s3 import S3Client, S3Url


def _client_from_props(el, region: Optional[str] = None) -> S3Client:
    timeout = el._props.get("request-timeout", 15_000)
    return S3Client(
        region=region or el.get_property("region") or "us-east-1",
        access_key=el.get_property("access-key"),
        secret_key=el.get_property("secret-access-key"),
        session_token=el.get_property("session-token"),
        endpoint_uri=el.get_property("endpoint-uri"),
        force_path_style=bool(el._props.get("force-path-style")),
        timeout_ms=int(timeout) if timeout is not None else 15_000,
        retry_attempts=int(el._props.get("retry-attempts", 5)),
    )


def _resolve_target(el) -> Tuple[S3Client, str, str]:
    """(client, bucket, key) from s3-uri=, uri= or bucket=/key= properties."""
    s3uri = el._props.get("s3-uri")
    if s3uri:
        u = S3Url.parse_s3uri(s3uri, el.get_property("region") or "us-east-1")
        return _client_from_props(el, region=u.region), u.bucket, u.key
    uri = el.get_property("uri")
    if uri:
        u = S3Url.parse(uri)
        return _client_from_props(el, region=u.region), u.bucket, u.key
    bucket = el.get_property("bucket")
    key = el.get_property("key")
    if not bucket or not key:
        raise ValueError(f"{el.name}: need uri=s3://region/bucket/key or bucket=/key=")
    return _client_from_props(el), bucket, key


def _object_headers(el) -> dict:
    """Cache-Control / Content-* / x-amz-meta-* headers from properties."""
    headers = {
        "cache-control": el._props.get("cache-control"),
        "content-disposition": el._props.get("content-disposition"),
        "content-encoding": el._props.get("content-encoding"),
        "content-language": el._props.get("content-language"),
    }
    meta = el._props.get("metadata")
    if meta:
        items = meta.items() if hasattr(meta, "items") else meta
        for k, v in items:
            headers[f"x-amz-meta-{k}"] = str(v)
    return {k: v for k, v in headers.items() if v}


_S3_COMMON = [
    Prop("uri", None, type="str", doc="s3://region/bucket/key"),
    Prop("s3-uri", None, type="str",
         doc="AWS-standard s3://bucket/key (region from the region "
             "property); takes precedence over uri"),
    Prop("bucket", None, type="str"),
    Prop("key", None, type="str"),
    Prop("region", "us-east-1", type="str"),
    Prop("access-key", None, type="str"),
    Prop("secret-access-key", None, type="str"),
    Prop("session-token", None, type="str"),
    Prop("endpoint-uri", None, type="str"),
    Prop("content-type", None, type="str"),
    Prop("force-path-style", False, type="bool",
         doc="Force path-style addressing for buckets (custom endpoints "
             "are always path-style)"),
    Prop("request-timeout", 15_000, type="int", minimum=-1,
         doc="Timeout for S3 requests in ms (-1 = infinity)"),
    Prop("retry-attempts", 5, type="uint", minimum=1, maximum=10,
         doc="Request attempts before abandoning (5xx and connection "
             "errors retry with capped exponential backoff)"),
]

# deprecated-in-reference per-operation knobs: kept for parity, they feed
# the same client timeout/retry configuration
_S3_DEPRECATED_TUNING = [
    Prop("retry-duration", 75_000, type="int", minimum=-1,
         doc="(deprecated: use retry-attempts) total retry budget in ms"),
]


@register
class AwsS3Src(BaseSrc):
    ELEMENT_NAME = "awss3src"
    ELEMENT_CLASS = "Source/Network"
    ELEMENT_DESCRIPTION = "Reads an object from Amazon S3 (SigV4 REST)"
    SRC_CAPS = Caps.builder("application/octet-stream")
    SEEK_FORMAT = "bytes"
    PROPERTIES = _S3_COMMON + _S3_DEPRECATED_TUNING + [
        Prop("blocksize", 1 << 20, type="uint", doc="bytes per ranged GET"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._client: Optional[S3Client] = None
        self._bucket = self._key = ""
        self._size = 0
        self._pos = 0

    def start(self) -> None:
        self._client, self._bucket, self._key = _resolve_target(self)
        self._size = self._client.head_object(self._bucket, self._key)
        self._pos = int(self.segment.start)  # pre-roll seeks start here

    def stop(self) -> None:
        self._client = None

    # ranged GETs make the object natively byte-seekable (the reference's
    # s3src answers seeks the same way, via GetObject Range)
    def is_seekable(self) -> bool:
        return True

    def do_seek(self, segment) -> bool:
        self._pos = int(segment.start)
        return True

    def duration_ns(self):
        return self._size or None

    def position_ns(self):
        return self._pos

    def create(self):
        end_limit = self._size
        if self.segment.stop is not None:
            end_limit = min(end_limit, int(self.segment.stop))
        if self._pos >= end_limit:
            return None
        end = min(self._pos + self.get_property("blocksize"), end_limit) - 1
        data = self._client.get_object(self._bucket, self._key, range_=(self._pos, end))
        buf = Buffer(np.frombuffer(data, np.uint8), offset=self._pos)
        self._pos += len(data)
        return buf


@register
class AwsS3Sink(BaseSink):
    """Multipart upload; parts flushed at part-size boundaries, completed on EOS."""

    ELEMENT_NAME = "awss3sink"
    ELEMENT_CLASS = "Sink/Network"
    ELEMENT_DESCRIPTION = "Streams to an S3 object via multipart upload"
    PROPERTIES = _S3_COMMON + _S3_DEPRECATED_TUNING + [
        Prop("part-size", 5 * 1024 * 1024, type="uint64",
             doc="multipart part size (AWS minimum 5 MiB except the last)"),
        Prop("on-error", "abort-upload", type="str",
             doc="abort-upload | complete-upload | do-nothing"),
        Prop("cache-control", None, type="str",
             doc="Cache-Control header for the uploaded object"),
        Prop("content-disposition", None, type="str"),
        Prop("content-encoding", None, type="str"),
        Prop("content-language", None, type="str"),
        Prop("metadata", None, type="object",
             doc="mapping stored as x-amz-meta-* headers"),
        Prop("complete-upload-request-timeout", 15_000, type="int", minimum=-1,
             doc="(deprecated: use request-timeout)"),
        Prop("complete-upload-retry-duration", 75_000, type="int", minimum=-1,
             doc="(deprecated: use retry-attempts)"),
        Prop("upload-part-request-timeout", 15_000, type="int", minimum=-1,
             doc="(deprecated: use request-timeout)"),
        Prop("upload-part-retry-duration", 75_000, type="int", minimum=-1,
             doc="(deprecated: use retry-attempts)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._client: Optional[S3Client] = None
        self._bucket = self._key = ""
        self._upload_id: Optional[str] = None
        self._parts: List[Tuple[int, str]] = []
        self._pending = bytearray()

    def on_ready_to_paused(self) -> None:
        self._client, self._bucket, self._key = _resolve_target(self)
        self._upload_id = self._client.create_multipart(
            self._bucket, self._key,
            content_type=self.get_property("content-type"),
            extra_headers=_object_headers(self))
        self._parts = []
        self._pending = bytearray()

    def render(self, buffer: Buffer) -> FlowReturn:
        self._pending += host_bytes(buffer.data)  # raw bytes, never value-cast
        part_size = self.get_property("part-size")
        while len(self._pending) >= part_size:
            chunk, self._pending = bytes(self._pending[:part_size]), self._pending[part_size:]
            self._upload_part(chunk)
        return FlowReturn.OK

    def _upload_part(self, data: bytes) -> None:
        n = len(self._parts) + 1
        etag = self._client.upload_part(self._bucket, self._key, self._upload_id, n, data)
        self._parts.append((n, etag))

    def on_event(self, event) -> None:
        from ...core.events import EventType

        if event.type == EventType.EOS and self._upload_id is not None:
            if self._pending:
                self._upload_part(bytes(self._pending))
                self._pending = bytearray()
            self._client.complete_multipart(self._bucket, self._key, self._upload_id, self._parts)
            self._upload_id = None

    def on_paused_to_ready(self) -> None:
        if self._upload_id is not None:
            if self.get_property("on-error") == "complete-upload":
                self._client.complete_multipart(self._bucket, self._key, self._upload_id, self._parts)
            elif self.get_property("on-error") == "abort-upload":
                self._client.abort_multipart(self._bucket, self._key, self._upload_id)
            self._upload_id = None


@register
class AwsS3PutObjectSink(BaseSink):
    """Whole-object PutObject with periodic flushes (next-file style)."""

    ELEMENT_NAME = "awss3putobjectsink"
    ELEMENT_CLASS = "Sink/Network"
    ELEMENT_DESCRIPTION = "Writes accumulated buffers to S3 with PutObject"
    PROPERTIES = _S3_COMMON + [
        Prop("flush-interval-buffers", 0, type="uint", doc="0 = only at EOS"),
        Prop("flush-interval-bytes", 0, type="uint64"),
        Prop("flush-interval-time", 0, type="uint64",
             doc="accumulated buffer duration (ns) per write (0 = disable)"),
        Prop("flush-on-error", False, type="bool",
             doc="write accumulated data when stopping without EOS"),
        Prop("next-file", "next-buffer", type="enum",
             choices=["next-buffer", "key-frame"],
             doc="when a flush starts a NEW object (key gets a %05d "
                 "counter) instead of rewriting the same key"),
        Prop("min-keyframe-distance", 10_000_000_000, type="uint64",
             doc="minimum pts distance between keyframe-triggered files"),
        Prop("cache-control", None, type="str"),
        Prop("content-disposition", None, type="str"),
        Prop("content-encoding", None, type="str"),
        Prop("content-language", None, type="str"),
        Prop("metadata", None, type="object",
             doc="mapping stored as x-amz-meta-* headers"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._client: Optional[S3Client] = None
        self._bucket = self._key = ""
        self._data = bytearray()
        self._buffers = 0
        self._accum_time = 0
        self._file_index = 0
        self._last_split_pts: Optional[int] = None
        self._got_eos = False

    def on_ready_to_paused(self) -> None:
        self._client, self._bucket, self._key = _resolve_target(self)
        self._data = bytearray()
        self._buffers = 0
        self._accum_time = 0
        self._file_index = 0
        self._last_split_pts = None
        self._got_eos = False

    def _object_key(self) -> str:
        if self.get_property("next-file") == "next-buffer":
            return self._key
        key = self._key
        return (key % self._file_index) if "%" in key \
            else f"{key}.{self._file_index:05d}"

    def render(self, buffer: Buffer) -> FlowReturn:
        from ...core.buffer import BufferFlags

        if self.get_property("next-file") == "key-frame" and self._data \
                and not buffer.has_flag(BufferFlags.DELTA_UNIT):
            pts = getattr(buffer, "pts", None)
            dist = self.get_property("min-keyframe-distance")
            if pts is None or self._last_split_pts is None \
                    or pts - self._last_split_pts >= dist:
                self._flush(new_file=True)
                self._last_split_pts = pts
        self._data += host_bytes(buffer.data)  # raw bytes, never value-cast
        self._buffers += 1
        self._accum_time += int(buffer.duration or 0) \
            if getattr(buffer, "duration", None) else 0
        fb = self.get_property("flush-interval-buffers")
        fby = self.get_property("flush-interval-bytes")
        ft = self.get_property("flush-interval-time")
        if (fb and self._buffers % fb == 0) or (fby and len(self._data) >= fby) \
                or (ft and self._accum_time >= ft):
            self._flush()
        return FlowReturn.OK

    def _flush(self, new_file: bool = False) -> None:
        if not self._data:
            return
        self._client.put_object(
            self._bucket, self._object_key(), bytes(self._data),
            content_type=self.get_property("content-type"),
            extra_headers=_object_headers(self))
        self._accum_time = 0
        if new_file:
            self._data = bytearray()
            self._file_index += 1

    def on_event(self, event) -> None:
        from ...core.events import EventType

        if event.type == EventType.EOS and self._client is not None:
            self._flush()
            self._got_eos = True

    def on_paused_to_ready(self) -> None:
        if not self._got_eos and self.get_property("flush-on-error") \
                and self._client is not None:
            self._flush()
        self._client = None


@register
class AwsS3HlsSink(BaseSink):
    """HLS-to-S3: embeds hlssink3's segmenter, uploading segments + playlist.

    Like the reference (net/aws/src/s3hlssink), this wraps the HLS sink:
    buffers flow into an internal hlscmafsink whose file writes are
    redirected to PutObject calls under key-prefix/.
    """

    ELEMENT_NAME = "awss3hlssink"
    ELEMENT_CLASS = "Sink/Network"
    ELEMENT_DESCRIPTION = "Writes HLS segments and playlists to S3"
    PROPERTIES = [
        Prop("bucket", None, type="str"),
        Prop("key-prefix", "hls", type="str"),
        Prop("region", "us-east-1", type="str"),
        Prop("access-key", None, type="str"),
        Prop("secret-access-key", None, type="str"),
        Prop("session-token", None, type="str"),
        Prop("endpoint-uri", None, type="str"),
        Prop("target-duration", 2_000_000_000, type="uint64"),
        Prop("playlist-length", 5, type="uint"),
        Prop("acl", "private", type="str",
             doc="canned ACL sent as x-amz-acl on every upload"),
        Prop("force-path-style", False, type="bool"),
        Prop("request-timeout", 15_000, type="int", minimum=-1,
             doc="Timeout for S3 requests in ms"),
        Prop("retry-attempts", 5, type="uint", minimum=1, maximum=10),
        Prop("hlssink", None, type="object",
             doc="(read) underlying HLS sink — the segmenter is built-in "
                 "here, so this element itself is returned"),
        Prop("stats", None, type="object",
             doc="(read) segments-uploaded / bytes-uploaded / "
                 "playlist-uploads counters"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._client: Optional[S3Client] = None
        self._segment = bytearray()
        self._segments: List[Tuple[str, int]] = []
        self._segment_start: Optional[int] = None
        self._index = 0
        self._bytes_uploaded = 0
        self._playlist_uploads = 0

    def get_property(self, name: str):
        if name == "hlssink":
            return self
        if name == "stats":
            from ...core.caps import Structure

            return Structure(
                "awss3hlssink-stats",
                **{"segments-uploaded": self._index,
                   "bytes-uploaded": self._bytes_uploaded,
                   "playlist-uploads": self._playlist_uploads})
        return super().get_property(name)

    def _acl_headers(self) -> dict:
        acl = self.get_property("acl")
        return {"x-amz-acl": acl} if acl and acl != "private" else {}

    EXTRA_PAD_TEMPLATES = [
        ("audio", "sink", "request", "ANY"),
        ("video", "sink", "request", "ANY"),
    ]

    def on_ready_to_paused(self) -> None:
        self._client = _client_from_props(self)
        if getattr(self, "_tsmux", None) is not None:
            from ...core.element import State

            self._tsmux.parent = self.parent
            self._tsmux.set_state(State.PAUSED)
        self._segment = bytearray()
        self._segments = []
        self._segment_start = None
        self._index = 0
        self._bytes_uploaded = 0
        self._playlist_uploads = 0

    def render(self, buffer: Buffer) -> FlowReturn:
        pts = getattr(buffer, "pts", None)
        if self._segment_start is None:
            self._segment_start = pts if pts is not None else 0
        self._segment += host_bytes(buffer.data)  # raw bytes, never value-cast
        target = self.get_property("target-duration")
        if pts is not None and self._segment_start is not None and \
                pts - self._segment_start >= target:
            self._finish_segment(pts - self._segment_start)
            self._segment_start = pts
        return FlowReturn.OK

    # -- elementary-stream input (reference: hlssink3 embedded under the
    #    S3 sink; audio/video request pads, s3hlssink/imp.rs) ----------------
    def _ensure_tsmux(self):
        if getattr(self, "_tsmux", None) is not None:
            return self._tsmux
        from ...core import Pad as _Pad, PadDirection as _PD, \
            PadPresence as _PP, PadTemplate as _PT
        from ..mux.tsmux import MpegTsMux

        self._tsmux = MpegTsMux(f"{self.name}-tsmux")
        self._tsmux.set_property("pat-interval", 1)
        self._tsmux.parent = self.parent
        inner = _Pad("inner_sink", _PD.SINK,
                     _PT("inner", _PD.SINK, _PP.ALWAYS, Caps.new_any()))
        inner.chain_function = lambda p, b: self.render(b)
        inner.event_function = lambda p, ev: self._event(self.sinkpad, ev)
        inner.element = self
        self._tsmux.srcpad.peer = inner
        inner.peer = self._tsmux.srcpad
        return self._tsmux

    def request_pad(self, template_name: str = "video"):
        from ...core import Pad as _Pad, PadDirection as _PD, \
            PadPresence as _PP, PadTemplate as _PT

        media = "audio" if "audio" in template_name else "video"
        if media in self.pads:
            raise ValueError(f"{self.name}: pad {media} already requested")
        muxpad = self._ensure_tsmux().request_sink_pad()
        pad = _Pad(media, _PD.SINK,
                   _PT(media, _PD.SINK, _PP.REQUEST, Caps.new_any()))
        pad.chain_function = lambda p, b: muxpad.chain(b)
        pad.event_function = lambda p, ev: muxpad.send_event(ev)
        return self.add_pad(pad)

    def on_paused_to_playing(self) -> None:
        if getattr(self, "_tsmux", None) is not None:
            from ...core.element import State

            self._tsmux.parent = self.parent
            self._tsmux.set_state(State.PLAYING)

    def _finish_segment(self, duration_ns: int) -> None:
        if not self._segment:
            return
        prefix = self.get_property("key-prefix").rstrip("/")
        name = f"segment{self._index:05d}.ts"
        self._client.put_object(self.get_property("bucket"), f"{prefix}/{name}",
                                bytes(self._segment), content_type="video/mp2t",
                                extra_headers=self._acl_headers())
        self._bytes_uploaded += len(self._segment)
        self._segments.append((name, duration_ns))
        maxlen = self.get_property("playlist-length")
        self._segments = self._segments[-maxlen:]
        self._upload_playlist()
        self._segment = bytearray()
        self._index += 1

    def _upload_playlist(self) -> None:
        target_s = max((d for _, d in self._segments), default=0) / 1e9
        lines = ["#EXTM3U", "#EXT-X-VERSION:3",
                 f"#EXT-X-TARGETDURATION:{int(round(target_s)) or 1}",
                 f"#EXT-X-MEDIA-SEQUENCE:{max(0, self._index + 1 - len(self._segments))}"]
        for name, dur in self._segments:
            lines.append(f"#EXTINF:{dur / 1e9:.3f},")
            lines.append(name)
        prefix = self.get_property("key-prefix").rstrip("/")
        self._client.put_object(
            self.get_property("bucket"), f"{prefix}/playlist.m3u8",
            ("\n".join(lines) + "\n").encode(),
            content_type="application/vnd.apple.mpegurl",
            extra_headers=self._acl_headers(),
        )
        self._playlist_uploads += 1

    def on_event(self, event) -> None:
        from ...core.events import EventType

        if event.type == EventType.EOS and self._client is not None and self._segment:
            self._finish_segment(self.get_property("target-duration"))


# ---------------------------------------------------------------------------
# Polly / Translate / Transcribe


def _aws_json_post(el, url: str, target: Optional[str], payload: dict,
                   service: str) -> Tuple[int, bytes]:
    body = json.dumps(payload).encode()
    headers = {"content-type": "application/x-amz-json-1.1"}
    if target:
        headers["x-amz-target"] = target
    signed = sigv4.sign_headers(
        "POST", url, el.get_property("region") or "us-east-1", service,
        el.get_property("access-key") or "anonymous",
        el.get_property("secret-access-key") or "anonymous",
        headers=headers, payload=body,
        session_token=el.get_property("session-token"),
    )
    req = urllib.request.Request(url, data=body, method="POST")
    for k, v in signed.items():
        if k.lower() != "host":
            req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


TEXT_CAPS = Caps.builder("text/x-raw")


@register
class AwsPolly(BaseTransform):
    """Text → synthesized audio via the Polly SynthesizeSpeech REST call."""

    ELEMENT_NAME = "awspolly"
    ELEMENT_CLASS = "Filter/Audio/Text"
    ELEMENT_DESCRIPTION = "Synthesizes speech from text with Amazon Polly"
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = Caps.builder("audio/x-raw")
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("region", "us-east-1", type="str"),
        Prop("access-key", None, type="str"),
        Prop("secret-access-key", None, type="str"),
        Prop("session-token", None, type="str"),
        Prop("endpoint-uri", None, type="str"),
        Prop("voice-id", "Joanna", type="str"),
        Prop("engine", "standard", type="str"),
        Prop("language-code", None, type="str"),
        Prop("sample-rate", 16000, type="int"),
        Prop("latency", 2_000, type="uint",
             doc="ms of latency to report for the Polly round trip"),
        Prop("lexicon-names", None, type="object",
             doc="list of lexicon names sent as LexiconNames"),
        Prop("overflow", "clip", type="enum",
             choices=["clip", "compress", "nothing"],
             doc="how audio longer than the text cue's duration is "
                 "handled: clip truncates, compress time-compresses to "
                 "fit, nothing passes it through"),
        Prop("max-overflow", 0, type="uint",
             doc="ms a cue may overflow its duration (mode=compress)"),
        Prop("max-compression", 0.0, type="float",
             doc="maximum compression factor (mode=compress; may cause "
                 "max-overflow to be ignored)"),
        Prop("ssml-set-max-duration", False, type="bool",
             doc="wrap plain text as SSML with amazon:max-duration"),
    ]

    def transform_caps(self, direction, caps: Caps, filter_=None) -> Caps:
        from ...core.element import PadDirection

        if direction == PadDirection.SINK:
            rate = self.get_property("sample-rate")
            out = parse_caps(
                f"audio/x-raw,format=S16,rate={rate},channels=1,layout=interleaved")
        else:
            out = TEXT_CAPS
        return out if filter_ is None else out.intersect(filter_)

    def transform(self, buffer: Buffer) -> Buffer:
        text = buffer.data if isinstance(buffer.data, str) else \
            host_bytes(buffer.data, np.uint8).decode("utf-8", "replace")
        endpoint = self.get_property("endpoint-uri") or \
            f"https://polly.{self.get_property('region')}.amazonaws.com"
        payload = {
            "OutputFormat": "pcm",
            "SampleRate": str(self.get_property("sample-rate")),
            "Text": text,
            "VoiceId": self.get_property("voice-id"),
            "Engine": self.get_property("engine"),
        }
        if self.get_property("ssml-set-max-duration") and buffer.duration:
            ms = int(buffer.duration / 1e6)
            payload["Text"] = (f'<speak><prosody amazon:max-duration="{ms}ms">'
                               f"{text}</prosody></speak>")
            payload["TextType"] = "ssml"
        lex = self.get_property("lexicon-names")
        if lex:
            payload["LexiconNames"] = list(lex) if not isinstance(lex, str) \
                else [s.strip() for s in lex.split(",") if s.strip()]
        if self.get_property("language-code"):
            payload["LanguageCode"] = self.get_property("language-code")
        status, body = _aws_json_post(self, endpoint.rstrip("/") + "/v1/speech",
                                      None, payload, "polly")
        if status != 200:
            raise RuntimeError(f"polly: HTTP {status}: {body[:200]!r}")
        pcm = np.frombuffer(body, "<i2").reshape(-1, 1)
        pcm = self._apply_overflow(pcm, buffer.duration)
        out = Buffer(pcm, pts=buffer.pts, duration=buffer.duration)
        return out

    def _apply_overflow(self, pcm: np.ndarray, duration) -> np.ndarray:
        """overflow handling: audio longer than the text cue's duration is
        clipped or linearly time-compressed (net/aws/src/polly/imp.rs
        GstAwsOverflow semantics)."""
        mode = self.get_property("overflow")
        if mode == "nothing" or not duration:
            return pcm
        want = int(duration * self.get_property("sample-rate") / 1e9)
        if pcm.shape[0] <= want or want <= 0:
            return pcm
        if mode == "clip":
            return pcm[:want]
        # compress: allow max-overflow ms beyond the cue, bounded by
        # max-compression; then linear-resample to fit
        allow = want + int(self.get_property("max-overflow")
                           * self.get_property("sample-rate") / 1e3)
        target = min(pcm.shape[0], allow)
        factor = pcm.shape[0] / max(1, target)
        maxc = self.get_property("max-compression")
        if maxc and factor > maxc > 1.0:
            target = int(np.ceil(pcm.shape[0] / maxc))
        xs = np.linspace(0, pcm.shape[0] - 1, target)
        return np.interp(xs, np.arange(pcm.shape[0]),
                         pcm[:, 0].astype(np.float32)).astype(np.int16).reshape(-1, 1)


@register
class AwsTranslate(BaseTransform):
    """Text → translated text via the Translate TranslateText JSON API."""

    ELEMENT_NAME = "awstranslate"
    ELEMENT_CLASS = "Filter/Text"
    ELEMENT_DESCRIPTION = "Translates text with Amazon Translate"
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = TEXT_CAPS
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("region", "us-east-1", type="str"),
        Prop("access-key", None, type="str"),
        Prop("secret-access-key", None, type="str"),
        Prop("session-token", None, type="str"),
        Prop("endpoint-uri", None, type="str"),
        Prop("input-language-code", "en", type="str"),
        Prop("output-language-code", "es", type="str"),
        Prop("latency", 2_000, type="uint",
             doc="ms of latency to report for the Translate round trip"),
        Prop("accumulator-lateness", 0, type="uint",
             doc="ms to shift input timestamps forward"),
        Prop("brevity-on", False, type="bool",
             doc="request the Brevity setting on TranslateText"),
        Prop("tokenization-method", "span-based", type="enum",
             choices=["span-based", "punctuation"],
             doc="punctuation splits input at sentence punctuation and "
                 "translates each span; span-based sends the span whole"),
    ]

    def _translate_one(self, text: str) -> str:
        endpoint = self.get_property("endpoint-uri") or \
            f"https://translate.{self.get_property('region')}.amazonaws.com"
        payload = {
            "Text": text,
            "SourceLanguageCode": self.get_property("input-language-code"),
            "TargetLanguageCode": self.get_property("output-language-code"),
        }
        if self.get_property("brevity-on"):
            payload["Settings"] = {"Brevity": "ON"}
        status, body = _aws_json_post(
            self, endpoint.rstrip("/") + "/",
            "AWSShineFrontendService_20170701.TranslateText",
            payload, "translate")
        if status != 200:
            raise RuntimeError(f"translate: HTTP {status}: {body[:200]!r}")
        return json.loads(body).get("TranslatedText", "")

    def transform(self, buffer: Buffer) -> Buffer:
        import re as _re

        text = buffer.data if isinstance(buffer.data, str) else \
            host_bytes(buffer.data, np.uint8).decode("utf-8", "replace")
        if self.get_property("tokenization-method") == "punctuation":
            spans = [s for s in _re.split(r"(?<=[.!?;])\s+", text) if s]
            translated = " ".join(self._translate_one(s) for s in spans)
        else:
            translated = self._translate_one(text)
        pts = buffer.pts
        late = self.get_property("accumulator-lateness")
        if pts is not None and late:
            pts += late * 1_000_000
        return Buffer(np.frombuffer(translated.encode(), np.uint8),
                      pts=pts, duration=buffer.duration)


@register
class AwsTranscribeParse(BaseTransform):
    """Parses batch Transcribe result JSON into timed text buffers
    (net/aws/src/transcribe_parse)."""

    ELEMENT_NAME = "awstranscribeparse"
    ELEMENT_CLASS = "Parser/Text"
    ELEMENT_DESCRIPTION = "Parses AWS Transcribe result JSON into timed text"
    SINK_CAPS = Caps.builder("application/x-json")
    SRC_CAPS = TEXT_CAPS
    MODE = TransformMode.NEVER_IN_PLACE

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._out: List[Buffer] = []

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            doc = json.loads(host_bytes(inbuf.data, np.uint8).decode())
            for item in doc.get("results", {}).get("items", []):
                if item.get("type") != "pronunciation":
                    continue
                word = item["alternatives"][0]["content"]
                start = int(float(item["start_time"]) * 1e9)
                end = int(float(item["end_time"]) * 1e9)
                self._out.append(Buffer(np.frombuffer(word.encode(), np.uint8),
                                        pts=start, duration=end - start))
        return self._out.pop(0) if self._out else None


@register
class AwsTranscriber2(BaseTransform):
    """Streaming transcription over the Transcribe WebSocket API.

    Audio buffers are wrapped in event-stream AudioEvent messages
    (net/eventstream.py); TranscriptEvent results come back the same way.
    Final (non-partial) results are emitted as text buffers.  The
    endpoint is a SigV4-presigned wss URL in production; `endpoint-uri`
    connects directly for tests.
    """

    ELEMENT_NAME = "awstranscriber2"
    ELEMENT_CLASS = "Filter/Audio/Text"
    ELEMENT_DESCRIPTION = "Streaming speech-to-text with Amazon Transcribe"
    SINK_CAPS = Caps.builder("audio/x-raw")
    SRC_CAPS = TEXT_CAPS
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("region", "us-east-1", type="str"),
        Prop("access-key", None, type="str"),
        Prop("secret-access-key", None, type="str"),
        Prop("session-token", None, type="str"),
        Prop("endpoint-uri", None, type="str"),
        Prop("language-code", "en-US", type="str"),
        Prop("latency", 2_000_000_000, type="uint64"),
        Prop("lateness", 0, type="uint",
             doc="ms added to every output timestamp"),
        Prop("session-id", None, type="str",
             doc="transcription session id (36 chars), sent as session-id"),
        Prop("results-stability", "low", type="enum",
             choices=["low", "medium", "high"],
             doc="partial-results stabilization level (presign param)"),
        Prop("show-speaker-label", False, type="bool",
             doc="request speaker partitioning; labels prefix the text"),
        Prop("vocabulary-name", None, type="str",
             doc="custom vocabulary name (presign param)"),
        Prop("vocabulary-filter-name", None, type="str",
             doc="custom filter vocabulary name (presign param)"),
        Prop("vocabulary-filter-method", "mask", type="enum",
             choices=["mask", "remove", "tag"],
             doc="how filtered words are edited (needs filter-name)"),
        Prop("max-observed-delay", 0, type="uint",
             doc="(read) max ms between sending audio and receiving an item"),
    ]

    EXTRA_PAD_TEMPLATES = [
        ("unsynced_src", "src", "sometimes", "text/x-raw"),
        ("translate_src_%u", "src", "request", "text/x-raw"),
        ("unsynced_translate_src_%u", "src", "sometimes", "text/x-raw"),
    ]
    # GstTranslateSrcPad surface (reference aws other-types): the main src
    # and every translate_src pad carry a target language + tokenization
    PAD_PROPERTIES = {
        "src": [
            Prop("language-code", None, type="str", mutable="playing",
                 doc="translate the main transcript to this language "
                     "(None = emit untranslated)"),
            Prop("tokenization-method", "none", type="enum",
                 choices=["none", "span-based"], mutable="playing",
                 doc="span-based marks translation segments with brackets "
                     "for caption timing (Translate span tokenization)"),
        ],
        "translate_src": [
            Prop("language-code", None, type="str", mutable="playing",
                 doc="target language of this translation pad"),
            Prop("tokenization-method", "none", type="enum",
                 choices=["none", "span-based"], mutable="playing",
                 doc="see src.tokenization-method"),
        ],
    }

    def pad_property_changed(self, pad, name: str, value) -> None:
        if pad is getattr(self, "srcpad", None) and name == "language-code" \
                and value:
            tr = AwsTranslate(f"{self.name}-translate-src")
            for prop in ("region", "access-key", "secret-access-key",
                         "session-token"):
                tr.set_property(prop, self.get_property(prop))
            tr.set_property("input-language-code",
                            self.get_property("language-code").split("-")[0])
            tr.set_property("output-language-code", str(value).split("-")[0])
            self._src_translator = tr

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ws = None
        self._results: List[str] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_send_t: Optional[float] = None
        self._ended = False
        from ...core import Pad, PadDirection, PadPresence, PadTemplate

        self.unsynced_srcpad = self.add_pad(
            Pad("unsynced_src", PadDirection.SRC,
                PadTemplate("unsynced_src", PadDirection.SRC,
                            PadPresence.SOMETIMES, TEXT_CAPS)))
        self._translate_pads: List[tuple] = []  # (pad, unsynced_pad, translator)
        self._text_pads_started = False

    # -- per-language translate pads (transcriber/imp.rs:1132-1175: one
    #    request creates translate_src_N and its unsynced twin) -------------
    def request_pad(self, template_name: str = "translate_src_%u"):
        from ...core import Pad, PadDirection, PadPresence, PadTemplate

        n = len(self._translate_pads)
        translator = AwsTranslate(f"{self.name}-translate-{n}")
        for prop in ("region", "access-key", "secret-access-key",
                     "session-token"):
            translator.set_property(prop, self.get_property(prop))
        translator.set_property(
            "input-language-code", self.get_property("language-code").split("-")[0])

        class _TranslatePad(Pad):
            def set_property(self, prop_name, value, _tr=translator):
                if prop_name == "language-code":
                    _tr.set_property("output-language-code", value)
                elif prop_name == "tokenization-method":
                    Pad.set_property(self, prop_name, value)
                else:
                    _tr.set_property(prop_name, value)

            def get_property(self, prop_name, _tr=translator):
                if prop_name == "language-code":
                    return _tr.get_property("output-language-code")
                if prop_name == "tokenization-method":
                    return Pad.get_property(self, prop_name)
                return _tr.get_property(prop_name)

        pad = _TranslatePad(
            f"translate_src_{n}", PadDirection.SRC,
            PadTemplate("translate_src_%u", PadDirection.SRC,
                        PadPresence.REQUEST, TEXT_CAPS))
        unsynced = Pad(
            f"unsynced_translate_src_{n}", PadDirection.SRC,
            PadTemplate("unsynced_translate_src_%u", PadDirection.SRC,
                        PadPresence.SOMETIMES, TEXT_CAPS))
        self.add_pad(pad)
        self.add_pad(unsynced)
        self._translate_pads.append((pad, unsynced, translator))
        return pad

    def _extra_text_pads(self):
        return ([self.unsynced_srcpad]
                + [p for pair in self._translate_pads for p in pair[:2]])

    def _fan_out_text(self, text: str, pts) -> None:
        linked = [p for p in self._extra_text_pads() if p.peer is not None]
        if not linked:
            return
        if not self._text_pads_started:
            self._text_pads_started = True
            for p in linked:
                p.push_event(Event.new_stream_start(f"{self.name}-{p.name}"))
                p.push_event(Event.new_caps(TEXT_CAPS))
                p.push_event(Event.new_segment(Segment()))
        translations = {}
        for pad, unsynced, translator in self._translate_pads:
            if pad.peer is None and unsynced.peer is None:
                continue
            translations[pad.name] = translator._translate_one(text)
        for pad, unsynced, translator in self._translate_pads:
            out = translations.get(pad.name)
            if out is None:
                continue
            for p in (pad, unsynced):
                if p.peer is not None:
                    p.push(Buffer(np.frombuffer(out.encode(), np.uint8), pts=pts))
        if self.unsynced_srcpad.peer is not None:
            self.unsynced_srcpad.push(
                Buffer(np.frombuffer(text.encode(), np.uint8), pts=pts))

    def sink_event(self, event: Event) -> bool:
        if event.type == EventType.EOS:
            self.drain()  # the transcripts still owed go out before EOS
        if event.type in (EventType.EOS, EventType.FLUSH_START,
                          EventType.FLUSH_STOP):
            for p in self._extra_text_pads():
                if p.peer is not None:
                    p.push_event(event)
        return event.type != EventType.EOS  # EOS: drained above

    def drain(self) -> Optional[Buffer]:
        """End the stream (once) and wait, within `latency`, for the
        service to end it after its last transcript; push what came."""
        if self._ws is not None and not self._ended:
            self._ended = True
            try:
                self._send_end()
            except Exception:
                pass
            else:
                self._thread.join(self.get_property("latency") / 1e9)
        while True:
            out = self.generate_output()
            if out is None:
                return None
            self.srcpad.push(out)

    def _send_end(self) -> None:
        from ...net import eventstream

        # empty AudioEvent signals end of stream
        self._ws.send(eventstream.encode_message(
            {":message-type": "event", ":event-type": "AudioEvent",
             ":content-type": "application/octet-stream"}, b""))

    def transform_caps(self, direction, caps: Caps, filter_=None) -> Caps:
        from ...core.element import PadDirection

        out = TEXT_CAPS if direction == PadDirection.SINK else Caps.builder("audio/x-raw")
        return out if filter_ is None else out.intersect(filter_)

    def _connect_url(self) -> str:
        ep = self.get_property("endpoint-uri")
        if ep:
            return ep
        region = self.get_property("region")
        base = f"wss://transcribestreaming.{region}.amazonaws.com:8443/stream-transcription-websocket"
        params = {
            "language-code": self.get_property("language-code"),
            "media-encoding": "pcm",
            "sample-rate": "16000",
        }
        if self.get_property("session-id"):
            params["session-id"] = self.get_property("session-id")
        if self.get_property("results-stability") != "low":
            params["enable-partial-results-stabilization"] = "true"
            params["partial-results-stability"] = \
                self.get_property("results-stability")
        if self.get_property("show-speaker-label"):
            params["show-speaker-label"] = "true"
        if self.get_property("vocabulary-name"):
            params["vocabulary-name"] = self.get_property("vocabulary-name")
        if self.get_property("vocabulary-filter-name"):
            params["vocabulary-filter-name"] = \
                self.get_property("vocabulary-filter-name")
            params["vocabulary-filter-method"] = \
                self.get_property("vocabulary-filter-method")
        return sigv4.presign_url(
            "GET", base, region, "transcribe",
            self.get_property("access-key") or "anonymous",
            self.get_property("secret-access-key") or "anonymous",
            session_token=self.get_property("session-token"),
            extra_params=params,
        )

    def start(self) -> None:
        from websockets.sync.client import connect as ws_connect

        self._ws = ws_connect(self._connect_url(), open_timeout=10)
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._ws is not None:
            try:
                if not self._ended:
                    self._send_end()
                self._ws.close()
            except Exception:
                pass
            self._ws = None
        self._ended = False

    def _recv_loop(self) -> None:
        from ...net import eventstream

        try:
            for raw in self._ws:
                if isinstance(raw, str):
                    raw = raw.encode()
                headers, payload, _ = eventstream.decode_message(raw)
                if headers.get(":event-type") != "TranscriptEvent":
                    continue
                doc = json.loads(payload)
                if self._last_send_t is not None:
                    import time as _time

                    delay_ms = int((_time.monotonic() - self._last_send_t) * 1e3)
                    if delay_ms > self._props.get("max-observed-delay", 0):
                        self._props["max-observed-delay"] = delay_ms
                for res in doc.get("Transcript", {}).get("Results", []):
                    if res.get("IsPartial"):
                        continue
                    alts = res.get("Alternatives", [])
                    if not alts:
                        continue
                    text = alts[0].get("Transcript", "")
                    if self.get_property("show-speaker-label"):
                        items = alts[0].get("Items", [])
                        speakers = {i.get("Speaker") for i in items
                                    if i.get("Speaker") is not None}
                        if len(speakers) == 1:
                            text = f"[spk_{next(iter(speakers))}] {text}"
                    with self._lock:
                        self._results.append(text)
        except Exception:
            pass

    def generate_output(self) -> Optional[Buffer]:
        from ...net import eventstream

        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._last_pts = inbuf.pts
            pcm = host_array(inbuf.data)
            if pcm.dtype != np.int16:
                pcm = (np.clip(np.asarray(pcm, np.float32), -1, 1) * 32767).astype(np.int16)
            import time as _time

            self._last_send_t = _time.monotonic()
            self._ws.send(eventstream.encode_message(
                {":message-type": "event", ":event-type": "AudioEvent",
                 ":content-type": "application/octet-stream"},
                pcm.tobytes()))
            _time.sleep(0.01)  # let the receive thread drain on loopback
        with self._lock:
            if not self._results:
                return None
            text = self._results.pop(0)
        pts = getattr(self, "_last_pts", None)
        late = self.get_property("lateness")
        if pts is not None and late:
            pts += late * 1_000_000
        self._fan_out_text(text, pts)
        src_tr = getattr(self, "_src_translator", None)
        if src_tr is not None:  # src-pad language-code property set
            text = src_tr._translate_one(text)
        return Buffer(np.frombuffer(text.encode(), np.uint8), pts=pts)


@register
class AwsTranscriber(AwsTranscriber2):
    ELEMENT_NAME = "awstranscriber"
    ELEMENT_DESCRIPTION = "Streaming speech-to-text with Amazon Transcribe (v1 name)"
    PROPERTIES = AwsTranscriber2.PROPERTIES + [
        # v1 carries its own in-element translation channel in the
        # reference; here translation channels live in transcriberbin
        # (elements/cc/transcriberbin.py), so the latency split knobs are
        # carried for pipeline parity and fold into the reported latency
        Prop("transcribe-latency", 8_000, type="uint",
             doc="ms budget for the transcribe leg (folds into latency)"),
        Prop("translate-latency", 500, type="uint",
             doc="ms budget for the translate leg (transcriberbin wires "
                 "the actual translation channel)"),
        Prop("translate-lookahead", 3_000, type="uint",
             doc="max ms of transcript lookahead before translation"),
    ]
