"""dav1ddec / rav1enc / ffv1dec: codec-wrapper elements over system C libraries.

Parity targets:
- video/dav1d (dav1ddec, imp.rs:1150-1196; props n-threads, max-frame-delay,
  apply-grain, inloop-filters at imp.rs:1128-1143) — the reference wraps
  libdav1d through the dav1d crate; here the same libdav1d is reached via
  libavcodec (native/avshim.cpp + codecs/avlib.py).
- video/rav1e (rav1enc, imp.rs:246-351: speed-preset=6, low-latency=false,
  min/max-key-frame-interval=12/240, switch-frame-interval=0, bitrate=0,
  quantizer=100, min-quantizer=0, tile-cols/rows/tiles=0, error-resilient,
  threads) — wraps the same librav1e.
- video/ffv1 (ffv1dec, imp.rs:315-343: sink video/x-ffv ffvversion=1) — the
  reference decodes with the pure-Rust ffv1 crate; here libavcodec's ffv1.

Video is exchanged as I420 plane tuples (the framework's planar payload
convention, core/video.py); colorspace work stays on the TPU side of the
boundary and the C shim only does packing.

Where the libavcodec shim is missing (`avlib.available()` is False, as on a
machine without libavcodec), each element raises
RuntimeError("libavcodec shim unavailable ...") when it opens its codec, as
in the JAX package.  A decoder puts each frame's three planes on the device
`gst_plugins_rs_tpu_torch.set_device` selects in one upload (views of one
tensor); rav1enc reads a frame on the device back once (the planes joined
on the device first).  The JAX elements emit and take host arrays.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...core import (
    BaseTransform,
    Buffer,
    BufferFlags,
    Caps,
    PadDirection,
    Prop,
    TransformMode,
    register,
)
from ...core.caps import Structure, ValueList
from ...core.events import Event
from ...core.video import VideoInfo, video_caps_template
from ..._device import device
from ...codecs import avlib
from ...core.payload import host_array, host_bytes

AV1_CAPS = Caps([Structure("video/x-av1", **{
    "stream-format": "obu-stream",
    "alignment": ValueList(("frame", "tu")),
})])
FFV_CAPS = Caps([Structure("video/x-ffv", ffvversion=1)])
I420_CAPS = video_caps_template(("I420",))


def planes_to_device(planes, dev: torch.device):
    """Host planes -> views of one tensor on dev (one upload)."""
    flat = np.concatenate([np.ascontiguousarray(p, np.uint8).ravel() for p in planes])
    t = torch.from_numpy(flat).to(dev)
    out, off = [], 0
    for p in planes:
        out.append(t[off:off + p.size].view(p.shape))
        off += p.size
    return tuple(out)


def planes_to_host(planes):
    """Planes on a device -> host u8 arrays (one read-back: the planes are
    joined on the device first); host planes as u8 arrays."""
    if not all(isinstance(p, torch.Tensor) for p in planes):
        return tuple(host_array(p, np.uint8) for p in planes)
    flat = host_array(torch.cat([p.reshape(-1) for p in planes]), np.uint8)
    out, off = [], 0
    for p in planes:
        out.append(flat[off:off + p.numel()].reshape(tuple(p.shape)))
        off += p.numel()
    return tuple(out)


class _AvVideoDecoderBase(BaseTransform):
    """Shared packet-in / I420-frames-out decoder skeleton.

    Src caps are deferred until the first decoded frame reports real
    dimensions (same reason claxondec defers to STREAMINFO): fixating the
    1x1 template at link time would push garbage downstream.
    """

    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = I420_CAPS
    CODEC = ""  # libavcodec decoder name

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._dec: Optional[avlib.VideoDecoder] = None
        self._pending: List[Buffer] = []
        self._frame_count = 0
        self._fps = None
        self._caps_sent = False
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._dec = None
        self._pending = []
        self._frame_count = 0
        self._fps = None
        self._caps_sent = False

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (I420_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _handle_caps(self, incaps: Caps) -> bool:
        self.in_caps = incaps
        s = incaps.structure(0)
        self._fps = s.get("framerate")
        self._open(s)
        return True

    def _open(self, s: Structure) -> None:
        extradata = s.get("codec_data", b"")
        if isinstance(extradata, np.ndarray):
            extradata = extradata.tobytes()
        self._dec = avlib.VideoDecoder(self.CODEC, extradata or b"")

    def _send_caps(self, w: int, h: int) -> None:
        if self._caps_sent:
            return
        self._caps_sent = True
        fields = {"format": "I420", "width": w, "height": h}
        if self._fps is not None:
            fields["framerate"] = self._fps
        caps = Caps.builder("video/x-raw", **fields)
        self.out_caps = caps
        self.srcpad.current_caps = caps
        self.srcpad.push_event(Event.new_caps(caps))

    def _enqueue(self, frames, pts_fallback: int, duration) -> None:
        for y, u, v, pts in frames:
            self._send_caps(y.shape[1], y.shape[0])
            self._pending.append(
                Buffer(planes_to_device((y, u, v), self._device),
                       pts=pts if pts >= 0 else pts_fallback, duration=duration))
            self._frame_count += 1

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            d = inbuf.data
            pkt = d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
            pts = inbuf.pts if inbuf.pts is not None else -1
            self._enqueue(self._dec.decode(pkt, pts if pts is not None else -1),
                          pts, inbuf.duration)
        return self._pending.pop(0) if self._pending else None

    def drain(self) -> Optional[Buffer]:
        if self._dec is not None:
            self._enqueue(self._dec.decode(None), -1, None)
        # BaseTransform drains a single residue buffer; push the rest directly
        while len(self._pending) > 1:
            self.srcpad.push(self._pending.pop(0))
        return self._pending.pop(0) if self._pending else None


@register
class Dav1dDec(_AvVideoDecoderBase):
    ELEMENT_NAME = "dav1ddec"
    ELEMENT_CLASS = "Codec/Decoder/Video"
    ELEMENT_DESCRIPTION = "Decode AV1 video streams with dav1d"
    SINK_CAPS = AV1_CAPS
    CODEC = "libdav1d"
    PROPERTIES = [
        Prop("n-threads", 0, type="uint"),
        Prop("max-frame-delay", -1, type="int64", minimum=-1),
        Prop("apply-grain", False, type="bool"),
        Prop("inloop-filters", "all", type="enum",
             choices=["none", "deblock", "cdef", "restoration", "all"]),
    ]


@register
class Ffv1Dec(_AvVideoDecoderBase):
    ELEMENT_NAME = "ffv1dec"
    ELEMENT_CLASS = "Codec/Decoder/Video"
    ELEMENT_DESCRIPTION = "FFV1 (lossless intra) video decoder"
    SINK_CAPS = FFV_CAPS
    CODEC = "ffv1"

    def _open(self, s: Structure) -> None:
        # ffv1 carries dimensions in the container, not the bitstream
        extradata = s.get("codec_data", b"")
        if isinstance(extradata, np.ndarray):
            extradata = extradata.tobytes()
        self._dec = avlib.VideoDecoder(
            self.CODEC, extradata or b"",
            width=s.get("width", 0), height=s.get("height", 0))


@register
class Rav1Enc(BaseTransform):
    ELEMENT_NAME = "rav1enc"
    ELEMENT_CLASS = "Codec/Encoder/Video"
    ELEMENT_DESCRIPTION = "AV1 encoder based on rav1e"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = I420_CAPS
    SRC_CAPS = AV1_CAPS
    # defaults mirror rav1enc/imp.rs:30-45
    PROPERTIES = [
        Prop("speed-preset", 6, type="uint", minimum=0, maximum=11),
        Prop("low-latency", False, type="bool"),
        Prop("min-key-frame-interval", 12, type="uint64"),
        Prop("max-key-frame-interval", 240, type="uint64"),
        Prop("switch-frame-interval", 0, type="uint64"),
        Prop("bitrate", 0, type="int", mutable="playing",
             doc="target bitrate (bps); 0 = constant quantizer; live changes "
                 "rebuild the encoder (keyframe restart)"),
        Prop("quantizer", 100, type="uint", maximum=255),
        Prop("min-quantizer", 0, type="uint", maximum=255),
        Prop("tile-cols", 0, type="uint"),
        Prop("tile-rows", 0, type="uint"),
        Prop("tiles", 0, type="uint"),
        Prop("error-resilient", False, type="bool"),
        Prop("threads", 0, type="uint"),
        Prop("tune", "psychovisual", type="enum",
             choices=["psnr", "psychovisual"],
             doc="quality tuning metric (rav1e Tune)"),
        Prop("rdo-lookahead-frames", -1, type="int", minimum=-1,
             doc="RDO lookahead window (-1 = rav1e default; low-latency "
                 "forces 1)"),
        Prop("reservoir-frame-delay", -1, type="int", minimum=-1,
             doc="rate-control reservoir size in frames (-1 = default)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._enc: Optional[avlib.VideoEncoder] = None
        self._info: Optional[VideoInfo] = None
        self._pending: List[Buffer] = []
        self._frame_index = 0

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._enc = None
        self._pending = []
        self._frame_index = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (AV1_CAPS if direction == PadDirection.SINK else I420_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _opts(self) -> str:
        parts = [f"speed={self.get_property('speed-preset')}",
                 f"g={self.get_property('max-key-frame-interval')}",
                 "keyint_min=%d" % self.get_property("min-key-frame-interval")]
        if not self.get_property("bitrate"):
            parts.append(f"qp={self.get_property('quantizer')}")
        if self.get_property("tile-cols"):
            parts.append(f"tile-columns={self.get_property('tile-cols')}")
        if self.get_property("tile-rows"):
            parts.append(f"tile-rows={self.get_property('tile-rows')}")
        rav1e_params = []
        if self.get_property("low-latency"):
            rav1e_params.append("low_latency=true")
        if self.get_property("min-quantizer"):
            rav1e_params.append(f"min_quantizer={self.get_property('min-quantizer')}")
        if self.get_property("switch-frame-interval"):
            rav1e_params.append(
                f"switch_frame_interval={self.get_property('switch-frame-interval')}")
        if self.get_property("error-resilient"):
            rav1e_params.append("error_resilient=true")
        if self.get_property("threads"):
            rav1e_params.append(f"threads={self.get_property('threads')}")
        if self.get_property("tune") != "psychovisual":
            rav1e_params.append(f"tune={self.get_property('tune')}")
        if self.get_property("reservoir-frame-delay") >= 0:
            rav1e_params.append(
                f"reservoir_frame_delay={self.get_property('reservoir-frame-delay')}")
        if self.get_property("low-latency"):
            # rav1e only starts emitting before EOS with a short RDO window
            rav1e_params.append("rdo_lookahead_frames=1")
        elif self.get_property("rdo-lookahead-frames") >= 0:
            rav1e_params.append(
                f"rdo_lookahead_frames={self.get_property('rdo-lookahead-frames')}")
        if rav1e_params:
            parts.append("rav1e-params=" + ":".join(rav1e_params))
        return "|".join(parts)

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self._info = VideoInfo.from_caps(incaps)
        fps = self._info.fps
        self._enc = avlib.VideoEncoder(
            "librav1e", self._info.width, self._info.height,
            fps=(fps.numerator, fps.denominator),
            bitrate=self.get_property("bitrate") or 0,
            opts=self._opts())

    def _emit(self, packets) -> None:
        dur = self._info.frame_duration() if self._info else None
        for data, pts, key in packets:
            buf = Buffer(np.frombuffer(data, np.uint8),
                         pts=pts * dur if (dur and pts >= 0) else None,
                         duration=dur)
            if not key:
                buf.set_flag(BufferFlags.DELTA_UNIT)
            self._pending.append(buf)

    def property_changed(self, name: str, value) -> None:
        # live bitrate adaptation (webrtcsink congestion control): mark for
        # rebuild; the STREAMING thread applies it before the next encode —
        # set_property may run on another thread (e.g. the RTCP receive
        # thread) and must not race an in-flight encode on the same encoder
        if name == "bitrate" and self._enc is not None:
            self._reconfigure = True

    def _apply_reconfigure(self) -> None:
        if not getattr(self, "_reconfigure", False) or self._info is None:
            return
        self._reconfigure = False
        self._emit(self._enc.encode(None))  # flush; restart on a keyframe
        fps = self._info.fps
        self._enc = avlib.VideoEncoder(
            "librav1e", self._info.width, self._info.height,
            fps=(fps.numerator, fps.denominator),
            bitrate=self.get_property("bitrate") or 0,
            opts=self._opts())

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._apply_reconfigure()
            y, u, v = planes_to_host(inbuf.data)
            self._emit(self._enc.encode(y, u, v, pts=self._frame_index))
            self._frame_index += 1
        return self._pending.pop(0) if self._pending else None

    def drain(self) -> Optional[Buffer]:
        if self._enc is not None:
            self._emit(self._enc.encode(None))
        while len(self._pending) > 1:
            self.srcpad.push(self._pending.pop(0))
        return self._pending.pop(0) if self._pending else None


__all__ = ["Dav1dDec", "Ffv1Dec", "Rav1Enc"]
