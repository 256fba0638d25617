"""Plumbing: tee, audioconvert, audioresample, videoconvert.

The port of gst_plugins_rs_tpu/elements/generic/convert.py: the GStreamer
core elements the reference pipelines lean on.  audioconvert converts
sample formats (F64/F32/S32/S16) and layouts; audioresample runs the
polyphase resampler (ops/resample.py); videoconvert repacks between the
RGB-family layouts and converts to and from BT.601 4:2:0 (I420/NV12,
ops/yuv.py).  They run on the selected device (CUDA unless
`set_device("cpu")`); payloads that arrive elsewhere are moved there.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Element,
    Event,
    FlowReturn,
    IntRange,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    TransformMode,
    ValueList,
    VideoFilter,
    audio_caps_template,
    register,
    video_caps_template,
)
from ..._device import device
from ...core.video import RGB_FORMATS


@register
class Tee(Element):
    ELEMENT_NAME = "tee"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "1-to-N stream duplication"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any())))
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._counter = 0

    def request_src_pad(self) -> Pad:
        pad = Pad(f"src_{self._counter}", PadDirection.SRC,
                  PadTemplate("src_%u", PadDirection.SRC, PadPresence.REQUEST, Caps.new_any()))
        self._counter += 1
        return self.add_pad(pad)

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        ret = FlowReturn.OK
        for src in self.src_pads():
            if src.peer is not None:
                r = src.push(buf)
                if r != FlowReturn.OK:
                    ret = r
        return ret

    def _event(self, pad: Pad, event: Event) -> bool:
        ok = True
        for src in self.src_pads():
            ok = src.push_event(event) and ok
        return ok


_A_FORMATS = ("F64", "F32", "S32", "S16")
_SCALES = {"S16": 32768.0, "S32": 2147483648.0}
_INT_TYPES = {"S16": torch.int16, "S32": torch.int32}
_LAYOUTS = ("interleaved", "non-interleaved")


@register
class AudioConvert(BaseTransform):
    """Converts sample formats and layouts.  Non-interleaved (planar)
    payloads are [channels, frames]; interleaved are [frames, channels]."""

    ELEMENT_NAME = "audioconvert"
    ELEMENT_CLASS = "Filter/Converter/Audio"
    ELEMENT_DESCRIPTION = "Converts audio sample formats and layouts"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = audio_caps_template(formats=_A_FORMATS, layouts=_LAYOUTS)
    SRC_CAPS = audio_caps_template(formats=_A_FORMATS, layouts=_LAYOUTS)

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        for s in out.structures:
            s["format"] = ValueList(_A_FORMATS)
            s["layout"] = ValueList(_LAYOUTS)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        # prefer keeping the input format and layout
        s = caps.structure(0)
        return othercaps.fixate({"format": s.get("format"), "layout": s.get("layout")})

    def transform(self, inbuf: Buffer) -> Buffer:
        ins, outs = self.in_caps.structure(0), self.out_caps.structure(0)
        in_fmt, out_fmt = ins["format"], outs["format"]
        x = torch.as_tensor(inbuf.data).to(device())
        if ins.get("layout", "interleaved") != outs.get("layout", "interleaved"):
            x = x.t().contiguous()
        if in_fmt != out_fmt:
            # through float: integers scale to [-1, 1), F64 narrows to F32
            # unless it stays F64
            if in_fmt in _SCALES:
                x = x.to(torch.float32) / _SCALES[in_fmt]
            elif in_fmt == "F64" and out_fmt != "F64":
                x = x.to(torch.float32)
            if out_fmt in _SCALES:
                s = _SCALES[out_fmt]
                # the clip bound rounds to f32 (1 - 2^-31 becomes 1.0), and
                # 2^31 converts to the int32 maximum, as XLA's conversion
                # saturates (through int64, where 2^31 is exact)
                x = torch.clamp(x, -1.0, float(np.float32(1.0 - 1.0 / s))) * s
                x = torch.clamp(x.to(torch.int64), -2**31, 2**31 - 1).to(_INT_TYPES[out_fmt])
            elif out_fmt == "F64":
                x = x.to(torch.float64)
            else:
                x = x.to(torch.float32)
        out = Buffer(x)
        out.copy_metadata_from(inbuf)
        return out


@register
class AudioResample(BaseTransform):
    """Rational sample-rate conversion (ops/resample.py).  F32 interleaved;
    output PTS runs on the output-sample counter anchored at the first input
    PTS (a gap-free timeline)."""

    ELEMENT_NAME = "audioresample"
    ELEMENT_CLASS = "Filter/Converter/Audio"
    ELEMENT_DESCRIPTION = "Resamples audio (polyphase Kaiser-sinc on MXU)"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = audio_caps_template(formats=("F32",))
    SRC_CAPS = audio_caps_template(formats=("F32",))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._rs = None
        self._out_rate = 0
        self._base_pts = None
        self._out_samples = 0

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        for s in out.structures:
            s["rate"] = IntRange(1, 2_822_400)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        return othercaps.fixate({"rate": caps.structure(0).get("rate")})

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        from ...ops.resample import Resampler

        self._out_rate = outcaps.structure(0)["rate"]
        self._rs = Resampler(incaps.structure(0)["rate"], self._out_rate)
        self._base_pts = None
        self._out_samples = 0

    def _emit(self, y) -> Buffer:
        pts = None
        if self._base_pts is not None:
            pts = self._base_pts + self._out_samples * 1_000_000_000 // self._out_rate
        out = Buffer(y, pts=pts, duration=y.shape[0] * 1_000_000_000 // self._out_rate)
        self._out_samples += int(y.shape[0])
        return out

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        if self._base_pts is None:
            self._base_pts = inbuf.pts if inbuf.pts is not None else 0
        x = torch.as_tensor(inbuf.data)  # Resampler.process moves it to its device
        y = self._rs.process(x if x.dim() == 2 else x.reshape(1, -1))
        if y.shape[0] == 0:
            return None  # polyphase warm-up: nothing to push yet
        return self._emit(y)

    def drain(self) -> Optional[Buffer]:
        if self._rs is None or self._rs.identity or self._base_pts is None:
            return None
        y = self._rs.drain()
        return self._emit(y) if y.shape[0] else None

    def on_paused_to_ready(self) -> None:
        super().on_paused_to_ready()
        if self._rs is not None:
            self._rs.reset()
        self._base_pts = None
        self._out_samples = 0


_VC_FORMATS = tuple(RGB_FORMATS) + ("I420", "NV12")


@register
class VideoConvert(VideoFilter):
    """Packed RGB-family repacks and BT.601 4:2:0 conversion (I420/NV12 <->
    any RGB format, ops/yuv.py).  4:2:0 formats need even width and height."""

    ELEMENT_NAME = "videoconvert"
    ELEMENT_CLASS = "Filter/Converter/Video"
    ELEMENT_DESCRIPTION = "Converts video formats (RGB family, I420/NV12 4:2:0)"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = video_caps_template(_VC_FORMATS)
    SRC_CAPS = video_caps_template(_VC_FORMATS)

    def __init__(self, name=None):
        super().__init__(name)
        self._converters = {}  # (in_fmt, out_fmt) -> payload -> payload

    def transform_caps(self, direction: PadDirection, caps: Caps,
                       filter_: Optional[Caps]) -> Caps:
        out = caps.copy()
        if out.is_any():
            out = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        for s in out.structures:
            s["format"] = ValueList(_VC_FORMATS)
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def fixate_caps(self, direction, caps, othercaps):
        return othercaps.fixate({"format": caps.structure(0).get("format")})

    def pure_kernel(self):
        """Chain-fusion hook (parallel/fuse.py): the converter of the
        negotiated formats, the identity when they match."""
        in_info, out_info = self.video_info, self.out_video_info
        if in_info is None or out_info is None or in_info.format == out_info.format:
            return lambda d: d
        return build_format_converter(in_info, out_info)

    def transform(self, inbuf: Buffer) -> Buffer:
        in_info, out_info = self.video_info, self.out_video_info
        assert in_info is not None and out_info is not None
        if in_info.format == out_info.format:
            out = Buffer(inbuf.data)
            out.copy_metadata_from(inbuf)
            return out
        if (in_info.is_planar or out_info.is_planar) and (in_info.width % 2
                                                          or in_info.height % 2):
            raise ValueError(f"{self.name}: 4:2:0 conversion needs even dimensions, got "
                             f"{in_info.width}x{in_info.height}")
        key = (in_info.format, out_info.format)
        fn = self._converters.get(key)
        if fn is None:
            fn = self._converters[key] = build_format_converter(in_info, out_info)
        dev = device()
        data = inbuf.data
        if in_info.is_planar:
            data = tuple(torch.as_tensor(p).to(dev) for p in data)
        else:
            data = torch.as_tensor(data).to(dev)
        payload = fn(data)
        out = Buffer(tuple(payload) if isinstance(payload, (tuple, list)) else payload)
        out.copy_metadata_from(inbuf)
        return out


def _u8_or_u16(info):
    return torch.uint8 if info.dtype == np.uint8 else torch.uint16


def build_format_converter(in_info, out_info):
    """The payload -> payload converter of a format pair; geometry comes from
    the tensors."""
    from ...ops.yuv import KB, KG, KR, i420_to_rgb_planes, nv12_to_uv, rgb_planes_to_i420, \
        uv_to_nv12

    in_planar, out_planar = in_info.is_planar, out_info.is_planar
    in_fmt, out_fmt = in_info.format, out_info.format

    def to_planes(frame):
        """Any input payload -> (y, u, v) u8 planes."""
        if in_fmt == "I420":
            return frame
        if in_fmt == "NV12":
            y, uv = frame
            u, v = nv12_to_uv(uv)
            return y, u, v
        ir, ig, ib, _ = in_info.rgb_offsets
        scale = (1.0 / 257.0) if in_info.dtype != np.uint8 else 1.0
        return rgb_planes_to_i420(frame[..., ir].to(torch.float32) * scale,
                                  frame[..., ig].to(torch.float32) * scale,
                                  frame[..., ib].to(torch.float32) * scale)

    if out_planar:  # RGB/I420/NV12 -> I420/NV12

        def convert(frame):
            y, u, v = to_planes(frame)
            return (y, uv_to_nv12(u, v)) if out_fmt == "NV12" else (y, u, v)

        return convert

    our, oug, oub, oa = out_info.rgb_offsets
    maxv_out = 255 if out_info.dtype == np.uint8 else 65535
    dtype = _u8_or_u16(out_info)

    def pack(h, w, comps, device):
        """The packed output frame from (channel, int32 plane or scalar)
        pairs, built in int32 (few PyTorch operators take uint16) and
        converted once."""
        frame = torch.zeros((h, w, out_info.components), dtype=torch.int32, device=device)
        for off, val in comps:
            frame[..., off] = val
        return frame.to(dtype)

    if in_planar:  # I420/NV12 -> packed

        def convert(frame):
            y, u, v = to_planes(frame)
            if out_fmt == "GRAY8":
                # GRAY8 is full-range luma: rescale studio-swing Y
                g8 = torch.clamp(torch.round((y.to(torch.float32) - 16.0) * (255.0 / 219.0)),
                                 0.0, 255.0).to(torch.uint8)
                return g8[..., None]
            r, g, b = (p.to(torch.int32) * (257 if maxv_out == 65535 else 1)
                       for p in i420_to_rgb_planes(y, u, v))
            comps = [(our, r), (oug, g), (oub, b)]
            if oa is not None:
                comps.append((oa, maxv_out))
            return pack(y.shape[0], y.shape[1], comps, y.device)

        return convert

    # packed -> packed (channel reorder / alpha add-drop / depth rescale)
    ir, ig, ib, ia = in_info.rgb_offsets
    maxv_in = 255 if in_info.dtype == np.uint8 else 65535

    if out_fmt == "GRAY8":
        # full-range BT.601 luma, not a channel copy

        def convert(frame):
            scale = (1.0 / 257.0) if maxv_in == 65535 else 1.0
            r = frame[..., ir].to(torch.float32) * scale
            g = frame[..., ig].to(torch.float32) * scale
            b = frame[..., ib].to(torch.float32) * scale
            y = torch.clamp(torch.round(KR * r + KG * g + KB * b), 0.0, 255.0)
            return y.to(torch.uint8)[..., None]

        return convert

    def convert(frame):
        def comp(off):
            c = frame[..., off].to(torch.int32)
            if maxv_in != maxv_out:
                c = c * maxv_out // maxv_in
            return c

        comps = [(our, comp(ir)), (oug, comp(ig)), (oub, comp(ib))]
        if oa is not None:
            comps.append((oa, comp(ia) if ia is not None else maxv_out))
        return pack(frame.shape[0], frame.shape[1], comps, frame.device)

    return convert


__all__ = ["Tee", "AudioConvert", "AudioResample", "VideoConvert", "build_format_converter"]
