"""skiacompositor: N-input video compositor on the device.

The port of gst_plugins_rs_tpu/elements/video/compositor.py (parity target
video/skia, compositor/mod.rs:26: a VideoAggregator with per-pad
xpos/ypos/width/height/alpha/operator/anti-alias placing each input onto an
output canvas).  The canvas is one [H, W*C] f32 tensor on the selected
device; each pad's frame is resized with the weights of `jax.image.resize`
(ops/image_resize.py: linear with antialiasing when the pad's anti-alias is
set, else nearest), blended over its region with the pad's Porter-Duff
operator and pasted back by slice assignment.  The placement and the crop
of an out-of-bounds pad are host integer arithmetic; nothing is read back.
The JAX element compiles one program per placement tuple; the port loops
over the pads eagerly.

Per-pad properties are set via `pad.props` (xpos, ypos, width, height,
alpha, operator, anti-alias), mirroring the reference's pad property names.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ...core import Buffer, FlowReturn, Prop, register, video_caps_template
from ...core.aggregator import Aggregator, AggregatorPad
from ...core.events import Event, Segment
from ...core.video import RGB_FORMATS, VideoInfo
from ..._device import device
from ...ops.image_resize import resize

_U8_FORMATS = tuple(f for f in RGB_FORMATS if RGB_FORMATS[f][1] == np.uint8)
VIDEO_CAPS = video_caps_template(_U8_FORMATS)


def background_canvas(background: str, out_h: int, out_w: int, channels: int,
                      dev) -> torch.Tensor:
    """[out_h, out_w * channels] f32 canvas filled per the background
    property (skia Background enum: checker/black/white/transparent)."""
    if background == "white":
        return torch.full((out_h, out_w * channels), 255.0, dtype=torch.float32, device=dev)
    if background == "checker":
        # 8px checkerboard in the 0x66/0x99 skia pattern (opaque alpha)
        yy = (torch.arange(out_h, device=dev) // 8)[:, None]
        xx = (torch.arange(out_w, device=dev) // 8)[None, :]
        cell = torch.where((yy + xx) % 2 == 0, 0x66, 0x99).to(torch.float32)
        px = cell[..., None].repeat(1, 1, channels)
        if channels == 4:
            px[..., 3] = 255.0
        return px.reshape(out_h, out_w * channels)
    # black and transparent both start from zeros (alpha plane included)
    return torch.zeros((out_h, out_w * channels), dtype=torch.float32, device=dev)


#: GstSkiaCompositorPadOperator parity (reference skia compositor/pad.rs:36-51)
OPERATORS = ["source", "over", "add", "dest", "clear", "dest-over",
             "source-in", "dest-in", "source-out", "dest-out",
             "source-atop", "dest-atop", "xor", "modulate"]


def blend(op: str, dst: torch.Tensor, img: torch.Tensor, a) -> torch.Tensor:
    """Porter-Duff composition of a uniform-alpha source over the opaque
    canvas (dst alpha = 1, src alpha = pad alpha): the closed forms below
    are the exact Porter-Duff results under those alphas.  `a` is rounded
    to float32 and 1 - a is taken in float32, as the JAX element takes both
    from its f32 alpha array."""
    a = np.float32(a)
    keep = float(np.float32(1.0) - a)  # 1 - a, in float32
    a = float(a)
    if op == "clear" or op == "source-out":
        return torch.zeros_like(dst)
    if op == "source" or op == "source-in":
        return img * a
    if op == "over" or op == "source-atop":
        return img * a + dst * keep
    if op == "add":
        return dst + img * a
    if op == "dest" or op == "dest-over":
        return dst
    if op == "dest-in" or op == "dest-atop":
        return dst * a
    if op == "dest-out" or op == "xor":
        return dst * keep
    if op == "modulate":
        return dst * img * (1.0 / 255.0)
    raise ValueError(f"unknown operator {op!r}")


def composite(frames: Sequence[torch.Tensor], alphas: Sequence[float],
              placements: Sequence[Tuple[int, int, int, int]], *,
              out_h: int, out_w: int, channels: int, background: str = "checker",
              operators: Optional[Sequence[str]] = None,
              methods: Optional[Sequence[str]] = None) -> torch.Tensor:
    """frames: per-pad [h, w, c] u8 on one device; placements: (x, y, w, h)
    per pad, already clipped to the canvas; operators: per-pad Porter-Duff
    op (default 'over'); methods: per-pad resize method ('linear' or
    'nearest', default 'nearest').  Returns the [out_h, out_w, channels] u8
    frame: the canvas clipped to [0, 255] and truncated."""
    dev = frames[0].device
    canvas = background_canvas(background, out_h, out_w, channels, dev)
    for i, (frame, (x, y, w, h)) in enumerate(zip(frames, placements)):
        img = frame.to(torch.float32)
        if img.shape[-1] != channels:
            rgb = img[..., :3]
            if channels == 4:
                img = torch.cat([rgb, torch.full(rgb.shape[:2] + (1,), 255.0, device=dev)], -1)
            else:
                img = rgb
        if (img.shape[0], img.shape[1]) != (h, w):
            img = resize(img, (h, w), methods[i] if methods else "nearest")
        img = img.reshape(h, w * channels)
        region = canvas[y:y + h, x * channels:(x + w) * channels]
        op = operators[i] if operators else "over"
        canvas[y:y + h, x * channels:(x + w) * channels] = blend(op, region, img, alphas[i])
    out = torch.clamp(canvas, 0.0, 255.0).to(torch.uint8)
    return out.reshape(out_h, out_w, channels)


class CompositorPad(AggregatorPad):
    """Pad surface parity: GstSkiaCompositorPad (xpos/ypos/width/height/
    alpha/operator/anti-alias; reference skia compositor/pad.rs).  `props`
    aliases the per-pad property store."""

    def __init__(self, name, template):
        super().__init__(name, template)
        self.props = self._props  # alias: pad.props["xpos"] == property


@register
class SkiaCompositor(Aggregator):
    ELEMENT_NAME = "skiacompositor"
    ELEMENT_CLASS = "Filter/Editor/Video/Compositor"
    ELEMENT_DESCRIPTION = "Composites video streams on device"
    SINK_TEMPLATE_CAPS = VIDEO_CAPS
    SRC_TEMPLATE_CAPS = VIDEO_CAPS
    PROPERTIES = [
        Prop("width", 0, type="uint", doc="output width (0 = first input's)"),
        Prop("height", 0, type="uint", doc="output height (0 = first input's)"),
        Prop("background", "checker", type="enum",
             choices=["checker", "black", "white", "transparent"],
             doc="canvas fill behind the composed pads"),
    ]
    PAD_PROPERTIES = {
        "sink": [
            Prop("xpos", 0.0, type="float", mutable="playing",
                 doc="horizontal position of the input"),
            Prop("ypos", 0.0, type="float", mutable="playing",
                 doc="vertical position of the input"),
            Prop("width", 0.0, type="float", mutable="playing",
                 doc="width of the picture (<=0 = input width)"),
            Prop("height", 0.0, type="float", mutable="playing",
                 doc="height of the picture (<=0 = input height)"),
            Prop("alpha", 1.0, type="float", minimum=0.0, maximum=1.0,
                 mutable="playing", doc="alpha of the input"),
            Prop("operator", "over", type="enum", choices=OPERATORS,
                 mutable="playing",
                 doc="Porter-Duff blend of this pad over the accumulated "
                     "canvas (opaque-destination closed forms)"),
            Prop("anti-alias", True, type="bool", mutable="playing",
                 doc="bilinear resampling when scaling (nearest when off)"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._out_info: Optional[VideoInfo] = None
        self._sent_caps = False
        self._device: Optional[torch.device] = None

    def request_sink_pad(self, name: Optional[str] = None) -> CompositorPad:
        if name is None:
            name = f"sink_{self._pad_counter}"
        self._pad_counter += 1
        pad = CompositorPad(name, self._sink_template)
        pad.chain_function = self._sink_chain
        pad.event_function = self._sink_event
        pad.query_function = self._sink_query
        return self.add_pad(pad)  # type: ignore[return-value]

    def on_paused_to_ready(self) -> None:
        self._out_info = None
        self._sent_caps = False

    def _ensure_output(self) -> bool:
        if self._out_info is not None:
            return True
        first = next((p for p in self.agg_pads() if p.current_caps is not None), None)
        if first is None:
            return False
        info = VideoInfo.from_caps(first.current_caps)
        w = self.get_property("width") or info.width
        h = self.get_property("height") or info.height
        self._out_info = VideoInfo(info.format, w, h, info.fps)
        self._device = device()
        return True

    def _send_caps(self) -> None:
        if not self._sent_caps:
            self._sent_caps = True
            self.srcpad.push_event(Event.new_caps(self._out_info.to_caps()))
            self.srcpad.push_event(Event.new_segment(Segment()))

    def aggregate(self, timeout: bool) -> FlowReturn:
        if not self._ensure_output():
            return FlowReturn.OK
        self._send_caps()
        out = self._out_info
        frames, placements, alphas, operators, methods = [], [], [], [], []
        pts = None
        duration = None
        for pad in self.agg_pads():
            buf = pad.pop_buffer()
            if buf is None:
                continue
            if pts is None or (buf.pts or 0) < pts:
                pts = buf.pts or 0
                duration = buf.duration
            frame = torch.as_tensor(buf.data, device=self._device)
            info = VideoInfo.from_caps(pad.current_caps)
            w = int(pad.props["width"]) if pad.props["width"] > 0 else info.width
            h = int(pad.props["height"]) if pad.props["height"] > 0 else info.height
            x, y = int(pad.props["xpos"]), int(pad.props["ypos"])
            # clip to the canvas (host integers)
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + w, out.width), min(y + h, out.height)
            if x1 <= x0 or y1 <= y0:
                continue
            if (x0, y0, x1, y1) != (x, y, x + w, y + h):
                # crop the source proportionally for out-of-bounds placement
                sx0 = (x0 - x) * info.width // w
                sy0 = (y0 - y) * info.height // h
                sx1 = (x1 - x) * info.width // w
                sy1 = (y1 - y) * info.height // h
                frame = frame[sy0:sy1, sx0:sx1]
            frames.append(frame)
            placements.append((x0, y0, x1 - x0, y1 - y0))
            alphas.append(pad.props["alpha"])
            operators.append(pad.props["operator"])
            methods.append("linear" if pad.props["anti-alias"] else "nearest")
        if not frames:
            return FlowReturn.OK
        canvas = composite(
            frames, alphas, placements,
            out_h=out.height, out_w=out.width, channels=out.components,
            background=self.get_property("background"),
            operators=operators, methods=methods,
        )
        return self.finish_buffer(Buffer(canvas, pts=pts, duration=duration))


__all__ = ["SkiaCompositor", "CompositorPad", "composite", "blend", "background_canvas",
           "OPERATORS"]
