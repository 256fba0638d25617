"""cea608overlay: render CEA-608 captions onto video frames on device.

Parity target: video/closedcaption/src/cea608overlay/imp.rs (pango-rendered
caption box composited over video).  The glyphs come from a bitmap atlas
(one 8x12 tile a printable character) that the port carries as data,
`data/cea608_atlas.npz`, drawn with Pillow's default font by
`utils/cea608_atlas.py`; the port imports no Pillow when it runs (the JAX
package draws the atlas with Pillow in `start`).  The atlas is uploaded to
the frame's device once.  Each distinct caption text becomes a frame-sized
[h, w] alpha mask and box there, built by gathering atlas tiles on the
device and cached by (lines, h, w); compositing (box, then white text over
the frame) is elementwise torch on the frame's device, so the frame never
leaves the card.  Frames that arrive elsewhere are moved to the selected
device (`set_device`).

Pad layout follows the reference: video sink pad + cc sink pad
(closedcaption/x-cea-608), video src pad.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
    video_caps_template,
)
from ..._device import device
from ...core.payload import host_array
from ...core.video import RGB_FORMATS
from ...ops import cea608
from ...utils.cea608_atlas import ATLAS_CHARS as _ATLAS_CHARS
from ...utils.cea608_atlas import ATLAS_PATH, GLYPH_H, GLYPH_W


def _build_atlas() -> np.ndarray:
    """[n_chars, GLYPH_H, GLYPH_W] float32 alpha atlas: the bundled glyphs'
    coverage over 255."""
    with np.load(ATLAS_PATH) as f:
        glyphs = f["glyphs"]
    return glyphs.astype(np.float32) / 255.0


def _composite(frame: torch.Tensor, mask: torch.Tensor, box: torch.Tensor,
               box_strength: float = 0.7) -> torch.Tensor:
    """White text (mask) over a darkened box region, elementwise on the
    frame's device; box_strength 1.0 = solid black background
    (black-background=true)."""
    f = frame.to(torch.float32)
    boxed = f * (1.0 - box_strength * box[..., None])
    out = boxed * (1.0 - mask[..., None]) + 255.0 * mask[..., None]
    return out.clamp(0.0, 255.0).to(torch.uint8)


def _cdp_extract_608_field1(cdp: bytes):
    """Yield 608 field-1 byte pairs from a CDP packet (SMPTE 334-2):
    0x9669 magic, length, framerate/flags, sequence counter, then sections —
    cc_data section id 0x72 carries cc_data triplets."""
    if len(cdp) < 8 or cdp[0] != 0x96 or cdp[1] != 0x69:
        return
    pos = 7  # magic(2) + len(1) + framerate(1) + flags(1) + seq(2)
    while pos + 1 < len(cdp):
        section = cdp[pos]
        if section == 0x71:  # time code
            pos += 5
        elif section == 0x72:  # cc_data
            count = cdp[pos + 1] & 0x1F
            pos += 2
            for _ in range(count):
                if pos + 3 > len(cdp):
                    return
                b0, b1, b2 = cdp[pos], cdp[pos + 1], cdp[pos + 2]
                if b0 & 0x04 and (b0 & 0x03) == 0:  # cc_valid, cc_type 0
                    yield b1, b2
                pos += 3
        elif section == 0x73:  # service info
            count = cdp[pos + 1] & 0x0F
            pos += 2 + 7 * count
        elif section == 0x74:  # footer
            return
        else:
            return  # unknown section: bail


@register
class Cea608Overlay(Element):
    ELEMENT_NAME = "cea608overlay"
    ELEMENT_CLASS = "Video/Overlay/Subtitle"
    ELEMENT_DESCRIPTION = "Renders CEA-608 captions over video on device"
    PROPERTIES = [
        Prop("scale", 2, type="uint", minimum=1, maximum=8, doc="glyph upscale factor"),
        Prop("black-background", False, type="bool", mutable="playing",
             doc="solid black box behind text (false = translucent box; "
                 "divergence: the reference draws none when false)"),
        Prop("field", -1, type="int", minimum=-1, maximum=1, mutable="playing",
             doc="caption field to render from S334-1A/cc_data "
                 "(-1 = automatic = field 1)"),
        Prop("timeout", (1 << 64) - 1, type="uint64",
             minimum=16_000_000_000, mutable="playing",
             doc="erase the overlay when no cc data arrived for this long"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        vid_caps = video_caps_template(tuple(f for f in RGB_FORMATS if RGB_FORMATS[f][1] == np.uint8))
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK, PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, vid_caps))
        )
        cc_caps = Caps.builder("closedcaption/x-cea-608", format="raw")
        self.ccpad = self.add_pad(
            Pad("cc_sink", PadDirection.SINK, PadTemplate("cc_sink", PadDirection.SINK, PadPresence.ALWAYS, cc_caps))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC, PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, vid_caps))
        )
        self.sinkpad.chain_function = self._video_chain
        self.sinkpad.event_function = self._video_event
        self.ccpad.chain_function = self._cc_chain
        self.ccpad.event_function = lambda pad, ev: True  # cc stream is auxiliary
        self._dec = cea608.Cea608Decoder()
        self._lines: List[str] = []
        self._atlas: Optional[np.ndarray] = None
        self._atlas_on: Dict[torch.device, torch.Tensor] = {}
        self._mask_cache: Dict[tuple, tuple] = {}

    def on_ready_to_paused(self) -> None:
        if self._atlas is None:
            self._atlas = _build_atlas()
        self._dec = cea608.Cea608Decoder()
        self._lines = []
        self._mask_cache.clear()

    # -- caption stream ---------------------------------------------------------
    def _cc_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        for hi, lo in host_array(buf.data, np.uint8).reshape(-1, 2):
            self._dec.push_pair(int(hi), int(lo))
        for ev in self._dec.take_events():
            self._lines = [] if ev is None else ev.lines
        if buf.pts is not None:
            self._last_cc_pts = buf.pts
        return FlowReturn.OK

    # -- video stream ------------------------------------------------------------
    def _render_mask(self, lines: tuple, h: int, w: int, dev: torch.device):
        """Build (mask, box) [h, w] float32 alpha tensors on `dev` for the
        caption lines; cached per (lines, h, w) since captions persist
        across many frames.  Each line's tiles are one gather from the
        atlas on `dev`: only the line's character indices are uploaded."""
        key = (lines, h, w)
        if key in self._mask_cache:
            return self._mask_cache[key]
        atlas = self._atlas_on.get(dev)
        if atlas is None:
            atlas = self._atlas_on[dev] = torch.from_numpy(self._atlas).to(dev)
        scale = self.get_property("scale")
        gw, gh = GLYPH_W * scale, GLYPH_H * scale
        mask = torch.zeros((h, w), dtype=torch.float32, device=dev)
        box = torch.zeros((h, w), dtype=torch.float32, device=dev)
        n = len(lines)
        for li, line in enumerate(lines):
            line = line[: w // gw]
            y0 = h - (n - li + 1) * gh
            x0 = (w - len(line) * gw) // 2
            if y0 < 0 or not line:
                continue
            box[y0 : y0 + gh, max(x0 - gw // 2, 0) : x0 + len(line) * gw + gw // 2] = 1.0
            idx = [ord(ch) - 0x20 for ch in line]
            idx = torch.tensor([i if 0 <= i < len(_ATLAS_CHARS) else 0 for i in idx],
                               device=dev)
            tiles = atlas[idx].repeat_interleave(scale, 1).repeat_interleave(scale, 2)
            mask[y0 : y0 + gh, x0 : x0 + len(line) * gw] = \
                tiles.permute(1, 0, 2).reshape(gh, len(line) * gw)
        out = (mask, box)
        self._mask_cache[key] = out
        return out

    # -- caption meta on the video stream (reference model: the reference's
    # cea608overlay has ONE sink pad and reads VideoCaptionMeta,
    # cea608overlay/imp.rs:264-285; the cc_sink pad above is this
    # framework's auxiliary wiring convenience)
    def _extract_meta_pairs(self, buf: Buffer):
        from ...core import VideoCaptionMeta

        for meta in buf.metas:
            if not isinstance(meta, VideoCaptionMeta):
                continue
            d = meta.data
            field = self.get_property("field")
            want_f1 = field in (-1, 0)  # automatic renders field 1
            if meta.caption_type == "cea608-raw":
                for i in range(0, len(d) - 1, 2):
                    yield d[i], d[i + 1]
            elif meta.caption_type == "cea608-s334-1a":
                # SMPTE 334-1 Annex A triplets: bit 7 set = field 1
                for i in range(0, len(d) - 2, 3):
                    if bool(d[i] & 0x80) == want_f1:
                        yield d[i + 1], d[i + 2]
            elif meta.caption_type == "cea708-raw":
                # cc_data triplets: cc_type 0 = field 1, 1 = field 2
                want_type = 0 if want_f1 else 1
                for i in range(0, len(d) - 2, 3):
                    if d[i] & 0x04 and (d[i] & 0x03) == want_type:
                        yield d[i + 1], d[i + 2]
            elif meta.caption_type == "cea708-cdp":
                for hi, lo in _cdp_extract_608_field1(d):
                    yield hi, lo

    def _video_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        fed = False
        for hi, lo in self._extract_meta_pairs(buf):
            self._dec.push_pair(int(hi), int(lo))
            fed = True
        if fed:
            for ev in self._dec.take_events():
                self._lines = [] if ev is None else ev.lines
            self._last_cc_pts = buf.pts
        else:
            timeout = self.get_property("timeout")
            if (self._lines and timeout != (1 << 64) - 1
                    and buf.pts is not None
                    and getattr(self, "_last_cc_pts", None) is not None
                    and buf.pts - self._last_cc_pts > timeout):
                self._lines = []
        if self._lines:
            frame = torch.as_tensor(buf.data, device=device())
            h, w = frame.shape[0], frame.shape[1]
            mask, box = self._render_mask(tuple(self._lines), h, w, frame.device)
            strength = 1.0 if self.get_property("black-background") else 0.7
            out = Buffer(_composite(frame, mask, box, strength))
            out.copy_metadata_from(buf)
            return self.srcpad.push(out)
        return self.srcpad.push(buf)

    def _video_event(self, pad: Pad, event: Event) -> bool:
        return self.srcpad.push_event(event)


__all__ = ["Cea608Overlay"]
