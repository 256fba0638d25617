"""CD+G (karaoke graphics) elements: cdgparse, cdgdec.

Parity targets: video/cdg (cdgparse splits the subcode stream into
timestamped 24-byte packets; cdgdec renders them — the reference wraps the
cdg/cdg_renderer crates; constants from video/cdg/src/constants.rs:
CDG_PACKET_SIZE=24, CDG_PACKET_PERIOD=300 packets/s, display 300x216).

Renderer implements the public CD+G spec commands: memory preset, border
preset, tile block (normal + XOR), load color table lo/hi, and scrolling.
The 300x216 indexed surface is palette-expanded to RGB per emitted frame.

The renderer is host numpy, as in the JAX package; cdgdec puts each frame
it emits on the device `gst_plugins_rs_tpu_torch.set_device` selects, once
(the JAX element emits host arrays).  Packets are host bytes: a packet
stream on the device is read back once (`core/payload.py`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    SECOND,
    TransformMode,
    register,
    video_caps_template,
)
from ...core.payload import host_bytes

CDG_PACKET_SIZE = 24
CDG_PACKET_PERIOD = 300  # packets per second (constants.rs:14)
CDG_WIDTH, CDG_HEIGHT = 300, 216  # constants.rs:16-17
CDG_MASK = 0x3F
CDG_COMMAND = 0x09

CDG_CAPS = Caps.builder("video/x-cdg")
CDG_PARSED_CAPS = Caps.builder("video/x-cdg", parsed=True)


class CdgRenderer:
    """CD+G state machine over a 300x216 4-bit indexed surface."""

    def __init__(self) -> None:
        self.surface = np.zeros((CDG_HEIGHT, CDG_WIDTH), np.uint8)
        self.palette = np.zeros((16, 3), np.uint8)
        self.dirty = False

    def push_packet(self, pkt: bytes) -> None:
        if (pkt[0] & CDG_MASK) != CDG_COMMAND:
            return
        instr = pkt[1] & CDG_MASK
        data = bytes(b & CDG_MASK for b in pkt[4:20])
        if instr == 1:  # memory preset
            if (data[1] & 0x0F) == 0:  # repeat==0 only (spec)
                self.surface[:] = data[0] & 0x0F
                self.dirty = True
        elif instr == 2:  # border preset
            color = data[0] & 0x0F
            self.surface[:12, :] = color
            self.surface[-12:, :] = color
            self.surface[:, :6] = color
            self.surface[:, -6:] = color
            self.dirty = True
        elif instr in (6, 38):  # tile block normal / XOR
            self._tile(data, xor=instr == 38)
        elif instr == 20:  # scroll preset
            self._scroll(data, copy=False)
        elif instr == 24:  # scroll copy
            self._scroll(data, copy=True)
        elif instr == 30:  # load color table 0-7
            self._load_colors(data, 0)
        elif instr == 31:  # load color table 8-15
            self._load_colors(data, 8)

    def _load_colors(self, data: bytes, base: int) -> None:
        for i in range(8):
            b0, b1 = data[2 * i], data[2 * i + 1]
            r = (b0 >> 2) & 0x0F
            g = ((b0 & 0x3) << 2) | ((b1 >> 4) & 0x3)
            b = b1 & 0x0F
            self.palette[base + i] = (r * 17, g * 17, b * 17)
        self.dirty = True

    def _tile(self, data: bytes, xor: bool) -> None:
        c0, c1 = data[0] & 0x0F, data[1] & 0x0F
        row = (data[2] & 0x1F) * 12
        col = (data[3] & 0x3F) * 6
        if row + 12 > CDG_HEIGHT or col + 6 > CDG_WIDTH:
            return
        bits = np.unpackbits(
            np.frombuffer(data[4:16], np.uint8).reshape(-1, 1), axis=1
        )[:, 2:]  # 6 LSBs per row byte
        tile = np.where(bits == 1, c1, c0).astype(np.uint8)
        region = self.surface[row : row + 12, col : col + 6]
        if xor:
            region ^= tile
        else:
            region[:] = tile
        self.dirty = True

    def _scroll(self, data: bytes, copy: bool) -> None:
        color = data[0] & 0x0F
        hcmd, vcmd = (data[1] >> 4) & 0x3, (data[2] >> 4) & 0x3
        dx = {0: 0, 1: 6, 2: -6}.get(hcmd, 0)
        dy = {0: 0, 1: 12, 2: -12}.get(vcmd, 0)
        if dx == 0 and dy == 0:
            return
        s = np.roll(self.surface, (dy, dx), axis=(0, 1))
        if not copy:
            if dy > 0:
                s[:dy, :] = color
            elif dy < 0:
                s[dy:, :] = color
            if dx > 0:
                s[:, :dx] = color
            elif dx < 0:
                s[:, dx:] = color
        self.surface = s
        self.dirty = True

    def frame_rgb(self) -> np.ndarray:
        return self.palette[self.surface]


@register
class CdgParse(BaseTransform):
    """Splits a CD+G byte stream into timestamped 24-byte packets
    (video/cdg/src/cdgparse)."""

    ELEMENT_NAME = "cdgparse"
    ELEMENT_CLASS = "Parser/Video"
    ELEMENT_DESCRIPTION = "CD+G parser"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CDG_CAPS
    SRC_CAPS = CDG_PARSED_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()
        self._count = 0

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()
        self._count = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CDG_PARSED_CAPS if direction == PadDirection.SINK else CDG_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._acc += host_bytes(inbuf.data, np.uint8)
        if len(self._acc) < CDG_PACKET_SIZE:
            return None
        pkt, self._acc = self._acc[:CDG_PACKET_SIZE], self._acc[CDG_PACKET_SIZE:]
        pts = self._count * SECOND // CDG_PACKET_PERIOD
        self._count += 1
        return Buffer(np.frombuffer(bytes(pkt), np.uint8), pts=pts,
                      duration=SECOND // CDG_PACKET_PERIOD)


@register
class CdgDec(BaseTransform):
    """Renders parsed CD+G packets to RGB frames (video/cdg/src/cdgdec).
    Emits a frame only for packets that change the surface."""

    ELEMENT_NAME = "cdgdec"
    ELEMENT_CLASS = "Codec/Decoder/Video"
    ELEMENT_DESCRIPTION = "CD+G decoder"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CDG_PARSED_CAPS
    SRC_CAPS = video_caps_template(("RGB",), width=CDG_WIDTH, height=CDG_HEIGHT)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._renderer = CdgRenderer()
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._renderer = CdgRenderer()

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else CDG_PARSED_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        pkt = host_bytes(inbuf.data, np.uint8)
        self._renderer.dirty = False
        self._renderer.push_packet(pkt)
        if not self._renderer.dirty:
            return None
        out = Buffer(torch.from_numpy(self._renderer.frame_rgb()).to(self._device))
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["CdgParse", "CdgDec", "CdgRenderer"]
