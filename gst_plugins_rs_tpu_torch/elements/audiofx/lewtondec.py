"""lewtondec: Vorbis audio decoder element.

Parity target: audio/lewton (lewtondec/imp.rs:73-100: sink audio/x-vorbis,
src F32 interleaved up to 255 channels; header packets — identification,
comment, setup — arrive in-stream before audio packets, imp.rs:122+).  The
reference decodes with the pure-Rust lewton crate; here the system
libvorbis decoder is reached via libavcodec (codecs/avlib.py).

Caps are deferred until the identification header is seen (rate/channels
live there, Vorbis I spec §4.2.2); the three header packets are packed into
xiph-laced extradata for the decoder.

Where the libavcodec shim is missing (`avlib.available()` is False, as on a
machine without libavcodec), the third header packet raises
RuntimeError("libavcodec shim unavailable"), as in the JAX package.  Each
decoded buffer is put on the device `gst_plugins_rs_tpu_torch.set_device`
selects, once (the JAX element emits host arrays).
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    SECOND,
    TransformMode,
    audio_caps_template,
    register,
)
from ...core.events import Event
from ..._device import device
from ...codecs import avlib
from ...core.payload import host_bytes

VORBIS_CAPS = Caps.builder("audio/x-vorbis")
F32_CAPS = audio_caps_template(formats=("F32",))


@register
class LewtonDec(BaseTransform):
    ELEMENT_NAME = "lewtondec"
    ELEMENT_CLASS = "Codec/Decoder/Audio"
    ELEMENT_DESCRIPTION = "Vorbis audio decoder"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = VORBIS_CAPS
    SRC_CAPS = F32_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._headers: List[bytes] = []
        self._dec: Optional[avlib.AudioDecoder] = None
        self._rate = 0
        self._channels = 0
        self._sample_pos = 0
        self._pending: List[Buffer] = []
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._headers = []
        self._dec = None
        self._rate = 0
        self._channels = 0
        self._sample_pos = 0
        self._pending = []

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (F32_CAPS if direction == PadDirection.SINK else VORBIS_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _handle_caps(self, incaps: Caps) -> bool:
        # real rate/channels come from the identification header packet
        self.in_caps = incaps
        s = incaps.structure(0)
        codec_data = s.get("codec_data")
        if codec_data is not None:
            if isinstance(codec_data, np.ndarray):
                codec_data = codec_data.tobytes()
            for pkt in avlib.parse_xiph_extradata(codec_data):
                self._take_header(pkt)
        return True

    def _take_header(self, pkt: bytes) -> None:
        self._headers.append(pkt)
        if pkt[:7] == b"\x01vorbis":
            # Vorbis I §4.2.2: [channels u8][rate u32le] at offset 11/12
            self._channels = pkt[11]
            self._rate = struct.unpack_from("<I", pkt, 12)[0]
        if len(self._headers) == 3:
            self._dec = avlib.AudioDecoder(
                "vorbis", avlib.build_xiph_extradata(self._headers))
            caps = Caps.builder("audio/x-raw", format="F32", rate=self._rate,
                                channels=self._channels, layout="interleaved")
            self.out_caps = caps
            self.srcpad.current_caps = caps
            self.srcpad.push_event(Event.new_caps(caps))

    def _enqueue(self, decoded) -> None:
        for samples, rate, _pts in decoded:
            buf = Buffer(torch.from_numpy(samples).to(self._device),
                         pts=self._sample_pos * SECOND // rate,
                         duration=samples.shape[0] * SECOND // rate)
            self._sample_pos += samples.shape[0]
            self._pending.append(buf)

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            d = inbuf.data
            pkt = d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
            if self._dec is None:
                first = pkt[:1]
                if first in (b"\x01", b"\x03", b"\x05"):
                    self._take_header(pkt)
                else:
                    raise ValueError(
                        f"{self.name}: audio packet before 3 vorbis headers")
            else:
                self._enqueue(self._dec.decode(pkt))
        return self._pending.pop(0) if self._pending else None

    def drain(self) -> Optional[Buffer]:
        if self._dec is not None:
            self._enqueue(self._dec.decode(None))
        while len(self._pending) > 1:
            self.srcpad.push(self._pending.pop(0))
        return self._pending.pop(0) if self._pending else None


__all__ = ["LewtonDec"]
