"""claxondec: FLAC audio decoder element.

Parity target: audio/claxon (claxondec/imp.rs:26) whose decoding is done by
the claxon crate; here the codec is owned in-repo (codecs/flac.py,
SURVEY.md §2.4).  The element accumulates the byte stream, parses
STREAMINFO for caps, and emits decoded frames as they complete; 16-bit
streams map to S16 payloads, everything else to S32 (claxondec outputs
S16/S32 the same way).

Frames decode through the native decoder when it loads
(`flac.native_available()`), through the Python reference otherwise.  Each
output buffer is put on the device `gst_plugins_rs_tpu_torch.set_device`
selects, once (the JAX element emits host arrays).  The byte accumulator
drops the frames it has decoded, so a long stream is not copied again at
every input buffer.
"""
from __future__ import annotations

from typing import Optional

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
from ..._device import device
from ...codecs import flac
from ...core.payload import host_bytes

FLAC_CAPS = Caps.builder("audio/x-flac")


@register
class ClaxonDec(BaseTransform):
    ELEMENT_NAME = "claxondec"
    ELEMENT_CLASS = "Codec/Decoder/Audio"
    ELEMENT_DESCRIPTION = "FLAC audio decoder"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = FLAC_CAPS
    SRC_CAPS = audio_caps_template(formats=("S16", "S32"))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()
        self._info: Optional[flac.StreamInfo] = None
        self._pos = 0
        self._sample_pos = 0
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()
        self._info = None
        self._pos = 0
        self._sample_pos = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else FLAC_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _handle_caps(self, incaps: Caps) -> bool:
        # real src caps come from STREAMINFO; fixating the template here
        # would push meaningless rate/channel values downstream
        self.in_caps = incaps
        return True

    def _try_streaminfo(self) -> bool:
        if self._info is not None:
            return True
        try:
            self._info, self._pos = flac.parse_header(bytes(self._acc))
        except (ValueError, IndexError):
            return False
        from ...core.events import Event

        fmt = "S16" if self._info.bps <= 16 else "S32"
        caps = Caps.builder(
            "audio/x-raw", format=fmt, rate=self._info.rate,
            channels=self._info.channels, layout="interleaved",
        )
        self.out_caps = caps
        self.srcpad.current_caps = caps
        self.srcpad.push_event(Event.new_caps(caps))
        return True

    def _decode_ready(self, final: bool) -> Optional[Buffer]:
        if not self._try_streaminfo():
            return None
        data = bytes(self._acc)
        frames = []
        while self._pos < len(data):
            try:
                native = flac.decode_frame_native(data, self._pos, self._info)
                if native is not None:
                    frame, nxt = native  # C++ hot path (native/flacdec.cpp)
                else:
                    frame, nxt = flac.decode_frame(data, self._pos, self._info)
            except (ValueError, IndexError):
                if final:
                    raise
                break  # need more bytes
            frames.append(frame)
            self._pos = nxt
        del self._acc[:self._pos]  # the decoded frames' bytes
        self._pos = 0
        if not frames:
            return None
        pcm = np.concatenate(frames, axis=0)
        if self._info.total_samples:
            remaining = self._info.total_samples - self._sample_pos
            pcm = pcm[:remaining]
        dtype = np.int16 if self._info.bps <= 16 else np.int32
        buf = Buffer(
            torch.from_numpy(pcm.astype(dtype)).to(self._device),
            pts=self._sample_pos * SECOND // self._info.rate,
            duration=pcm.shape[0] * SECOND // self._info.rate,
        )
        self._sample_pos += pcm.shape[0]
        return buf

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        d = inbuf.data
        self._acc += d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
        return self._decode_ready(final=False)

    def drain(self) -> Optional[Buffer]:
        return self._decode_ready(final=True)


__all__ = ["ClaxonDec"]
