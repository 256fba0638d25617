"""G.711 companding codec elements: alawenc / alawdec / mulawenc / mulawdec.

The reference RTP PCMA/PCMU pay/depay elements consume/produce
audio/x-alaw / audio/x-mulaw byte streams (net/rtp/src/pcmau/pay/imp.rs:37-59
caps; the companders themselves live in GStreamer core, outside the
reference repo).  Here companding runs on device (ops/g711.py, bit-exact vs
the ITU tables) so an effect chain can feed an RTP sender without leaving
the TPU until the socket.

Payload convention: audio/x-alaw and audio/x-mulaw buffers carry
[frames, channels] uint8 arrays (interleaved companded bytes).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..._device import device
from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    IntRange,
    PadDirection,
    TransformMode,
    audio_caps_template,
    register,
)
from ...core.caps import Structure
from ...ops import g711

_RAW = audio_caps_template(formats=("S16",))


def _compressed_caps(media: str) -> Caps:
    return Caps([Structure(media, rate=IntRange(1, 2_822_400), channels=IntRange(1, 64))])


class _G711Base(BaseTransform):
    MODE = TransformMode.NEVER_IN_PLACE
    MEDIA = ""  # audio/x-alaw | audio/x-mulaw
    ENCODE = True

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        to_raw = (direction == PadDirection.SRC) if self.ENCODE else (direction == PadDirection.SINK)
        out = []
        for s in caps.structures:
            fields = {k: s[k] for k in ("rate", "channels") if k in s}
            if to_raw:
                out.append(Structure("audio/x-raw", format="S16", layout="interleaved", **fields))
            else:
                out.append(Structure(self.MEDIA, **fields))
        result = Caps(out)
        if caps.is_any():
            result = (self.SRC_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            result = filter_.intersect(result)
        return result

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._device: Optional[torch.device] = None

    def start(self) -> None:
        self._device = device()

    def transform(self, inbuf: Buffer) -> Buffer:
        out = Buffer(self._kernel(torch.as_tensor(inbuf.data, device=self._device)))
        out.copy_metadata_from(inbuf)
        return out


class _AlawEncKernel:
    _enc = staticmethod(g711.alaw_encode)
    _dec = staticmethod(g711.alaw_decode)


class _MulawKernel:
    _enc = staticmethod(g711.mulaw_encode)
    _dec = staticmethod(g711.mulaw_decode)


@register
class ALawEnc(_G711Base, _AlawEncKernel):
    ELEMENT_NAME = "alawenc"
    ELEMENT_CLASS = "Codec/Encoder/Audio"
    ELEMENT_DESCRIPTION = "A-law (G.711) encoder on device"
    MEDIA = "audio/x-alaw"
    ENCODE = True
    SINK_CAPS = _RAW
    SRC_CAPS = _compressed_caps("audio/x-alaw")

    def _kernel(self, x):
        return self._enc(x)


@register
class ALawDec(_G711Base, _AlawEncKernel):
    ELEMENT_NAME = "alawdec"
    ELEMENT_CLASS = "Codec/Decoder/Audio"
    ELEMENT_DESCRIPTION = "A-law (G.711) decoder on device"
    MEDIA = "audio/x-alaw"
    ENCODE = False
    SINK_CAPS = _compressed_caps("audio/x-alaw")
    SRC_CAPS = _RAW

    def _kernel(self, x):
        return self._dec(x)


@register
class MuLawEnc(_G711Base, _MulawKernel):
    ELEMENT_NAME = "mulawenc"
    ELEMENT_CLASS = "Codec/Encoder/Audio"
    ELEMENT_DESCRIPTION = "mu-law (G.711) encoder on device"
    MEDIA = "audio/x-mulaw"
    ENCODE = True
    SINK_CAPS = _RAW
    SRC_CAPS = _compressed_caps("audio/x-mulaw")

    def _kernel(self, x):
        return self._enc(x)


@register
class MuLawDec(_G711Base, _MulawKernel):
    ELEMENT_NAME = "mulawdec"
    ELEMENT_CLASS = "Codec/Decoder/Audio"
    ELEMENT_DESCRIPTION = "mu-law (G.711) decoder on device"
    MEDIA = "audio/x-mulaw"
    ENCODE = False
    SINK_CAPS = _compressed_caps("audio/x-mulaw")
    SRC_CAPS = _RAW

    def _kernel(self, x):
        return self._dec(x)


__all__ = ["ALawEnc", "ALawDec", "MuLawEnc", "MuLawDec"]
