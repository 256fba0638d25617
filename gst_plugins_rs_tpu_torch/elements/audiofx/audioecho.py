"""rsaudioecho: echo/reverb effect element.

The port of gst_plugins_rs_tpu/elements/audiofx/audioecho.py (parity
target: audio/audiofx/src/audioecho/imp.rs).  Properties max-delay and
delay (ns), intensity, feedback; caps F32/F64 interleaved, any rate and
channels; AlwaysInPlace; the delay clamps to max-delay when a buffer is
processed, and delay, intensity and feedback may change while PLAYING.  The
delay-line history lives on the selected device (ops/echo.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    AudioFilter,
    AudioInfo,
    Buffer,
    Prop,
    SECOND,
    TransformMode,
    audio_caps_template,
    register,
)
from ...ops.echo import echo_apply_flat, echo_lag_samples, echo_ring_size

_U64_MAX_MINUS_1 = 2**64 - 2


@register
class AudioEcho(AudioFilter):
    ELEMENT_NAME = "rsaudioecho"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Adds an echo or reverb effect to an audio stream"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False

    SINK_CAPS = audio_caps_template(formats=("F32", "F64"))
    SRC_CAPS = audio_caps_template(formats=("F32", "F64"))

    PROPERTIES = [
        Prop("max-delay", SECOND, type="uint64", maximum=_U64_MAX_MINUS_1, mutable="ready",
             doc="Maximum delay of the echo in nanoseconds"),
        Prop("delay", 500 * SECOND, type="uint64", maximum=_U64_MAX_MINUS_1, mutable="playing",
             doc="Delay of the echo in nanoseconds"),
        Prop("intensity", 0.5, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("feedback", 0.0, minimum=0.0, maximum=1.0, mutable="playing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._hist = None

    def setup(self, info: AudioInfo) -> None:
        size = echo_ring_size(self.get_property("max-delay"), info.rate, info.channels)
        if size == 0:
            size = info.channels  # a max-delay under one sample
        dtype = torch.float64 if info.format == "F64" else torch.float32
        self._hist = torch.zeros(size, dtype=dtype, device=device())

    def stop(self) -> None:
        self._hist = None

    def transform_ip(self, buf: Buffer) -> Buffer:
        info = self.audio_info
        assert info is not None and self._hist is not None
        S = self._hist.shape[0]
        lag = echo_lag_samples(self.get_property("delay"), self.get_property("max-delay"),
                               info.rate, info.channels)
        # the reference's ring: delay 0 reads the slot written S samples ago
        lag = S if lag == 0 else min(lag, S)
        data = torch.as_tensor(buf.data).to(self._hist.device, self._hist.dtype)
        frames, ch = data.shape
        # intensity and feedback rounded to the stream's dtype, as the JAX
        # element's jnp.asarray(value, dtype)
        rnd = np.float64 if self._hist.dtype == torch.float64 else np.float32
        intensity = float(rnd(self.get_property("intensity")))
        feedback = float(rnd(self.get_property("feedback")))
        out, self._hist = echo_apply_flat(data.reshape(frames * ch), self._hist, intensity,
                                          feedback, lag=lag)
        buf.data = out.reshape(frames, ch)
        return buf


__all__ = ["AudioEcho"]
