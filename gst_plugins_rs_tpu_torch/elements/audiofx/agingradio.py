"""agingradio: old-radio distortion element.

The port of gst_plugins_rs_tpu/elements/audiofx/agingradio.py (parity
target: audio/audiofx/src/agingradio/imp.rs).  Caps F32/F64 interleaved;
per-chunk clicks, white noise, per-channel lowpass, quantization, cubic
distortion (ops/agingradio.py).  Deterministic through the `seed` property,
as the JAX element: the click decisions and the noise come from a
`torch.Generator` seeded with it on the element's device.  They are not the
JAX element's numbers (`jax.random` cannot be reproduced in torch); the
tests hand both ops the same draws, and check this element's draws by their
statistics.  F64 runs in float64.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..._device import device
from ...core import (
    AudioFilter,
    AudioInfo,
    Buffer,
    Prop,
    TransformMode,
    audio_caps_template,
    register,
)
from ...ops.agingradio import agingradio_process, lowpass_alpha


@register
class AgingRadio(AudioFilter):
    ELEMENT_NAME = "agingradio"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Adds age to an audio stream using various kinds of distortion"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    SINK_CAPS = audio_caps_template(formats=("F32", "F64"))
    SRC_CAPS = audio_caps_template(formats=("F32", "F64"))

    PROPERTIES = [
        Prop("white-noise-ampl", 0.011, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("clicks-prob", 1.0 / 100000.0, minimum=0.0, maximum=1.0, mutable="playing"),
        Prop("lowpass-freq", 2000, type="uint", mutable="ready",
             doc="Lowpass cutoff in Hz; 0 disables the filter"),
        Prop("bits-to-quantize", 4.0, minimum=0.0, maximum=32.0, mutable="playing"),
        Prop("cubic-curve-distortion", 1.0, minimum=0.0, maximum=10.0, mutable="playing"),
        Prop("cubic-curve-passes", 3, type="uint", maximum=64, mutable="ready"),
        Prop("seed", 0, type="uint64", mutable="ready", doc="PRNG seed (deterministic)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._filt_state = None
        self._gen: Optional[torch.Generator] = None
        self._alpha = 0.0

    def setup(self, info: AudioInfo) -> None:
        dev = device()
        dtype = torch.float64 if info.format == "F64" else torch.float32
        self._filt_state = torch.zeros(info.channels, dtype=dtype, device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.get_property("seed"))
        freq = self.get_property("lowpass-freq")
        self._alpha = lowpass_alpha(info.rate, freq) if freq > 0 else 0.0

    def stop(self) -> None:
        self._filt_state = None
        self._gen = None

    def _draws(self, frames: int, channels: int):
        """The next buffer's click decisions [ceil(frames/2)] (one per 2-frame
        chunk, uniform < clicks-prob) and noise [frames, channels] (uniform in
        [-1, 1)), from the element's generator."""
        state = self._filt_state
        u = torch.rand((frames + 1) // 2, generator=self._gen, dtype=state.dtype,
                       device=state.device)
        noise = torch.empty((frames, channels), dtype=state.dtype, device=state.device)
        noise.uniform_(-1.0, 1.0, generator=self._gen)
        return u < self.get_property("clicks-prob"), noise

    def transform_ip(self, buf: Buffer) -> Buffer:
        assert self._filt_state is not None
        state = self._filt_state
        x = torch.as_tensor(buf.data).to(state.device, state.dtype)
        clicks, noise = self._draws(x.shape[0], x.shape[1])
        out, self._filt_state = agingradio_process(
            x, clicks, noise, state,
            self.get_property("white-noise-ampl"),
            self._alpha,
            self.get_property("bits-to-quantize"),
            self.get_property("cubic-curve-distortion"),
            passes=self.get_property("cubic-curve-passes"),
            use_lowpass=self.get_property("lowpass-freq") > 0,
        )
        buf.data = out
        return buf


__all__ = ["AgingRadio"]
