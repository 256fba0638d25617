"""audiornnoise: the RNNoise denoiser element.

The port of gst_plugins_rs_tpu/elements/audiofx/audiornnoise.py (parity
target: audio/audiofx/src/audiornnoise/imp.rs): BaseTransform NeverInPlace
with generate_output() and an adapter of 480-sample frames; caps F32
interleaved at 48 kHz only; per-channel denoiser state; x32767 in, /32767
out; the VAD is the maximum over channels, and a frame whose VAD is below
`voice-activity-threshold` is zeroed; a VAD >= 0.98 sets has_voice; an
AudioLevelMeta (RMS -> dB byte + has_voice) rides on each output buffer;
drains on DISCONT and EOS; latency += 480/48000 s.

The `model` property loads trained weights from an .npz (ops/rnnoise.py);
without it the packaged weights are used (the JAX element's default).  Each
output buffer holds every whole frame the adapter has, and runs through
`denoise_frames_fast` once: on the card that is one launch of kernel R1
(ops/rnnoise_gru.py) per buffer.  The state and the weights live on the
selected device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    Adapter,
    AudioFilter,
    AudioInfo,
    Buffer,
    BufferFlags,
    Meta,
    Prop,
    SECOND,
    TransformMode,
    audio_caps_template,
    register,
)
from ...ops.rnnoise import (
    FRAME_SIZE,
    default_weights,
    denoise_frames_fast,
    denoise_init,
    load_weights,
    weights_to,
)


class AudioLevelMeta(Meta):
    """Audio level meta (gst_audio::AudioLevelMeta analog): level is the
    negative RMS dB as a byte, 0 = loudest."""

    api = "audio-level"

    def __init__(self, level: int, voice_activity: bool):
        self.level = level
        self.voice_activity = voice_activity

    def __repr__(self):
        return f"AudioLevelMeta(level={self.level}, voice={self.voice_activity})"


@register
class AudioRNNoise(AudioFilter):
    ELEMENT_NAME = "audiornnoise"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Removes noise from an audio stream"
    MODE = TransformMode.NEVER_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False

    SINK_CAPS = audio_caps_template(formats=("F32",), rate=48000)
    SRC_CAPS = audio_caps_template(formats=("F32",), rate=48000)

    PROPERTIES = [
        Prop("voice-activity-threshold", 0.0, minimum=0.0, maximum=1.0, mutable="playing",
             doc="Frames with voice activity below are zeroed"),
        Prop("model", None, type="str", mutable="ready", doc=".npz weight file (optional)"),
        Prop("seed", 0, type="uint64", mutable="ready", doc="random-init seed when no model set"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._adapter = Adapter()
        self._dstate = None
        self._weights = None

    def setup(self, info: AudioInfo) -> None:
        dev = device()
        self._dstate = denoise_init(info.channels, dev)
        path = self.get_property("model")
        self._weights = weights_to(load_weights(path) if path else default_weights(), dev)
        self._adapter.clear()

    def stop(self) -> None:
        self._dstate = None
        self._weights = None
        self._adapter.clear()

    def latency_additional_ns(self) -> int:
        return FRAME_SIZE * SECOND // 48000

    # ------------------------------------------------------------------
    def _process(self, data):
        """data: [n*FRAME, ch] -> (out [n*FRAME, ch], level, has_voice)."""
        dev = self._dstate.hp_mem.device
        x = torch.as_tensor(data).to(dev, torch.float32)
        n = x.shape[0] // FRAME_SIZE
        ch = x.shape[1]
        frames = (x * 32767.0).reshape(n, FRAME_SIZE, ch).permute(0, 2, 1)  # [n, C, FRAME]
        self._dstate, outs, vads = denoise_frames_fast(self._dstate, self._weights, frames)
        vad = vads.amax(1)  # [n], the maximum over channels
        out = outs.permute(0, 2, 1) / 32767.0  # [n, FRAME, ch]
        keep = vad >= self.get_property("voice-activity-threshold")
        out = torch.where(keep[:, None, None], out, torch.zeros((), device=dev))
        out = out.reshape(n * FRAME_SIZE, ch)
        # the meta's two host values in one read-back
        has_voice, rms = (torch.stack([(vad >= 0.98).any().to(torch.float32),
                                       (out * out).sum()]).tolist())
        level = int(np.clip(-20.0 * np.log10(rms + np.finfo(np.float32).eps), 0.0, 255.0))
        return out, level, bool(has_voice)

    def submit_input_buffer(self, buf: Buffer) -> None:
        if buf.has_flag(BufferFlags.DISCONT):
            residue = self.drain()
            if residue is not None:
                self.srcpad.push(residue)
        self._adapter.push(buf)

    def generate_output(self) -> Optional[Buffer]:
        info = self.audio_info
        if info is None or self._adapter.available() < FRAME_SIZE:
            return None
        pts, dist = self._adapter.prev_pts()
        n = (self._adapter.available() // FRAME_SIZE) * FRAME_SIZE
        out, level, has_voice = self._process(self._adapter.take(n))
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        buf = Buffer(out, pts=out_pts, duration=n * SECOND // info.rate)
        buf.add_meta(AudioLevelMeta(level, has_voice))
        return buf

    def drain(self) -> Optional[Buffer]:
        info = self.audio_info
        avail = self._adapter.available()
        if info is None or avail == 0:
            return None
        pts, dist = self._adapter.prev_pts()
        taken = torch.as_tensor(self._adapter.take(avail)).to(self._dstate.hp_mem.device,
                                                                torch.float32)
        data = torch.cat([taken, taken.new_zeros((FRAME_SIZE - avail, info.channels))])
        out, level, has_voice = self._process(data)
        out = out[:avail]
        out_pts = None if pts is None else pts + dist * SECOND // info.rate
        buf = Buffer(out, pts=out_pts, duration=avail * SECOND // info.rate)
        buf.add_meta(AudioLevelMeta(level, has_voice))
        return buf


__all__ = ["AudioLevelMeta", "AudioRNNoise"]
