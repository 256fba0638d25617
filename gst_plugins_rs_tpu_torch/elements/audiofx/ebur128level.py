"""ebur128level: loudness analyser element posting `ebur128-level` messages.

The port of gst_plugins_rs_tpu/elements/audiofx/ebur128level.py (parity
target: audio/audiofx/src/ebur128level/imp.rs): passthrough AlwaysInPlace,
mode flags M/S/I/LRA/sample-peak/true-peak (default all), `interval`
(default 1 s), buffers split at interval boundaries, one element message a
completed interval with timestamp, running-time, stream-time and the
requested metrics, and the `reset` action.  The analyser (ops/ebur128.py)
keeps its state on the selected device; each message reads every metric
back in one copy.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core import (
    AudioFilter,
    AudioInfo,
    Buffer,
    Message,
    MessageType,
    Prop,
    SECOND,
    Structure,
    TransformMode,
    audio_caps_template,
    register,
)
from ...core.audio import AudioLayout
from ...ops.ebur128 import (
    MODE_I,
    MODE_LRA,
    MODE_M,
    MODE_S,
    MODE_SAMPLE_PEAK,
    MODE_TRUE_PEAK,
    EbuR128,
)

MODE_ALL = MODE_M | MODE_S | MODE_I | MODE_LRA | MODE_SAMPLE_PEAK | MODE_TRUE_PEAK


@register
class EbuR128Level(AudioFilter):
    ELEMENT_NAME = "ebur128level"
    ELEMENT_CLASS = "Filter/Analyzer/Audio"
    SIGNALS = {"reset": "reset"}
    ELEMENT_DESCRIPTION = "Measures loudness according to EBU R-128"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = True
    TRANSFORM_IP_ON_PASSTHROUGH = True

    SINK_CAPS = audio_caps_template(
        formats=("S16", "S32", "F32", "F64"), layouts=("interleaved", "non-interleaved"))
    SRC_CAPS = audio_caps_template(
        formats=("S16", "S32", "F32", "F64"), layouts=("interleaved", "non-interleaved"))

    PROPERTIES = [
        Prop("mode", MODE_ALL, type="uint", mutable="playing",
             doc="Flags: 1=momentary 2=shortterm 4=global 8=loudness-range 16=sample-peak "
                 "32=true-peak"),
        Prop("post-messages", True, type="bool", mutable="playing"),
        Prop("interval", SECOND, type="uint64", mutable="ready",
             doc="Interval in ns for posting messages"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._r128: Optional[EbuR128] = None
        self._interval_frames = 0
        self._interval_remaining = 0
        self._reset_pending = False

    def reset(self) -> None:
        """The `reset` action signal."""
        self._reset_pending = True

    def setup(self, info: AudioInfo) -> None:
        self._r128 = EbuR128(info.channels, info.rate, info.positions)
        self._interval_frames = self.get_property("interval") * info.rate // SECOND
        if self._interval_frames == 0:
            raise RuntimeError(f"{self.name}: interval too small for rate {info.rate}")
        self._interval_remaining = self._interval_frames

    def stop(self) -> None:
        self._r128 = None

    def _to_float(self, data):
        data = torch.as_tensor(data)
        fmt = self.audio_info.format
        if fmt == "S16":
            return data.to(torch.float64) / 32768.0
        if fmt == "S32":
            return data.to(torch.float64) / 2147483648.0
        return data

    def transform_ip(self, buf: Buffer) -> Buffer:
        info = self.audio_info
        r128 = self._r128
        assert info is not None and r128 is not None
        data = self._to_float(buf.data)
        if info.layout == AudioLayout.NON_INTERLEAVED:
            data = data.t()  # planar [ch, frames] -> [frames, ch]
        pos = 0
        n = data.shape[0]
        timestamp = buf.pts
        while pos < n:
            if self._reset_pending:
                self._reset_pending = False
                r128.reset()
                self._interval_remaining = self._interval_frames
            to_process = min(self._interval_remaining, n - pos)
            r128.add_frames(data[pos:pos + to_process])
            pos += to_process
            self._interval_remaining -= to_process
            if timestamp is not None:
                # the message's timestamp is the end of the measured audio
                timestamp = buf.pts + pos * SECOND // info.rate
            if self._interval_remaining == 0:
                self._interval_remaining = self._interval_frames
                if self.get_property("post-messages"):
                    self._post_level_message(timestamp)
        return buf

    def _post_level_message(self, timestamp: Optional[int]) -> None:
        info = self.audio_info
        r128 = self._r128
        mode = self.get_property("mode")
        seg = self.segment
        s = Structure(
            "ebur128-level",
            timestamp=timestamp,
            **{
                "running-time": seg.to_running_time(timestamp)
                if seg and timestamp is not None else None,
                "stream-time": seg.to_stream_time(timestamp)
                if seg and timestamp is not None else None,
            },
        )
        if mode & MODE_M:
            s["momentary-loudness"] = r128.loudness_momentary()
        if mode & MODE_S:
            s["shortterm-loudness"] = r128.loudness_shortterm()
        if mode & MODE_I:
            s["global-loudness"] = r128.loudness_global()
            s["relative-threshold"] = r128.relative_threshold()
        if mode & MODE_LRA:
            s["loudness-range"] = r128.loudness_range()
        if mode & MODE_SAMPLE_PEAK:
            s["sample-peak"] = tuple(r128.sample_peak(c) for c in range(info.channels))
        if mode & MODE_TRUE_PEAK:
            s["true-peak"] = tuple(r128.true_peak(c) for c in range(info.channels))
        self.post_message(Message(MessageType.ELEMENT, structure=s))


__all__ = ["EbuR128Level", "MODE_ALL"]
