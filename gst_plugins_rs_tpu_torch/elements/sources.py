"""Test/application sources: audiotestsrc, videotestsrc, appsrc.

Deterministic synthetic signals replacing the reference test fixtures
(`audiotestsrc`/`videotestsrc` waves used throughout SURVEY.md §4).  Audio is
synthesised on the host in float64 (exact phase over unbounded streams) and
put on the device once a buffer; the video pattern is rendered with numpy and
put on the device once, at caps negotiation, so downstream element chains
stay device-resident end to end.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from ..core import (
    AudioInfo,
    BaseSrc,
    Buffer,
    Caps,
    Prop,
    SECOND,
    audio_caps_template,
    video_caps_template,
)
from ..core.registry import register
from ..core.video import RGB_FORMATS, VideoInfo
from .._device import device

_WAVES = ["sine", "square", "saw", "triangle", "silence", "white-noise", "ticks"]


@register
class AudioTestSrc(BaseSrc):
    ELEMENT_NAME = "audiotestsrc"
    ELEMENT_CLASS = "Source/Audio"
    ELEMENT_DESCRIPTION = "Creates audio test signals"
    SRC_CAPS = audio_caps_template(formats=("F32", "F64", "S16", "S32"))
    PROPERTIES = [
        Prop("wave", "sine", type="enum", choices=_WAVES),
        Prop("freq", 440.0, minimum=0.0, maximum=200000.0),
        Prop("volume", 0.8, minimum=0.0, maximum=10.0),
        Prop("samplesperbuffer", 1024, type="int", minimum=1),
        Prop("num-buffers", -1, type="int", minimum=-1),
        Prop("seed", 0, type="int", doc="PRNG seed for white-noise"),
        Prop("tick-interval", SECOND, type="uint64", doc="ns between ticks"),
        Prop("sine-periods-per-tick", 10, type="uint"),
        Prop("is-live", False, type="bool"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sample_offset = 0
        self._buffer_count = 0
        self._info: Optional[AudioInfo] = None
        self._rng: Optional[np.random.RandomState] = None
        self._device: Optional[torch.device] = None

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate({"format": "F32", "rate": 48000, "channels": 2})

    def negotiated(self, caps: Caps) -> None:
        self._info = AudioInfo.from_caps(caps)
        self._device = device()
        # a pre-roll seek (before streaming started) positions the stream:
        # derive the start offset from the active segment
        self._sample_offset = int(self.segment.start) * self._info.rate // SECOND
        self._buffer_count = 0
        self._rng = np.random.RandomState(self.get_property("seed"))

    def _synth(self, n0: int, n: int) -> torch.Tensor:
        info = self._info
        assert info is not None
        wave = self.get_property("wave")
        freq = self.get_property("freq")
        volume = self.get_property("volume")
        idx = n0 + np.arange(n, dtype=np.float64)
        t = idx / info.rate
        if wave == "silence":
            mono = np.zeros(n, np.float64)
        elif wave == "sine":
            mono = volume * np.sin(2 * math.pi * freq * t)
        elif wave == "square":
            mono = volume * np.sign(np.sin(2 * math.pi * freq * t))
        elif wave == "saw":
            mono = volume * (2.0 * np.mod(freq * t, 1.0) - 1.0)
        elif wave == "triangle":
            mono = volume * (4.0 * np.abs(np.mod(freq * t, 1.0) - 0.5) - 1.0)
        elif wave == "white-noise":
            mono = volume * self._rng.uniform(-1.0, 1.0, n)
        elif wave == "ticks":
            # a tick is `sine-periods-per-tick` sine periods at `freq`, every
            # `tick-interval` (the reference's limiter test signal,
            # audio/audiofx/tests/audioloudnorm.rs:174-257)
            interval_samps = self.get_property("tick-interval") * info.rate / SECOND
            tick_len = self.get_property("sine-periods-per-tick") * info.rate / freq
            pos = np.mod(idx, interval_samps)
            mono = np.where(pos < tick_len, volume * np.sin(2 * math.pi * freq * t), 0.0)
        else:
            raise ValueError(f"unknown wave {wave!r}")
        samples = np.repeat(mono[:, None], info.channels, axis=1)
        if info.format in ("S16", "S32"):
            scale = 32767.0 if info.format == "S16" else 2147483647.0
            samples = (np.clip(samples, -1.0, 1.0) * scale).astype(
                np.int16 if info.format == "S16" else np.int32)
        elif info.format == "F32":
            samples = samples.astype(np.float32)
        return torch.from_numpy(samples).to(self._device)

    def is_seekable(self) -> bool:
        return not self._is_live()

    def do_seek(self, segment) -> bool:
        """Repositions sample-exactly: the waves are pure functions of the
        sample offset, so the output after a seek equals a stream that
        started there."""
        rate = self._info.rate if self._info is not None else 48_000
        self._sample_offset = int(segment.start) * rate // SECOND
        self._buffer_count = 0
        return True

    def position_ns(self):
        if self._info is None:
            return None
        return self._info.frames_to_time(self._sample_offset)

    def duration_ns(self):
        nb = self.get_property("num-buffers")
        if nb < 0 or self._info is None:
            return None
        return self._info.frames_to_time(nb * self.get_property("samplesperbuffer"))

    def create(self) -> Optional[Buffer]:
        nb = self.get_property("num-buffers")
        if nb >= 0 and self._buffer_count >= nb:
            return None
        info = self._info
        assert info is not None
        n = self.get_property("samplesperbuffer")
        data = self._synth(self._sample_offset, n)
        pts = info.frames_to_time(self._sample_offset)
        end = info.frames_to_time(self._sample_offset + n)
        buf = Buffer(data, pts=pts, duration=end - pts, offset=self._sample_offset,
                     offset_end=self._sample_offset + n)
        self._sample_offset += n
        self._buffer_count += 1
        return buf

_PATTERNS = ["smpte", "solid-color", "checkers-8", "gradient", "black", "white", "red", "green", "blue"]

# SMPTE top color bars (75% intensity), left to right.
_SMPTE_BARS = np.array(
    [
        [191, 191, 191],  # grey
        [191, 191, 0],  # yellow
        [0, 191, 191],  # cyan
        [0, 191, 0],  # green
        [191, 0, 191],  # magenta
        [191, 0, 0],  # red
        [0, 0, 191],  # blue
    ],
    dtype=np.uint8,
)


@register
class VideoTestSrc(BaseSrc):
    ELEMENT_NAME = "videotestsrc"
    ELEMENT_CLASS = "Source/Video"
    ELEMENT_DESCRIPTION = "Creates video test frames"
    SRC_CAPS = video_caps_template(formats=tuple(f for f in RGB_FORMATS))
    PROPERTIES = [
        Prop("pattern", "smpte", type="enum", choices=_PATTERNS),
        Prop("foreground-color", 0xFFFFFFFF, type="uint"),
        Prop("num-buffers", -1, type="int", minimum=-1),
        Prop("is-live", False, type="bool"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frame_count = 0
        self._info: Optional[VideoInfo] = None
        self._frame = None

    def fixate(self, caps: Caps) -> Caps:
        return caps.fixate({"format": "RGB", "width": 320, "height": 240, "framerate": Fraction(30, 1)})

    def negotiated(self, caps: Caps) -> None:
        s = caps.structure(0)
        if "framerate" not in s:
            s["framerate"] = Fraction(30, 1)
        self._info = VideoInfo.from_caps(caps)
        # pre-roll seeks position the stream (see AudioTestSrc.negotiated)
        self._frame_count = int(self.segment.start) // self._info.frame_duration()
        self._frame = torch.from_numpy(self._render_pattern()).to(device())

    def _render_pattern(self) -> np.ndarray:
        info = self._info
        assert info is not None
        h, w, c = info.height, info.width, info.components
        dtype = info.dtype
        maxv = 255 if dtype == np.uint8 else 65535
        pattern = self.get_property("pattern")
        rgb = np.zeros((h, w, 3), dtype=np.float32)
        if pattern == "smpte":
            bar_w = np.linspace(0, 7, w, endpoint=False).astype(int)
            rgb = _SMPTE_BARS[bar_w].astype(np.float32)[None, :, :].repeat(h, axis=0)
        elif pattern in ("solid-color",):
            argb = self.get_property("foreground-color")
            col = np.array([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF], np.float32)
            rgb[:] = col
        elif pattern == "checkers-8":
            yy, xx = np.mgrid[0:h, 0:w]
            mask = ((yy // 8) + (xx // 8)) % 2 == 1
            rgb[mask] = 255.0
        elif pattern == "gradient":
            rgb[:] = np.linspace(0, 255, w, dtype=np.float32)[None, :, None]
        elif pattern == "black":
            pass
        elif pattern == "white":
            rgb[:] = 255.0
        elif pattern in ("red", "green", "blue"):
            rgb[:, :, _PATTERNS.index(pattern) - _PATTERNS.index("red")] = 255.0
        out = np.zeros((h, w, c), dtype=dtype)
        scaled = (rgb / 255.0 * maxv).astype(dtype)
        r_off, g_off, b_off, a_off = info.rgb_offsets
        out[:, :, r_off] = scaled[:, :, 0]
        out[:, :, g_off] = scaled[:, :, 1]
        out[:, :, b_off] = scaled[:, :, 2]
        if a_off is not None:
            out[:, :, a_off] = maxv
        return out

    def is_seekable(self) -> bool:
        return True

    def do_seek(self, segment) -> bool:
        if self._info is None:
            return True  # pre-roll seek: negotiated() derives the position
        self._frame_count = int(segment.start) // self._info.frame_duration()
        return True

    def position_ns(self):
        if self._info is None:
            return None
        return self._frame_count * self._info.frame_duration()

    def duration_ns(self):
        nb = self.get_property("num-buffers")
        if nb < 0 or self._info is None:
            return None
        return nb * self._info.frame_duration()

    def create(self) -> Optional[Buffer]:
        nb = self.get_property("num-buffers")
        if nb >= 0 and self._frame_count >= nb:
            return None
        info = self._info
        assert info is not None
        dur = info.frame_duration()
        buf = Buffer(
            self._frame,
            pts=self._frame_count * dur,
            duration=dur,
            offset=self._frame_count,
            offset_end=self._frame_count + 1,
        )
        self._frame_count += 1
        return buf


@register
class AppSrc(BaseSrc):
    """Application-driven source: feed buffers with push_buffer()."""

    ELEMENT_NAME = "appsrc"
    ELEMENT_CLASS = "Source/Generic"
    ELEMENT_DESCRIPTION = "Allow the application to feed buffers"
    PROPERTIES = [Prop("caps", None, type="object")]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        from collections import deque

        self._queue = deque()
        self._ended = False

    def fixate(self, caps: Caps) -> Caps:
        configured = self.get_property("caps")
        if configured is not None:
            return configured
        return caps.fixate()

    def negotiate(self) -> Caps:
        configured = self.get_property("caps")
        if configured is not None and configured.is_fixed():
            return configured
        return super().negotiate()

    def push_buffer(self, buf: Buffer) -> None:
        self._queue.append(buf)

    def end_of_stream(self) -> None:
        self._ended = True

    def create(self):
        if self._queue:
            return self._queue.popleft()
        if self._ended:
            return None
        return BaseSrc.RETRY


__all__ = ["AudioTestSrc", "VideoTestSrc", "AppSrc"]
