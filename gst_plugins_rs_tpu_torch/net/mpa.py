"""MPEG audio (MP3) frame header parsing.

Support code for rtpmparobustdepay2 (RFC 5219); mirrors the reference's
mparobust/mpeg_audio_utils.rs peek_frame_header: sync word, version/layer,
bitrate/samplerate tables, frame length and samples-per-frame.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_BITRATES = {  # kbps, index 1..14 (0 = free, 15 = invalid)
    (1, 1): [0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416, 448],
    (1, 2): [0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384],
    (1, 3): [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320],
    (2, 1): [0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256],
    (2, 2): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
    (2, 3): [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],
}
_RATES = {1: [44100, 48000, 32000], 2: [22050, 24000, 16000], 3: [11025, 12000, 8000]}


@dataclass
class FrameHeader:
    version: int  # 1, 2, or 3 (= MPEG 2.5)
    layer: int
    bitrate_kbps: int
    sample_rate: int
    channels: int
    frame_len: int
    samples_per_frame: int


def peek_frame_header(data: bytes) -> Optional[FrameHeader]:
    if len(data) < 4 or data[0] != 0xFF or (data[1] >> 5) != 0b111:
        return None
    version_bits = (data[1] >> 3) & 0b11
    version = {0b00: 3, 0b10: 2, 0b11: 1}.get(version_bits)
    layer = {0b01: 3, 0b10: 2, 0b11: 1}.get((data[1] >> 1) & 0b11)
    if version is None or layer is None:
        return None
    bitrate_idx = data[2] >> 4
    rate_idx = (data[2] >> 2) & 0b11
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None
    table_version = 1 if version == 1 else 2
    bitrate = _BITRATES[(table_version, layer)][bitrate_idx]
    rate = _RATES[version][rate_idx]
    padding = (data[2] >> 1) & 1
    channels = 1 if (data[3] >> 6) == 0b11 else 2
    if layer == 1:
        frame_len = (12 * bitrate * 1000 // rate + padding) * 4
        samples = 384
    elif layer == 2 or version == 1:
        frame_len = 144 * bitrate * 1000 // rate + padding
        samples = 1152
    else:  # MPEG-2/2.5 layer 3
        frame_len = 72 * bitrate * 1000 // rate + padding
        samples = 576
    return FrameHeader(version, layer, bitrate, rate, channels, frame_len, samples)


def build_frame_header(
    *, version: int = 1, layer: int = 3, bitrate_idx: int = 9,
    rate_idx: int = 1, channels: int = 2,
) -> bytes:
    """4-byte MP3 frame header for tests."""
    b1 = 0xE0 | ({1: 0b11, 2: 0b10, 3: 0b00}[version] << 3) | ({3: 0b01, 2: 0b10, 1: 0b11}[layer] << 1) | 1
    b2 = (bitrate_idx << 4) | (rate_idx << 2)
    b3 = (0b11 if channels == 1 else 0b00) << 6
    return bytes([0xFF, b1, b2, b3])


__all__ = ["FrameHeader", "peek_frame_header", "build_frame_header"]
