"""Remaining rsrtp payloaders/depayloaders: L20/L24 linear audio,
raw video (RFC 4175), SMPTE ST 291 ancillary data (RFC 8331), and the
unsuffixed av1 factory names.

Parity targets: net/rtp/src/linear_audio (rtpL24pay2/depay2, rtpL20pay/
depay), raw_video (rtpvrawpay2/depay2), smpte291 (rtpsmpte291pay/depay
— payload header layout per imp.rs:250-299: ext-seq u16 + length u16 +
ANC_Count u8 + F(2)+reserved(22); each ANC packet C(1) line(11)
hoffset(12) S(1) StreamNum(7) DID(10) SDID(10) DC(10) UDW*10 CS(10)
padded to 32 bits), av1 (both rtpav1pay and rtpav1pay2 names are
registered by the reference plugin).

Packets are host bytes.  rtpvrawpay2 reads a frame on the device back once
(core/payload.py); rtpvrawdepay2 assembles a frame on the host and puts it
on the selected device once, at the marker, so a frame costs one copy each
way and never one a packet.  L24 packs and unpacks its samples with numpy
(the same bytes as a per-sample loop).
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np
import torch

from ..._device import device
from ...core import Buffer, Caps, Prop, register
from ...core.caps import IntRange, Structure, ValueList
from ...core.payload import host_array, host_bytes
from ...net.rtp import RtpPacket
from ...ops import st2038
from .rtppay import RtpBaseAudioPay, RtpBaseDepay, RtpBasePay
from .rtpvideo import RtpAv1Pay, RtpAv1Depay


# ---------------------------------------------------------------------------
# L24 / L20 linear audio (RFC 3551 / RFC 3190)


@register
class RtpL24Pay(RtpBaseAudioPay):
    ELEMENT_NAME = "rtpL24pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload 24-bit raw audio (L24) into RTP packets (RFC 3551)"
    # reference: linear_audio/pay/imp.rs:506-545 (S24BE); host representation
    # is int32 [frames, ch] holding 24-bit significance
    SINK_CAPS = Caps([Structure("audio/x-raw", format="S24",
                                rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                                layout="interleaved")])

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "L24", "clock-rate": s["rate"],
               "channels": s["channels"], "encoding-params": str(s["channels"])},
        )

    def bpf(self) -> int:
        return 3 * self.in_caps.structure(0)["channels"]

    def payload_bytes(self, buf: Buffer) -> bytes:
        flat = (host_array(buf.data, np.int64).reshape(-1) & 0xFFFFFF).astype(">u4")
        return flat.view(np.uint8).reshape(-1, 4)[:, 1:].tobytes()


@register
class RtpL24Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpL24depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload 24-bit raw audio (L24) from RTP packets"
    SRC_CAPS = Caps([Structure("audio/x-raw", format="S24",
                               rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                               layout="interleaved")])

    def media_structure(self, s: Structure) -> Structure:
        ch = int(s.get("encoding-params", s.get("channels", 1)))
        return Structure("audio/x-raw", format="S24", rate=s["clock-rate"],
                         channels=ch, layout="interleaved")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        ch = self.out_caps.structure(0)["channels"]
        raw = pkt.payload
        b = np.frombuffer(raw, np.uint8, len(raw) // 3 * 3).reshape(-1, 3).astype(np.int32)
        vals = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        vals -= (vals & 0x800000) << 1
        return Buffer(vals.reshape(-1, ch)) if out is None else self._fill(out, vals, ch)

    @staticmethod
    def _fill(out: Buffer, vals: np.ndarray, ch: int) -> Buffer:
        out.data = vals.reshape(-1, ch)
        return out


def _pack20(samples: np.ndarray) -> bytes:
    """Pack 20-bit samples bit-contiguously, big-endian (RFC 3190 §4)."""
    bits = 0
    nbits = 0
    out = bytearray()
    for v in samples:
        bits = (bits << 20) | (int(v) & 0xFFFFF)
        nbits += 20
        while nbits >= 8:
            nbits -= 8
            out.append((bits >> nbits) & 0xFF)
    if nbits:
        out.append((bits << (8 - nbits)) & 0xFF)
    return bytes(out)


def _unpack20(data: bytes) -> np.ndarray:
    bits = 0
    nbits = 0
    vals: List[int] = []
    for b in data:
        bits = (bits << 8) | b
        nbits += 8
        if nbits >= 20:
            nbits -= 20
            v = (bits >> nbits) & 0xFFFFF
            vals.append(v - (1 << 20) if v & 0x80000 else v)
    return np.asarray(vals, np.int32)


@register
class RtpL20Pay(RtpBaseAudioPay):
    ELEMENT_NAME = "rtpL20pay"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload 20-bit raw audio (L20) into RTP packets (RFC 3551)"
    SINK_CAPS = Caps([Structure("audio/x-raw", format="S20",
                                rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                                layout="interleaved")])

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "L20", "clock-rate": s["rate"],
               "channels": s["channels"], "encoding-params": str(s["channels"])},
        )

    def bpf(self) -> int:
        # 20 bits * channels per frame; frames stay byte-aligned only per 2
        ch = self.in_caps.structure(0)["channels"]
        return (20 * ch + 7) // 8

    def payload_bytes(self, buf: Buffer) -> bytes:
        return _pack20(host_array(buf.data, np.int64).reshape(-1))


@register
class RtpL20Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpL20depay"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload 20-bit raw audio (L20) from RTP packets"
    SRC_CAPS = Caps([Structure("audio/x-raw", format="S20",
                               rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                               layout="interleaved")])

    def media_structure(self, s: Structure) -> Structure:
        ch = int(s.get("encoding-params", s.get("channels", 1)))
        return Structure("audio/x-raw", format="S20", rate=s["clock-rate"],
                         channels=ch, layout="interleaved")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        ch = self.out_caps.structure(0)["channels"]
        vals = _unpack20(pkt.payload)
        vals = vals[: (len(vals) // ch) * ch]
        out.data = vals.reshape(-1, ch)
        return out


# ---------------------------------------------------------------------------
# av1 unsuffixed factory names (the reference registers both)


@register
class RtpAv1PayAlias(RtpAv1Pay):
    ELEMENT_NAME = "rtpav1pay"
    ELEMENT_DESCRIPTION = "Payload AV1 into RTP packets (unsuffixed name)"


@register
class RtpAv1DepayAlias(RtpAv1Depay):
    ELEMENT_NAME = "rtpav1depay"
    ELEMENT_DESCRIPTION = "Depayload AV1 from RTP packets (unsuffixed name)"


# ---------------------------------------------------------------------------
# raw video (RFC 4175)

_VRAW_PGROUP = {"RGB": (3, 1), "BGR": (3, 1), "RGBA": (4, 1), "BGRA": (4, 1),
                "UYVY": (4, 2)}
_VRAW_SAMPLING = {"RGB": "RGB", "BGR": "BGR", "RGBA": "RGBA", "BGRA": "BGRA",
                  "UYVY": "YCbCr-4:2:2"}
_SAMPLING_TO_FORMAT = {v: k for k, v in _VRAW_SAMPLING.items()}
# The payloader's template as its pad negotiates with: SINK_CAPS lists the
# formats as a plain list, as the JAX element's does, and a plain list
# intersects no caps, so an upstream element that asks its peer's caps
# (hsvfilter, colorlut) could not negotiate with it
_VRAW_SINK_CAPS = Caps([Structure("video/x-raw", format=ValueList(list(_VRAW_PGROUP)))])


@register
class RtpVRawPay(RtpBasePay):
    """RFC 4175 raw-video payloader (reference net/rtp/src/raw_video/pay).

    Payload = extended seq (u16) + segment headers (Length u16,
    F|LineNo u16, C|Offset u16)... + pixel data; lines split across
    packets at MTU, C bit chains multiple segments per packet."""

    ELEMENT_NAME = "rtpvrawpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload raw video into RTP packets (RFC 4175)"
    SINK_CAPS = Caps([Structure("video/x-raw", format=list(_VRAW_PGROUP))])

    def __init__(self, name: Optional[str] = None):
        self.SINK_CAPS = _VRAW_SINK_CAPS
        super().__init__(name)
        self._ext_seq = 0

    def rtp_structure(self, s: Structure) -> Structure:
        fmt = s["format"]
        return Structure(
            "application/x-rtp", media="video",
            **{"encoding-name": "RAW", "clock-rate": 90000,
               "sampling": _VRAW_SAMPLING[fmt], "depth": "8",
               "width": str(s["width"]), "height": str(s["height"])},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        s = self.in_caps.structure(0)
        fmt = s["format"]
        pgroup, pixels_per_group = _VRAW_PGROUP[fmt]
        frame = host_array(buf.data, np.uint8)
        height, width = frame.shape[0], frame.shape[1]
        line_bytes = width * pgroup // pixels_per_group
        raw = frame.reshape(height, line_bytes)
        maxp = self.max_payload_size() - 2  # minus extended seq

        segments: List[tuple] = []  # (line, offset_pixels, nbytes)
        for line in range(height):
            off = 0
            while off < line_bytes:
                n = min(line_bytes - off, maxp - 6)  # at least one header
                segments.append((line, off, n))
                off += n

        i = 0
        while i < len(segments):
            # greedily pack segments into one packet
            batch = [segments[i]]
            used = 2 + 6 + batch[0][2]
            i += 1
            while i < len(segments) and used + 6 + segments[i][2] <= self.max_payload_size():
                batch.append(segments[i])
                used += 6 + segments[i][2]
                i += 1
            payload = bytearray(struct.pack("!H", self._ext_seq >> 16 & 0xFFFF))
            for j, (line, off, n) in enumerate(batch):
                cont = 0x8000 if j + 1 < len(batch) else 0
                off_px = off * pixels_per_group // pgroup
                payload += struct.pack("!HHH", n, line & 0x7FFF, cont | (off_px & 0x7FFF))
            for line, off, n in batch:
                payload += raw[line, off:off + n].tobytes()
            last = i >= len(segments)
            self.queue_packet(bytes(payload), pts=buf.pts, duration=buf.duration,
                              marker=last)
            self._ext_seq += 1


@register
class RtpVRawDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpvrawdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload raw video from RTP packets (RFC 4175)"
    SRC_CAPS = Caps([Structure("video/x-raw", format=list(_VRAW_PGROUP))])
    PROPERTIES = [
        Prop("concealment-method", "last-frame", type="enum",
             choices=["black", "last-frame"],
             doc="how pixels lost to packet loss are filled: black zeros "
                 "them, last-frame repeats the previous frame's content"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frame: Optional[np.ndarray] = None
        self._last: Optional[np.ndarray] = None
        self._pts: Optional[int] = None

    def media_structure(self, s: Structure) -> Structure:
        fmt = _SAMPLING_TO_FORMAT.get(s.get("sampling", "RGB"), "RGB")
        return Structure("video/x-raw", format=fmt,
                         width=int(s["width"]), height=int(s["height"]))

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        s = self.out_caps.structure(0)
        fmt = s["format"]
        pgroup, pixels_per_group = _VRAW_PGROUP[fmt]
        width, height = s["width"], s["height"]
        line_bytes = width * pgroup // pixels_per_group
        if self._frame is None:
            if (self.get_property("concealment-method") == "last-frame"
                    and self._last is not None
                    and self._last.shape == (height, line_bytes)):
                self._frame = self._last.copy()
            else:
                self._frame = np.zeros((height, line_bytes), np.uint8)
            self._pts = out.pts
        data = pkt.payload
        pos = 2  # skip extended seq
        headers = []
        while True:
            n, line, off = struct.unpack("!HHH", data[pos:pos + 6])
            pos += 6
            headers.append((n, line & 0x7FFF, off & 0x7FFF))
            if not off & 0x8000:
                break
        for n, line, off_px in headers:
            off = off_px * pgroup // pixels_per_group
            if line < height and off + n <= line_bytes:
                self._frame[line, off:off + n] = np.frombuffer(data[pos:pos + n], np.uint8)
            pos += n
        if pkt.marker:
            frame = self._frame
            self._last = frame
            self._frame = None
            if pixels_per_group == 1:
                frame = frame.reshape(height, width, pgroup)
            out.data = torch.from_numpy(frame).to(device())
            return out
        return None


# ---------------------------------------------------------------------------
# SMPTE ST 291 ancillary data (RFC 8331)

ANC_CAPS = Caps([Structure("meta/x-st-2038")])


class _BitWriter:
    def __init__(self) -> None:
        self.bits: List[int] = []

    def write(self, value: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def align32(self) -> None:
        while len(self.bits) % 32:
            self.bits.append(0)

    def bytes(self) -> bytes:
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for bit in self.bits[i:i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


def _parity10(v: int) -> int:
    p = bin(v & 0xFF).count("1") & 1
    return (v & 0xFF) | (p << 8) | ((p ^ 1) << 9)


@register
class RtpSmpte291Pay(RtpBasePay):
    ELEMENT_NAME = "rtpsmpte291pay"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload SMPTE ST 291 ancillary data into RTP (RFC 8331)"
    SINK_CAPS = ANC_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ext_seq = 0

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="video",
            **{"encoding-name": "SMPTE291", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        data = host_bytes(buf.data, np.uint8)
        packets = st2038.unpack_all(data)
        w = _BitWriter()
        w.write(self._ext_seq >> 16 & 0xFFFF, 16)
        w.write(0, 16)  # Length: patched below
        w.write(len(packets), 8)  # ANC_Count
        w.write(0, 2)   # F
        w.write(0, 22)  # reserved
        for anc in packets:
            w.write(1 if anc.c_not_y else 0, 1)
            w.write(anc.line_number, 11)
            w.write(anc.horizontal_offset, 12)
            w.write(0, 1)  # S
            w.write(0, 7)  # StreamNum
            w.write(_parity10(anc.did), 10)
            w.write(_parity10(anc.sdid), 10)
            w.write(_parity10(len(anc.data)), 10)
            checksum = _parity10(anc.did) + _parity10(anc.sdid) + _parity10(len(anc.data))
            for b in anc.data:
                word = _parity10(b)
                w.write(word, 10)
                checksum += word
            checksum &= 0x1FF
            w.write(checksum | ((~checksum & 0x100) << 1), 10)
            w.align32()
        payload = bytearray(w.bytes())
        length = len(payload) - 8
        payload[2:4] = struct.pack("!H", length)
        self.queue_packet(bytes(payload), pts=buf.pts, duration=buf.duration, marker=True)
        self._ext_seq += 1


@register
class RtpSmpte291Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpsmpte291depay"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload SMPTE ST 291 ancillary data from RTP (RFC 8331)"
    SRC_CAPS = ANC_CAPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("meta/x-st-2038")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        data = pkt.payload
        if len(data) < 8:
            return None
        anc_count = data[4]
        bits = []
        for b in data[8:]:
            for i in range(7, -1, -1):
                bits.append((b >> i) & 1)
        pos = 0

        def read(n: int) -> int:
            nonlocal pos
            v = 0
            for _ in range(n):
                v = (v << 1) | bits[pos]
                pos += 1
            return v

        chunks: List[bytes] = []
        for _ in range(anc_count):
            c = read(1)
            line = read(11)
            hoff = read(12)
            read(1)  # S
            read(7)  # StreamNum
            did = read(10) & 0xFF
            sdid = read(10) & 0xFF
            dc = read(10) & 0xFF
            payload = bytes(read(10) & 0xFF for _ in range(dc))
            read(10)  # checksum
            pos = (pos + 31) // 32 * 32
            chunks.append(st2038.pack(did, sdid, payload, c_not_y=bool(c),
                                      line_number=line, horizontal_offset=hoff))
        if not chunks:
            return None
        out.data = np.frombuffer(b"".join(chunks), np.uint8)
        return out
