"""RTP pay/depay for video codecs and MPEG-4 generic: VP8 (RFC 7741),
VP9 (draft-ietf-payload-vp9), AV1 (AOM RTP spec), JPEG (RFC 2435),
AAC / MPEG-4 generic (RFC 3640).

Parity targets: net/rtp/src/{vp8,vp9,av1,jpeg,mp4a,mp4g}.  Encoded frames
are opaque to the payloaders (the codecs live outside the framework, as
with the reference); the RTP framing — payload descriptors, aggregation
headers, fragmentation and marker semantics — follows each spec.  The
JPEG pair is complete enough that a PIL-encoded image survives
pay -> depay -> PIL decode (quant tables travel in-band per RFC 2435 §4.2
with Q=255; the depayloader rebuilds the JFIF headers with the standard
Huffman tables of ITU-T T.81 Annex K.3, written out below, so the port
needs no image library at run time).

Frames are host bytes: a payloader reads a payload on the device back once
(core/payload.py), and depayloaders emit host numpy arrays.  The random
PictureID start comes from a generator of this module's own, not from the
process-wide `random` state.
"""
from __future__ import annotations

import random
import struct
from typing import Dict, List, Optional

import numpy as np

from ...core import Buffer, BufferFlags, Caps, Prop, register
from ...core.caps import Structure
from ...core.payload import host_bytes
from ...net.rtp import RtpPacket
from .rtppay import (
    AGGREGATE_PROPS,
    RtpAggregateMixin,
    RtpBaseDepay,
    RtpBasePay,
)


def _bytes_of(buf: Buffer) -> bytes:
    d = buf.data
    return d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)


class _FragmentingPay(RtpBasePay):
    """Shared fragment-per-frame scaffolding; subclasses provide headers."""

    def frag_header(self, first: bool, last: bool, frame: bytes) -> bytes:
        raise NotImplementedError

    def handle_buffer(self, buf: Buffer) -> None:
        frame = _bytes_of(buf)
        maxp = self.max_payload_size() - 4  # room for descriptors
        pos = 0
        first = True
        while pos < len(frame) or first:
            chunk = frame[pos : pos + maxp]
            pos += len(chunk)
            last = pos >= len(frame)
            self.queue_packet(
                self.frag_header(first, last, frame) + chunk,
                pts=buf.pts, duration=buf.duration, marker=last,
            )
            first = False


KEYFRAME_RECOVERY_PROPS = [
    Prop("request-keyframe", False, type="bool",
         doc="send an upstream force-key-unit event when packet loss "
             "corrupts a frame"),
    Prop("wait-for-keyframe", False, type="bool",
         doc="after loss, drop frames until the next keyframe instead of "
             "forwarding potentially corrupt inter frames"),
]


class _ReassemblingDepay(RtpBaseDepay):
    """Shared marker-based reassembly; subclasses strip descriptors."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._frags: List[bytes] = []
        self._waiting_keyframe = False

    def strip(self, payload: bytes, first: bool) -> bytes:
        raise NotImplementedError

    def frame_is_keyframe(self, frame: bytes) -> Optional[bool]:
        """None = unknown (recovery gating passes the frame through)."""
        return None

    def _request_keyframe(self) -> None:
        from ...core import Event, EventType

        self.sinkpad.push_event(Event(
            EventType.CUSTOM_UPSTREAM, name="GstForceKeyUnit",
            **{"all-headers": True}))

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if out.has_flag(BufferFlags.DISCONT):
            self._frags.clear()
            if self._props.get("request-keyframe"):
                self._request_keyframe()
            if self._props.get("wait-for-keyframe"):
                self._waiting_keyframe = True
        self._frags.append(self.strip(pkt.payload, first=not self._frags))
        if not pkt.marker:
            return None
        frame = b"".join(self._frags)
        self._frags.clear()
        if self._waiting_keyframe:
            if self.frame_is_keyframe(frame) is False:
                return None  # dropped: waiting for a clean keyframe
            self._waiting_keyframe = False
        out.data = np.frombuffer(frame, np.uint8)
        return out


# ---------------------------------------------------------------------------
# VP8 — RFC 7741: descriptor X|R|N|S|R|PID, S=1 on frame start
# ---------------------------------------------------------------------------
VP8_CAPS = Caps.builder("video/x-vp8")


_PICTURE_ID_PROPS = [
    Prop("picture-id-mode", "none", type="enum",
         choices=["none", "7-bit", "15-bit"],
         doc="whether/how a PictureID travels in the payload descriptor"),
    Prop("picture-id-offset", -1, type="int", minimum=-1, maximum=0x7FFF,
         doc="initial PictureID (-1 = random)"),
    Prop("picture-id", 0, type="int",
         doc="(read) current PictureID"),
]


# the random PictureID start (picture-id-offset=-1), seeded from the OS
_PICTURE_ID_RNG = random.Random()


class _PictureIdMixin:
    """PictureID state shared by the VP8/VP9 payloaders."""

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        off = self.get_property("picture-id-offset")
        mode = self.get_property("picture-id-mode")
        mask = 0x7F if mode == "7-bit" else 0x7FFF
        self._picture_id = (_PICTURE_ID_RNG.getrandbits(15) if off < 0 else off) & mask
        self._props["picture-id"] = self._picture_id

    def _picture_id_bytes(self) -> bytes:
        mode = self.get_property("picture-id-mode")
        if mode == "none":
            return b""
        if mode == "7-bit":
            return bytes([self._picture_id & 0x7F])
        return bytes([0x80 | (self._picture_id >> 8), self._picture_id & 0xFF])

    def _advance_picture_id(self) -> None:
        mode = self.get_property("picture-id-mode")
        if mode == "none":
            return
        mask = 0x7F if mode == "7-bit" else 0x7FFF
        self._picture_id = (self._picture_id + 1) & mask
        self._props["picture-id"] = self._picture_id


@register
class RtpVp8Pay(_PictureIdMixin, _FragmentingPay):
    ELEMENT_NAME = "rtpvp8pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload VP8 into RTP packets (RFC 7741)"
    SINK_CAPS = VP8_CAPS
    PROPERTIES = _FragmentingPay.PROPERTIES + _PICTURE_ID_PROPS + [
        Prop("fragmentation-mode", "none", type="enum",
             choices=["none", "partition-start", "every-partition"],
             doc="none packs as much as fits per packet; partition modes "
                 "are accepted for parity (this payloader does not parse "
                 "VP8 partition boundaries)"),
    ]

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure("application/x-rtp", media="video",
                         **{"encoding-name": "VP8", "clock-rate": 90000})

    def frag_header(self, first: bool, last: bool, frame: bytes) -> bytes:
        pid = self._picture_id_bytes()
        if last:
            self._advance_picture_id()
        if not pid:
            return bytes([0x10 if first else 0x00])  # S bit, PID=0
        # X + I: extended control bits carrying the PictureID (RFC 7741 §4.2)
        return bytes([(0x10 if first else 0x00) | 0x80, 0x80]) + pid


@register
class RtpVp8Depay(_ReassemblingDepay):
    ELEMENT_NAME = "rtpvp8depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload VP8 from RTP packets (RFC 7741)"
    SRC_CAPS = VP8_CAPS
    PROPERTIES = _ReassemblingDepay.PROPERTIES + KEYFRAME_RECOVERY_PROPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/x-vp8")

    def frame_is_keyframe(self, frame: bytes) -> Optional[bool]:
        # VP8 uncompressed header: frame_type is bit 0 of the first byte
        # (0 = key frame)
        return (frame[0] & 0x01) == 0 if frame else None

    def strip(self, payload: bytes, first: bool) -> bytes:
        pos = 1
        b0 = payload[0]
        if b0 & 0x80:  # X: extended control bits
            x = payload[pos]
            pos += 1
            if x & 0x80:  # I: picture id (may be 15-bit)
                pos += 2 if payload[pos] & 0x80 else 1
            if x & 0x40:  # L: TL0PICIDX
                pos += 1
            if x & 0x30:  # T/K
                pos += 1
        return payload[pos:]


# ---------------------------------------------------------------------------
# VP9 — draft-ietf-payload-vp9: descriptor I|P|L|F|B|E|V|Z
# ---------------------------------------------------------------------------
VP9_CAPS = Caps.builder("video/x-vp9")


@register
class RtpVp9Pay(_PictureIdMixin, _FragmentingPay):
    ELEMENT_NAME = "rtpvp9pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload VP9 into RTP packets"
    SINK_CAPS = VP9_CAPS
    PROPERTIES = _FragmentingPay.PROPERTIES + _PICTURE_ID_PROPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure("application/x-rtp", media="video",
                         **{"encoding-name": "VP9", "clock-rate": 90000})

    def frag_header(self, first: bool, last: bool, frame: bytes) -> bytes:
        be = (0x08 if first else 0) | (0x04 if last else 0)  # B|E
        pid = self._picture_id_bytes()
        if last:
            self._advance_picture_id()
        if not pid:
            return bytes([be])
        return bytes([be | 0x80]) + pid  # I bit + PictureID


@register
class RtpVp9Depay(_ReassemblingDepay):
    ELEMENT_NAME = "rtpvp9depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload VP9 from RTP packets"
    SRC_CAPS = VP9_CAPS
    PROPERTIES = _ReassemblingDepay.PROPERTIES + KEYFRAME_RECOVERY_PROPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/x-vp9")

    def strip(self, payload: bytes, first: bool) -> bytes:
        b0 = payload[0]
        pos = 1
        if b0 & 0x80:  # I: picture id
            pos += 2 if payload[pos] & 0x80 else 1
        if b0 & 0x20 and b0 & 0x10:  # L+F: layer indices
            pos += 1
        if first:
            # descriptor P bit: inter-picture predicted (0 = keyframe)
            self._first_desc_p = bool(b0 & 0x40)
        return payload[pos:]

    def frame_is_keyframe(self, frame: bytes) -> Optional[bool]:
        p = getattr(self, "_first_desc_p", None)
        return (not p) if p is not None else None


# ---------------------------------------------------------------------------
# AV1 — AOM RTP spec: aggregation header Z|Y|W|N
# ---------------------------------------------------------------------------
AV1_CAPS = Caps.builder("video/x-av1")


@register
class RtpAv1Pay(RtpBasePay):
    ELEMENT_NAME = "rtpav1pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload AV1 into RTP packets (AOM AV1 RTP spec)"
    SINK_CAPS = AV1_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._first_frame = True

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._first_frame = True

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure("application/x-rtp", media="video",
                         **{"encoding-name": "AV1", "clock-rate": 90000})

    def handle_buffer(self, buf: Buffer) -> None:
        frame = _bytes_of(buf)  # one temporal unit's OBUs
        maxp = self.max_payload_size() - 1
        chunks = [frame[i : i + maxp] for i in range(0, len(frame), maxp)] or [b""]
        for i, chunk in enumerate(chunks):
            z = i > 0  # continues an element from the previous packet
            y = i < len(chunks) - 1  # element continues in next packet
            n = self._first_frame and i == 0  # new coded video sequence
            hdr = (0x80 if z else 0) | (0x40 if y else 0) | 0x10  # W=1
            hdr |= 0x08 if n else 0
            self.queue_packet(bytes([hdr]) + chunk, pts=buf.pts,
                              duration=buf.duration, marker=i == len(chunks) - 1)
        self._first_frame = False


@register
class RtpAv1Depay(_ReassemblingDepay):
    ELEMENT_NAME = "rtpav1depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload AV1 from RTP packets"
    SRC_CAPS = AV1_CAPS
    PROPERTIES = _ReassemblingDepay.PROPERTIES + KEYFRAME_RECOVERY_PROPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/x-av1")

    def strip(self, payload: bytes, first: bool) -> bytes:
        if first:
            # N bit: start of a new coded video sequence (keyframe boundary)
            self._first_n = bool(payload[0] & 0x08)
        return payload[1:]  # aggregation header

    def frame_is_keyframe(self, frame: bytes) -> Optional[bool]:
        n = getattr(self, "_first_n", None)
        return n if n is not None else None


# ---------------------------------------------------------------------------
# JPEG — RFC 2435 with in-band quantization tables (Q=255)
# ---------------------------------------------------------------------------
JPEG_CAPS = Caps.builder("image/jpeg")


def _parse_jfif(data: bytes):
    """-> (type, width, height, dri, [qtables], scan_data)."""
    pos = 2  # SOI
    qtables: Dict[int, bytes] = {}
    width = height = 0
    jtype = 1
    dri = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError("bad JPEG marker stream")
        marker = data[pos + 1]
        if marker == 0xD8:
            pos += 2
            continue
        seglen = struct.unpack_from(">H", data, pos + 2)[0]
        body = data[pos + 4 : pos + 2 + seglen]
        if marker == 0xDB:  # DQT (may hold several tables)
            bpos = 0
            while bpos < len(body):
                tid = body[bpos] & 0x0F
                qtables[tid] = body[bpos + 1 : bpos + 65]
                bpos += 65
        elif marker == 0xC0:  # SOF0 baseline
            height, width = struct.unpack_from(">HH", body, 1)
            # body: prec, H, W, ncomp, then (id, sampling, qtab) per component
            h1 = body[7] >> 4
            v1 = body[7] & 0x0F
            if (h1, v1) == (2, 1):
                jtype = 0  # 4:2:2
            elif (h1, v1) == (2, 2):
                jtype = 1  # 4:2:0
            else:
                raise ValueError(f"RFC 2435 supports 4:2:2/4:2:0 only, got {h1}x{v1}")
        elif marker == 0xC4:
            pass  # DHT: standard tables assumed (RFC 2435 §4.1)
        elif marker == 0xDD:
            dri = struct.unpack_from(">H", body, 0)[0]
        elif marker == 0xDA:  # SOS: entropy data follows until EOI
            scan = data[pos + 2 + seglen : ]
            if scan.endswith(b"\xff\xd9"):
                scan = scan[:-2]
            tables = [qtables[k] for k in sorted(qtables)]
            return jtype + (64 if dri else 0), width, height, dri, tables, scan
        pos += 2 + seglen
    raise ValueError("no SOS marker")


# ITU-T T.81 Annex K.3 (Tables K.3-K.6): (table class << 4 | id, the code
# counts of lengths 1..16, the symbol values in code order)
_ANNEX_K_TABLES = (
    (0x00, (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), range(12)),
    (0x10, (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
        "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
        "5455565758595a636465666768696a737475767778797a838485868788898a9293"
        "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
        "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    (0x01, (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), range(12)),
    (0x11, (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f015"
        "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
        "535455565758595a636465666768696a737475767778797a82838485868788898a92"
        "939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
        "c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
)


def _standard_dht() -> bytes:
    """The four DHT segments of the Annex K tables (luminance DC and AC,
    chrominance DC and AC), as a baseline encoder without optimised tables
    writes them."""
    out = bytearray()
    for tc_th, counts, values in _ANNEX_K_TABLES:
        body = bytes([tc_th, *counts]) + bytes(values)
        out += b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body
    return bytes(out)


def _rebuild_jfif(jtype: int, width: int, height: int, dri: int,
                  qtables: List[bytes], scan: bytes) -> bytes:
    out = bytearray(b"\xff\xd8")
    for tid, table in enumerate(qtables):
        out += b"\xff\xdb" + struct.pack(">H", 2 + 1 + 64) + bytes([tid]) + table
    if dri:
        out += b"\xff\xdd" + struct.pack(">HH", 4, dri)
    sampling = 0x21 if (jtype & 0x3F) == 0 else 0x22
    ncomp = 3
    sof = bytes([8]) + struct.pack(">HH", height, width) + bytes([ncomp])
    sof += bytes([1, sampling, 0])
    sof += bytes([2, 0x11, min(1, len(qtables) - 1)])
    sof += bytes([3, 0x11, min(1, len(qtables) - 1)])
    out += b"\xff\xc0" + struct.pack(">H", 2 + len(sof)) + sof
    out += _standard_dht()
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out += b"\xff\xda" + struct.pack(">H", 2 + len(sos)) + sos
    out += scan + b"\xff\xd9"
    return bytes(out)


@register
class RtpJpegPay(RtpBasePay):
    ELEMENT_NAME = "rtpjpegpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload JPEG into RTP packets (RFC 2435)"
    DEFAULT_PT = 26  # static JPEG assignment
    SINK_CAPS = JPEG_CAPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure("application/x-rtp", media="video",
                         **{"encoding-name": "JPEG", "clock-rate": 90000})

    def handle_buffer(self, buf: Buffer) -> None:
        jtype, width, height, dri, qtables, scan = _parse_jfif(_bytes_of(buf))
        q = 255  # in-band quant tables
        main = lambda off: struct.pack(">BBBB", 0, (off >> 16) & 0xFF, (off >> 8) & 0xFF, off & 0xFF) + bytes(
            [jtype, q, width // 8, height // 8]
        )
        qhdr = struct.pack(">BBH", 0, 0, 64 * len(qtables)) + b"".join(qtables)
        rst = struct.pack(">HH", dri, 0xFFFF) if jtype & 0x40 else b""
        pos = 0
        first = True
        while pos < len(scan) or first:
            extra = (len(qhdr) if first else 0) + len(rst) + 8
            maxp = self.max_payload_size() - extra
            chunk = scan[pos : pos + maxp]
            payload = main(pos) + rst + (qhdr if first else b"") + chunk
            pos += len(chunk)
            self.queue_packet(payload, pts=buf.pts, duration=buf.duration,
                              marker=pos >= len(scan))
            first = False


@register
class RtpJpegDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpjpegdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload JPEG from RTP packets (RFC 2435)"
    SRC_CAPS = JPEG_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._scan: List[bytes] = []
        self._hdr = None

    def media_structure(self, s: Structure) -> Structure:
        return Structure("image/jpeg")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        p = pkt.payload
        off = (p[1] << 16) | (p[2] << 8) | p[3]
        jtype, q, w8, h8 = p[4], p[5], p[6], p[7]
        pos = 8
        dri = 0
        if jtype & 0x40:
            dri = struct.unpack_from(">H", p, pos)[0]
            pos += 4
        if out.has_flag(BufferFlags.DISCONT):
            self._scan.clear()
            self._hdr = None
        if off == 0:
            qtables = []
            if q >= 128:
                _mbz, _prec, qlen = struct.unpack_from(">BBH", p, pos)
                pos += 4
                for i in range(qlen // 64):
                    qtables.append(p[pos : pos + 64])
                    pos += 64
            self._hdr = (jtype, w8 * 8, h8 * 8, dri, qtables)
            self._scan = []
        self._scan.append(p[pos:])
        if not pkt.marker or self._hdr is None:
            return None
        jtype, width, height, dri, qtables = self._hdr
        out.data = np.frombuffer(
            _rebuild_jfif(jtype, width, height, dri, qtables, b"".join(self._scan)),
            np.uint8,
        )
        self._scan = []
        return out


# ---------------------------------------------------------------------------
# MPEG-4 generic / AAC — RFC 3640 (AAC-hbr AU headers)
# ---------------------------------------------------------------------------
AAC_CAPS = Caps([Structure("audio/mpeg", mpegversion=4,
                           **{"stream-format": "raw"})])
MP4V_CAPS = Caps([Structure("video/mpeg", mpegversion=4, systemstream=False)])


class _Mp4GenericPay(RtpAggregateMixin, RtpBasePay):
    MEDIA = "audio"
    PROPERTIES = RtpBasePay.PROPERTIES + AGGREGATE_PROPS

    def rtp_structure(self, s: Structure) -> Structure:
        fields = {"encoding-name": "MPEG4-GENERIC",
                  "clock-rate": s.get("rate", 90000),
                  "mode": "AAC-hbr" if self.MEDIA == "audio" else "generic",
                  "sizelength": "13", "indexlength": "3", "indexdeltalength": "3"}
        return Structure("application/x-rtp", media=self.MEDIA, **fields)

    def handle_buffer(self, buf: Buffer) -> None:
        au = _bytes_of(buf)
        maxp = self.max_payload_size() - 4
        if len(au) <= maxp:
            self.aggregate_frame(au, buf.pts, buf.duration,
                                 per_frame_overhead=2, base_overhead=2)
            return
        self._agg_flush()
        # fragmentation: one AU split over packets, AU header repeated
        hdr = struct.pack(">HH", 16, (len(au) << 3) & 0xFFF8)
        pos = 0
        while pos < len(au) or pos == 0:
            chunk = au[pos : pos + maxp]
            pos += len(chunk)
            self.queue_packet(hdr + chunk, pts=buf.pts, duration=buf.duration,
                              marker=pos >= len(au))
            if not chunk:
                break

    def flush_frames(self, frames) -> None:
        # RFC 3640 §3.2.1: N AUs per packet, one 16-bit AU header each
        hdrs = b"".join(struct.pack(">H", (len(f) << 3) & 0xFFF8)
                        for f, _, _ in frames)
        payload = struct.pack(">H", 16 * len(frames)) + hdrs + \
            b"".join(f for f, _, _ in frames)
        dur = sum(d or 0 for _, _, d in frames) or None
        self.queue_packet(payload, pts=frames[0][1], duration=dur, marker=True)


class _Mp4GenericDepay(_ReassemblingDepay):
    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        # multi-AU packets (aggregated, RFC 3640 §3.2.1) split here into
        # per-AU buffers: extras push directly, the last returns normally
        payload = pkt.payload
        (hdr_bits,) = struct.unpack_from(">H", payload, 0)
        n_aus = hdr_bits // 16
        if pkt.marker and n_aus > 1 and not self._frags:
            data_pos = 2 + (hdr_bits + 7) // 8
            sizes = [struct.unpack_from(">H", payload, 2 + 2 * i)[0] >> 3
                     for i in range(n_aus)]
            for size in sizes[:-1]:
                b = Buffer(np.frombuffer(payload[data_pos:data_pos + size],
                                         np.uint8), pts=out.pts)
                data_pos += size
                self.srcpad.push(b)
            out.data = np.frombuffer(payload[data_pos:data_pos + sizes[-1]],
                                     np.uint8)
            return out
        return super().depay(pkt, out)

    def strip(self, payload: bytes, first: bool) -> bytes:
        (hdr_bits,) = struct.unpack_from(">H", payload, 0)
        return payload[2 + (hdr_bits + 7) // 8 :]


@register
class RtpMp4aPay(_Mp4GenericPay):
    ELEMENT_NAME = "rtpmp4apay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload AAC into RTP packets (RFC 3640 AAC-hbr)"
    SINK_CAPS = AAC_CAPS
    MEDIA = "audio"


@register
class RtpMp4aDepay(_Mp4GenericDepay):
    ELEMENT_NAME = "rtpmp4adepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload AAC from RTP packets (RFC 3640)"
    SRC_CAPS = AAC_CAPS

    def media_structure(self, s: Structure) -> Structure:
        return Structure("audio/mpeg", mpegversion=4,
                         **{"stream-format": "raw",
                            "rate": s.get("clock-rate", 48000)})


@register
class RtpMp4gPay(_Mp4GenericPay):
    ELEMENT_NAME = "rtpmp4gpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload MPEG-4 elementary streams (RFC 3640 generic)"
    # generic mode carries mpeg4 video AND AAC audio (rtpmp4gpay2 caps)
    SINK_CAPS = Caps(MP4V_CAPS.structures + AAC_CAPS.structures)
    MEDIA = "video"

    def rtp_structure(self, s: Structure) -> Structure:
        media = "audio" if s.name == "audio/mpeg" else "video"
        mode = "AAC-hbr" if media == "audio" else "generic"
        fields = {"encoding-name": "MPEG4-GENERIC",
                  "clock-rate": s.get("rate", 90000),
                  "mode": mode,
                  "sizelength": "13", "indexlength": "3",
                  "indexdeltalength": "3"}
        return Structure("application/x-rtp", media=media, **fields)


@register
class RtpMp4gDepay(_Mp4GenericDepay):
    ELEMENT_NAME = "rtpmp4gdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload MPEG-4 elementary streams (RFC 3640)"
    SRC_CAPS = Caps(MP4V_CAPS.structures + AAC_CAPS.structures)

    def media_structure(self, s: Structure) -> Structure:
        return Structure("video/mpeg", mpegversion=4, systemstream=False)


__all__ = [
    "RtpVp8Pay", "RtpVp8Depay", "RtpVp9Pay", "RtpVp9Depay",
    "RtpAv1Pay", "RtpAv1Depay", "RtpJpegPay", "RtpJpegDepay",
    "RtpMp4aPay", "RtpMp4aDepay", "RtpMp4gPay", "RtpMp4gDepay",
]
