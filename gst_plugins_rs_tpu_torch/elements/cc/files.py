"""Caption file formats: sccparse / sccenc (Scenarist SCC) and
mccparse / mccenc (MacCaption MCC).

Parity targets: video/closedcaption/src/scc_parse, scc_enc, mcc_parse,
mcc_enc.  SCC lines are `HH:MM:SS:FF<TAB>9420 9420 ...` hex pairs;
MCC payload lines use the single-character run aliases expanded by the
reference parser (mcc_parse/parser.rs:130-199: G..O = 1..9 repetitions of
the `fa 00 00` padding triplet, P/Q/R = fb/fc/fd 80 80, S = 96 69,
T = 61 01, U = e1 00 00 00, Z = 00).

MCC caption lines carry an SMPTE 291 ANC data packet (DID 0x61 SDID 0x01)
whose user words are a CDP (SMPTE 334-2) with the cc_data triplets — the
framing visible in the reference parser's own test vector
(mcc_parse/parser.rs test_caption).  mccenc writes that full framing
(ANC header + CDP + 8-bit-truncated ANC checksum); mccparse unwraps it and
also accepts raw cc_data triplet lines.
"""
from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    register,
)
from ...core.payload import host_array, host_bytes
from .elements import CEA608_CAPS, pairs_to_array

SCC_CAPS = Caps.builder("application/x-scc")
MCC_CAPS = Caps.builder("application/x-mcc", version=1)

SCC_HEADER = "Scenarist_SCC V1.0"


def _tc_to_ns(tc: str, fps: Fraction, drop: Optional[bool] = None) -> int:
    if drop is None:
        drop = ";" in tc
    parts = tc.replace(";", ":").split(":")
    h, m, s, f = (int(p) for p in parts)
    fpsec = int(round(float(fps)))  # timecode counts f at the rounded rate
    frame_num = ((h * 60 + m) * 60 + s) * fpsec + f
    if drop:
        # drop-frame: 2 frames dropped per minute except every 10th
        total_min = h * 60 + m
        frame_num -= 2 * (total_min - total_min // 10)
    return frame_num * SECOND * fps.denominator // fps.numerator


def _frames_to_tc(frame_num: int, fps: Fraction) -> str:
    """Frame count -> SMPTE timecode string; drop-frame (semicolon form,
    scc_enc.rs expected vectors) when the rate is fractional."""
    fpsec = int(round(float(fps)))
    if fps.denominator == 1001:
        # re-insert the dropped frame numbers (2/min except every 10th)
        per10 = fpsec * 600 - 18  # frames in 10 minutes (17982 at 30 fps)
        per1 = fpsec * 60 - 2  # frames in a dropped minute (1798)
        d10, rem = divmod(frame_num, per10)
        extra_min = 0 if rem < fpsec * 60 else 1 + (rem - fpsec * 60) // per1
        nominal = frame_num + 2 * (d10 * 9 + extra_min)
        f = nominal % fpsec
        s = nominal // fpsec
        return f"{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d};{f:02d}"
    f = frame_num % fpsec
    s = frame_num // fpsec
    return f"{s // 3600:02d}:{s // 60 % 60:02d}:{s % 60:02d}:{f:02d}"


def _ns_to_frames(ns: int, fps: Fraction) -> int:
    # round (not floor): _tc_to_ns floors the ns, so flooring here could
    # come back one frame short
    num, den = fps.numerator, SECOND * fps.denominator
    return (ns * num + den // 2) // den


def _ns_to_tc(ns: int, fps: Fraction) -> str:
    return _frames_to_tc(_ns_to_frames(ns, fps), fps)


def _text_of(buf: Buffer) -> str:
    d = buf.data
    if isinstance(d, str):
        return d
    return host_bytes(d, np.uint8).decode("utf-8", errors="replace")


class _FileParseBase(BaseTransform):
    """Byte-stream in (rsfilesrc-style), caption pair buffers out."""

    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = CEA608_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = ""

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = ""

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (CEA608_CAPS if direction == PadDirection.SINK else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def parse_line(self, line: str) -> Optional[Buffer]:
        raise NotImplementedError

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._acc += _text_of(inbuf)
        while "\n" in self._acc:
            line, self._acc = self._acc.split("\n", 1)
            out = self.parse_line(line.rstrip("\r"))
            if out is not None:
                return out
        return None

    def drain(self) -> Optional[Buffer]:
        if self._acc.strip():
            line, self._acc = self._acc, ""
            return self.parse_line(line.strip())
        return None


@register
class SccParse(_FileParseBase):
    ELEMENT_NAME = "sccparse"
    ELEMENT_CLASS = "Parser/ClosedCaption"
    ELEMENT_DESCRIPTION = "Parses SCC files into CEA-608 byte pairs"
    SINK_CAPS = SCC_CAPS
    PROPERTIES = [Prop("framerate", "30000/1001", type="str")]

    def parse_line(self, line: str) -> Optional[Buffer]:
        line = line.strip()
        if not line or line.startswith(SCC_HEADER):
            return None
        tc, _, payload = line.partition("\t")
        if not payload:
            tc, _, payload = line.partition(" ")
        fps = Fraction(self.get_property("framerate"))
        words = payload.split()
        pairs = [(int(w[:2], 16), int(w[2:], 16)) for w in words if len(w) == 4]
        if not pairs:
            return None
        pts = _tc_to_ns(tc, fps)
        buf = Buffer(pairs_to_array(pairs), pts=pts)
        buf.duration = len(pairs) * SECOND * fps.denominator // fps.numerator
        return buf


@register
class SccEnc(BaseTransform):
    ELEMENT_NAME = "sccenc"
    ELEMENT_CLASS = "Encoder/ClosedCaption"
    ELEMENT_DESCRIPTION = "Encodes CEA-608 byte pairs into SCC"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = CEA608_CAPS
    SRC_CAPS = SCC_CAPS
    PROPERTIES = [
        Prop("framerate", "30000/1001", type="str"),
        Prop("output-padding", True, type="bool",
             doc="encode padding (0x8080) pairs received from upstream; "
                 "false strips them from the output words"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sent_header = False
        self._line_start = None  # frame number of the open line
        self._line_words: List[str] = []
        self._next_frame = None  # expected frame of the next pair

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._sent_header = False
        self._line_start = None
        self._line_words = []
        self._next_frame = None

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (SCC_CAPS if direction == PadDirection.SINK else CEA608_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    #: max byte pairs per SCC line before continuing on a new line with the
    #: timecode advanced by the frames consumed (scc_enc.rs
    #: test_encode_multiple_packets expected vectors)
    MAX_LINE_WORDS = 16

    def _flush_line(self, fps: Fraction) -> str:
        if not self._line_words:
            return ""
        text = (f"{_frames_to_tc(self._line_start, fps)}\t"
                f"{' '.join(self._line_words)}\r\n\r\n")
        self._line_start = None
        self._line_words = []
        return text

    def _with_header(self, text: str) -> str:
        if not self._sent_header:
            text = f"{SCC_HEADER}\r\n\r\n" + text
            self._sent_header = True
        return text

    def generate_output(self) -> Optional[Buffer]:
        """Merge consecutive-frame caption pairs into up-to-16-word lines,
        like the reference encoder (scc_enc.rs expects one pair per frame
        continuing the open line while timecodes stay consecutive)."""
        inbuf = self.take_queued_buffer()
        if inbuf is None:
            return None
        fps = Fraction(self.get_property("framerate"))
        pairs = host_array(inbuf.data, np.uint8).reshape(-1, 2)
        if not self.get_property("output-padding"):
            pairs = pairs[~((pairs[:, 0] == 0x80) & (pairs[:, 1] == 0x80))]
        frame = _ns_to_frames(inbuf.pts or 0, fps)
        flushed = ""
        out_pts = inbuf.pts
        for hi, lo in pairs:
            if self._line_words and (
                    frame != self._next_frame
                    or len(self._line_words) >= self.MAX_LINE_WORDS):
                flushed += self._flush_line(fps)
            if not self._line_words:
                self._line_start = frame
            self._line_words.append(f"{hi:02x}{lo:02x}")
            self._next_frame = frame + 1
            frame += 1
        if not flushed:
            return None
        return Buffer(self._with_header(flushed), pts=out_pts,
                      duration=inbuf.duration)

    def drain(self) -> Optional[Buffer]:
        fps = Fraction(self.get_property("framerate"))
        start = self._line_start
        text = self._flush_line(fps)
        if not text:
            return None
        pts = (start * SECOND * fps.denominator // fps.numerator
               if start is not None else None)
        return Buffer(self._with_header(text), pts=pts)


# MCC alias table (mcc_parse/parser.rs:130-199)
_MCC_ALIASES = {
    **{chr(ord("G") + i): bytes([0xFA, 0x00, 0x00]) * (i + 1) for i in range(9)},
    "P": bytes([0xFB, 0x80, 0x80]),
    "Q": bytes([0xFC, 0x80, 0x80]),
    "R": bytes([0xFD, 0x80, 0x80]),
    "S": bytes([0x96, 0x69]),
    "T": bytes([0x61, 0x01]),
    "U": bytes([0xE1, 0x00, 0x00, 0x00]),
    "Z": bytes([0x00]),
}

MCC_HEADER = "File Format=MacCaption_MCC V1.0"


def mcc_decode_payload(s: str) -> bytes:
    out = bytearray()
    i = 0
    while i < len(s):
        c = s[i]
        if c in _MCC_ALIASES:
            out += _MCC_ALIASES[c]
            i += 1
        else:
            out.append(int(s[i : i + 2], 16))
            i += 2
    return bytes(out)


def mcc_encode_payload(data: bytes) -> str:
    """Greedy alias compression: longest padding runs first, then the
    single-sequence aliases, then plain hex."""
    out = []
    i = 0
    pad = bytes([0xFA, 0x00, 0x00])
    while i < len(data):
        if data[i : i + 3] == pad:
            n = 1
            while n < 9 and data[i + 3 * n : i + 3 * (n + 1)] == pad:
                n += 1
            out.append(chr(ord("G") + n - 1))
            i += 3 * n
            continue
        for alias in ("P", "Q", "R", "S", "T", "U", "Z"):
            seq = _MCC_ALIASES[alias]
            if data[i : i + len(seq)] == seq:
                out.append(alias)
                i += len(seq)
                break
        else:
            out.append(f"{data[i]:02X}")
            i += 1
    return "".join(out)


#: MCC "Time Code Rate=" header values -> (framerate, drop)
_MCC_RATES = {
    "24": (Fraction(24), False), "25": (Fraction(25), False),
    "30": (Fraction(30), False), "30DF": (Fraction(30000, 1001), True),
    "50": (Fraction(50), False), "60": (Fraction(60), False),
    "60DF": (Fraction(60000, 1001), True),
}

ST2038_CAPS = Caps.builder("meta/x-st-2038", alignment="packet")


@register
class MccParse(_FileParseBase):
    """MCC file parser.

    Like the reference (mccparse src pad: meta/x-st-2038 alignment=packet;
    mcc_enc.rs documents the first parsed packet of captions-test_708.mcc
    byte for byte), each caption line becomes ONE packed ST-2038 ANC packet
    with line_number 255 / horizontal_offset 4095 ("unknown" sentinels, the
    values visible in that reference vector).  A closedcaption/x-cea-608
    downstream instead negotiates the convenience 608-pairs output (the CDP
    inside the ANC packet unwrapped, field-1 pairs extracted).  The
    framerate follows the file's `Time Code Rate=` header."""

    ELEMENT_NAME = "mccparse"
    ELEMENT_CLASS = "Parser/ClosedCaption"
    ELEMENT_DESCRIPTION = "Parses MCC files into ST-2038 ANC packets"
    SINK_CAPS = MCC_CAPS
    SRC_CAPS = Caps([ST2038_CAPS.structure(0).copy(),
                     CEA608_CAPS.structure(0).copy()])
    PROPERTIES = [Prop("framerate", "30000/1001", type="str")]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._file_rate = None  # (Fraction, drop) from Time Code Rate=

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._file_rate = None

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK
               else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def _emits_st2038(self) -> bool:
        cur = self.srcpad.current_caps
        return cur is None or cur.structure(0).name == "meta/x-st-2038"

    def _fps(self):
        if self._file_rate is not None:
            return self._file_rate
        fps = Fraction(self.get_property("framerate"))
        return fps, fps.denominator == 1001

    def parse_line(self, line: str) -> Optional[Buffer]:
        line = line.strip()
        if line.startswith("Time Code Rate="):
            self._file_rate = _MCC_RATES.get(
                line.split("=", 1)[1].strip(), self._file_rate)
            return None
        if not line or line.startswith(("File Format", "//", "UUID",
                                        "Creation", "Code Rate")):
            return None
        tc, _, payload = line.partition("\t")
        if not payload:
            return None
        data = mcc_decode_payload(payload.strip())
        fps, drop = self._fps()
        pts = _tc_to_ns(tc, fps, drop)
        if len(data) < 4:
            return None
        did, sdid, dc = data[0], data[1], data[2]
        udw = data[3:3 + dc]
        if self._emits_st2038():
            from ...ops import st2038 as st

            return Buffer(np.frombuffer(
                st.pack(did, sdid, udw, line_number=255,
                        horizontal_offset=4095), np.uint8), pts=pts)
        # 608-pairs convenience output: unwrap the CDP inside the ANC packet
        if (did, sdid) == (0x61, 0x01):
            from ...ops import cea708

            try:
                cc_data, _seq = cea708.parse_cdp(udw)
            except ValueError:
                return None
        else:
            cc_data = udw  # raw cc_data triplet lines
        pairs: List = []
        for j in range(0, len(cc_data) - 2, 3):
            if cc_data[j] == 0xFC:
                pairs.append((cc_data[j + 1], cc_data[j + 2]))
        if not pairs:
            return None
        return Buffer(pairs_to_array(pairs), pts=pts)


#: The MCC format's descriptive boilerplate.  The format mandates carrying
#: this text verbatim ("Permission to generate this format is granted
#: provided that ... this entire descriptive information text is included
#: in a generated .mcc file") — byte-identical in the reference encoder
#: (mcc_enc.rs expected vector) and in files written by MacCaption/Premiere.
_MCC_BOILERPLATE = (
    "///////////////////////////////////////////////////////////////////////////////////\r\n"
    "// Computer Prompting and Captioning Company\r\n"
    "// Ancillary Data Packet Transfer File\r\n"
    "//\r\n"
    "// Permission to generate this format is granted provided that\r\n"
    "//   1. This ANC Transfer file format is used on an as-is basis and no warranty is given, and\r\n"
    "//   2. This entire descriptive information text is included in a generated .mcc file.\r\n"
    "//\r\n"
    "// General file format:\r\n"
    "//   HH:MM:SS:FF(tab)[Hexadecimal ANC data in groups of 2 characters]\r\n"
    "//     Hexadecimal data starts with the Ancillary Data Packet DID (Data ID defined in S291M)\r\n"
    "//       and concludes with the Check Sum following the User Data Words.\r\n"
    "//     Each time code line must contain at most one complete ancillary data packet.\r\n"
    "//     To transfer additional ANC Data successive lines may contain identical time code.\r\n"
    "//     Time Code Rate=[24, 25, 30, 30DF, 50, 60]\r\n"
    "//\r\n"
    "//   ANC data bytes may be represented by one ASCII character according to the following schema:\r\n"
    "//     G  FAh 00h 00h\r\n"
    "//     H  2 x (FAh 00h 00h)\r\n"
    "//     I  3 x (FAh 00h 00h)\r\n"
    "//     J  4 x (FAh 00h 00h)\r\n"
    "//     K  5 x (FAh 00h 00h)\r\n"
    "//     L  6 x (FAh 00h 00h)\r\n"
    "//     M  7 x (FAh 00h 00h)\r\n"
    "//     N  8 x (FAh 00h 00h)\r\n"
    "//     O  9 x (FAh 00h 00h)\r\n"
    "//     P  FBh 80h 80h\r\n"
    "//     Q  FCh 80h 80h\r\n"
    "//     R  FDh 80h 80h\r\n"
    "//     S  96h 69h\r\n"
    "//     T  61h 01h\r\n"
    "//     U  E1h 00h 00h 00h\r\n"
    "//     Z  00h\r\n"
    "//\r\n"
    "///////////////////////////////////////////////////////////////////////////////////\r\n"
)


@register
class MccEnc(BaseTransform):
    """MCC encoder.

    Like the reference (mccenc sink pad: meta/x-st-2038 alignment=packet;
    mcc_enc.rs test_encode), the native input is packed ST-2038 ANC
    packets, written as one aliased-hex ANC line per packet with the full
    MCC header (boilerplate + UUID / Creation Program / Creation Date /
    Creation Time / Time Code Rate).  closedcaption/x-cea-608 input is also
    accepted for convenience: pairs are CDP-framed (SMPTE 334-2) and ANC-
    wrapped first."""

    ELEMENT_NAME = "mccenc"
    ELEMENT_CLASS = "Encoder/ClosedCaption"
    ELEMENT_DESCRIPTION = "Encodes ST-2038 ANC packets into MCC"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = Caps([ST2038_CAPS.structure(0).copy(),
                      CEA608_CAPS.structure(0).copy()])
    SRC_CAPS = MCC_CAPS
    PROPERTIES = [
        Prop("framerate", "30000/1001", type="str"),
        Prop("uuid", None, type="str",
             doc="UUID written in the header (None = fresh uuid4)"),
        Prop("creation-date", None, type="str",
             doc="creation date/time for the header; ISO 8601 "
                 "YYYY-MM-DDTHH:MM:SS renders as the reference's split "
                 "Creation Date= / Creation Time= lines (None = now)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sent_header = False
        self._input_is_st2038 = False

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._sent_header = False

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self._input_is_st2038 = \
            incaps.structure(0).name == "meta/x-st-2038"

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (MCC_CAPS if direction == PadDirection.SINK
               else self.SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def __init_seq(self) -> int:
        seq = getattr(self, "_cdp_seq", 0)
        self._cdp_seq = (seq + 1) & 0xFFFF
        return seq

    @staticmethod
    def _anc_wrap(cdp: bytes, did: int = 0x61, sdid: int = 0x01) -> bytes:
        """ANC packet bytes as MCC stores them: DID, SDID, DC, UDWs and the
        low 8 bits of the SMPTE 291 checksum over the parity-extended words
        (matches the reference parser's caption test vector)."""
        from ...ops.st2038 import _parity10

        words = [_parity10(did), _parity10(sdid), _parity10(len(cdp))]
        words += [_parity10(b) for b in cdp]
        checksum = sum(w & 0x1FF for w in words) & 0x1FF
        return bytes([did, sdid, len(cdp)]) + cdp + bytes([checksum & 0xFF])

    def _header(self, fps: Fraction) -> str:
        import uuid as _uuid
        from datetime import datetime, timezone

        from ... import __version__ as _ver

        uid = self.get_property("uuid") or str(_uuid.uuid4()).upper()
        created = self.get_property("creation-date")
        if created is None:
            dt = datetime.now(timezone.utc)
        else:
            try:
                dt = datetime.fromisoformat(created)
            except ValueError:
                dt = None
        if dt is not None:
            date_line = (f"Creation Date={dt.strftime('%A')}, "
                         f"{dt.strftime('%B')} {dt.day:02d}, {dt.year}\r\n"
                         f"Creation Time={dt.strftime('%H:%M:%S')}\r\n")
        else:
            date_line = f"Creation Date={created}\r\n"
        rate = "30DF" if fps == Fraction(30000, 1001) else (
            "60DF" if fps == Fraction(60000, 1001)
            else str(int(round(float(fps)))))
        return (f"{MCC_HEADER}\r\n\r\n{_MCC_BOILERPLATE}\r\n"
                f"UUID={uid}\r\n"
                f"Creation Program=gst-plugins-rs-tpu MCC Encoder {_ver}\r\n"
                f"{date_line}"
                f"Time Code Rate={rate}\r\n\r\n")

    def transform(self, inbuf: Buffer) -> Buffer:
        fps = Fraction(self.get_property("framerate"))
        if self._input_is_st2038:
            from ...ops import st2038 as st

            raw = host_bytes(inbuf.data, np.uint8)
            lines = []
            tc = _ns_to_tc(inbuf.pts or 0, fps)
            for pkt in st.unpack_all(raw):
                anc = self._anc_wrap(pkt.data, pkt.did, pkt.sdid)
                lines.append(f"{tc}\t{mcc_encode_payload(anc)}\r\n")
            text = "".join(lines)
        else:
            from ...ops import cea708

            pairs = host_array(inbuf.data, np.uint8).reshape(-1, 2)
            # cc_data: the 608 pairs as field-1 triplets, padded with DTVCC
            # filler to the frame-rate-appropriate 20-triplet budget
            cc = b"".join(bytes([0xFC, hi, lo]) for hi, lo in pairs)
            while len(cc) // 3 < 20:
                cc += bytes([0xFA, 0x00, 0x00])
            cdp = cea708.build_cdp(cc, sequence=self.__init_seq(),
                                   fps=int(round(float(fps))))
            text = (f"{_ns_to_tc(inbuf.pts or 0, fps)}\t"
                    f"{mcc_encode_payload(self._anc_wrap(cdp))}\r\n")
        if not self._sent_header:
            text = self._header(fps) + text
            self._sent_header = True
        return Buffer(text, pts=inbuf.pts, duration=inbuf.duration)


__all__ = ["SccParse", "SccEnc", "MccParse", "MccEnc",
           "mcc_decode_payload", "mcc_encode_payload"]
