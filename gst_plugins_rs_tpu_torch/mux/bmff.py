"""ISO-BMFF box serialization (ISO/IEC 14496-12).

From-scratch writer covering the boxes the reference muxers emit:
- movie header: ftyp/styp, moov(mvhd, trak(tkhd, mdia(mdhd, hdlr,
  minf(smhd|vmhd, dinf(dref(url)), stbl(stsd, stts, stsc, stsz, stco,
  stss)))), mvex(mehd, trex))  — reference mux/isobmff/src/isobmff/boxes.rs
- fragments: moof(mfhd, traf(tfhd, tfdt, trun)) + mdat, mfra(tfra, mfro)
  — reference mux/isobmff/src/isobmff/fmp4mux/boxes.rs
- sample entries: raw PCM audio as ipcm/fpcm + pcmC (ISO/IEC 23003-5;
  reference boxes.rs:1458-1463, create_pcmc boxes.rs:2537-2563) and
  uncompressed video as uncv + uncC/cmpd (ISO/IEC 23001-17; reference
  uncompressed.rs:256-318, profile table uncompressed.rs:552-574).

All multi-byte integers are big-endian per the spec.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

U32_MAX = 0xFFFFFFFF


def box(fourcc: bytes, payload: bytes) -> bytes:
    """size(u32) + type(4cc) + payload; 64-bit largesize when needed."""
    assert len(fourcc) == 4, fourcc
    size = 8 + len(payload)
    if size <= U32_MAX:
        return struct.pack(">I", size) + fourcc + payload
    return struct.pack(">I", 1) + fourcc + struct.pack(">Q", size + 8) + payload


def full_box(fourcc: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(fourcc, struct.pack(">B", version) + struct.pack(">I", flags)[1:] + payload)


# ---------------------------------------------------------------------------
# Sample entries
# ---------------------------------------------------------------------------
def pcm_sample_entry(fmt: str, channels: int, rate: int) -> bytes:
    """AudioSampleEntry 'ipcm' (integer) / 'fpcm' (float) with a pcmC child.

    Reference picks fpcm for float formats, ipcm otherwise
    (boxes.rs:1458-1463); pcmC carries endianness flag + sample width
    (boxes.rs:2537-2563, ISO/IEC 23003-5).
    """
    widths = {"S16": 16, "S24LE": 24, "S32": 32, "F32": 32, "F64": 64, "U8": 8}
    width = widths[fmt]
    fourcc = b"fpcm" if fmt.startswith("F") else b"ipcm"
    pcmc = full_box(b"pcmC", 0, 0, struct.pack(">BB", 1, width))  # 1 = little-endian
    body = (
        b"\x00" * 6  # reserved
        + struct.pack(">H", 1)  # data_reference_index
        + b"\x00" * 8  # reserved
        + struct.pack(">HH", channels, 16)  # channelcount, samplesize
        + struct.pack(">HH", 0, 0)  # pre_defined, reserved
        # 16.16 fixed-point; rates >= 2^16 (192 kHz) can't be represented here,
        # the authoritative rate is the mdhd timescale (ISO/IEC 23003-5 §5)
        + struct.pack(">I", rate << 16 if rate < 0x10000 else 0)
        + pcmc
    )
    return box(fourcc, body)


# ISO/IEC 23001-17:2024 Table 5 profiles the reference maps video formats to
# (uncompressed.rs:552-574).  v1 uncC (profile only) is used for the
# zero-padding packed RGB family (uncompressed.rs:263-272).
UNCC_V1_PROFILES = {"RGB": b"rgb3", "RGBA": b"rgba", "ABGR": b"abgr"}

# 23001-17 Table 1 component types (uncompressed.rs:366-377)
_MONO, _Y, _CB, _CR, _R, _G, _B, _A = 0, 1, 2, 3, 4, 5, 6, 7

# uncC parameters per video format (reference uncompressed.rs:455-770):
#   components (in storage order), sampling_type (0=4:4:4 1=4:2:2 2=4:2:0
#   3=4:1:1), interleave_type (0=planar 1=pixel 2=semi-planar 5=multi-Y),
#   pixel_size (interleave 1/5 only), profile (Table 5 fourcc or zeros),
#   bit depth (per component) and block_size where non-default.
_UNCC = {
    # packed RGB family (pixel interleave)
    "RGB": dict(comps=[_R, _G, _B], il=1, px=3, profile=b"rgb3"),
    "BGR": dict(comps=[_B, _G, _R], il=1, px=3),
    "RGBA": dict(comps=[_R, _G, _B, _A], il=1, px=4, profile=b"rgba"),
    "ARGB": dict(comps=[_A, _R, _G, _B], il=1, px=4),
    "BGRA": dict(comps=[_B, _G, _R, _A], il=1, px=4),
    "ABGR": dict(comps=[_A, _B, _G, _R], il=1, px=4, profile=b"abgr"),
    "RGBx": dict(comps=[_R, _G, _B], il=1, px=4),
    "BGRx": dict(comps=[_B, _G, _R], il=1, px=4),
    "xRGB": dict(comps=[_R, _G, _B], il=1, px=4),
    "xBGR": dict(comps=[_B, _G, _R], il=1, px=4),
    "r210": dict(comps=[_R, _G, _B], il=1, px=4, depth=10, block=4),
    # grayscale (single component = planar interleave, pixel_size 0)
    "GRAY8": dict(comps=[_MONO], il=0),
    "GRAY16_BE": dict(comps=[_MONO], il=0, depth=16),
    # packed YUV 4:4:4
    "IYU2": dict(comps=[_CB, _Y, _CR], il=1, px=3),
    "v308": dict(comps=[_Y, _CB, _CR], il=1, px=3, profile=b"v308"),
    "AYUV": dict(comps=[_A, _Y, _CB, _CR], il=1, px=4),
    # packed YUV 4:2:2 (multi-Y)
    "YUY2": dict(comps=[_Y, _CB, _Y, _CR], il=5, px=4, sampling=1,
                 profile=b"yuv2"),
    "YVYU": dict(comps=[_Y, _CR, _Y, _CB], il=5, px=4, sampling=1,
                 profile=b"yvyu"),
    "UYVY": dict(comps=[_CB, _Y, _CR, _Y], il=5, px=4, sampling=1,
                 profile=b"2vuy"),
    "VYUY": dict(comps=[_CR, _Y, _CB, _Y], il=5, px=4, sampling=1,
                 profile=b"vyuy"),
    # planar YUV
    "Y444": dict(comps=[_Y, _CB, _CR], il=0),
    "I420": dict(comps=[_Y, _CB, _CR], il=0, sampling=2, profile=b"i420"),
    "YV12": dict(comps=[_Y, _CR, _CB], il=0, sampling=2, profile=b"yv20"),
    "Y42B": dict(comps=[_Y, _CB, _CR], il=0, sampling=1, profile=b"yu22"),
    "Y41B": dict(comps=[_Y, _CB, _CR], il=0, sampling=3),
    # planar RGB
    "GBR": dict(comps=[_G, _B, _R], il=0),
    "RGBP": dict(comps=[_R, _G, _B], il=0),
    "BGRP": dict(comps=[_B, _G, _R], il=0),
    # semi-planar YUV
    "NV12": dict(comps=[_Y, _CB, _CR], il=2, sampling=2, profile=b"nv12"),
    "NV21": dict(comps=[_Y, _CR, _CB], il=2, sampling=2, profile=b"nv21"),
    "NV16": dict(comps=[_Y, _CB, _CR], il=2, sampling=1),
    "NV61": dict(comps=[_Y, _CR, _CB], il=2, sampling=1),
}

COMPRESSION_FOURCC = {
    "zlib": b"zlib",
    "deflate": b"defl",
    "brotli": b"brot",
}


def uncc_boxes(fmt: str, *, row_align: int = 0) -> bytes:
    """cmpd + uncC (or the v1 profile-only uncC) for one video format —
    the generic ISO/IEC 23001-17 component model
    (reference uncompressed.rs:256-313)."""
    if fmt in UNCC_V1_PROFILES and row_align == 0:
        return full_box(b"uncC", 1, 0, UNCC_V1_PROFILES[fmt])
    spec = _UNCC.get(fmt)
    if spec is None:
        raise ValueError(f"no uncC mapping for video format {fmt!r}")
    comps = spec["comps"]
    n = len(comps)
    depth = spec.get("depth", 8)
    cmpd = box(
        b"cmpd",
        struct.pack(">I", n) + b"".join(struct.pack(">H", t) for t in comps),
    )
    comp_entries = b"".join(
        struct.pack(">HBBB", i, depth - 1, 0, 0)  # index, depth-1, fmt, align
        for i in range(n)
    )
    il = spec["il"]
    uncc = full_box(
        b"uncC",
        0,
        0,
        (spec.get("profile") or b"\x00\x00\x00\x00")
        + struct.pack(">I", n)
        + comp_entries
        + struct.pack(">BB", spec.get("sampling", 0), il)
        + struct.pack(">BB", spec.get("block", 0), 0)  # block_size, flag_bits
        # pixel_size only for pixel/multi-Y interleave (23001-17 §5.2.1.7)
        + struct.pack(">I", spec.get("px", 0) if il in (1, 5) else 0)
        + struct.pack(">I", row_align)
        + struct.pack(">III", 0, 0, 0),  # tile align / cols-1 / rows-1
    )
    return cmpd + uncc


def rinf_box(compression: str) -> bytes:
    """RestrictedSchemeInfoBox for generically-compressed uncompressed
    video (ISO/IEC 14496-12 8.12.5 + 23001-17 Amd.2 §9.3;
    reference uncompressed.rs:226-254): frma 'uncv' + schm 'gcmp' +
    schi{cmpC}."""
    frma = box(b"frma", b"uncv")
    schm = full_box(b"schm", 0, 0, b"gcmp" + struct.pack(">I", 1))
    cmpc = full_box(
        b"cmpC", 0, 0,
        COMPRESSION_FOURCC[compression] + b"\x00")  # unit_type=0: whole sample
    return box(b"rinf", frma + schm + box(b"schi", cmpc))


def uncv_sample_entry(fmt: str, width: int, height: int, *,
                      compression: Optional[str] = None,
                      row_align: int = 0) -> bytes:
    """VisualSampleEntry 'uncv' with uncC (+cmpd) children; with
    `compression` set, the restricted 'resv' entry wrapping rinf
    (frma/schm/schi{cmpC}) around the same uncC (the generically-
    compressed form, reference uncompressed.rs:316-321)."""
    children = uncc_boxes(fmt, row_align=row_align)
    if compression is not None:
        children = rinf_box(compression) + children
    body = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + struct.pack(">HH", 0, 0)  # pre_defined, reserved
        + struct.pack(">III", 0, 0, 0)  # pre_defined[3]
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)  # frame_count
        + b"\x00" * 32  # compressorname
        + struct.pack(">Hh", 0x0018, -1)  # depth, pre_defined
        + children
    )
    return box(b"resv" if compression is not None else b"uncv", body)


# ---------------------------------------------------------------------------
# Compressed-codec sample entries (reference boxes.rs get_audio_fourcc /
# get_video_fourcc: h264->avc1+avcC, aac->mp4a+esds, opus->Opus+dOps,
# av1->av01+av1C, vp9->vp09+vpcC)
# ---------------------------------------------------------------------------
def _audio_entry_body(channels: int, rate: int, children: bytes) -> bytes:
    return (
        b"\x00" * 6
        + struct.pack(">H", 1)
        + b"\x00" * 8
        + struct.pack(">HH", channels, 16)
        + struct.pack(">HH", 0, 0)
        + struct.pack(">I", rate << 16 if rate < 0x10000 else 0)
        + children
    )


def _visual_entry_body(width: int, height: int, children: bytes) -> bytes:
    return (
        b"\x00" * 6
        + struct.pack(">H", 1)
        + struct.pack(">HH", 0, 0)
        + struct.pack(">III", 0, 0, 0)
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)
        + struct.pack(">I", 0)
        + struct.pack(">H", 1)
        + b"\x00" * 32
        + struct.pack(">Hh", 0x0018, -1)
        + children
    )


def avc1_sample_entry(width: int, height: int, avcc: bytes,
                      fourcc: bytes = b"avc1") -> bytes:
    """'avc1'/'avc3' with the AVCDecoderConfigurationRecord verbatim in avcC
    (reference boxes.rs:1475-1479 stream-format avc->avc1, avc3->avc3)."""
    return box(fourcc, _visual_entry_body(width, height, box(b"avcC", avcc)))


def hvc1_sample_entry(width: int, height: int, hvcc: bytes,
                      fourcc: bytes = b"hvc1") -> bytes:
    """'hvc1'/'hev1' with the HEVCDecoderConfigurationRecord in hvcC
    (reference boxes.rs:1480-1487,1606-1617)."""
    return box(fourcc, _visual_entry_body(width, height, box(b"hvcC", hvcc)))


def vvc1_sample_entry(width: int, height: int, vvcc: bytes,
                      fourcc: bytes = b"vvc1") -> bytes:
    """'vvc1'/'vvi1' with vvcC as a FullBox (reference boxes.rs:1488-1495,
    1618-1629)."""
    return box(fourcc, _visual_entry_body(
        width, height, full_box(b"vvcC", 0, 0, vvcc)))


class _BitReader:
    """MSB-first bit reader with HEVC emulation-prevention removal."""

    def __init__(self, data: bytes, unescape: bool = False):
        if unescape:
            out = bytearray()
            i = 0
            while i < len(data):
                if i + 2 < len(data) and data[i] == 0 and data[i + 1] == 0 \
                        and data[i + 2] == 3:
                    out += data[i:i + 2]
                    i += 3
                else:
                    out.append(data[i])
                    i += 1
            data = bytes(out)
        self.data = data
        self.pos = 0

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)


def hvcc_from_parameter_sets(vps: bytes, sps: bytes, pps: bytes,
                             nal_length_size: int = 4) -> bytes:
    """HEVCDecoderConfigurationRecord (ISO 14496-15 §8.3.3.1) built from raw
    VPS/SPS/PPS NAL units, parsing the SPS profile_tier_level for the
    general_* fields and chroma/bit-depth."""
    r = _BitReader(sps[2:], unescape=True)  # skip 2-byte NAL header
    r.u(4)  # sps_video_parameter_set_id
    max_sub_layers_minus1 = r.u(3)
    temporal_id_nesting = r.u(1)
    # profile_tier_level(1, max_sub_layers_minus1)
    profile_space = r.u(2)
    tier_flag = r.u(1)
    profile_idc = r.u(5)
    compat_flags = r.u(32)
    constraint_flags = r.u(48)
    level_idc = r.u(8)
    sub_profile_present = []
    sub_level_present = []
    for _ in range(max_sub_layers_minus1):
        sub_profile_present.append(r.u(1))
        sub_level_present.append(r.u(1))
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            r.u(2)
    for i in range(max_sub_layers_minus1):
        if sub_profile_present[i]:
            r.u(2 + 1 + 5)
            r.u(32)
            r.u(48)
        if sub_level_present[i]:
            r.u(8)
    r.ue()  # sps_seq_parameter_set_id
    chroma_format_idc = r.ue()
    if chroma_format_idc == 3:
        r.u(1)  # separate_colour_plane_flag
    r.ue()  # pic_width_in_luma_samples
    r.ue()  # pic_height_in_luma_samples
    if r.u(1):  # conformance_window_flag
        r.ue(); r.ue(); r.ue(); r.ue()
    bit_depth_luma_minus8 = r.ue()
    bit_depth_chroma_minus8 = r.ue()

    rec = bytearray()
    rec.append(1)  # configurationVersion
    rec.append((profile_space << 6) | (tier_flag << 5) | profile_idc)
    rec += compat_flags.to_bytes(4, "big")
    rec += constraint_flags.to_bytes(6, "big")
    rec.append(level_idc)
    rec += (0xF000).to_bytes(2, "big")  # min_spatial_segmentation_idc = 0
    rec.append(0xFC | 0)  # parallelismType
    rec.append(0xFC | chroma_format_idc)
    rec.append(0xF8 | bit_depth_luma_minus8)
    rec.append(0xF8 | bit_depth_chroma_minus8)
    rec += (0).to_bytes(2, "big")  # avgFrameRate
    rec.append((0 << 6) | (1 << 3) | (temporal_id_nesting << 2)
               | (nal_length_size - 1))  # constantFrameRate=0, numTemporalLayers=1
    arrays = [(32, vps), (33, sps), (34, pps)]
    rec.append(len(arrays))
    for nal_type, nal in arrays:
        rec.append(0x80 | nal_type)  # array_completeness=1
        rec += (1).to_bytes(2, "big")
        rec += len(nal).to_bytes(2, "big")
        rec += nal
    return bytes(rec)


def av01_sample_entry(width: int, height: int, av1c: bytes) -> bytes:
    return box(b"av01", _visual_entry_body(width, height, box(b"av1C", av1c)))


def vp08_sample_entry(width: int, height: int) -> bytes:
    # vp08 + vpcC (reference boxes.rs get_video_fourcc: video/x-vp8 -> vp08)
    vpcc = full_box(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1), 2, 2, 2]) + b"\x00\x00")
    return box(b"vp08", _visual_entry_body(width, height, vpcc))


def vp09_sample_entry(width: int, height: int) -> bytes:
    # vpcC: version 1, profile 0, level 10, 8-bit 4:2:0, no codec init
    vpcc = full_box(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1), 2, 2, 2]) + b"\x00\x00")
    return box(b"vp09", _visual_entry_body(width, height, vpcc))


def mp4a_sample_entry(channels: int, rate: int, audio_specific_config: bytes) -> bytes:
    """'mp4a' with an esds carrying the AudioSpecificConfig (ISO 14496-1)."""

    def descriptor(tag: int, payload: bytes) -> bytes:
        # expandable length, single-byte form is fine at these sizes
        return bytes([tag, len(payload)]) + payload

    dec_specific = descriptor(0x05, audio_specific_config)
    dec_config = descriptor(
        0x04,
        bytes([0x40, 0x15]) + b"\x00\x00\x00" + struct.pack(">II", 0, 0) + dec_specific,
    )
    sl_config = descriptor(0x06, b"\x02")
    es = descriptor(0x03, struct.pack(">HB", 1, 0) + dec_config + sl_config)
    esds = full_box(b"esds", 0, 0, es)
    return box(b"mp4a", _audio_entry_body(channels, rate, esds))


def parse_ac3_header(frame: bytes):
    """(fscod, frmsizecod, bsid, bsmod, acmod, lfeon) from an AC-3
    syncframe (reference ac3.rs SyncInfo/Bsi parse)."""
    if len(frame) < 8 or frame[0] != 0x0B or frame[1] != 0x77:
        raise ValueError("not an AC-3 syncframe")
    bits = int.from_bytes(frame[:8], "big")
    offset = [32]  # skip syncword + crc1

    def take(n):
        shift = 64 - (offset[0] + n)
        offset[0] += n
        return (bits >> shift) & ((1 << n) - 1)
    fscod = take(2)
    frmsizecod = take(6)
    bsid = take(5)
    bsmod = take(3)
    acmod = take(3)
    if (acmod & 1) and acmod != 1:
        take(2)  # cmixlev
    if acmod & 4:
        take(2)  # surmixlev
    if acmod == 2:
        take(2)  # dsurmod
    lfeon = take(1)
    return fscod, frmsizecod, bsid, bsmod, acmod, lfeon


_AC3_CHANNELS = {0: 2, 1: 1, 2: 2, 3: 3, 4: 3, 5: 4, 6: 4, 7: 5}
_AC3_RATES = {0: 48000, 1: 44100, 2: 32000}


def ac3_sample_entry(frame: bytes) -> bytes:
    """'ac-3' AudioSampleEntry with dac3 (ETSI TS 102 366 Annex F) built
    from the first syncframe, like the reference's create_dac3."""
    fscod, frmsizecod, bsid, bsmod, acmod, lfeon = parse_ac3_header(frame)
    rate = _AC3_RATES.get(fscod, 48000)
    channels = _AC3_CHANNELS[acmod] + lfeon
    bit_rate_code = frmsizecod >> 1
    val = (fscod << 22) | (bsid << 17) | (bsmod << 14) | (acmod << 11)
    val |= (lfeon << 10) | (bit_rate_code << 5)
    dac3 = box(b"dac3", val.to_bytes(3, "big"))
    return box(b"ac-3", _audio_entry_body(channels, rate, dac3))


_EAC3_RATES = {0: 48000, 1: 44100, 2: 32000}
_EAC3_BLOCKS = {0: 1, 1: 2, 2: 3, 3: 6}


def parse_eac3_header(frame: bytes):
    """Minimal E-AC-3 (ETSI TS 102 366 Annex E) bsi parse of one syncframe:
    (frmsiz, fscod, numblks, acmod, lfeon, bsid, rate)."""
    if frame[:2] != b"\x0b\x77":
        raise ValueError("not an (E-)AC-3 syncframe")
    r = _BitReader(frame[2:])
    r.u(2)  # strmtyp
    r.u(3)  # substreamid
    frmsiz = r.u(11)
    fscod = r.u(2)
    if fscod == 3:
        fscod2 = r.u(2)
        rate = _EAC3_RATES.get(fscod2, 24000) // 2
        numblks = 6
    else:
        rate = _EAC3_RATES[fscod]
        numblks = _EAC3_BLOCKS[r.u(2)]
    acmod = r.u(3)
    lfeon = r.u(1)
    bsid = r.u(5)
    return frmsiz, fscod, numblks, acmod, lfeon, bsid, rate


def eac3_sample_entry(frame: bytes) -> bytes:
    """'ec-3' AudioSampleEntry with dec3 (ETSI TS 102 366 Annex F.6) built
    from the first syncframe (reference boxes.rs EAC-3 handling)."""
    frmsiz, fscod, numblks, acmod, lfeon, bsid, rate = parse_eac3_header(frame)
    channels = _AC3_CHANNELS[acmod] + lfeon
    frame_bytes = 2 * (frmsiz + 1)
    data_rate = frame_bytes * 8 * rate // (numblks * 256) // 1000  # kbps
    # dec3: data_rate(13) num_ind_sub-1(3); per substream:
    # fscod(2) bsid(5) reserved(1) asvc(1) bsmod(3) acmod(3) lfeon(1)
    # reserved(3) num_dep_sub(4) reserved(1)
    v = (data_rate & 0x1FFF) << 3 | 0  # one independent substream
    sub = (fscod << 22) | (bsid << 17) | (0 << 16) | (0 << 15) | (0 << 12)
    sub |= (acmod << 9) | (lfeon << 8) | (0 << 5) | (0 << 1) | 0
    dec3 = box(b"dec3", v.to_bytes(2, "big") + sub.to_bytes(3, "big"))
    return box(b"ec-3", _audio_entry_body(channels, rate, dec3))


def opus_sample_entry(channels: int, rate: int, pre_skip: int = 312) -> bytes:
    """'Opus' with dOps (Opus-in-ISOBMFF spec, mapping family 0)."""
    dops = box(
        b"dOps",
        bytes([0, channels]) + struct.pack(">HIhB", pre_skip, rate, 0, 0),
    )
    return box(b"Opus", _audio_entry_body(channels, rate, dops))


# ---------------------------------------------------------------------------
# Track / movie configuration
# ---------------------------------------------------------------------------
@dataclass
class TrackConfig:
    track_id: int
    timescale: int
    handler: str  # "soun" | "vide"
    sample_entry: bytes
    width: int = 0
    height: int = 0
    default_sample_duration: int = 0  # in track timescale, for trex
    # edit list entries: (segment_duration movie-ts, media_time track-ts)
    # (write-edts-mode, reference mod.rs WriteEdtsMode / ElstInfo)
    elst: Optional[List[Tuple[int, int]]] = None
    # ISO 639-2/T code in mdhd (reference boxes.rs:1198-1231); "und" default
    language: str = "und"
    # video rotation in degrees CW (image-orientation tag -> tkhd matrix,
    # reference boxes.rs:1137-1195 per-stream orientation matrix)
    orientation: int = 0
    # additional stsd entries appended by mid-stream caps changes in the
    # non-fragmented muxer (stsc switches sample_description_index;
    # mp4_tests.rs test_caps_change_with_*)
    extra_sample_entries: List[bytes] = field(default_factory=list)


@dataclass
class SampleTable:
    """Accumulated stbl data for non-fragmented muxing."""

    durations: List[int] = field(default_factory=list)  # per sample, track ts
    sizes: List[int] = field(default_factory=list)
    sync: List[bool] = field(default_factory=list)
    # chunks: (file_offset, n_samples) runs in mdat order
    chunks: List[Tuple[int, int]] = field(default_factory=list)
    # per-chunk stsd sample_description_index (1-based; empty = all 1) —
    # mid-stream caps changes append stsd entries and switch the index
    # (mp4_tests.rs test_caps_change_with_*)
    chunk_desc: List[int] = field(default_factory=list)

    @property
    def total_duration(self) -> int:
        return sum(self.durations)

    def desc(self, i: int) -> int:
        return self.chunk_desc[i] if i < len(self.chunk_desc) else 1


def ftyp(major: bytes, minor: int, compatible: Sequence[bytes]) -> bytes:
    return box(b"ftyp", major + struct.pack(">I", minor) + b"".join(compatible))


def styp(major: bytes, minor: int, compatible: Sequence[bytes]) -> bytes:
    return box(b"styp", major + struct.pack(">I", minor) + b"".join(compatible))


def _mvhd(movie_timescale: int, duration: int, next_track_id: int) -> bytes:
    matrix = struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
    payload = (
        struct.pack(">II", 0, 0)  # creation/modification
        + struct.pack(">II", movie_timescale, duration)
        + struct.pack(">iH", 0x00010000, 0x0100)  # rate 1.0, volume 1.0
        + b"\x00" * 10
        + matrix
        + b"\x00" * 24  # pre_defined
        + struct.pack(">I", next_track_id)
    )
    return full_box(b"mvhd", 0, 0, payload)


_ROTATION_MATRICES = {
    # unity-scale 2D rotation in 16.16 fixed point; w = 0x40000000 (2.30)
    0: (0x10000, 0, 0, 0x10000),
    90: (0, 0x10000, -0x10000, 0),
    180: (-0x10000, 0, 0, -0x10000),
    270: (0, -0x10000, 0x10000, 0),
}


def _tkhd(t: TrackConfig, duration_movie_ts: int) -> bytes:
    a, b_, c, d = _ROTATION_MATRICES.get(t.orientation % 360,
                                         _ROTATION_MATRICES[0])
    # translate so the rotated frame stays in the positive quadrant
    tx = t.width << 16 if t.orientation % 360 in (90, 180) else 0
    ty = t.height << 16 if t.orientation % 360 in (180, 270) else 0
    if t.orientation % 360 == 90:
        tx, ty = t.height << 16, 0
    elif t.orientation % 360 == 270:
        tx, ty = 0, t.width << 16
    matrix = struct.pack(">9i", a, b_, 0, c, d, 0, tx, ty, 0x40000000)
    volume = 0x0100 if t.handler == "soun" else 0
    w, h = t.width, t.height
    if t.orientation % 180 == 90:
        w, h = h, w  # presentation size swaps for quarter turns
    payload = (
        struct.pack(">II", 0, 0)
        + struct.pack(">I", t.track_id)
        + struct.pack(">I", 0)  # reserved
        + struct.pack(">I", duration_movie_ts)
        + b"\x00" * 8
        + struct.pack(">hhHH", 0, 0, volume, 0)
        + matrix
        + struct.pack(">II", w << 16, h << 16)
    )
    return full_box(b"tkhd", 0, 3, payload)  # flags: enabled | in_movie


def pack_language(code: str) -> int:
    """ISO 639-2/T 3-letter code packed as 5-bit letters (boxes.rs:1224)."""
    code = (code or "und").lower()
    if len(code) != 3 or not all("a" <= c <= "z" for c in code):
        code = "und"
    return (((ord(code[0]) - 0x60) << 10) | ((ord(code[1]) - 0x60) << 5)
            | (ord(code[2]) - 0x60))


def _mdhd(timescale: int, duration: int, language: str = "und") -> bytes:
    payload = (
        struct.pack(">II", 0, 0)
        + struct.pack(">II", timescale, duration)
        + struct.pack(">HH", pack_language(language), 0)
    )
    return full_box(b"mdhd", 0, 0, payload)


def _hdlr(handler: str) -> bytes:
    names = {"soun": b"SoundHandler\x00", "vide": b"VideoHandler\x00",
             "pict": b"PictureHandler\x00"}  # ISO 23008-12 image sequences
    payload = struct.pack(">I", 0) + handler.encode() + b"\x00" * 12 + names[handler]
    return full_box(b"hdlr", 0, 0, payload)


def _dinf() -> bytes:
    url = full_box(b"url ", 0, 1, b"")  # flag 1: data in same file
    dref = full_box(b"dref", 0, 0, struct.pack(">I", 1) + url)
    return box(b"dinf", dref)


def _stbl(entry: bytes, table: Optional[SampleTable],
          extra_entries: Sequence[bytes] = ()) -> bytes:
    entries = [entry, *extra_entries]
    stsd = full_box(b"stsd", 0, 0,
                    struct.pack(">I", len(entries)) + b"".join(entries))
    if table is None or not table.sizes:
        # empty tables (fragmented init segment)
        stts = full_box(b"stts", 0, 0, struct.pack(">I", 0))
        stsc = full_box(b"stsc", 0, 0, struct.pack(">I", 0))
        stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, 0))
        stco = full_box(b"stco", 0, 0, struct.pack(">I", 0))
        return box(b"stbl", stsd + stts + stsc + stsz + stco)

    # stts: run-length encode (count, duration)
    runs: List[Tuple[int, int]] = []
    for d in table.durations:
        if runs and runs[-1][1] == d:
            runs[-1] = (runs[-1][0] + 1, d)
        else:
            runs.append((1, d))
    stts = full_box(
        b"stts",
        0,
        0,
        struct.pack(">I", len(runs)) + b"".join(struct.pack(">II", c, d) for c, d in runs),
    )
    # stsc: runs of (samples-per-chunk, sample_description_index)
    stsc_entries: List[Tuple[int, int, int]] = []  # (first_chunk, n, desc)
    for i, (_off, n) in enumerate(table.chunks):
        desc = table.desc(i)
        if not stsc_entries or stsc_entries[-1][1:] != (n, desc):
            stsc_entries.append((i + 1, n, desc))
    stsc = full_box(
        b"stsc",
        0,
        0,
        struct.pack(">I", len(stsc_entries))
        + b"".join(struct.pack(">III", fc, n, d)
                   for fc, n, d in stsc_entries),
    )
    stsz = full_box(
        b"stsz",
        0,
        0,
        struct.pack(">II", 0, len(table.sizes))
        + b"".join(struct.pack(">I", s) for s in table.sizes),
    )
    stco = full_box(
        b"stco",
        0,
        0,
        struct.pack(">I", len(table.chunks))
        + b"".join(struct.pack(">I", off) for off, _n in table.chunks),
    )
    body = stsd + stts + stsc + stsz + stco
    if not all(table.sync):
        idx = [i + 1 for i, k in enumerate(table.sync) if k]
        body += full_box(
            b"stss", 0, 0, struct.pack(">I", len(idx)) + b"".join(struct.pack(">I", i) for i in idx)
        )
    return box(b"stbl", body)


def _elst(entries: List[Tuple[int, int]]) -> bytes:
    payload = struct.pack(">I", len(entries))
    for seg_dur, media_time in entries:
        payload += struct.pack(">IiHH", seg_dur, media_time, 1, 0)  # rate 1.0
    return box(b"edts", full_box(b"elst", 0, 0, payload))


def _trak(t: TrackConfig, movie_timescale: int, table: Optional[SampleTable]) -> bytes:
    duration_ts = table.total_duration if table else 0
    duration_movie = (
        duration_ts * movie_timescale // t.timescale if t.timescale else 0
    )
    mdia = box(
        b"mdia",
        _mdhd(t.timescale, duration_ts, t.language)
        + _hdlr(t.handler)
        + box(
            b"minf",
            (
                full_box(b"smhd", 0, 0, struct.pack(">hH", 0, 0))
                if t.handler == "soun"
                else full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
            )
            + _dinf()
            + _stbl(t.sample_entry, table, t.extra_sample_entries),
        ),
    )
    edts = _elst(t.elst) if t.elst else b""
    return box(b"trak", _tkhd(t, duration_movie) + edts + mdia)


def moov(
    tracks: Sequence[TrackConfig],
    movie_timescale: int,
    *,
    fragmented: bool = False,
    duration: int = 0,
    write_mehd: bool = False,
    tables: Optional[Sequence[Optional[SampleTable]]] = None,
    extra_boxes: bytes = b"",
) -> bytes:
    """Movie box. For fragmented files the sample tables are empty and an
    mvex with one trex per track is appended (fmp4mux/boxes.rs)."""
    if tables is None:
        tables = [None] * len(tracks)
    body = _mvhd(movie_timescale, duration, max(t.track_id for t in tracks) + 1)
    for t, table in zip(tracks, tables):
        body += _trak(t, movie_timescale, table)
    if fragmented:
        mvex = b""
        if write_mehd:
            mvex += full_box(b"mehd", 1, 0, struct.pack(">Q", duration))
        for t in tracks:
            # all-zero trex defaults like the reference (fmp4mux/boxes.rs;
            # fmp4_tests.rs check_mvex_sanity): every trun carries explicit
            # per-sample duration/size/flags, so the fallbacks never apply
            mvex += full_box(
                b"trex",
                0,
                0,
                struct.pack(">IIIII", t.track_id, 1, 0, 0, 0),
            )
        body += box(b"mvex", mvex)
    body += extra_boxes
    return box(b"moov", body)


# ---------------------------------------------------------------------------
# Fragments
# ---------------------------------------------------------------------------
@dataclass
class FragmentSample:
    size: int
    duration: int  # track timescale
    sync: bool


@dataclass
class TrackFragment:
    track_id: int
    decode_time: int  # track timescale (tfdt baseMediaDecodeTime)
    samples: List[FragmentSample]
    data: bytes  # this track's mdat slice
    #: optional interleave runs: [(samples, data), ...] — when set, the
    #: traf carries one trun per run and the mdat lays runs out
    #: round-robin across tracks (GstFMP4Mux interleave-bytes/-time;
    #: reference fmp4mux/imp.rs:3221-3230).  samples/data above must be
    #: the concatenation of the runs.
    runs: Optional[List[Tuple[List[FragmentSample], bytes]]] = None


SAMPLE_FLAG_SYNC = 0x02000000  # sample_depends_on=2 (independent)
SAMPLE_FLAG_NON_SYNC = 0x01010000  # depends_on=1 + non_sync_sample


def moof(sequence_number: int, fragments: Sequence[TrackFragment]) -> bytes:
    """moof + mdat bytes for one fragment.

    tfhd uses default-base-is-moof (0x020000) so trun data offsets are
    relative to the moof start, like the reference
    (fmp4mux/boxes.rs tfhd flags).
    """
    mfhd = full_box(b"mfhd", 0, 0, struct.pack(">I", sequence_number))

    # per-track run lists: [(samples, data), ...] — one trun per run
    track_runs = [
        frag.runs if frag.runs is not None else [(frag.samples, frag.data)]
        for frag in fragments
    ]
    # mdat layout: round-robin across tracks so streams interleave at run
    # granularity (run 0 of every track, then run 1 of every track, ...)
    order: List[Tuple[int, int]] = []
    max_runs = max((len(r) for r in track_runs), default=0)
    for ri in range(max_runs):
        for fi, runs in enumerate(track_runs):
            if ri < len(runs):
                order.append((fi, ri))

    def _trun(samples: List[FragmentSample], off: int) -> bytes:
        # trun flags: data-offset | sample-duration | sample-size | sample-flags
        flags = 0x000001 | 0x000100 | 0x000200 | 0x000400
        entries = b"".join(
            struct.pack(
                ">III",
                s.duration,
                s.size,
                SAMPLE_FLAG_SYNC if s.sync else SAMPLE_FLAG_NON_SYNC,
            )
            for s in samples
        )
        return full_box(
            b"trun", 0, flags, struct.pack(">Ii", len(samples), off) + entries
        )

    # First pass with zero data offsets to learn the moof size.
    def build(run_offsets: dict) -> bytes:
        body = mfhd
        for fi, (frag, runs) in enumerate(zip(fragments, track_runs)):
            tfhd = full_box(b"tfhd", 0, 0x020000, struct.pack(">I", frag.track_id))
            tfdt = full_box(b"tfdt", 1, 0, struct.pack(">Q", frag.decode_time))
            truns = b"".join(
                _trun(samples, run_offsets.get((fi, ri), 0))
                for ri, (samples, _d) in enumerate(runs)
            )
            body += box(b"traf", tfhd + tfdt + truns)
        return box(b"moof", body)

    probe = build({})
    moof_size = len(probe)
    offsets, acc = {}, moof_size + 8  # + mdat header
    for fi, ri in order:
        offsets[(fi, ri)] = acc
        acc += len(track_runs[fi][ri][1])
    out = build(offsets)
    assert len(out) == moof_size
    mdat = box(b"mdat", b"".join(track_runs[fi][ri][1] for fi, ri in order))
    return out + mdat


@dataclass
class MfraEntry:
    time: int  # track timescale
    moof_offset: int  # from file start


def mfra(track_entries: Sequence[Tuple[int, List[MfraEntry]]]) -> bytes:
    """Movie fragment random access box (write-mfra property,
    fmp4mux/imp.rs DEFAULT_WRITE_MFRA)."""
    body = b""
    for track_id, entries in track_entries:
        payload = struct.pack(">I", track_id) + struct.pack(">I", 0)  # all lengths 1 byte
        payload += struct.pack(">I", len(entries))
        for e in entries:
            payload += struct.pack(">QQ", e.time, e.moof_offset) + bytes([1, 1, 1])
        body += full_box(b"tfra", 1, 0, payload)
    total = len(body) + 8 + 16  # + mfra hdr + mfro
    body += full_box(b"mfro", 0, 0, struct.pack(">I", total))
    return box(b"mfra", body)


__all__ = [
    "box",
    "full_box",
    "ftyp",
    "styp",
    "moov",
    "moof",
    "mfra",
    "MfraEntry",
    "pcm_sample_entry",
    "uncv_sample_entry",
    "TrackConfig",
    "SampleTable",
    "TrackFragment",
    "FragmentSample",
]


# ---------------------------------------------------------------------------
# ISO/IEC 23001-17 TAI timestamps + ONVIF export (reference
# isobmff/precision_timestamps.rs and boxes.rs write_cstb/write_onvif_metabox)
# ---------------------------------------------------------------------------
TAIC_TIME_UNCERTAINTY_UNKNOWN = 0xFFFFFFFFFFFFFFFF
TAIC_CLOCK_DRIFT_RATE_UNKNOWN = 0x7FFFFFFF
TAIC_CLOCK_TYPES = {"unknown": 0, "can-sync": 1, "cannot-sync": 2}

#: 100 ns units between 1601-01-01 and the unix epoch (boxes.rs UNIX_1601_OFFSET)
UNIX_1601_OFFSET_S = 11_644_473_600


def taic_box(
    time_uncertainty: int = TAIC_TIME_UNCERTAINTY_UNKNOWN,
    clock_resolution: int = 1000,
    clock_drift_rate: int = TAIC_CLOCK_DRIFT_RATE_UNKNOWN,
    clock_type: str = "unknown",
) -> bytes:
    """TAI Clock Information box (precision_timestamps.rs write_taic_box)."""
    payload = struct.pack(
        ">QIiB",
        time_uncertainty,
        clock_resolution,
        clock_drift_rate if clock_drift_rate <= 0x7FFFFFFF else TAIC_CLOCK_DRIFT_RATE_UNKNOWN,
        (TAIC_CLOCK_TYPES.get(clock_type, 0) & 0x3) << 6,
    )
    return full_box(b"taic", 0, 0, payload)


def append_to_sample_entry(entry: bytes, child: bytes) -> bytes:
    """Appends a child box inside a finished sample-entry blob."""
    size = struct.unpack(">I", entry[:4])[0]
    assert size == len(entry), "compact sample entry expected"
    out = struct.pack(">I", size + len(child)) + entry[4:] + child
    return out


def onvif_meta_box(start_utc_ns: int) -> bytes:
    """moov-level meta box with the ONVIF Correct Start Time box
    (boxes.rs write_onvif_metabox/write_cstb): hdlr 'null' + cstb with
    track id 0 and UTC start in 100 ns units since 1601-01-01."""
    hdlr = full_box(
        b"hdlr",
        0,
        0,
        struct.pack(">I4s", 0, b"null") + b"\x00" * 12 + b"MetadataHandler\x00",
    )
    start_1601 = start_utc_ns // 100 + UNIX_1601_OFFSET_S * 10_000_000
    cstb = full_box(b"cstb", 0, 0, struct.pack(">IIQ", 1, 0, start_1601))
    return full_box(b"meta", 0, 0, hdlr + cstb)


def flac_sample_entry(channels: int, rate: int, streaminfo_body: bytes) -> bytes:
    """'fLaC' sample entry with the dfLa box (reference isobmff/flac.rs):
    dfLa = FullBox(version 0) + METADATA_BLOCK_STREAMINFO with the
    last-metadata-block flag set."""
    block = bytes([0x80]) + struct.pack(">I", len(streaminfo_body))[1:] + streaminfo_body
    dfla = full_box(b"dfLa", 0, 0, block)
    return box(b"fLaC", _audio_entry_body(channels, rate, dfla))
