"""ISO-BMFF box parser: the independent oracle for the muxer tests and the
base for future demuxing.

Written against ISO/IEC 14496-12 directly (NOT the writer in bmff.py) so a
round-trip test actually checks conformance: it walks the box tree, decodes
the sample tables (stts/stsc/stsz/stco) and fragment runs (tfhd/tfdt/trun),
and re-extracts the original sample payloads — the analog of the reference's
tests re-reading muxer output (mux/isobmff tests drive pipelines back
through qtdemux).
"""
from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


def _graceful(fn):
    """Malformed input raises ValueError, never an internal error type.

    Box payloads are untrusted bytes: a file that parses as a box tree can
    still carry short/missing sub-boxes, so downstream struct.unpack and
    attribute access on find() results become ValueError here (the contract
    tests/test_parser_robustness.py pins)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (struct.error, AttributeError, IndexError, TypeError) as e:
            raise ValueError(f"corrupt mp4 structure: {e}") from None

    return wrapper

CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"mvex", b"moof", b"traf",
    b"dinf", b"edts", b"mfra", b"udta", b"mdhd_children",
    # restricted-scheme wrapper (generically-compressed video, 23001-17
    # Amd.2: rinf{frma, schm, schi{cmpC}})
    b"rinf", b"schi",
}


@dataclass
class BoxNode:
    type: bytes
    start: int  # absolute offset of the box header in the file
    size: int
    payload: bytes = b""
    children: List["BoxNode"] = field(default_factory=list)

    def find(self, *path: bytes) -> Optional["BoxNode"]:
        node = self
        for p in path:
            node = next((c for c in node.children if c.type == p), None)
            if node is None:
                return None
        return node

    def find_all(self, t: bytes) -> List["BoxNode"]:
        return [c for c in self.children if c.type == t]


def parse_boxes(data: bytes, start: int = 0, end: Optional[int] = None) -> List[BoxNode]:
    end = len(data) if end is None else end
    out: List[BoxNode] = []
    pos = start
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        hdr = 8
        if size == 1:
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            raise ValueError(f"corrupt box {typ!r} at {pos}: size {size}")
        node = BoxNode(typ, pos, size)
        if typ in CONTAINERS:
            node.children = parse_boxes(data, pos + hdr, pos + size)
        else:
            node.payload = data[pos + hdr : pos + size]
        out.append(node)
        pos += size
    return out


def _full(payload: bytes) -> Tuple[int, int, bytes]:
    return payload[0], int.from_bytes(payload[1:4], "big"), payload[4:]


# ---------------------------------------------------------------------------
# Decoded views
# ---------------------------------------------------------------------------
@dataclass
class TrackInfo:
    track_id: int
    timescale: int
    handler: str
    sample_entry_type: str
    duration: int  # mdhd units
    width: int = 0
    height: int = 0
    channels: int = 0
    # non-fragmented sample layout
    sample_sizes: List[int] = field(default_factory=list)
    sample_durations: List[int] = field(default_factory=list)
    sample_offsets: List[int] = field(default_factory=list)  # absolute file offsets
    sync_samples: Optional[List[int]] = None  # 1-based, None = all sync


def _decode_stbl(stbl: BoxNode, track: TrackInfo) -> None:
    stsd = stbl.find(b"stsd")
    _v, _f, rest = _full(stsd.payload)
    (count,) = struct.unpack_from(">I", rest, 0)
    if count < 1:
        raise ValueError("empty stsd")
    entry_size, entry_type = struct.unpack_from(">I4s", rest, 4)
    track.sample_entry_type = entry_type.decode("latin1")
    entry = rest[12:]
    if track.handler == "soun":
        track.channels = struct.unpack_from(">H", entry, 16)[0]
    elif track.handler == "vide":
        track.width, track.height = struct.unpack_from(">HH", entry, 24)

    _v, _f, stts = _full(stbl.find(b"stts").payload)
    (n,) = struct.unpack_from(">I", stts, 0)
    for i in range(n):
        c, d = struct.unpack_from(">II", stts, 4 + 8 * i)
        track.sample_durations.extend([d] * c)

    _v, _f, stsz = _full(stbl.find(b"stsz").payload)
    const_size, n = struct.unpack_from(">II", stsz, 0)
    if const_size:
        track.sample_sizes = [const_size] * n
    else:
        track.sample_sizes = list(struct.unpack_from(f">{n}I", stsz, 8))

    _v, _f, stsc = _full(stbl.find(b"stsc").payload)
    (n,) = struct.unpack_from(">I", stsc, 0)
    stsc_entries = [struct.unpack_from(">III", stsc, 4 + 12 * i) for i in range(n)]

    co = stbl.find(b"stco") or stbl.find(b"co64")
    _v, _f, cop = _full(co.payload)
    (n,) = struct.unpack_from(">I", cop, 0)
    fmt = ">I" if co.type == b"stco" else ">Q"
    width = 4 if co.type == b"stco" else 8
    chunk_offsets = [struct.unpack_from(fmt, cop, 4 + width * i)[0] for i in range(n)]

    # expand stsc over the chunk list into per-sample absolute offsets
    samples_per_chunk = []
    for i, (first, spc, _desc) in enumerate(stsc_entries):
        last = stsc_entries[i + 1][0] - 1 if i + 1 < len(stsc_entries) else len(chunk_offsets)
        samples_per_chunk.extend([spc] * (last - first + 1))
    si = 0
    for chunk_i, off in enumerate(chunk_offsets):
        pos = off
        for _ in range(samples_per_chunk[chunk_i]):
            track.sample_offsets.append(pos)
            pos += track.sample_sizes[si]
            si += 1

    stss = stbl.find(b"stss")
    if stss is not None:
        _v, _f, p = _full(stss.payload)
        (n,) = struct.unpack_from(">I", p, 0)
        track.sync_samples = [struct.unpack_from(">I", p, 4 + 4 * i)[0] for i in range(n)]


@_graceful
def decode_tracks(tree: List[BoxNode]) -> List[TrackInfo]:
    moov = next((b for b in tree if b.type == b"moov"), None)
    if moov is None:
        raise ValueError("no moov box")
    tracks = []
    for trak in moov.find_all(b"trak"):
        _v, _f, tkhd = _full(trak.find(b"tkhd").payload)
        (track_id,) = struct.unpack_from(">I", tkhd, 8)
        mdia = trak.find(b"mdia")
        _v, _f, mdhd = _full(mdia.find(b"mdhd").payload)
        timescale, duration = struct.unpack_from(">II", mdhd, 8)
        _v, _f, hdlr = _full(mdia.find(b"hdlr").payload)
        handler = hdlr[4:8].decode("latin1")
        t = TrackInfo(track_id, timescale, handler, "", duration)
        _decode_stbl(mdia.find(b"minf", b"stbl"), t)
        tracks.append(t)
    return tracks


@_graceful
def movie_timescale(tree: List[BoxNode]) -> Tuple[int, int]:
    """(timescale, duration) from mvhd."""
    moov = next((b for b in tree if b.type == b"moov"), None)
    if moov is None:
        raise ValueError("no moov box")
    _v, _f, mvhd = _full(moov.find(b"mvhd").payload)
    return struct.unpack_from(">II", mvhd, 8)


@_graceful
def extract_samples(data: bytes, track: TrackInfo) -> bytes:
    return b"".join(
        data[off : off + size] for off, size in zip(track.sample_offsets, track.sample_sizes)
    )


# ---------------------------------------------------------------------------
# Fragmented files
# ---------------------------------------------------------------------------
@dataclass
class FragmentRun:
    sequence_number: int
    track_id: int
    decode_time: int
    sample_sizes: List[int]
    sample_durations: List[int]
    sample_sync: List[bool]
    data: bytes


@_graceful
def decode_fragments(data: bytes, tree: Optional[List[BoxNode]] = None) -> List[FragmentRun]:
    tree = parse_boxes(data) if tree is None else tree
    out: List[FragmentRun] = []
    for i, node in enumerate(tree):
        if node.type != b"moof":
            continue
        _v, _f, mfhd = _full(node.find(b"mfhd").payload)
        (seq,) = struct.unpack_from(">I", mfhd, 0)
        for traf in node.find_all(b"traf"):
            _v, tf_flags, tfhd = _full(traf.find(b"tfhd").payload)
            (track_id,) = struct.unpack_from(">I", tfhd, 0)
            base = node.start if tf_flags & 0x020000 else 0
            pos = 4
            if tf_flags & 0x1:  # base-data-offset
                (base,) = struct.unpack_from(">Q", tfhd, pos)
                pos += 8
            if tf_flags & 0x2:
                pos += 4
            default_dur = default_size = default_flags = 0
            if tf_flags & 0x8:
                (default_dur,) = struct.unpack_from(">I", tfhd, pos)
                pos += 4
            if tf_flags & 0x10:
                (default_size,) = struct.unpack_from(">I", tfhd, pos)
                pos += 4
            if tf_flags & 0x20:
                (default_flags,) = struct.unpack_from(">I", tfhd, pos)
                pos += 4
            tfdt = traf.find(b"tfdt")
            decode_time = 0
            if tfdt is not None:
                v, _f2, p = _full(tfdt.payload)
                decode_time = (
                    struct.unpack_from(">Q", p, 0)[0] if v == 1 else struct.unpack_from(">I", p, 0)[0]
                )
            for trun in traf.find_all(b"trun"):
                v, flags, p = _full(trun.payload)
                (count,) = struct.unpack_from(">I", p, 0)
                pos2 = 4
                data_offset = 0
                if flags & 0x1:
                    (data_offset,) = struct.unpack_from(">i", p, pos2)
                    pos2 += 4
                first_flags = None
                if flags & 0x4:
                    (first_flags,) = struct.unpack_from(">I", p, pos2)
                    pos2 += 4
                sizes, durs, sync = [], [], []
                for s in range(count):
                    dur, size, fl = default_dur, default_size, default_flags
                    if flags & 0x100:
                        (dur,) = struct.unpack_from(">I", p, pos2)
                        pos2 += 4
                    if flags & 0x200:
                        (size,) = struct.unpack_from(">I", p, pos2)
                        pos2 += 4
                    if flags & 0x400:
                        (fl,) = struct.unpack_from(">I", p, pos2)
                        pos2 += 4
                    if flags & 0x800:
                        pos2 += 4  # composition offset
                    if s == 0 and first_flags is not None:
                        fl = first_flags
                    sizes.append(size)
                    durs.append(dur)
                    sync.append(not (fl & 0x00010000))
                start = base + data_offset
                payload = data[start : start + sum(sizes)]
                out.append(FragmentRun(seq, track_id, decode_time, sizes, durs, sync, payload))
    return out


def box_types(data: bytes) -> List[str]:
    return [b.type.decode("latin1") for b in parse_boxes(data)]


__all__ = [
    "parse_boxes",
    "BoxNode",
    "TrackInfo",
    "decode_tracks",
    "decode_fragments",
    "extract_samples",
    "movie_timescale",
    "box_types",
    "FragmentRun",
]
