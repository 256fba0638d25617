"""RTP payloader / depayloader elements.

Parity targets: reference net/rtp base classes RtpBasePay2 / RtpBaseDepay2
(net/rtp/src/basepay/imp.rs 2223 LoC, basedepay/) and the codec-free pairs:
- rtppcmapay2/rtppcmupay2 + depay (RFC 3551 G.711, pcmau/pay/imp.rs:37-59)
- rtpL8pay2/rtpL16pay2 + depay (RFC 3551 linear audio,
  linear_audio/pay/imp.rs:60-108; L16 is big-endian on the wire)
- rtpklvpay2/rtpklvdepay2 (RFC 6597 SMPTE 336 KLV metadata, klv/)

Base-class semantics kept from the reference: mtu-bounded packetization
(default_mtu = 1200, basepay/imp.rs:1847), pt/ssrc/timestamp-offset/
seqnum-offset properties with random defaults, RTP time = offset +
pts * clock-rate, marker bit per subclass, seqnum-gap -> DISCONT on depay.

Packets are host bytes: a payloader reads a payload on the device back once
(core/payload.py), and depayloaders emit host numpy arrays, which a decoder
behind them (alawdec, mulawdec) moves to its device.
"""
from __future__ import annotations

import random
from collections import deque
from typing import List, Optional

import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    BufferFlags,
    Caps,
    IntRange,
    PadDirection,
    Prop,
    SECOND,
    TransformMode,
    register,
)
from ...core.buffer import Meta
from ...core.payload import host_array, host_bytes
from ...core.caps import Structure
from ...net.rtp import (
    KNOWN_EXTENSIONS,
    RtpPacket,
    SeqnumTracker,
    TimestampTracker,
    build_onebyte_extensions,
    parse_onebyte_extensions,
)

U32 = 0xFFFFFFFF
U16 = 0xFFFF
RTP_CAPS = Caps([Structure("application/x-rtp")])


class RtpSourceMeta(Meta):
    """GstRTPSourceMeta analog: RTP source info (ssrc + csrcs) carried as
    buffer metadata when `source-info` is enabled (reference basepay/
    basedepay `source-info` property)."""

    api = "rtp-source"

    def __init__(self, ssrc: Optional[int], csrcs: tuple = ()):
        self.ssrc = ssrc
        self.csrcs = tuple(csrcs)


class RtpBasePay(BaseTransform):
    """Payloader base: input media buffers -> application/x-rtp packet buffers."""

    MODE = TransformMode.NEVER_IN_PLACE
    SRC_CAPS = RTP_CAPS
    DEFAULT_PT = 96
    PROPERTIES = [
        Prop("mtu", 1200, type="uint", minimum=28, doc="max total packet size (basepay default_mtu)"),
        Prop("pt", -1, type="int", minimum=-1, maximum=127, doc="-1 = class default"),
        Prop("ssrc", -1, type="int", minimum=-1, maximum=U32, doc="-1 = random"),
        Prop("timestamp-offset", -1, type="int", minimum=-1, maximum=U32, doc="-1 = random"),
        Prop("seqnum-offset", -1, type="int", minimum=-1, maximum=U16, doc="-1 = random"),
        # GstRtpBasePay2 base surface (basepay/imp.rs:1969-2020)
        Prop("onvif-no-rate-control", False, type="bool", mutable="playing",
             doc="ONVIF Rate-Control=no timestamping mode: RTP time follows "
                 "unscaled stream time under non-1.0 segment rates"),
        Prop("scale-rtptime", True, type="bool", mutable="playing",
             doc="whether the RTP timestamp is scaled with the segment rate "
                 "(speed); false for ONVIF replay without rate control"),
        Prop("source-info", False, type="bool", mutable="playing",
             doc="read RtpSourceMeta from input buffers to set ssrc/csrcs"),
        Prop("auto-header-extension", True, type="bool", mutable="playing",
             doc="auto-enable known header extensions from caps extmap-N"),
        Prop("extensions", None, type="object", mutable="playing",
             doc="list of enabled RtpHeaderExtension objects"),
        Prop("seqnum", 0, type="uint", maximum=U16,
             doc="read-only: RTP sequence number of the last packet"),
        Prop("timestamp", 0, type="uint", maximum=U32,
             doc="read-only: RTP timestamp of the last packet"),
        Prop("stats", None, type="object",
             doc="read-only: application/x-rtp-payload-stats structure"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._packets: deque = deque()
        self.clock_rate = 0
        self._seqnum = 0
        self._ssrc = 0
        self._ts_base = 0
        self._last_seqnum = 0
        self._last_rtptime = 0
        self._last_running_time: Optional[int] = None
        self._auto_extensions: List = []

    # read-only computed properties (the reference's create_stats,
    # basepay/imp.rs:1805-1817 + seqnum/timestamp getters)
    def get_property(self, name: str):
        if name == "seqnum":
            return self._last_seqnum
        if name == "timestamp":
            return self._last_rtptime
        if name == "stats":
            return {
                "name": "application/x-rtp-payload-stats",
                "ssrc": self._ssrc,
                "clock-rate": self.clock_rate,
                "running-time": self._last_running_time,
                "seqnum": self._last_seqnum,
                "timestamp": self._last_rtptime,
                "pt": self.pt(),
                "seqnum-offset": self.get_property("seqnum-offset"),
                "timestamp-offset": self._ts_base,
            }
        return super().get_property(name)

    def _enabled_extensions(self) -> List:
        exts = self.get_property("extensions") or []
        return list(exts) + self._auto_extensions

    # -- subclass hooks ------------------------------------------------------
    def rtp_structure(self, s: Structure) -> Structure:
        """Map fixed sink caps structure -> application/x-rtp structure."""
        raise NotImplementedError

    def handle_buffer(self, buf: Buffer) -> None:
        """Convert one input buffer into queue_packet() calls."""
        raise NotImplementedError

    # -- negotiation ----------------------------------------------------------
    def pt(self) -> int:
        p = self.get_property("pt")
        return self.DEFAULT_PT if p < 0 else p

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        if direction == PadDirection.SINK:
            if caps.is_any():
                out = RTP_CAPS.copy()
            else:
                structs = []
                for s in caps.structures:
                    if s.is_fixed():
                        r = self.rtp_structure(s)
                        r["payload"] = self.pt()
                        structs.append(r)
                    else:
                        structs.append(Structure("application/x-rtp"))
                out = Caps(structs)
        else:
            out = self.SINK_CAPS.copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        self.clock_rate = outcaps.structure(0)["clock-rate"]
        # auto-header-extension: instantiate known implementations from
        # caps `extmap-N` URI fields (basepay auto_header_extensions)
        self._auto_extensions = []
        if self.get_property("auto-header-extension"):
            enabled_ids = {e.id for e in (self.get_property("extensions") or [])}
            s = outcaps.structure(0)
            for key, val in s.fields.items():
                if key.startswith("extmap-") and key[7:].isdigit():
                    ext_id = int(key[7:])
                    cls = KNOWN_EXTENSIONS.get(str(val))
                    if cls is not None and ext_id not in enabled_ids:
                        self._auto_extensions.append(cls(ext_id))

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._packets.clear()
        ssrc = self.get_property("ssrc")
        self._ssrc = random.getrandbits(32) if ssrc < 0 else ssrc
        seq = self.get_property("seqnum-offset")
        self._seqnum = random.getrandbits(16) if seq < 0 else seq
        ts = self.get_property("timestamp-offset")
        self._ts_base = random.getrandbits(32) if ts < 0 else ts
        self._last_seqnum = self._seqnum
        self._last_rtptime = self._ts_base
        self._last_running_time = None
        self._current_input: Optional[Buffer] = None

    # -- packet production -------------------------------------------------------
    def rtp_time(self, pts: Optional[int]) -> int:
        base = self._ts_base
        if pts is None:
            return base & U32
        rate = abs(self.segment.rate) if self.segment is not None else 1.0
        if rate != 1.0 and (self.get_property("scale-rtptime")
                            and not self.get_property("onvif-no-rate-control")):
            # RTP time follows running time (scaled by 1/rate) so receivers
            # play at the trick-mode speed; with Rate-Control=no (ONVIF
            # replay) it follows unscaled stream time instead
            pts = int(pts / rate)
        return (base + pts * self.clock_rate // SECOND) & U32

    def queue_packet(
        self,
        payload: bytes,
        *,
        pts: Optional[int],
        duration: Optional[int] = None,
        marker: bool = False,
    ) -> None:
        ssrc, csrcs = self._ssrc, ()
        src_buf = self._current_input
        if self.get_property("source-info") and src_buf is not None:
            meta = src_buf.get_meta(RtpSourceMeta)
            if meta is not None:
                csrcs = meta.csrcs
                if meta.ssrc is not None:
                    ssrc = meta.ssrc
        extension = None
        ext_items = {}
        for ext in self._enabled_extensions():
            data = ext.write(src_buf)
            if data:
                ext_items[ext.id] = data
        if ext_items:
            extension = build_onebyte_extensions(ext_items)
        rtptime = self.rtp_time(pts)
        pkt = RtpPacket(
            payload_type=self.pt(),
            sequence_number=self._seqnum,
            timestamp=rtptime,
            ssrc=ssrc,
            payload=payload,
            marker=marker,
            csrcs=csrcs,
            extension=extension,
        )
        self._last_seqnum = self._seqnum
        self._last_rtptime = rtptime
        if pts is not None and self.segment is not None:
            self._last_running_time = self.segment.to_running_time(pts)
        self._seqnum = (self._seqnum + 1) & U16
        self._packets.append(
            Buffer(np.frombuffer(pkt.to_bytes(), np.uint8), pts=pts, duration=duration)
        )

    def max_payload_size(self) -> int:
        return self.get_property("mtu") - 12

    def generate_output(self) -> Optional[Buffer]:
        if not self._packets:
            buf = self.take_queued_buffer()
            if buf is None:
                return None
            self._current_input = buf
            self.handle_buffer(buf)
        return self._packets.popleft() if self._packets else None


AGGREGATE_PROPS = [
    Prop("aggregate-mode", "auto", type="enum",
         choices=["auto", "zero-latency", "aggregate"],
         doc="whether multiple frames share one packet: zero-latency "
             "sends each frame immediately, aggregate packs frames until "
             "mtu/max-ptime; auto resolves to zero-latency here (the "
             "live-safe choice — the reference aggregates for non-live "
             "sessions)"),
    Prop("max-ptime", -1, type="int", minimum=-1,
         doc="maximum duration (ns) of media per packet when aggregating "
             "(-1 = bound by mtu only)"),
]


class RtpAggregateMixin:
    """Frame aggregation for payloaders whose wire format packs several
    complete frames per packet (RFC 4184 AC-3, RFC 2250 MPA, RFC 3640,
    RFC 4867).  Subclasses implement flush_frames(frames) -> queue_packet
    calls and call aggregate_frame() from handle_buffer."""

    def __init__(self, name=None):
        super().__init__(name)
        self._agg: List[tuple] = []  # (frame_bytes, pts, duration)

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._agg = []

    def _aggregating(self) -> bool:
        return self.get_property("aggregate-mode") == "aggregate"

    def flush_frames(self, frames: List[tuple]) -> None:
        raise NotImplementedError

    def _agg_flush(self) -> None:
        if self._agg:
            frames, self._agg = self._agg, []
            self.flush_frames(frames)

    def aggregate_frame(self, frame: bytes, pts, duration,
                        per_frame_overhead: int = 0,
                        base_overhead: int = 0) -> None:
        if not self._aggregating():
            self.flush_frames([(frame, pts, duration)])
            return
        maxp = self.max_payload_size() - base_overhead
        size = sum(len(f) + per_frame_overhead for f, _, _ in self._agg)
        dur = sum(d or 0 for _, _, d in self._agg)
        max_ptime = self.get_property("max-ptime")
        if self._agg and (
                size + len(frame) + per_frame_overhead > maxp
                or (max_ptime >= 0 and dur + (duration or 0) > max_ptime)):
            self._agg_flush()
        self._agg.append((frame, pts, duration))
        size = sum(len(f) + per_frame_overhead for f, _, _ in self._agg)
        dur = sum(d or 0 for _, _, d in self._agg)
        if size >= maxp or (max_ptime >= 0 and dur >= max_ptime):
            self._agg_flush()

    def drain(self) -> Optional[Buffer]:
        """EOS: flush pending aggregation. All but the last flushed packet
        push directly (drain's contract returns one residue buffer)."""
        self._agg_flush()
        while len(self._packets) > 1:
            self.srcpad.push(self._packets.popleft())
        return self._packets.popleft() if self._packets else None


class RtpBaseAudioPay(RtpBasePay):
    """Audio payloader: accumulates constant-bpf media and emits full
    MTU/max-ptime-bounded packets, keeping the remainder queued until more
    data, a discont, or EOS (reference baseaudiopay/imp.rs queueing +
    audio_discont.rs alignment).

    Base surface parity: GstRtpBaseAudioPay2 — min-ptime/max-ptime/
    ptime-multiple (baseaudiopay/imp.rs:96-122) and the audio-discont
    alignment-threshold/discont-wait pair (audio_discont.rs:136-143)."""

    BPF_FROM_CAPS = True  # bpf = bytes-per-frame of the wire format
    PROPERTIES = [
        Prop("max-ptime", -1, type="int", minimum=-1,
             doc="max packet duration ns (-1 = unlimited up to MTU)"),
        Prop("min-ptime", 0, type="int", minimum=0, mutable="playing",
             doc="min packet duration ns (can't go above MTU)"),
        Prop("ptime-multiple", 0, type="int", minimum=0, mutable="playing",
             doc="force packet durations to multiples of this ns (0 = off)"),
        Prop("alignment-threshold", 40_000_000, type="int", minimum=0,
             mutable="playing",
             doc="PTS deviation (ns) from the expected continuous position "
                 "tolerated before a resync is considered"),
        Prop("discont-wait", 1_000_000_000, type="int", minimum=0,
             mutable="playing",
             doc="how long (ns) the deviation must persist before resyncing"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc = bytearray()
        self._acc_pts: Optional[int] = None  # pts of the first queued frame
        self._acc_off = 0  # frames already emitted from _acc_pts
        self._next_pts: Optional[int] = None  # expected pts of next input
        self._deviating_since: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._acc = bytearray()
        self._acc_pts = None
        self._acc_off = 0
        self._next_pts = None
        self._deviating_since = None

    def bpf(self) -> int:
        raise NotImplementedError

    def payload_bytes(self, buf: Buffer) -> bytes:
        """Wire-format bytes for the buffer's payload."""
        raise NotImplementedError

    def _frames_ns(self, n: int) -> int:
        return n * SECOND // self.clock_rate

    def _packet_frames(self) -> int:
        """Frames per full packet: MTU-bounded, capped by max-ptime,
        rounded to ptime-multiple."""
        n = max(self.max_payload_size() // self.bpf(), 1)
        max_ptime = self.get_property("max-ptime")
        if max_ptime >= 0:
            n = min(n, max(max_ptime * self.clock_rate // SECOND, 1))
        mult = self.get_property("ptime-multiple")
        if mult > 0:
            mf = max(mult * self.clock_rate // SECOND, 1)
            n = max(n - n % mf, mf)
        return int(n)

    def _emit(self, final: bool) -> None:
        bpf = self.bpf()
        per_packet = self._packet_frames()
        min_frames = self.get_property("min-ptime") * self.clock_rate // SECOND
        while True:
            avail = len(self._acc) // bpf
            if avail <= 0:
                break
            n = min(per_packet, avail)
            if not final and (n < per_packet or n < min_frames):
                break  # wait for more data (remainder stays queued)
            pts = None
            if self._acc_pts is not None:
                pts = self._acc_pts + self._frames_ns(self._acc_off)
            self.queue_packet(bytes(self._acc[:n * bpf]), pts=pts,
                              duration=self._frames_ns(n))
            del self._acc[:n * bpf]
            self._acc_off += n

    def _resync(self) -> None:
        self._emit(final=True)
        self._acc_pts = None
        self._acc_off = 0
        self._deviating_since = None

    def handle_buffer(self, buf: Buffer) -> None:
        data = self.payload_bytes(buf)
        bpf = self.bpf()
        if buf.has_flag(BufferFlags.DISCONT):
            self._resync()
        elif buf.pts is not None and self._next_pts is not None:
            diff = abs(buf.pts - self._next_pts)
            if diff >= self.get_property("alignment-threshold"):
                wait = self.get_property("discont-wait")
                if self._deviating_since is None:
                    self._deviating_since = buf.pts
                if wait == 0 or abs(buf.pts - self._deviating_since) >= wait:
                    self._resync()
            else:
                self._deviating_since = None
        if self._acc_pts is None and buf.pts is not None:
            self._acc_pts = buf.pts
            self._acc_off = 0
        self._acc += data
        if buf.pts is not None:
            self._next_pts = buf.pts + self._frames_ns(len(data) // bpf)
        self._emit(final=False)

    def drain(self) -> Optional[Buffer]:
        """EOS: flush the queued remainder; all but the last packet push
        directly (drain's contract returns one residue buffer)."""
        self._emit(final=True)
        while len(self._packets) > 1:
            self.srcpad.push(self._packets.popleft())
        return self._packets.popleft() if self._packets else None


class RtpBaseDepay(BaseTransform):
    """Depayloader base: application/x-rtp packets -> media buffers.

    Base surface parity: GstRtpBaseDepay2 (basedepay/imp.rs:1955-1990) —
    max-reorder restart detection, source-info meta, header extensions,
    read-only stats."""

    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = RTP_CAPS
    PROPERTIES = [
        Prop("max-reorder", 100, type="uint", maximum=0x7FFF, mutable="playing",
             doc="max seqnum reorder before assuming the sender restarted"),
        Prop("source-info", False, type="bool", mutable="playing",
             doc="attach RtpSourceMeta (ssrc/csrcs) to output buffers"),
        Prop("auto-header-extension", True, type="bool", mutable="playing",
             doc="auto-enable known header extensions from caps extmap-N"),
        Prop("extensions", None, type="object", mutable="playing",
             doc="list of enabled RtpHeaderExtension objects"),
        Prop("stats", None, type="object",
             doc="read-only: application/x-rtp-depayload-stats structure"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.clock_rate = 0
        self._seq = SeqnumTracker()
        self._ts = TimestampTracker()
        self._first_ext_ts: Optional[int] = None
        self._auto_extensions: List = []
        self._last_ssrc: Optional[int] = None
        self._last_seqnum = 0
        self._last_rtptime = 0

    def get_property(self, name: str):
        if name == "stats":
            return {
                "name": "application/x-rtp-depayload-stats",
                "ssrc": self._last_ssrc,
                "clock-rate": self.clock_rate,
                "seqnum": self._last_seqnum,
                "timestamp": self._last_rtptime,
                "npt-start": None, "npt-stop": None,
                "play-speed": 1.0, "play-scale": 1.0,
            }
        return super().get_property(name)

    def _enabled_extensions(self) -> List:
        exts = self.get_property("extensions") or []
        return list(exts) + self._auto_extensions

    # -- subclass hooks -------------------------------------------------------
    def media_structure(self, s: Structure) -> Structure:
        """Map fixed application/x-rtp structure -> output media structure."""
        raise NotImplementedError

    def depay(self, packet: RtpPacket, out: Buffer) -> Optional[Buffer]:
        """Convert one RTP packet to an output buffer (None = consumed,
        e.g. while accumulating fragments)."""
        raise NotImplementedError

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        if direction == PadDirection.SINK:
            structs = []
            for s in caps.structures:
                structs.append(self.media_structure(s) if s.is_fixed() else
                               self.SRC_CAPS.structures[0].copy())
            out = Caps(structs) if not caps.is_any() else self.SRC_CAPS.copy()
        else:
            out = RTP_CAPS.copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def set_caps(self, incaps: Caps, outcaps: Caps) -> None:
        # clock-rate is mandatory in well-formed rtp caps; tolerate its
        # absence (raw udpsrc relinks) by falling back to the 90 kHz default
        self.clock_rate = incaps.structure(0).get("clock-rate", 90000)
        self._auto_extensions = []
        if self.get_property("auto-header-extension"):
            enabled_ids = {e.id for e in (self.get_property("extensions") or [])}
            s = incaps.structure(0)
            for key, val in s.fields.items():
                if key.startswith("extmap-") and key[7:].isdigit():
                    ext_id = int(key[7:])
                    cls = KNOWN_EXTENSIONS.get(str(val))
                    if cls is not None and ext_id not in enabled_ids:
                        self._auto_extensions.append(cls(ext_id))

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._seq = SeqnumTracker()
        self._ts = TimestampTracker()
        self._first_ext_ts = None
        self._last_ssrc = None

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        pkt = RtpPacket.parse(host_bytes(inbuf.data))
        _ext, gap = self._seq.update(pkt.sequence_number)
        if abs(gap) > self.get_property("max-reorder"):
            # sender restarted (basedepay max_reorder): resynchronize the
            # seqnum/timestamp trackers on this packet instead of treating
            # the jump as a huge gap or stale reorder
            self._seq = SeqnumTracker()
            self._ts = TimestampTracker()
            self._first_ext_ts = None
            _ext, gap = self._seq.update(pkt.sequence_number)
            gap = 0  # forced discont below
        ext_ts = self._ts.update(pkt.timestamp)
        if self._first_ext_ts is None:
            self._first_ext_ts = ext_ts
        pts = inbuf.pts
        if pts is None and self.clock_rate:
            pts = (ext_ts - self._first_ext_ts) * SECOND // self.clock_rate
        out = Buffer(None, pts=pts, duration=inbuf.duration)
        if gap != 1:
            out.set_flag(BufferFlags.DISCONT)
        self._last_ssrc = pkt.ssrc
        self._last_seqnum = pkt.sequence_number
        self._last_rtptime = pkt.timestamp
        exts = self._enabled_extensions()
        if exts and pkt.extension is not None:
            items = parse_onebyte_extensions(pkt.extension)
            for ext in exts:
                if ext.id in items:
                    ext.read(items[ext.id], out)
        if self.get_property("source-info"):
            out.add_meta(RtpSourceMeta(pkt.ssrc, pkt.csrcs))
        return self.depay(pkt, out)


# ---------------------------------------------------------------------------
# G.711 PCMA / PCMU (RFC 3551; reference pcmau/)
# ---------------------------------------------------------------------------
class _PcmauPay(RtpBaseAudioPay):
    MEDIA = ""
    ENCODING = ""

    def rtp_structure(self, s: Structure) -> Structure:
        # pt 0/8 are the static 8 kHz assignments (pcmau/pay/imp.rs:66-72)
        ch = s.get("channels", 1)
        return Structure(
            "application/x-rtp",
            media="audio",
            **{"encoding-name": self.ENCODING, "clock-rate": s["rate"],
               "encoding-params": str(ch)},
        )

    def bpf(self) -> int:
        return self.in_caps.structure(0).get("channels", 1)

    def payload_bytes(self, buf: Buffer) -> bytes:
        return host_bytes(buf.data, np.uint8)


class _PcmauDepay(RtpBaseDepay):
    MEDIA = ""

    def media_structure(self, s: Structure) -> Structure:
        channels = int(s.get("encoding-params", "1"))
        return Structure(self.MEDIA, rate=s["clock-rate"], channels=channels)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        ch = self.out_caps.structure(0)["channels"]
        arr = np.frombuffer(pkt.payload, np.uint8).reshape(-1, ch)
        out.data = arr
        if out.duration is None and self.clock_rate:
            out.duration = arr.shape[0] * SECOND // self.clock_rate
        return out


@register
class RtpPcmaPay(_PcmauPay):
    ELEMENT_NAME = "rtppcmapay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload A-law audio into RTP packets (RFC 3551)"
    MEDIA = "audio/x-alaw"
    ENCODING = "PCMA"
    DEFAULT_PT = 8
    SINK_CAPS = Caps([Structure("audio/x-alaw", rate=IntRange(1, 2_822_400), channels=IntRange(1, 64))])


@register
class RtpPcmuPay(_PcmauPay):
    ELEMENT_NAME = "rtppcmupay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload mu-law audio into RTP packets (RFC 3551)"
    MEDIA = "audio/x-mulaw"
    ENCODING = "PCMU"
    DEFAULT_PT = 0
    SINK_CAPS = Caps([Structure("audio/x-mulaw", rate=IntRange(1, 2_822_400), channels=IntRange(1, 64))])


@register
class RtpPcmaDepay(_PcmauDepay):
    ELEMENT_NAME = "rtppcmadepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload A-law audio from RTP packets (RFC 3551)"
    MEDIA = "audio/x-alaw"
    SRC_CAPS = Caps([Structure("audio/x-alaw", rate=IntRange(1, 2_822_400), channels=IntRange(1, 64))])


@register
class RtpPcmuDepay(_PcmauDepay):
    ELEMENT_NAME = "rtppcmudepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload mu-law audio from RTP packets (RFC 3551)"
    MEDIA = "audio/x-mulaw"
    SRC_CAPS = Caps([Structure("audio/x-mulaw", rate=IntRange(1, 2_822_400), channels=IntRange(1, 64))])


# ---------------------------------------------------------------------------
# Linear audio L8 / L16 (RFC 3551; reference linear_audio/)
# ---------------------------------------------------------------------------
@register
class RtpL8Pay(RtpBaseAudioPay):
    ELEMENT_NAME = "rtpL8pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload 8-bit raw audio (L8) into RTP packets (RFC 3551)"
    SINK_CAPS = Caps([Structure("audio/x-raw", format="U8",
                                rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                                layout="interleaved")])

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "L8", "clock-rate": s["rate"],
               "channels": s["channels"], "encoding-params": str(s["channels"])},
        )

    def bpf(self) -> int:
        return self.in_caps.structure(0)["channels"]

    def payload_bytes(self, buf: Buffer) -> bytes:
        return host_bytes(buf.data, np.uint8)


@register
class RtpL16Pay(RtpBaseAudioPay):
    ELEMENT_NAME = "rtpL16pay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload 16-bit raw audio (L16) into RTP packets (RFC 3551)"
    # reference takes S16BE (linear_audio/pay/imp.rs:74); payloads here are
    # native [frames, ch] int16 arrays, byte-swapped to network order on the wire
    SINK_CAPS = Caps([Structure("audio/x-raw", format="S16",
                                rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                                layout="interleaved")])

    def rtp_structure(self, s: Structure) -> Structure:
        # pt 10/11 are the static 44.1 kHz stereo/mono assignments
        # (linear_audio/pay/imp.rs:82-101)
        return Structure(
            "application/x-rtp", media="audio",
            **{"encoding-name": "L16", "clock-rate": s["rate"],
               "channels": s["channels"], "encoding-params": str(s["channels"])},
        )

    def bpf(self) -> int:
        return 2 * self.in_caps.structure(0)["channels"]

    def payload_bytes(self, buf: Buffer) -> bytes:
        return host_array(buf.data).astype(">i2").tobytes()


@register
class RtpL8Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpL8depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload 8-bit raw audio (L8) from RTP packets"
    SRC_CAPS = Caps([Structure("audio/x-raw", format="U8",
                               rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                               layout="interleaved")])

    def media_structure(self, s: Structure) -> Structure:
        ch = int(s.get("encoding-params", s.get("channels", 1)))
        return Structure("audio/x-raw", format="U8", rate=s["clock-rate"],
                         channels=ch, layout="interleaved")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        ch = self.out_caps.structure(0)["channels"]
        out.data = np.frombuffer(pkt.payload, np.uint8).reshape(-1, ch)
        return out


@register
class RtpL16Depay(RtpBaseDepay):
    ELEMENT_NAME = "rtpL16depay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload 16-bit raw audio (L16) from RTP packets"
    SRC_CAPS = Caps([Structure("audio/x-raw", format="S16",
                               rate=IntRange(1, 2_822_400), channels=IntRange(1, 64),
                               layout="interleaved")])

    def media_structure(self, s: Structure) -> Structure:
        ch = int(s.get("encoding-params", s.get("channels", 1)))
        return Structure("audio/x-raw", format="S16", rate=s["clock-rate"],
                         channels=ch, layout="interleaved")

    def depay(self, pkt: RtpPacket, out: Buffer) -> Buffer:
        ch = self.out_caps.structure(0)["channels"]
        out.data = np.frombuffer(pkt.payload, ">i2").astype(np.int16).reshape(-1, ch)
        return out


# ---------------------------------------------------------------------------
# KLV metadata (RFC 6597; reference klv/)
# ---------------------------------------------------------------------------
KLV_CAPS = Caps([Structure("meta/x-klv", parsed=True)])


@register
class RtpKlvPay(RtpBasePay):
    ELEMENT_NAME = "rtpklvpay2"
    ELEMENT_CLASS = "Codec/Payloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Payload KLV metadata into RTP packets (RFC 6597)"
    SINK_CAPS = KLV_CAPS

    def rtp_structure(self, s: Structure) -> Structure:
        return Structure(
            "application/x-rtp", media="application",
            **{"encoding-name": "SMPTE336M", "clock-rate": 90000},
        )

    def handle_buffer(self, buf: Buffer) -> None:
        data = host_bytes(buf.data, np.uint8)
        maxp = self.max_payload_size()
        # fragment one KLV unit across packets; marker on the last fragment
        # (RFC 6597 §4.2)
        for pos in range(0, len(data), maxp):
            chunk = data[pos : pos + maxp]
            self.queue_packet(
                chunk, pts=buf.pts, duration=buf.duration,
                marker=pos + maxp >= len(data),
            )


@register
class RtpKlvDepay(RtpBaseDepay):
    ELEMENT_NAME = "rtpklvdepay2"
    ELEMENT_CLASS = "Codec/Depayloader/Network/RTP"
    ELEMENT_DESCRIPTION = "Depayload KLV metadata from RTP packets (RFC 6597)"
    SRC_CAPS = KLV_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._acc: List[bytes] = []
        self._acc_pts: Optional[int] = None
        self._broken = False

    def media_structure(self, s: Structure) -> Structure:
        return Structure("meta/x-klv", parsed=True)

    def depay(self, pkt: RtpPacket, out: Buffer) -> Optional[Buffer]:
        if out.has_flag(BufferFlags.DISCONT):
            # lost a fragment: drop the partial unit (reference klv/depay)
            self._acc.clear()
            self._broken = True
        if not self._acc:
            self._acc_pts = out.pts
        self._acc.append(pkt.payload)
        if not pkt.marker:
            return None
        if self._broken:
            self._acc.clear()
            self._broken = False
            return None
        data = b"".join(self._acc)
        self._acc.clear()
        out.data = np.frombuffer(data, np.uint8)
        out.pts = self._acc_pts
        return out


__all__ = [
    "RtpBasePay", "RtpBaseAudioPay", "RtpBaseDepay",
    "RtpPcmaPay", "RtpPcmuPay", "RtpPcmaDepay", "RtpPcmuDepay",
    "RtpL8Pay", "RtpL16Pay", "RtpL8Depay", "RtpL16Depay",
    "RtpKlvPay", "RtpKlvDepay",
]
