"""raptorqenc / raptorqdec: forward error correction for RTP streams.

Parity target: net/raptorq (raptorqenc/imp.rs:35-40 defaults; props
protected-packets, repair-packets, repair-window, symbol-size, mtu, pt).
Media RTP packets pass through unchanged; every `protected-packets` block
yields `repair-packets` repair packets on the `fec_0` src pad, and the
decoder reconstructs lost media packets from any sufficient subset
(systematic fountain code over GF(256), net/fountain.py — recovery
property of RFC 6330 without its precomputed tables; the repair PAYLOAD
wire format is this framework's own, documented there).

Reference behavior contract (mirrored 1:1 by tests/test_raptorq_scenarios.py
against the reference's net/raptorq/tests/raptorq.rs):

- Repair packets are real RTP packets (configured pt, own seqnum counter,
  marker on the last repair of a block) spread linearly over the
  `repair-window` (ms): repair n is scheduled at block-end running time
  + n*(repair_window/repair_packets), its pts/dts are the block-end pts
  + that delay, and its RTP timestamp advances by delay*clock-rate
  (raptorqenc/imp.rs:175-245).  With a pipeline clock the emission is
  armed on single-shot clock ids (TestClock-steppable); clockless
  pipelines emit immediately.
- The fec_0 caps carry raptor-scheme-id, the repair window in MICROseconds
  and t=symbol-size (raptorqenc/imp.rs:521-537); the decoder derives its
  block-expiry window from those caps plus `repair-window-tolerance` (ms)
  (raptorqdec/imp.rs:546-552).
- FLUSH_START cancels all pending repair timers and drops the partial
  block (test_raptorq_encoder_flush_cancels_pending_timers).
- The decoder buffers media packets and repair symbols per source block;
  when the newest media arrival time passes a block's expiration the
  block is dropped together with every media packet at or below its
  range (raptorqdec/imp.rs:110-137,387-409); `stats` reports
  recovered / buffered-media-packets / buffered-repair-packets
  (raptorqdec/imp.rs:698-712).

Repair packet RTP payload: block_seq u16 | base_seq u16 | K u8 | row u8 |
symbol_len u16 | repair symbol.  Source symbols are the full RTP packet
bytes, length-prefixed and zero-padded to the block's symbol length.

Threads: the encoder's repairs fire on the clock's thread while media flows
on the streaming thread, and the decoder's media and fec pads are fed by two
sources, each on its own thread (a UDP receiver a stream).  A lock in each
element keeps its block state whole; a repair that EOS or a flush has taken
is pushed once.
"""
from __future__ import annotations

import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.events import Segment
from ...core.payload import host_bytes
from ...net import fountain
from ...net.rtp import RtpPacket

RTP_CAPS = Caps.builder("application/x-rtp")
HDR = struct.Struct(">HHBBH")
MS = 1_000_000  # ns


@register
class RaptorqEnc(Element):
    ELEMENT_NAME = "raptorqenc"
    EXTRA_PAD_TEMPLATES = [
        ('fec_%u', 'src', 'sometimes', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Network/FEC"
    ELEMENT_DESCRIPTION = "Adds fountain-code repair packets to an RTP stream"
    PROPERTIES = [
        Prop("protected-packets", 25, type="uint", minimum=1, maximum=255,
             doc="media packets per source block (reference default 25)"),
        Prop("repair-packets", 5, type="uint", minimum=1, maximum=255),
        Prop("mtu", 1400, type="uint", minimum=1, maximum=9216,
             doc="expected upper bound on media packet size; symbols are "
                 "sized so a repair packet stays under it"),
        Prop("pt", 97, type="uint", minimum=96, maximum=127,
             doc="payload type stamped on repair packets"),
        Prop("repair-window", 50, type="uint",
             doc="ms over which a block's repair packets are spread "
                 "(reference raptorqenc/imp.rs:37, unit ms)"),
        Prop("symbol-size", 1408, type="uint", minimum=1, maximum=9216,
             doc="fountain symbol size in bytes (packets are zero-padded "
                 "to whole symbols)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.fecpad = self.add_pad(
            Pad("fec_0", PadDirection.SRC,
                PadTemplate("fec_%u", PadDirection.SRC, PadPresence.SOMETIMES, RTP_CAPS))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._block: List[Tuple[int, bytes]] = []
        self._block_seq = 0
        self._seq = 0  # repair packet RTP seqnum counter
        self._clock_rate: Optional[int] = None
        self._fec_started = False
        self._pending: List[Tuple[object, Buffer]] = []  # (clock id, buffer)
        self._lock = threading.Lock()  # guards _pending against the clock thread

    def on_ready_to_paused(self) -> None:
        self._block = []
        self._block_seq = 0
        self._seq = 0
        self._clock_rate = None
        self._fec_started = False
        self._take_pending()

    def _take_pending(self) -> List[Tuple[object, Buffer]]:
        """Unschedule every armed repair and return them."""
        with self._lock:
            pending, self._pending = self._pending, []
        for cid, _buf in pending:
            cid.unschedule()
        return pending

    def _fec_caps(self) -> Caps:
        # reference raptorqenc/imp.rs:521-537: scheme id, window ms->us, t
        return Caps.builder(
            "application/x-rtp",
            **{"raptor-scheme-id": "6",
               "repair-window": str(self.get_property("repair-window") * 1000),
               "t": str(self.get_property("symbol-size"))})

    def _start_fec_stream(self) -> None:
        if self._fec_started or self.fecpad.peer is None:
            return
        self._fec_started = True
        self.fecpad.push_event(Event.new_stream_start(f"{self.name}-fec"))
        self.fecpad.push_event(Event.new_caps(self._fec_caps()))
        self.fecpad.push_event(Event.new_segment(Segment()))

    def _push_repair(self, buf: Buffer) -> None:
        if self.fecpad.peer is not None:
            self.fecpad.push(buf)

    def _emit_repair(self, now_pts, now_rtpts: int) -> None:
        """Build the block's repair packets and spread them over the repair
        window (clock-armed when a pipeline clock exists, immediate when
        clockless).  Reference raptorqenc/imp.rs:175-245."""
        if not self._block:
            return
        k = len(self._block)
        base_seq = self._block[0][0]
        # symbol-size caps the padded symbol; actual packets may force a
        # larger one (a symbol must hold the biggest protected packet)
        symbol_len = max(len(d) for _s, d in self._block) + 2
        symbol_len = max(symbol_len,
                         min(self.get_property("symbol-size"),
                             self.get_property("mtu")))
        symbols = []
        for _seq, data in self._block:
            sym = struct.pack(">H", len(data)) + data
            symbols.append(sym + b"\x00" * (symbol_len - len(sym)))
        n_repair = self.get_property("repair-packets")
        repairs = fountain.encode_repair(
            symbols, n_repair,
            seed=self._block_seq & 0xFFFF,  # the header carries 16 bits
        )
        self._start_fec_stream()
        window_ms = self.get_property("repair-window")
        delay_step_ms = window_ms // n_repair
        pt = self.get_property("pt")
        for row, sym in enumerate(repairs):
            delay_ms = (row + 1) * delay_step_ms
            payload = HDR.pack(self._block_seq & 0xFFFF, base_seq, k, row,
                               symbol_len) + sym
            rtpts = now_rtpts
            if self._clock_rate:
                rtpts = (now_rtpts + delay_ms * self._clock_rate // 1000) & 0xFFFFFFFF
            pkt = RtpPacket(pt, self._seq & 0xFFFF, rtpts, 0, payload,
                            marker=(row == n_repair - 1)).to_bytes()
            self._seq += 1
            pts = None if now_pts is None else now_pts + delay_ms * MS
            out = Buffer(np.frombuffer(pkt, np.uint8), pts=pts, dts=pts)
            if self.clock is not None and pts is not None:
                target = self.base_time + pts

                def fire(cid, out=out):
                    with self._lock:
                        armed = any(c is cid for c, _b in self._pending)
                        self._pending = [(c, b) for c, b in self._pending
                                         if c is not cid]
                    if armed:
                        self._push_repair(out)

                cid = self.clock.new_single_shot_id(target)
                with self._lock:
                    self._pending.append((cid, out))
                cid.wait_async(fire)
            else:
                self._push_repair(out)
        self._block = []
        self._block_seq += 1

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        pkt = RtpPacket.parse(data)
        self._block.append((pkt.sequence_number, data))
        ret = self.srcpad.push(buf)
        if len(self._block) >= self.get_property("protected-packets"):
            self._emit_repair(buf.pts, pkt.timestamp)
        return ret

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            caps = event.get("caps")
            st = caps.structure(0) if caps is not None else None
            cr = st.get("clock-rate") if st is not None else None
            self._clock_rate = int(cr) if cr is not None else None
            # the fec stream's caps are announced as soon as the media
            # caps are known (reference raptorqenc/imp.rs:471,521-537)
            self._start_fec_stream()
        elif event.type == EventType.FLUSH_START:
            # cancel pending repair timers and drop the partial block
            # (test_raptorq_encoder_flush_cancels_pending_timers)
            self._take_pending()
            self._block = []
            if self.fecpad.peer is not None:
                self.fecpad.push_event(event)
        elif event.type == EventType.EOS:
            # drain: release scheduled repairs now, emit the partial block
            for _cid, out in self._take_pending():
                self._push_repair(out)
            self._emit_repair(None, 0)  # pts-less drain emits immediately
            if self.fecpad.peer is not None:
                self.fecpad.push_event(event)
        return self.srcpad.push_event(event)


class _BlockState:
    def __init__(self, k: int, symbol_len: int, base_seq: int):
        self.k = k
        self.symbol_len = symbol_len
        self.base_seq = base_seq
        self.source: Dict[int, bytes] = {}
        self.repair: Dict[int, bytes] = {}
        self.done = False


@register
class RaptorqDec(Element):
    ELEMENT_NAME = "raptorqdec"
    EXTRA_PAD_TEMPLATES = [
        ('fec_%u', 'sink', 'request', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Network/FEC"
    ELEMENT_DESCRIPTION = "Recovers lost RTP packets from fountain-code repair packets"
    PROPERTIES = [
        Prop("repair-window-tolerance", 500, type="uint",
             doc="ms tolerated beyond the sender's repair window (from the "
                 "fec caps) before a source block expires (reference "
                 "raptorqdec/imp.rs:33,546-552, unit ms)"),
        Prop("media-packets-reset-threshold", 5000, type="uint",
             doc="buffered-media-packet count that resets the decoder "
                 "(runaway fuse, reference raptorqdec/imp.rs:34,399-409); "
                 "0 = never"),
        Prop("stats", None, type="object",
             doc="(read) recovered / buffered-media-packets / "
                 "buffered-repair-packets counters"),
    ]

    def get_property(self, name: str):
        if name == "stats":
            from ...core.caps import Structure

            with self._lock:
                return Structure(
                "raptorqdec-stats",
                    **{"recovered": self.num_recovered,
                       "buffered-media-packets": len(self._seen),
                       "buffered-repair-packets": sum(
                           len(b.repair) for b in self._blocks.values()
                           if not b.done)})
        return super().get_property(name)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.fecpad = self.add_pad(
            Pad("fec_0", PadDirection.SINK,
                PadTemplate("fec_%u", PadDirection.SINK, PadPresence.REQUEST, RTP_CAPS))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, RTP_CAPS))
        )
        self.sinkpad.chain_function = self._media_chain
        self.sinkpad.event_function = lambda pad, ev: self.srcpad.push_event(ev)
        self.fecpad.chain_function = self._fec_chain
        self.fecpad.event_function = self._fec_event
        self._blocks: Dict[int, _BlockState] = {}
        self._seen: Dict[int, bytes] = {}  # seq -> packet (recent window)
        self._expirations: Dict[int, int] = {}  # block_seq -> expiry ns
        self._max_arrival: Optional[int] = None
        self._sender_window_ns: Optional[int] = None
        self.num_recovered = 0
        self._lock = threading.RLock()  # the media and fec pads' threads

    def on_ready_to_paused(self) -> None:
        self._reset()
        self._sender_window_ns = None

    def _reset(self) -> None:
        self._blocks = {}
        self._seen = {}
        self._expirations = {}
        self._max_arrival = None
        self.num_recovered = 0

    def _fec_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            caps = event.get("caps")
            st = caps.structure(0) if caps is not None else None
            rw = st.get("repair-window") if st is not None else None
            if rw is not None:
                # caps carry MICROseconds (reference raptorqdec/imp.rs:548-552)
                self._sender_window_ns = int(rw) * 1000
        return True

    def _expiry_window_ns(self) -> int:
        sender = self._sender_window_ns
        if sender is None:
            sender = 50 * MS  # encoder default window
        return sender + self.get_property("repair-window-tolerance") * MS

    def _expire_blocks(self) -> None:
        """Drop source blocks the newest media arrival has overtaken, and
        every media packet at or below their range (reference
        raptorqdec/imp.rs:110-137,387-397)."""
        if self._max_arrival is None:
            return
        for bs in [bs for bs, exp in self._expirations.items()
                   if self._max_arrival > exp]:
            blk = self._blocks.pop(bs, None)
            self._expirations.pop(bs, None)
            if blk is None:
                continue
            seq_hi = (blk.base_seq + blk.k) & 0xFFFF
            self._seen = {s: d for s, d in self._seen.items()
                          if ((seq_hi - 1 - s) & 0xFFFF) >= 0x8000}

    def _media_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._lock:
            return self._media_locked(buf)

    def _media_locked(self, buf: Buffer) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        seq = RtpPacket.parse(data).sequence_number
        # stream-restart detection: a seq jump past the threshold resets
        # the decoder state instead of poisoning pending blocks
        thr = self.get_property("media-packets-reset-threshold")
        last = getattr(self, "_last_seq", None)
        if thr and last is not None:
            dist = (seq - last) & 0xFFFF
            if thr < dist < 0x8000:
                self._reset()
        self._last_seq = seq
        self._seen[seq] = data
        ts = buf.dts if buf.dts is not None else buf.pts
        if ts is not None:
            self._max_arrival = ts if self._max_arrival is None \
                else max(self._max_arrival, ts)
        # register into any block covering this seq
        for blk in self._blocks.values():
            idx = (seq - blk.base_seq) & 0xFFFF
            if idx < blk.k:
                sym = struct.pack(">H", len(data)) + data
                blk.source[idx] = sym + b"\x00" * (blk.symbol_len - len(sym))
        self._expire_blocks()
        # runaway fuse (reference raptorqdec/imp.rs:399-409)
        if thr and len(self._seen) >= thr:
            self._reset()
        return self.srcpad.push(buf)

    def _fec_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        with self._lock:
            return self._fec_locked(buf)

    def _fec_locked(self, buf: Buffer) -> FlowReturn:
        pkt = RtpPacket.parse(host_bytes(buf.data, np.uint8))
        payload = pkt.payload
        block_seq, base_seq, k, row, symbol_len = HDR.unpack_from(payload)
        blk = self._blocks.get(block_seq)
        if blk is None:
            blk = _BlockState(k, symbol_len, base_seq)
            # backfill sources already seen
            for i in range(k):
                seq = (base_seq + i) & 0xFFFF
                if seq in self._seen:
                    data = self._seen[seq]
                    sym = struct.pack(">H", len(data)) + data
                    blk.source[i] = sym + b"\x00" * (symbol_len - len(sym))
            self._blocks[block_seq] = blk
        if self._max_arrival is not None:
            exp = self._max_arrival + self._expiry_window_ns()
            prev = self._expirations.get(block_seq)
            self._expirations[block_seq] = exp if prev is None else min(prev, exp)
        blk.repair[row] = payload[HDR.size:]
        self._try_recover(blk)
        return FlowReturn.OK

    def _try_recover(self, blk: _BlockState) -> None:
        if blk.done or len(blk.source) >= blk.k:
            blk.done = True
            blk.repair = {}
            return
        if len(blk.source) + len(blk.repair) < blk.k:
            return
        # decode against the block's seed (= full block counter low 16 bits;
        # encoder/decoder agree since it travels in the header)
        seed = next(bs for bs, b in self._blocks.items() if b is blk)
        symbols = fountain.decode_block(blk.k, blk.symbol_len, blk.source,
                                        blk.repair, seed=seed)
        if symbols is None:
            return
        blk.done = True
        blk.repair = {}
        for i, sym in enumerate(symbols):
            if i in blk.source:
                continue
            (length,) = struct.unpack_from(">H", sym)
            data = sym[2 : 2 + length]
            seq = (blk.base_seq + i) & 0xFFFF
            if seq not in self._seen:
                self._seen[seq] = data
                self.num_recovered += 1
                self.srcpad.push(Buffer(np.frombuffer(data, np.uint8)))


__all__ = ["RaptorqEnc", "RaptorqDec"]
