"""loudnormbank: N-stream EBU R-128 loudness normalization, one step a tick.

The port of gst_plugins_rs_tpu/elements/audiofx/loudnormbank.py, the
element-layer face of parallel/streams.loudnorm_bank: N request sink pads
(`sink_%u`) each paired with a src pad (`src_%u`).  Aligned 100 ms frames
of every stream are stacked on a leading batch axis and processed by the
bank's hand-batched step: on the card one launch of the limiter kernel L1
covers all N streams (ops/loudnorm_limiter.py::limiter_frames), each stream's
idle case decided by its own block.

Per-stream math is the audioloudnorm element's (ops/loudnorm.py; reference
audio/audiofx/src/audioloudnorm/imp.rs) in F32: fixed 192 kHz, the 3 s
first frame in lockstep, 100 ms inner frames, the EOS drain (29 steps when
no stream has a partial frame left, else 30; one limiter launch a step),
each stream trimmed to 29 frames plus its real samples.  Output PTS = first
input PTS + k * 100 ms.  EOS goes to every src pad after the drain, and an
`r128-bank-level` element message is posted then.

`shard=true` shards the stream axis (state and data) over a mesh of every
visible device (parallel/streams.py::make_stream_mesh): each shard
advances its slice of the streams, one L1 launch a shard a tick, and the
outputs are gathered for the pads.  As in the JAX element, a stream count
that the mesh does not divide raises ValueError at the first buffer.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ...core import (
    Buffer,
    Caps,
    Element,
    Event,
    EventType,
    FlowReturn,
    Message,
    MessageType,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    SECOND,
    Structure,
    register,
)
from ..._device import device
from ...core.events import Segment
from ...ops import loudnorm as LN

AUDIO_CAPS = Caps.builder(
    "audio/x-raw", format="F32", rate=LN.RATE, layout="interleaved")


class _Stream:
    def __init__(self, idx: int):
        self.idx = idx
        self.pending: List[torch.Tensor] = []  # queued [n, ch] f32 chunks
        self.n_pending = 0
        self.eos = False
        self.started = False  # past the 3 s first frame
        self.first_pts: Optional[int] = None
        self.out_frames = 0

    def push(self, arr: torch.Tensor) -> None:
        self.pending.append(arr)
        self.n_pending += arr.shape[0]

    def take(self, n: int) -> torch.Tensor:
        """Pop exactly n samples (caller checked n_pending >= n)."""
        out = []
        need = n
        while need:
            head = self.pending[0]
            if head.shape[0] <= need:
                out.append(self.pending.pop(0))
                need -= head.shape[0]
            else:
                out.append(head[:need])
                self.pending[0] = head[need:]
                need = 0
        self.n_pending -= n
        return torch.cat(out, 0)


@register
class LoudnormBank(Element):
    ELEMENT_NAME = "loudnormbank"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = (
        "Batch EBU R-128 loudness normalization of N streams per device "
        "dispatch, optionally sharded over a device mesh")
    PROPERTIES = [
        Prop("loudness-target", -24.0, type="double", mutable="ready"),
        Prop("shard", False, type="bool", mutable="ready",
             doc="shard the stream axis over a mesh of all visible devices"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._streams: Dict[str, _Stream] = {}
        self._bank = None
        self._dev = None
        self._mesh = None
        self._sent_start: Dict[str, bool] = {}

    def on_ready_to_paused(self) -> None:
        self._dev = device()

    # -- pads ---------------------------------------------------------------
    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        n = len(self._streams)
        idx = str(n)
        sink = Pad(f"sink_{idx}", PadDirection.SINK,
                   PadTemplate("sink_%u", PadDirection.SINK,
                               PadPresence.REQUEST, AUDIO_CAPS))
        sink.chain_function = lambda pad, buf, i=idx: self._chain(pad, buf, i)
        sink.event_function = lambda pad, ev, i=idx: self._sink_event(pad, ev, i)
        self.add_pad(sink)
        src = Pad(f"src_{idx}", PadDirection.SRC,
                  PadTemplate("src_%u", PadDirection.SRC,
                              PadPresence.SOMETIMES, AUDIO_CAPS))
        self.add_pad(src)
        self._streams[idx] = _Stream(n)
        return sink

    request_pad = request_sink_pad

    def link(self, downstream) -> None:
        """`loudnormbank ! elem` links the first unlinked src pad."""
        src = next(p for p in self.src_pads() if p.peer is None)
        sink = next((p for p in downstream.sink_pads() if p.peer is None), None)
        if sink is None and hasattr(downstream, "request_sink_pad"):
            sink = downstream.request_sink_pad()
        src.link(sink)

    # -- bank ---------------------------------------------------------------
    def _ensure_bank(self, channels: int) -> None:
        if self._bank is not None:
            return
        from ...parallel.streams import loudnorm_bank, make_stream_mesh

        if self.get_property("shard"):
            self._mesh = make_stream_mesh()
        self._bank_channels = channels
        self._bank = loudnorm_bank(
            len(self._streams), channels=channels, mesh=self._mesh,
            loudness_target=self.get_property("loudness-target"),
            dtype=torch.float32, dev=self._dev)

    def _chain(self, pad: Pad, buf: Buffer, idx: str) -> FlowReturn:
        st = self._streams[idx]
        arr = torch.as_tensor(buf.data).to(self._dev, torch.float32)
        if arr.dim() == 1:
            arr = arr[:, None]
        if st.first_pts is None:
            st.first_pts = buf.pts or 0
        st.push(arr)
        self._try_process()
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event, idx: str) -> bool:
        if event.type == EventType.EOS:
            self._streams[idx].eos = True
            self._try_process()
            if all(s.eos for s in self._streams.values()):
                self._drain_all()
            return False  # forwarded per-stream after the drain
        return True  # caps/segment etc: forward to the paired src pad

    def _default_event(self, pad: Pad, event: Event) -> bool:
        # route sink_N events to src_N instead of broadcast
        if pad.direction == PadDirection.SINK and pad.name.startswith("sink_"):
            idx = pad.name.split("_", 1)[1]
            out = self.pads.get(f"src_{idx}")
            if out is not None and out.peer is not None:
                return out.push_event(event)
            return True
        return super()._default_event(pad, event)

    def _needed(self, st: _Stream) -> int:
        return LN.FRAME if st.started else LN.GAIN_LOOKAHEAD

    def _try_process(self) -> None:
        streams = list(self._streams.values())
        if not streams:
            return
        channels = next(
            (s.pending[0].shape[1] for s in streams if s.pending), None)
        if channels is None:
            return
        self._ensure_bank(channels)
        # phase 1: all streams must clear the 3 s first frame together
        if not streams[0].started:
            if any(s.n_pending < LN.GAIN_LOOKAHEAD and not s.eos
                   for s in streams):
                return
            if any(s.n_pending < LN.GAIN_LOOKAHEAD for s in streams):
                return  # short stream at EOS: handled by drain
            batch = torch.stack(
                [s.take(LN.GAIN_LOOKAHEAD) for s in streams])
            self._emit(self._bank.first_frame(batch))
            for s in streams:
                s.started = True
        # phase 2: inner 100 ms frames whenever every stream has one
        while all(s.n_pending >= LN.FRAME for s in streams):
            batch = torch.stack([s.take(LN.FRAME) for s in streams])
            self._emit(self._bank.process(batch))

    def _emit(self, outs: torch.Tensor) -> None:
        """outs: [S, FRAME, ch] — push one 100 ms buffer per stream."""
        frame_ns = LN.FRAME * SECOND // LN.RATE
        for idx, st in self._streams.items():
            out_pad = self.pads.get(f"src_{idx}")
            if out_pad is None or out_pad.peer is None:
                continue
            if not self._sent_start.get(idx):
                self._sent_start[idx] = True
                out_pad.push_event(Event.new_stream_start(f"{self.name}-{idx}"))
                out_pad.push_event(Event.new_caps(
                    Caps.builder("audio/x-raw", format="F32", rate=LN.RATE,
                                 channels=outs.shape[2],
                                 layout="interleaved")))
                out_pad.push_event(Event.new_segment(Segment()))
            pts = (st.first_pts or 0) + st.out_frames * frame_ns
            out_pad.push(Buffer(outs[st.idx], pts=pts, duration=frame_ns))
            st.out_frames += 1

    def _drain_all(self) -> None:
        streams = list(self._streams.values())
        if self._bank is not None and streams and streams[0].started:
            # the 30-frame drain, the audioloudnorm element's semantics
            # (imp.rs:697-779): residue is < 1 frame per stream when streams
            # are aligned; longer tails (unequal stream lengths) are dropped
            # with a warning, since the batch contract is lockstep streams
            # (analyticscombiner-style).  With no partial frame anywhere the
            # 30th step would be cut away whole: 29 steps run.
            padded = torch.zeros(
                (len(streams), LN.FRAME, self._bank_channels), dtype=torch.float32,
                device=self._dev)
            nums = []
            for s in streams:
                n = min(s.n_pending, LN.FRAME)
                if s.n_pending > LN.FRAME:
                    import logging

                    logging.getLogger(__name__).warning(
                        "%s: stream %d has %d samples past the shortest "
                        "stream; bank streams must be aligned — dropping",
                        self.name, s.idx, s.n_pending - LN.FRAME)
                if n:
                    padded[s.idx, :n] = s.take(n)
                nums.append(n)
            steps = LN.DRAIN_FRAMES if any(nums) else LN.DRAIN_FRAMES - 1
            outs = self._bank.drain(padded, steps)
            frame_ns = LN.FRAME * SECOND // LN.RATE
            for idx, st in self._streams.items():
                out_pad = self.pads.get(f"src_{idx}")
                if out_pad is None or out_pad.peer is None:
                    continue
                total = (LN.DRAIN_FRAMES - 1) * LN.FRAME + nums[st.idx]
                pts = (st.first_pts or 0) + st.out_frames * frame_ns
                out_pad.push(Buffer(outs[st.idx, :total], pts=pts))
        # merged loudness message (the cross-stream psum collective)
        self.post_message(Message(
            MessageType.ELEMENT,
            structure=Structure("r128-bank-level",
                                streams=len(self._streams))))
        for idx in self._streams:
            out = self.pads.get(f"src_{idx}")
            if out is not None and out.peer is not None:
                out.push_event(Event.new_eos())


__all__ = ["LoudnormBank"]
