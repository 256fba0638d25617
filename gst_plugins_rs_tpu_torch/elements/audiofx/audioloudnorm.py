"""audioloudnorm: EBU R-128 streaming loudness normaliser element.

The port of gst_plugins_rs_tpu/elements/audiofx/audioloudnorm.py (parity
target: audio/audiofx/src/audioloudnorm/imp.rs).  A custom element with its
own sink chain: an adapter, a 3 s first frame then 100 ms frames; drain on
DISCONT, caps change, EOS and segment; full reset on flush-stop; latency +3
s; output PTS = input PTS + 100 ms - 3 s for inner frames.

Caps: F64 or F32 interleaved at 192 kHz.  The stream's tensors live on the
selected device (CUDA unless `set_device("cpu")`); F64 runs in float64.
Every frame is one `ops/loudnorm.py` step, one limiter launch on CUDA (the
final drain runs 29 steps, or 30 when a partial frame is left).  The JAX
element scans 64/16/4/1 frames a dispatch instead.

`time-shard=true` shards the time axis over a mesh of every visible device
(`make_stream_mesh(axis="time")`; parallel/mesh.py, parallel/timeshard.py).
streaming: chunks of mesh size x _TS_FRAMES_PER_DEV frames; phase A is the
sharded input analysis, phase B `inner_frames_scan_pre` (one limiter launch
a frame), after which the sharded filter's exit state is handed back; the
first frame, the frames left at a drain and the final drain run the
default path.  linear: the whole stream is buffered and normalised by
`sharded_loudnorm_linear` at EOS, with one WARNING bus message once 3 s of
input have arrived.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..._device import device
from ...core import (
    Adapter,
    AudioInfo,
    Buffer,
    BufferFlags,
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
    Query,
    QueryType,
    SECOND,
    Structure,
    audio_caps_template,
    register,
)
from ...ops import loudnorm as LN

_CAPS = audio_caps_template(formats=("F64", "F32"), rate=192_000)


class _State:
    def __init__(self, element: "AudioLoudNorm", info: AudioInfo):
        self.info = info
        self.adapter = Adapter()
        self.device = device()
        self.dtype = torch.float64 if info.format == "F64" else torch.float32
        self.params = LN.loudnorm_params(
            element.get_property("loudness-target"),
            element.get_property("loudness-range-target"),
            element.get_property("max-true-peak"),
            info.channels, self.dtype, self.device)
        self.dev = LN.loudnorm_init(self.params, info.channels, element.get_property("offset"))
        self.frame_type = "first"  # first | inner
        self.samples_per_frame = LN.GAIN_LOOKAHEAD

    def take(self, n: int):
        return torch.as_tensor(self.adapter.take(n)).to(self.device, self.dtype)


@register
class AudioLoudNorm(Element):
    ELEMENT_NAME = "audioloudnorm"
    ELEMENT_CLASS = "Filter/Effect/Audio"
    ELEMENT_DESCRIPTION = "Normalizes perceived loudness of an audio stream"
    PROPERTIES = [
        Prop("loudness-target", -24.0, minimum=-70.0, maximum=-5.0, mutable="ready",
             doc="Loudness target in LUFS"),
        Prop("loudness-range-target", 7.0, minimum=1.0, maximum=20.0, mutable="ready",
             doc="Loudness range target in LU"),
        Prop("max-true-peak", -2.0, minimum=-9.0, maximum=0.0, mutable="ready",
             doc="Maximum True Peak in dbTP"),
        Prop("offset", 0.0, minimum=-99.0, maximum=99.0, mutable="ready",
             doc="Offset Gain in LU"),
        Prop("time-shard", False, type="bool", mutable="ready",
             doc="SP mode (SURVEY §2.3): shard the time axis across every "
                 "visible device.  See time-shard-mode for semantics."),
        Prop("time-shard-mode", "streaming", type="enum",
             choices=["streaming", "linear"], mutable="ready",
             doc="streaming (default): SAME OUTPUT as time-shard=false — "
                 "input is processed in bounded chunks; each chunk's "
                 "K-weighting/energy/peak analysis runs parallel across "
                 "the mesh (parallel/timeshard."
                 "sharded_kweight_frame_analysis: exact blocked-IIR with "
                 "all_gather state handoff) and the sequential gain/"
                 "limiter chain scans the precomputed results "
                 "(ops/loudnorm.inner_frames_scan_pre).  The chain itself "
                 "cannot be sharded without changing output: frame i's "
                 "limiter output feeds r128_out which feeds frame i+1's "
                 "delta (imp.rs:526-608).  Sample-parity on >=6 s streams "
                 "is test-gated (tests/test_timeshard_streaming.py).  "
                 "linear: buffer the WHOLE stream and normalize with ONE "
                 "linear gain (parallel/timeshard.sharded_loudnorm_linear "
                 "— ppermute halo for the 400 ms gating overlap, psum'd "
                 "gating histogram).  Semantics = the reference's LINEAR "
                 "frame type (imp.rs:323-366,781-816) applied to the "
                 "whole stream: for streams >= 3 s the output DIFFERS "
                 "from the streaming algorithm and memory grows with "
                 "stream length — a WARNING bus message is posted when "
                 "that threshold is crossed."),
    ]

    # streaming time-shard: frames per device per chunk (the memory bound:
    # a chunk is mesh_size * this * 100 ms of audio)
    _TS_FRAMES_PER_DEV = 4

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, _CAPS)))
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, _CAPS)))
        self.sinkpad.chain_function = self._sink_chain
        self.sinkpad.event_function = self._sink_event
        self.srcpad.query_function = self._src_query
        self._state: Optional[_State] = None
        self._ts_linear_warned = False

    # ------------------------------------------------------------------
    # Processing
    # ------------------------------------------------------------------
    def _push_out(self, data, pts: Optional[int]) -> None:
        n = int(data.shape[0])
        if n == 0:
            return
        self.srcpad.push(Buffer(data, pts=pts, duration=n * SECOND // self._state.info.rate))

    def _adapter_pts(self) -> Optional[int]:
        s = self._state
        pts, dist = s.adapter.prev_pts()
        if pts is None:
            return None
        return pts + dist * SECOND // s.info.rate

    @staticmethod
    def _inner_pts(pts: Optional[int]) -> Optional[int]:
        return None if pts is None else pts + 100 * SECOND // 1000 - 3 * SECOND

    def _first_frame(self) -> None:
        s = self._state
        if s.frame_type == "first" and s.adapter.available() >= s.samples_per_frame:
            pts = self._adapter_pts()
            s.dev, out = LN.first_frame_step(s.dev, s.params, s.take(s.samples_per_frame))
            s.frame_type = "inner"
            s.samples_per_frame = LN.FRAME
            self._push_out(out, pts)

    def _drain_full_frames(self) -> None:
        s = self._state
        self._first_frame()
        if s.frame_type != "inner":
            return
        while s.adapter.available() >= LN.FRAME:
            pts = self._adapter_pts()
            s.dev, out = LN.inner_frame_step(s.dev, s.params, s.take(LN.FRAME))
            self._push_out(out, self._inner_pts(pts))

    def _drain_chunks_streaming_sharded(self) -> None:
        """Streaming time-shard: whole chunks of M = mesh size x
        _TS_FRAMES_PER_DEV frames as they accumulate.  Phase A (the input's
        K-weighting, subblock energies and frame peaks) runs over the mesh;
        phase B (the sequential gain and limiter chain) runs on the
        precomputed analysis.  The output equals the default path's; memory
        is bounded by one chunk and the 3 s backlog."""
        from ...parallel.mesh import gather
        from ...parallel.streams import make_stream_mesh
        from ...parallel.timeshard import sharded_kweight_frame_analysis

        s = self._state
        self._first_frame()  # the 3 s first frame stays on the default path
        if s.frame_type != "inner":
            return
        mesh = make_stream_mesh(axis="time")
        m_frames = mesh.shape["time"] * self._TS_FRAMES_PER_DEV
        while s.adapter.available() >= m_frames * LN.FRAME:
            pts = self._adapter_pts()
            src = s.take(m_frames * LN.FRAME)
            energies, peaks, filt_z = sharded_kweight_frame_analysis(
                src, s.dev.r128_in.filt_z, s.params, mesh, m_frames, axis="time")
            s.dev, outs = LN.inner_frames_scan_pre(
                s.dev, s.params, src.reshape(m_frames, LN.FRAME, -1),
                gather(energies, device=src.device), gather(peaks, device=src.device))
            # the sharded filter's exit state, so that the default path (the
            # frames left at a drain, the final drain) continues exactly
            s.dev = s.dev._replace(r128_in=s.dev.r128_in._replace(filt_z=filt_z.to(src.device)))
            self._push_out(outs.reshape(m_frames * LN.FRAME, -1), self._inner_pts(pts))

    def _drain_sharded(self, src, pts: Optional[int]) -> None:
        """Whole-stream linear normalisation on a time-sharded mesh."""
        from ...parallel.mesh import gather
        from ...parallel.streams import make_stream_mesh
        from ...parallel.timeshard import sharded_loudnorm_linear

        s = self._state
        n100 = s.params.r128.n100
        mesh = make_stream_mesh(axis="time")
        stride = mesh.shape["time"] * n100
        n = int(src.shape[0])
        npad = -(-max(n, 1) // stride) * stride
        xp = torch.zeros((npad, s.info.channels), dtype=s.dtype, device=src.device)
        xp[:n] = src
        ys, _gain, _loudness = sharded_loudnorm_linear(xp, s.params, mesh,
                                                       n_valid_sb=n // n100)
        self._push_out(gather(ys, device=src.device)[:n], pts)

    def _drain(self) -> None:
        """Flush everything buffered (EOS / caps change / discont / segment)."""
        s = self._state
        if s is None:
            return
        time_shard = self.get_property("time-shard")
        linear = time_shard and self.get_property("time-shard-mode") == "linear"
        if time_shard and not linear:
            # the frames short of a chunk continue on the default path (the
            # same output), then the final drain below
            self._drain_full_frames()
        pts = self._adapter_pts()
        avail = s.adapter.available()
        src = s.take(avail) if avail else None
        if linear:
            if src is not None:
                self._drain_sharded(src, pts)
            return
        if s.frame_type == "inner":
            # the final frames (imp.rs:697-779): the backlog and tail drain
            # through 30 steps, of which 29 frames and the partial input are
            # output; with no partial input the 30th step is cut away whole,
            # so it is not run
            num = 0 if src is None else int(src.shape[0])
            padded = torch.zeros((LN.FRAME, s.info.channels), dtype=s.dtype, device=s.device)
            if num:
                padded[:num] = src
            steps = LN.DRAIN_FRAMES if num else LN.DRAIN_FRAMES - 1
            s.dev, out = LN.drain(s.dev, s.params, padded, steps)
            self._push_out(out[:(LN.DRAIN_FRAMES - 1) * LN.FRAME + num], self._inner_pts(pts))
        elif src is not None:
            # a stream shorter than 3 s: one linear gain (imp.rs:323-366,781-816)
            n100 = s.params.r128.n100
            nfull = (src.shape[0] // n100) * n100
            dev = s.dev
            if nfull:
                dev = dev._replace(r128_in=LN.r128_add_full_subblocks(
                    dev.r128_in, s.params.r128, src[:nfull]))
            self._push_out(src * LN.linear_gain_from_global(dev, s.params), pts)

    def _reset_state(self) -> None:
        self._ts_linear_warned = False
        if self._state is not None:
            self._state = _State(self, self._state.info)

    # ------------------------------------------------------------------
    # Pads
    # ------------------------------------------------------------------
    def _sink_chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        if self._state is None:
            return FlowReturn.NOT_NEGOTIATED
        if buf.has_flag(BufferFlags.DISCONT):
            self._drain()
            self._reset_state()
        s = self._state
        s.adapter.push(buf)
        if not self.get_property("time-shard"):
            self._drain_full_frames()
        elif self.get_property("time-shard-mode") == "streaming":
            self._drain_chunks_streaming_sharded()
        elif not self._ts_linear_warned and s.adapter.available() >= LN.GAIN_LOOKAHEAD:
            # linear whole-stream mode past 3 s: the output diverges from the
            # streaming algorithm and memory grows with the stream
            self._ts_linear_warned = True
            self.post_message(Message(
                MessageType.WARNING, src=self,
                structure=Structure(
                    "audioloudnorm-time-shard-linear",
                    text="time-shard-mode=linear received >= 3 s of input: "
                         "output diverges from the streaming algorithm "
                         "(reference LINEAR frame type applies one whole-"
                         "stream gain, imp.rs:323-366) and the element "
                         "buffers the entire stream until EOS")))
        return FlowReturn.OK

    def _sink_event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            caps = event.get("caps")
            info = AudioInfo.from_caps(caps)
            if self._state is not None:
                self._drain()
            self._state = _State(self, info)
            self.srcpad.current_caps = caps
            return self.srcpad.push_event(event)
        if event.type in (EventType.EOS, EventType.SEGMENT):
            if self._state is not None:
                self._drain()
                self._reset_state()
            return self.srcpad.push_event(event)
        if event.type == EventType.FLUSH_STOP:
            self._reset_state()
        return self.srcpad.push_event(event)

    def _src_query(self, pad: Pad, query: Query) -> bool:
        if query.type == QueryType.LATENCY:
            ok = self.sinkpad.peer_query(query) if self.sinkpad.peer else True
            query.result["min_latency"] = query.result.get("min_latency", 0) + 3 * SECOND
            if query.result.get("max_latency") is not None:
                query.result["max_latency"] += 3 * SECOND
            return ok
        if query.type == QueryType.CAPS:
            filter_ = query.fields.get("filter")
            query.result["caps"] = _CAPS if filter_ is None else filter_.intersect(_CAPS)
            return True
        return self._default_query(pad, query)

    def on_paused_to_ready(self) -> None:
        self._state = None


__all__ = ["AudioLoudNorm"]
