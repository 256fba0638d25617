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
element scans 64/16/4/1 frames a dispatch instead.  `time-shard=true` is
not ported yet: it raises NotImplementedError when the element starts.
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
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    Query,
    QueryType,
    SECOND,
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
             doc="shard the time axis across every visible device; not ported "
                 "yet (ROADMAP queue A, item 6: the parallel layer) and raises "
                 "NotImplementedError when the element starts"),
        Prop("time-shard-mode", "streaming", type="enum",
             choices=["streaming", "linear"], mutable="ready",
             doc="with time-shard=true: streaming (the same output as "
                 "time-shard=false) or linear (one whole-stream gain); not "
                 "ported yet"),
    ]

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

    def on_ready_to_paused(self) -> None:
        if self.get_property("time-shard"):
            raise NotImplementedError(
                "audioloudnorm time-shard=true: the parallel layer is not ported "
                "yet (ROADMAP queue A, item 6)")

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

    def _drain_full_frames(self) -> None:
        s = self._state
        if s.frame_type == "first" and s.adapter.available() >= s.samples_per_frame:
            pts = self._adapter_pts()
            s.dev, out = LN.first_frame_step(s.dev, s.params, s.take(s.samples_per_frame))
            s.frame_type = "inner"
            s.samples_per_frame = LN.FRAME
            self._push_out(out, pts)
        if s.frame_type != "inner":
            return
        while s.adapter.available() >= LN.FRAME:
            pts = self._adapter_pts()
            s.dev, out = LN.inner_frame_step(s.dev, s.params, s.take(LN.FRAME))
            self._push_out(out, self._inner_pts(pts))

    def _drain(self) -> None:
        """Flush everything buffered (EOS / caps change / discont / segment)."""
        s = self._state
        if s is None:
            return
        pts = self._adapter_pts()
        avail = s.adapter.available()
        src = s.take(avail) if avail else None
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
        self._state.adapter.push(buf)
        self._drain_full_frames()
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
