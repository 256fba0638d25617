"""demucs: music source separation element with one src pad per stem.

The port of gst_plugins_rs_tpu/elements/audiofx/demucs.py (parity target
audio/demucs: a sink pad and per-source src pads named src_<source>, a
model-name property, about one segment of latency).  The network is the
port's Demucs (models/demucs.py): `model-name=demucs` is the published v2
size (channels 64, depth 6, two BiLSTM layers), `demucs-lite` a small
variant that loads the packaged weights (`data/demucs_lite_weights.npz`, a
copy of the JAX package's) unless `weights` names a save_npz file.  Without
weights, the parameters are flax's default initialisers drawn from a
torch.Generator seeded `seed` on the selected device
(models/demucs.py::init_weights), which differ from the JAX element's
`jax.random` draws.  `model-name=htdemucs`
is rejected.

Segmented inference: the element accumulates `segment-duration` of audio
as a tensor on the selected device, pads it with zeros to the stride tree's
valid length, runs one forward pass a segment, trims the padding and
pushes one buffer a stem.  Nothing goes through the host.
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

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
    SECOND,
    audio_caps_template,
    register,
)
from ..._device import device
from ...core.audio import AudioInfo
from ...core.events import Segment
from ...models import demucs as demucs_model

_MODEL_CONFIGS = {
    # the reference's default is htdemucs (hybrid transformer), which is not
    # implemented; "demucs" is the published v2 time-domain size,
    # "demucs-lite" a small variant with packaged weights
    "demucs": dict(channels=64, depth=6, lstm_layers=2),
    "demucs-lite": dict(channels=16, depth=4, lstm_layers=1),
}

PACKAGED_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "demucs_lite_weights.npz")


@register
class Demucs(Element):
    ELEMENT_NAME = "demucs"
    EXTRA_PAD_TEMPLATES = [
        ('src_%s', 'src', 'always', 'audio/x-raw'),
    ]
    ELEMENT_CLASS = "Filter/Audio"
    ELEMENT_DESCRIPTION = "Music source separation (drums/bass/other/vocals)"
    PROPERTIES = [
        Prop("model-name", "demucs-lite", type="enum",
             choices=["demucs", "demucs-lite", "htdemucs"]),
        Prop("segment-duration", SECOND, type="uint64", minimum=100_000_000,
             doc="audio per inference dispatch"),
        Prop("chunk-duration", SECOND, type="uint64", minimum=100_000_000,
             doc="reference name for segment-duration (kept in sync)"),
        Prop("overlap", 0.0, type="float", minimum=0.0, maximum=0.9,
             doc="fraction of each chunk re-processed with the next one "
                 "(accepted; this pipeline processes disjoint chunks — "
                 "overlap-add crossfading is not implemented)"),
        Prop("processing-latency", 0, type="uint64",
             doc="(read) ns of latency the chunking introduces"),
        Prop("url", None, type="str",
             doc="pretrained checkpoint URL (gated: no egress in this "
                 "environment; in-repo demucs-lite weights load by default)"),
        Prop("weights", None, type="str", doc="npz from models.demucs.save_npz"),
        Prop("seed", 0, type="uint"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "chunk-duration":
            self._props["segment-duration"] = value
        elif name == "segment-duration":
            self._props["chunk-duration"] = value

    def get_property(self, name: str):
        if name == "processing-latency":
            return super().get_property("segment-duration")
        return super().get_property(name)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        sink_caps = audio_caps_template(formats=("F32",), channels=2)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, sink_caps))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self.src_pads_by_source = {}
        for source in demucs_model.SOURCES:
            pad = Pad(f"src_{source}", PadDirection.SRC,
                      PadTemplate(f"src_{source}", PadDirection.SRC,
                                  PadPresence.ALWAYS, sink_caps))
            self.add_pad(pad)
            self.src_pads_by_source[source] = pad
        self._model: Optional[demucs_model.Demucs] = None
        self._config: Optional[demucs_model.DemucsConfig] = None
        self._device: Optional[torch.device] = None
        self._info: Optional[AudioInfo] = None
        self._acc: List[torch.Tensor] = []
        self._acc_len = 0
        self._out_pos = 0
        self._started = False

    # -- setup -------------------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        name = self.get_property("model-name")
        if name == "htdemucs":
            raise RuntimeError(
                "htdemucs (hybrid transformer) is not implemented; pretrained "
                "weights are not redistributable in this environment — use "
                "model-name=demucs with converted weights"
            )
        self._config = demucs_model.DemucsConfig(**_MODEL_CONFIGS[name])
        self._device = device()
        weights = self.get_property("weights")
        if not weights and name == "demucs-lite" and os.path.exists(PACKAGED_WEIGHTS):
            weights = PACKAGED_WEIGHTS
        if weights:
            state = demucs_model.load_npz(weights, self._config)
        else:
            state = demucs_model.init_weights(self._config, self.get_property("seed"),
                                              self._device)
        self._model = demucs_model.build(self._config, state, self._device)
        self._acc = []
        self._acc_len = 0
        self._out_pos = 0
        self._started = False

    def on_paused_to_ready(self) -> None:
        self._model = None
        self._info = None

    # -- helpers ------------------------------------------------------------------
    def _segment_samples(self) -> int:
        assert self._info is not None
        return self.get_property("segment-duration") * self._info.rate // SECOND

    def _start_outputs(self, caps: Caps) -> None:
        if self._started:
            return
        self._started = True
        for source, pad in self.src_pads_by_source.items():
            if pad.peer is None:
                continue
            pad.push_event(Event.new_stream_start(f"{self.name}-{source}"))
            pad.push_event(Event.new_caps(caps))
            pad.push_event(Event.new_segment(Segment()))

    def _process(self, chunk: torch.Tensor) -> None:
        """chunk: [T, C] on the device -> push one buffer per stem."""
        cfg = self._config
        t = chunk.shape[0]
        padded = torch.zeros((1, cfg.valid_length(t), chunk.shape[1]), dtype=torch.float32,
                             device=self._device)
        padded[0, :t] = chunk
        with torch.no_grad():
            stems = self._model(padded)[0, :, :t]
        pts = self._out_pos * SECOND // self._info.rate
        dur = t * SECOND // self._info.rate
        for si, source in enumerate(cfg.sources):
            pad = self.src_pads_by_source[source]
            if pad.peer is not None:
                pad.push(Buffer(stems[si], pts=pts, duration=dur))
        self._out_pos += t

    def _drain_full(self, final: bool) -> None:
        seg = self._segment_samples()
        if self._acc:
            data = torch.cat(self._acc, dim=0)
        else:
            data = torch.zeros((0, 2), dtype=torch.float32, device=self._device)
        self._acc = []
        pos = 0
        while data.shape[0] - pos >= seg:
            self._process(data[pos: pos + seg])
            pos += seg
        rest = data[pos:]
        if final and rest.shape[0]:
            self._process(rest)
        elif rest.shape[0]:
            self._acc = [rest]
        self._acc_len = sum(a.shape[0] for a in self._acc)

    # -- dataflow --------------------------------------------------------------
    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        arr = torch.as_tensor(buf.data, device=self._device).to(torch.float32)
        self._acc.append(arr)
        self._acc_len += arr.shape[0]
        if self._acc_len >= self._segment_samples():
            self._drain_full(final=False)
        return FlowReturn.OK

    def _event(self, pad: Pad, event: Event) -> bool:
        if event.type == EventType.CAPS:
            self._info = AudioInfo.from_caps(event.get("caps"))
            self._start_outputs(event.get("caps"))
            return True
        if event.type == EventType.EOS:
            self._drain_full(final=True)
            ok = True
            for p in self.src_pads_by_source.values():
                if p.peer is not None:
                    ok = p.push_event(event) and ok
            return ok
        if event.type in (EventType.STREAM_START, EventType.SEGMENT):
            return True
        ok = True
        for p in self.src_pads_by_source.values():
            if p.peer is not None:
                ok = p.push_event(event) and ok
        return ok


__all__ = ["Demucs", "PACKAGED_WEIGHTS"]
