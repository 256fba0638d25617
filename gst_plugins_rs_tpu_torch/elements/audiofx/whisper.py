"""whispertranscriber: speech-to-text over the Whisper architecture.

The port of gst_plugins_rs_tpu/elements/audiofx/whisper.py.  Parity
target: audio/whisper (whispertranscriber, imp.rs:84; props
model-path, chunk-duration, language, translate, imp.rs:894-940 — the
reference runs whisper.cpp GGUF models).  Here the architecture comes from
the baked-in `transformers` Whisper implementation:

- `model-path` loads a local pretrained checkpoint directory
  (processor + weights); the element downloads no model.
- WITHOUT a model-path the element now falls back to the **builtin
  asr-lite model** (ops/asr.py): a BiGRU-CTC recognizer whose weights
  were TRAINED IN-REPO on the formant synthesizer (the JAX package's
  models/asr_train.py)
  — real speech-to-text over a documented ~30-word command vocabulary
  (ops/speechsynth.LEXICON), the same no-pretrained-checkpoint strategy
  that made audiornnoise and demucs functional.
- `allow-random-weights=true` still wires the Whisper architecture with
  random weights (token-id output; test wiring only).

Input: audio/x-raw F32 16 kHz mono (Whisper's native rate); output:
text/x-raw utf8 buffers per chunk with pts/duration spanning the chunk (a
`str` payload, host data as in the JAX element), or application/x-json
`{"lines": [{"text": ...}]}`.

In the port the chunks are tensors on the element's device (the selected
device when the element starts).  The builtin route runs ops/asr.py's
`transcribe` there: on the card each chunk is two launches of kernel T1,
one per BiGRU layer.  The `model-path` and `allow-random-weights` routes
import `transformers` when the element starts and put the model on the
element's device.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..._device import device
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
from ...core.caps import Structure

SINK_CAPS = Caps([Structure("audio/x-raw", format="F32", rate=16000,
                            channels=1, layout="interleaved")])
TEXT_CAPS = Caps.builder("text/x-raw", format="utf8")


@register
class WhisperTranscriber(BaseTransform):
    ELEMENT_NAME = "whispertranscriber"
    ELEMENT_CLASS = "Audio/Text/Transcriber"
    ELEMENT_DESCRIPTION = "Speech-to-text transcription (Whisper architecture)"
    MODE = TransformMode.NEVER_IN_PLACE
    SINK_CAPS = SINK_CAPS
    from ...core.caps import Structure as _S
    SRC_CAPS = Caps([_S("text/x-raw", format="utf8"),
                     _S("application/x-json")])
    PROPERTIES = [
        Prop("model-path", None, type="str",
             doc="local pretrained checkpoint directory (processor + weights)"),
        Prop("chunk-duration", 5_000_000_000, type="uint64", minimum=SECOND),
        Prop("language", "en", type="str"),
        Prop("translate", False, type="bool"),
        Prop("max-new-tokens", 64, type="uint", minimum=1),
        Prop("allow-random-weights", False, type="bool",
             doc="run the architecture with random weights (token-id output; "
                 "test wiring only)"),
        Prop("model-preset", "base", type="enum",
             choices=["tiny", "tiny-en", "base", "base-en", "small",
                      "small-en", "medium", "medium-en", "large"],
             doc="whisper.cpp preset name; with model-path unset the "
                 "builtin asr-lite model serves all presets (documented "
                 "divergence: no downloadable checkpoints offline)"),
        Prop("latency", 0, type="uint",
             doc="extra ms of latency to report (chunk-duration already "
                 "reports itself)"),
        Prop("live-edge-offset", 0, type="uint",
             doc="ms held back from the live edge before transcribing"),
        Prop("detect-language", False, type="bool",
             doc="auto-detect the language (checkpoint path: language "
                 "tokens unforced; asr-lite is en-only)"),
        Prop("sampling-strategy", "greedy", type="enum",
             choices=["greedy", "beam-search"],
             doc="checkpoint path decode strategy"),
        Prop("beam-search-size", 5, type="int", minimum=1,
             doc="beams for sampling-strategy=beam-search"),
        Prop("greedy-best-of", 1, type="int", minimum=1,
             doc="greedy candidates (maps to num_return_sequences)"),
        Prop("length-penalty", -1.0, type="float",
             doc="beam length penalty (-1 = backend default)"),
        Prop("suppress-blank", True, type="bool",
             doc="suppress blank outputs at start of sampling"),
        Prop("suppress-nst", False, type="bool",
             doc="suppress non-speech tokens (checkpoint path)"),
        Prop("entropy-thold", 2.4, type="float",
             doc="whisper.cpp fallback threshold; recorded — this decoder "
                 "has no temperature-fallback loop"),
        Prop("logprob-thold", -1.0, type="float",
             doc="whisper.cpp fallback threshold; recorded (see entropy-thold)"),
        Prop("debug-mode", False, type="bool",
             doc="log each transcribed chunk"),
    ]

    def latency_additional_ns(self) -> int:
        return (self.get_property("latency")
                + self.get_property("live-edge-offset")) * 1_000_000

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._model = None
        self._fe = None
        self._tokenizer = None
        self._asr_weights = None
        self._dev = None
        self._acc: List[torch.Tensor] = []
        self._acc_len = 0
        self._pos = 0

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_) -> Caps:
        out = (self.SRC_CAPS if direction == PadDirection.SINK else SINK_CAPS).copy()
        if filter_ is not None:
            out = filter_.intersect(out)
        return out

    def start(self) -> None:
        import os

        os.environ.setdefault("HF_HUB_OFFLINE", "1")

        self._asr_weights = None
        self._dev = device()
        path = self.get_property("model-path")
        if path:
            from transformers import WhisperForConditionalGeneration, WhisperProcessor

            processor = WhisperProcessor.from_pretrained(path)
            self._fe = processor.feature_extractor
            self._tokenizer = processor.tokenizer
            self._model = WhisperForConditionalGeneration.from_pretrained(path).eval().to(self._dev)
        elif self.get_property("allow-random-weights"):
            from transformers import (WhisperConfig, WhisperFeatureExtractor,
                                      WhisperForConditionalGeneration)

            cfg = WhisperConfig(
                d_model=64, encoder_layers=1, decoder_layers=1,
                encoder_attention_heads=2, decoder_attention_heads=2,
                encoder_ffn_dim=128, decoder_ffn_dim=128,
                max_source_positions=1500, max_target_positions=128,
            )
            self._model = WhisperForConditionalGeneration(cfg).eval().to(self._dev)
            self._fe = WhisperFeatureExtractor()
            self._tokenizer = None
        else:
            # builtin asr-lite: in-repo-trained BiGRU-CTC (ops/asr.py)
            from ...ops import asr as asr_ops

            if not os.path.exists(asr_ops.DEFAULT_WEIGHTS):
                raise RuntimeError(
                    "whispertranscriber: no model-path and the builtin "
                    "asr-lite weights are missing (data/asr_lite_weights.npz); "
                    "or set allow-random-weights=true for architecture wiring only")
            self._asr_weights = asr_ops.load_weights(dev=self._dev)
        self._acc = []
        self._acc_len = 0
        self._pos = 0

    def stop(self) -> None:
        self._model = None
        self._fe = None
        self._tokenizer = None
        self._asr_weights = None

    def _chunk_samples(self) -> int:
        return self.get_property("chunk-duration") * 16000 // SECOND

    def _transcribe(self, audio: torch.Tensor) -> str:
        if self._asr_weights is not None:
            from ...ops import asr as asr_ops

            return asr_ops.transcribe(self._asr_weights, audio)
        feats = self._fe(audio.cpu().numpy(), sampling_rate=16000,
                         return_tensors="pt").input_features.to(self._dev)
        gen = {"max_new_tokens": self.get_property("max-new-tokens")}
        if self.get_property("sampling-strategy") == "beam-search":
            gen["num_beams"] = self.get_property("beam-search-size")
            if self.get_property("length-penalty") >= 0:
                gen["length_penalty"] = self.get_property("length-penalty")
        if self.get_property("detect-language"):
            gen["language"] = None  # unforced language tokens = auto-detect
        if not self.get_property("suppress-blank"):
            gen["begin_suppress_tokens"] = []
        if self.get_property("suppress-nst"):
            gen["suppress_tokens"] = None  # backend's non-speech set
        with torch.no_grad():
            tokens = self._model.generate(feats, **gen)
        if self._tokenizer is not None:
            out = self._tokenizer.batch_decode(tokens, skip_special_tokens=True)[0].strip()
        else:
            out = " ".join(str(int(t)) for t in tokens[0])
        if self.get_property("debug-mode"):
            import logging

            logging.getLogger(__name__).info("%s: transcribed %r", self.name, out)
        return out

    def _emit(self, n: int) -> Buffer:
        acc = torch.cat(self._acc)
        data, rest = acc[:n], acc[n:]
        self._acc = [rest] if rest.numel() else []
        self._acc_len = rest.numel()
        text = self._transcribe(data)
        pts = self._pos * SECOND // 16000
        dur = n * SECOND // 16000
        self._pos += n
        if self.out_caps is not None \
                and self.out_caps.structure(0).name == "application/x-json":
            import json as _json

            text = _json.dumps({"lines": [{"text": text}]})
        return Buffer(text, pts=pts, duration=dur)

    def transform(self, inbuf: Buffer) -> Optional[Buffer]:
        arr = torch.as_tensor(inbuf.data).to(self._dev, torch.float32).reshape(-1)
        self._acc.append(arr)
        self._acc_len += arr.numel()
        if self._acc_len >= self._chunk_samples():
            return self._emit(self._chunk_samples())
        return None

    def drain(self) -> Optional[Buffer]:
        if self._acc_len:
            return self._emit(self._acc_len)
        return None


__all__ = ["WhisperTranscriber"]
