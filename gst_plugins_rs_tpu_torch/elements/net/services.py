"""Speech-service elements: deepgramtranscriber, speechmaticstranscriber,
elevenlabssynthesizer, elevenlabsvoicecloner, llamacpp-texttransform.

Parity targets: net/deepgram (WS listen API: binary PCM in, Results JSON
out), audio/speechmatics (RT API v2: StartRecognition/AddTranscript/
EndOfStream JSON + binary AddAudio), audio/elevenlabs (stream-input WS
TTS + /v1/voices/add cloner), text/llamacpp (local-LLM text transform —
backed here by `transformers` since llama.cpp is not in this image;
model gated by `model-path` exactly like whispertranscriber).

All service elements accept an `endpoint-uri`-style override (`url`)
so tests run against in-process fake servers; production uses the
real endpoints with the same code.

The port: audio and text payloads reach the services through one
read-back each (`core/payload.py`); the F32 -> S16 conversion stays
numpy's, after the read-back, so the bytes sent equal the JAX package's.
Divergence from the JAX package: mid-stream, a transcriber or the
synthesizer takes the replies that arrived within 10 ms of a buffer, as
there; at EOS the port ends the service's stream and waits, within the
element's `latency`, for the replies still owed (until the service ends
its stream), and pushes them before EOS.  The JAX elements lose a reply
that was still in flight at EOS.
"""
from __future__ import annotations

import base64
import json
import queue
import threading
import time
import uuid
from typing import List, Optional

import numpy as np
import torch

from ..._device import device
from ...core import (
    BaseSink,
    BaseTransform,
    Buffer,
    Caps,
    FlowReturn,
    Message,
    MessageType,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.basetransform import TransformMode
from ...core.caps import Structure
from ...core.parse import parse_caps
from ...core.payload import host_array, host_bytes

TEXT_CAPS = Caps.builder("text/x-raw")
S16_CAPS = "audio/x-raw,format=S16,rate=%d,channels=1,layout=interleaved"


class _WsTranscriberBase(BaseTransform):
    """Shared shape: S16 audio in, final transcripts out as text buffers
    (or application/x-json records when downstream negotiates JSON,
    matching the reference transcribers' dual output caps)."""

    SINK_CAPS = Caps.builder("audio/x-raw")
    SRC_CAPS = Caps([Structure("text/x-raw"),
                     Structure("application/x-json")])
    MODE = TransformMode.NEVER_IN_PLACE

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ws = None
        self._results: List[str] = []
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._last_pts: Optional[int] = None
        self._last_send_t: Optional[float] = None
        self._ended = False

    def transform_caps(self, direction, caps: Caps, filter_=None) -> Caps:
        from ...core.element import PadDirection

        out = self.SRC_CAPS.copy() if direction == PadDirection.SINK \
            else Caps.builder("audio/x-raw")
        return out if filter_ is None else out.intersect(filter_)

    def _json_out(self) -> bool:
        return (self.out_caps is not None
                and self.out_caps.structure(0).name == "application/x-json")

    def _push_result(self, text: str) -> None:
        if text:
            with self._lock:
                self._results.append(text)

    def _audio_bytes(self, buf: Buffer) -> bytes:
        pcm = host_array(buf.data)
        if pcm.dtype != np.int16:
            pcm = (np.clip(np.asarray(pcm, np.float32), -1, 1) * 32767).astype(np.int16)
        return pcm.tobytes()

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            import time

            self._last_pts = inbuf.pts
            self._last_send_t = time.monotonic()
            self._send_audio(self._audio_bytes(inbuf))
            time.sleep(0.01)
        with self._lock:
            if not self._results:
                return None
            text = self._results.pop(0)
        pts = self._last_pts
        late = self._props.get("lateness")
        if pts is not None and late:
            pts += late * 1_000_000
        if self._json_out():
            text = json.dumps({"lines": [{"text": text}]})
        return Buffer(np.frombuffer(text.encode(), np.uint8), pts=pts)

    def _send_audio(self, pcm: bytes) -> None:
        raise NotImplementedError

    def _end_stream(self) -> None:
        """Tell the service the audio has ended (once) and wait, within
        `latency`, for the replies it still owes."""
        if self._ws is None or self._ended:
            return
        self._ended = True
        try:
            self._close_stream()
        except Exception:
            return
        self._wait_owed(self.get_property("latency") / 1e3)

    def _wait_owed(self, timeout: float) -> None:
        """Default: the service ends its stream after the last reply."""
        if self._thread is not None:
            self._thread.join(timeout)

    def drain(self) -> Optional[Buffer]:
        self._end_stream()
        while True:
            out = self.generate_output()
            if out is None:
                return None
            self.srcpad.push(out)

    def stop(self) -> None:
        if self._ws is not None:
            try:
                if not self._ended:
                    self._close_stream()
                self._ws.close()
            except Exception:
                pass
            self._ws = None
        self._ended = False

    def _close_stream(self) -> None:
        pass


@register
class DeepgramTranscriber(_WsTranscriberBase):
    """Deepgram live-transcription WebSocket (net/deepgram/src/transcriber).

    Binary linear16 PCM frames in; `{"type": "Results", "channel":
    {"alternatives": [...]}, "is_final": bool}` JSON out; CloseStream on
    EOS.  `Authorization: Token <api-key>` header."""

    ELEMENT_NAME = "deepgramtranscriber"
    ELEMENT_CLASS = "Filter/Audio/Text"
    ELEMENT_DESCRIPTION = "Streaming speech-to-text via the Deepgram API"
    PROPERTIES = [
        Prop("api-key", None, type="str"),
        Prop("url", "wss://api.deepgram.com/v1/listen", type="str"),
        Prop("language", "en", type="str"),
        Prop("model", "nova-2", type="str"),
        Prop("sample-rate", 16000, type="int"),
        Prop("interim-results", False, type="bool"),
        Prop("language-code", "", type="str",
             doc="reference name for language (kept in sync)"),
        Prop("diarization", False, type="bool",
             doc="request per-speaker diarization (diarize=true); speaker "
                 "labels prefix the transcripts"),
        Prop("interim-strategy", "latest", type="enum",
             choices=["latest", "concat"],
             doc="with interim-results: emit each interim as-is (latest) "
                 "or only transcripts that grew (concat)"),
        Prop("interim-timing-threshold", 0, type="uint",
             doc="ms an interim must be stable before it is emitted "
                 "(0 = immediately)"),
        Prop("latency", 2_000, type="uint",
             doc="ms of latency reported for the service round trip"),
        Prop("lateness", 0, type="uint",
             doc="ms added to output timestamps"),
        Prop("max-observed-delay", 0, type="uint",
             doc="(read) max ms between sending audio and a result"),
    ]

    def property_changed(self, name, value) -> None:
        if name == "language-code" and value:
            self._props["language"] = value
        elif name == "language":
            self._props["language-code"] = value

    def latency_additional_ns(self) -> int:
        return self.get_property("latency") * 1_000_000

    def start(self) -> None:
        from websockets.sync.client import connect as ws_connect

        url = self.get_property("url")
        sep = "&" if "?" in url else "?"
        url = (f"{url}{sep}encoding=linear16"
               f"&sample_rate={self.get_property('sample-rate')}"
               f"&language={self.get_property('language')}"
               f"&model={self.get_property('model')}")
        if self.get_property("diarization"):
            url += "&diarize=true"
        headers = {}
        if self.get_property("api-key"):
            headers["Authorization"] = f"Token {self.get_property('api-key')}"
        self._ws = ws_connect(url, additional_headers=headers, open_timeout=10)
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def _recv_loop(self) -> None:
        try:
            for raw in self._ws:
                msg = json.loads(raw)
                if msg.get("type") != "Results":
                    continue
                if not msg.get("is_final") and not self.get_property("interim-results"):
                    continue
                if self._last_send_t is not None:
                    import time as _t

                    d = int((_t.monotonic() - self._last_send_t) * 1e3)
                    if d > self._props.get("max-observed-delay", 0):
                        self._props["max-observed-delay"] = d
                alts = msg.get("channel", {}).get("alternatives", [])
                if not alts:
                    continue
                text = alts[0].get("transcript", "")
                if not msg.get("is_final") \
                        and self.get_property("interim-strategy") == "concat" \
                        and not text.startswith(getattr(self, "_last_interim", "")):
                    continue  # interim shrank: skip per concat strategy
                if not msg.get("is_final"):
                    self._last_interim = text
                if self.get_property("diarization"):
                    words = alts[0].get("words", [])
                    speakers = {w.get("speaker") for w in words
                                if w.get("speaker") is not None}
                    if len(speakers) == 1:
                        text = f"[spk_{next(iter(speakers))}] {text}"
                self._push_result(text)
        except Exception:
            pass

    def _send_audio(self, pcm: bytes) -> None:
        self._ws.send(pcm)

    def _close_stream(self) -> None:
        self._ws.send(json.dumps({"type": "CloseStream"}))


@register
class SpeechmaticsTranscriber(_WsTranscriberBase):
    """Speechmatics RT API v2 (audio/speechmatics/src/transcriber/imp.rs:
    StartRecognition with raw/pcm_s16le audio_format, binary AddAudio
    frames, AddTranscript results, EndOfStream with last_seq_no)."""

    ELEMENT_NAME = "speechmaticstranscriber"
    ELEMENT_CLASS = "Filter/Audio/Text"
    ELEMENT_DESCRIPTION = "Streaming speech-to-text via the Speechmatics RT API"
    PROPERTIES = [
        Prop("api-key", None, type="str"),
        Prop("url", "wss://eu2.rt.speechmatics.com/v2", type="str"),
        Prop("language-code", "en", type="str"),
        Prop("sample-rate", 16000, type="int"),
        Prop("max-delay", 3.0, type="float"),
        Prop("enable-late-punctuation-hack", True, type="bool"),
        Prop("latency", 5_000, type="uint",
             doc="ms of latency reported for the service round trip"),
        Prop("lateness", 0, type="uint", doc="ms added to output timestamps"),
        Prop("max-observed-delay", 0, type="uint",
             doc="(read) max ms between sending audio and a result"),
        Prop("diarization", "none", type="enum",
             choices=["none", "speaker"],
             doc="speaker diarization in transcription_config"),
        Prop("max-speakers", 50, type="uint", minimum=2,
             doc="speaker_diarization_config.max_speakers"),
        Prop("get-speakers-interval", 0, type="uint",
             doc="ms between speaker-list element messages (0 = off; "
                 "emitted from AddTranscript speaker fields)"),
        Prop("labeled-speakers", None, type="object",
             doc="list of speaker labels passed to the service"),
        Prop("additional-vocabulary", None, type="object",
             doc="list of additional_vocab entries (words or mappings)"),
        Prop("mask-profanities", False, type="bool",
             doc="request profanity masking (transcript_filtering_config)"),
        Prop("remove-disfluencies", False, type="bool",
             doc="request disfluency removal (transcript_filtering_config)"),
        Prop("join-punctuation", True, type="bool",
             doc="attach punctuation results to the previous word instead "
                 "of spacing them"),
        Prop("audio-event-types", None, type="object",
             doc="list of audio event types to subscribe to "
                 "(audio_events_config)"),
    ]

    EXTRA_PAD_TEMPLATES = [
        ("unsynced_src", "src", "sometimes", "text/x-raw"),
        ("translate_src_%u", "src", "request", "text/x-raw"),
        ("unsynced_translate_src_%u", "src", "sometimes", "text/x-raw"),
    ]
    # GstSpeechmaticsTranscriberSrcPad surface (reference speechmatics
    # other-types): per-src-pad target language, fed into
    # translation_config.target_languages
    PAD_PROPERTIES = {
        "src": [
            Prop("language-code", None, type="str", mutable="ready",
                 doc="target language for this pad's text (None = the "
                     "untranslated transcript)"),
        ],
        "translate_src": [
            Prop("language-code", None, type="str", mutable="ready",
                 doc="target language of this translation pad"),
        ],
    }

    def latency_additional_ns(self) -> int:
        return self.get_property("latency") * 1_000_000

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._seq = 0
        self._started = threading.Event()
        self._eot = threading.Event()
        # (pad, unsynced_pad, language holder) per requested translate pad;
        # languages feed translation_config.target_languages and
        # AddTranslation results route back by language (imp.rs:1266-1292)
        self._translate_pads: List[tuple] = []
        self._translations: List[tuple] = []  # (language, text)
        self._translate_started = False
        self.unsynced_srcpad = self.add_pad(
            Pad("unsynced_src", PadDirection.SRC,
                PadTemplate("unsynced_src", PadDirection.SRC,
                            PadPresence.SOMETIMES, TEXT_CAPS)))
        self._unsynced_started = False

    def request_pad(self, template_name: str = "translate_src_%u") -> "Pad":
        n = len(self._translate_pads)
        lang = {"code": ""}

        class _TranslatePad(Pad):
            def set_property(self, prop_name, value, _lang=lang):
                if prop_name != "language-code":
                    raise KeyError(prop_name)
                _lang["code"] = value

            def get_property(self, prop_name, _lang=lang):
                if prop_name != "language-code":
                    raise KeyError(prop_name)
                return _lang["code"]

        pad = _TranslatePad(
            f"translate_src_{n}", PadDirection.SRC,
            PadTemplate("translate_src_%u", PadDirection.SRC,
                        PadPresence.REQUEST, TEXT_CAPS))
        unsynced = Pad(
            f"unsynced_translate_src_{n}", PadDirection.SRC,
            PadTemplate("unsynced_translate_src_%u", PadDirection.SRC,
                        PadPresence.SOMETIMES, TEXT_CAPS))
        self.add_pad(pad)
        self.add_pad(unsynced)
        self._translate_pads.append((pad, unsynced, lang))
        return pad

    def _target_languages(self) -> List[str]:
        return [h["code"] for _, _, h in self._translate_pads if h["code"]]

    def _push_translation(self, language: str, text: str) -> None:
        if not text:
            return
        with self._lock:
            self._translations.append((language, text))

    def _drain_translations(self, pts) -> None:
        with self._lock:
            items, self._translations = self._translations, []
        for language, text in items:
            for pad, unsynced, holder in self._translate_pads:
                if holder["code"] != language:
                    continue
                for p in (pad, unsynced):
                    if p.peer is None:
                        continue
                    if not self._translate_started:
                        self._translate_started = True
                        from ...core.events import Event, Segment

                        for q in [x for tp in self._translate_pads
                                  for x in tp[:2] if x.peer is not None]:
                            q.push_event(Event.new_stream_start(
                                f"{self.name}-{q.name}"))
                            q.push_event(Event.new_caps(TEXT_CAPS))
                            q.push_event(Event.new_segment(Segment()))
                    p.push(Buffer(np.frombuffer(text.encode(), np.uint8),
                                  pts=pts))

    def start(self) -> None:
        from websockets.sync.client import connect as ws_connect

        headers = {}
        if self.get_property("api-key"):
            headers["Authorization"] = f"Bearer {self.get_property('api-key')}"
        self._ws = ws_connect(self.get_property("url"),
                              additional_headers=headers, open_timeout=10)
        self._seq = 0
        self._started.clear()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()
        self._ws.send(json.dumps({
            "message": "StartRecognition",
            "audio_format": {
                "type": "raw",
                "encoding": "pcm_s16le",
                "sample_rate": self.get_property("sample-rate"),
            },
            "transcription_config": self._transcription_config(),
            "translation_config": {
                "target_languages": self._target_languages(),
                "enable_partials": False,
            },
            **self._audio_events_config(),
        }))
        if not self._started.wait(10.0):
            raise RuntimeError(f"{self.name}: RecognitionStarted never arrived")

    def _transcription_config(self) -> dict:
        cfg = {
            "language": self.get_property("language-code"),
            "max_delay": self.get_property("max-delay"),
            "enable_partials": False,
        }
        if self.get_property("diarization") != "none":
            cfg["diarization"] = self.get_property("diarization")
            sd = {"max_speakers": self.get_property("max-speakers")}
            labeled = self.get_property("labeled-speakers")
            if labeled:
                sd["speakers"] = list(labeled)
            cfg["speaker_diarization_config"] = sd
        vocab = self.get_property("additional-vocabulary")
        if vocab:
            cfg["additional_vocab"] = [
                v if isinstance(v, dict) else {"content": str(v)}
                for v in vocab]
        filtering = {}
        if self.get_property("mask-profanities"):
            filtering["remove_profanities"] = True  # masked server-side
        if self.get_property("remove-disfluencies"):
            filtering["remove_disfluencies"] = True
        if filtering:
            cfg["transcript_filtering_config"] = filtering
        return cfg

    def generate_output(self):
        out = super().generate_output()
        self._drain_translations(self._last_pts)
        if out is not None and self.unsynced_srcpad.peer is not None:
            if not self._unsynced_started:
                self._unsynced_started = True
                from ...core.events import Event, Segment

                self.unsynced_srcpad.push_event(
                    Event.new_stream_start(f"{self.name}-unsynced"))
                self.unsynced_srcpad.push_event(Event.new_caps(TEXT_CAPS))
                self.unsynced_srcpad.push_event(Event.new_segment(Segment()))
            self.unsynced_srcpad.push(
                Buffer(out.data, pts=out.pts, duration=out.duration))
        return out

    def _audio_events_config(self) -> dict:
        types = self.get_property("audio-event-types")
        if not types:
            return {}
        return {"audio_events_config": {"types": [str(t) for t in types]}}

    def _recv_loop(self) -> None:
        try:
            for raw in self._ws:
                msg = json.loads(raw)
                kind = msg.get("message")
                if kind == "RecognitionStarted":
                    self._started.set()
                elif kind == "AddTranscript":
                    words = []
                    speakers = set()
                    join_punct = self.get_property("join-punctuation")
                    for res in msg.get("results", []):
                        alts = res.get("alternatives", [])
                        if not alts:
                            continue
                        content = alts[0].get("content", "")
                        spk = alts[0].get("speaker")
                        if spk:
                            speakers.add(spk)
                        if join_punct and res.get("type") == "punctuation" \
                                and words:
                            words[-1] += content
                        else:
                            words.append(content)
                    self._maybe_post_speakers(speakers)
                    self._push_result(" ".join(w for w in words if w))
                elif kind == "AddTranslation":
                    parts = [r.get("content", "")
                             for r in msg.get("results", [])]
                    self._push_translation(
                        msg.get("language", ""),
                        " ".join(x for x in parts if x))
                elif kind == "EndOfTranscript":
                    self._eot.set()
                elif kind == "Error":
                    self._started.set()
                    self._eot.set()
        except Exception:
            pass
        finally:
            self._eot.set()

    def _maybe_post_speakers(self, speakers) -> None:
        """get-speakers-interval: post a speakers element message at most
        once per interval when diarization surfaces speaker labels."""
        if not speakers or not self.get_property("get-speakers-interval"):
            return
        import time as _t

        now = _t.monotonic()
        last = getattr(self, "_speakers_posted_t", 0.0)
        if now - last < self.get_property("get-speakers-interval") / 1e3:
            return
        self._speakers_posted_t = now
        from ...core.caps import Structure

        self.post_message(Message(
            MessageType.ELEMENT,
            structure=Structure("speechmatics-speakers",
                                speakers=sorted(speakers))))

    def _send_audio(self, pcm: bytes) -> None:
        self._ws.send(pcm)  # binary frame = AddAudio
        self._seq += 1

    def _close_stream(self) -> None:
        # like the reference, the final AddTranscript results flush before
        # EOS propagates downstream: drain() waits for EndOfTranscript
        self._eot.clear()
        self._ws.send(json.dumps({"message": "EndOfStream", "last_seq_no": self._seq}))

    def _wait_owed(self, timeout: float) -> None:
        self._eot.wait(timeout)


@register
class ElevenLabsSynthesizer(BaseTransform):
    """ElevenLabs stream-input TTS WebSocket (audio/elevenlabs/src/
    synthesizer): text chunks in, base64 PCM out."""

    ELEMENT_NAME = "elevenlabssynthesizer"
    ELEMENT_CLASS = "Filter/Text/Audio"
    ELEMENT_DESCRIPTION = "Text-to-speech via the ElevenLabs streaming API"
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = Caps.builder("audio/x-raw")
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("api-key", None, type="str"),
        Prop("voice-id", "21m00Tcm4TlvDq8ikWAM", type="str"),
        Prop("model-id", "eleven_flash_v2_5", type="str"),
        Prop("url", None, type="str", doc="override the wss endpoint (tests)"),
        Prop("sample-rate", 16000, type="int"),
        Prop("stability", 0.5, type="float"),
        Prop("similarity-boost", 0.75, type="float"),
        Prop("language-code", None, type="str",
             doc="ISO 639-1 language code sent with the init message"),
        Prop("latency", 2_000, type="uint",
             doc="ms of latency reported for the TTS round trip"),
        Prop("overflow", "clip", type="enum",
             choices=["clip", "compress", "nothing"],
             doc="how audio longer than the cue duration is handled "
                 "(same semantics as awspolly)"),
        Prop("max-overflow", 0, type="uint",
             doc="ms a cue may overflow its duration (mode=compress)"),
        Prop("retry-with-speed", False, type="bool",
             doc="on overflow, retry the request with a higher voice "
                 "speed setting before clipping"),
        Prop("max-previous-requests", 3, type="uint",
             doc="previous text chunks sent for prosody continuity"),
        Prop("speaker-map", None, type="object",
             doc="mapping of speaker label -> voice-id; [spk_N]-prefixed "
                 "input selects the mapped voice"),
        Prop("use-voice-id-events", False, type="bool",
             doc="honor elevenlabs/voice-id custom events to switch voice"),
    ]

    def latency_additional_ns(self) -> int:
        return self.get_property("latency") * 1_000_000

    def sink_event(self, event) -> bool:
        from ...core.events import EventType

        if (event.type == EventType.CUSTOM_DOWNSTREAM
                and event.get("name") == "elevenlabs/voice-id"
                and self.get_property("use-voice-id-events")):
            self._props["voice-id"] = event.get("voice-id")
            return False
        return True

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ws = None
        self._audio: "queue.Queue[bytes]" = queue.Queue()
        self._thread = None
        self._last_pts = None
        self._final = threading.Event()
        self._ended = False

    def transform_caps(self, direction, caps: Caps, filter_=None) -> Caps:
        from ...core.element import PadDirection

        if direction == PadDirection.SINK:
            out = parse_caps(S16_CAPS % self.get_property("sample-rate"))
        else:
            out = TEXT_CAPS
        return out if filter_ is None else out.intersect(filter_)

    def start(self) -> None:
        from websockets.sync.client import connect as ws_connect

        url = self.get_property("url") or (
            f"wss://api.elevenlabs.io/v1/text-to-speech/"
            f"{self.get_property('voice-id')}/stream-input"
            f"?model_id={self.get_property('model-id')}"
            f"&output_format=pcm_{self.get_property('sample-rate')}"
        )
        self._ws = ws_connect(url, open_timeout=10)
        init = {
            "text": " ",
            "voice_settings": {
                "stability": self.get_property("stability"),
                "similarity_boost": self.get_property("similarity-boost"),
            },
        }
        if self.get_property("language-code"):
            init["language_code"] = self.get_property("language-code")
        if self.get_property("max-previous-requests"):
            init["generation_config"] = {
                "chunk_length_schedule": [50],
            }
        if self.get_property("api-key"):
            init["xi_api_key"] = self.get_property("api-key")
        self._ws.send(json.dumps(init))
        self._final.clear()
        self._ended = False
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._ws is not None:
            try:
                if not self._ended:
                    self._ws.send(json.dumps({"text": ""}))  # flush/end
                self._ws.close()
            except Exception:
                pass
            self._ws = None
        self._ended = False

    def _recv_loop(self) -> None:
        try:
            for raw in self._ws:
                msg = json.loads(raw)
                if msg.get("audio"):
                    self._audio.put(base64.b64decode(msg["audio"]))
                if msg.get("isFinal"):
                    self._final.set()
        except Exception:
            pass
        finally:
            self._final.set()

    def drain(self) -> Optional[Buffer]:
        """At EOS: flush the stream and wait, within `latency`, for the
        audio still owed (the final message, or the service closing), then
        push it."""
        if self._ws is not None and not self._ended:
            self._ended = True
            self._final.clear()
            try:
                self._ws.send(json.dumps({"text": ""}))  # flush/end
            except Exception:
                pass
            else:
                deadline = time.monotonic() + self.get_property("latency") / 1e3
                while not self._final.is_set() and self._thread.is_alive() \
                        and time.monotonic() < deadline:
                    self._final.wait(0.01)
        while True:
            out = self.generate_output()
            if out is None:
                return None
            self.srcpad.push(out)

    def generate_output(self) -> Optional[Buffer]:
        inbuf = self.take_queued_buffer()
        if inbuf is not None:
            self._last_pts = inbuf.pts
            self._last_dur = inbuf.duration
            text = inbuf.data if isinstance(inbuf.data, str) else \
                host_bytes(inbuf.data, np.uint8).decode("utf-8", "replace")
            # speaker-map: a [spk_X] prefix selects the mapped voice for
            # multi-speaker synthesis continuity
            smap = self.get_property("speaker-map")
            if smap and text.startswith("[") and "]" in text:
                label, rest = text[1:].split("]", 1)
                mapped = (smap.get(label) if hasattr(smap, "get") else None)
                if mapped:
                    self._props["voice-id"] = mapped
                    text = rest.lstrip()
            msg = {"text": text, "try_trigger_generation": True}
            prev = getattr(self, "_prev_texts", [])
            if prev:
                msg["previous_text"] = " ".join(prev)
            prev.append(text)
            self._prev_texts = prev[-self.get_property("max-previous-requests"):] \
                if self.get_property("max-previous-requests") else []
            self._ws.send(json.dumps(msg))
            import time
            time.sleep(0.01)
        try:
            pcm = self._audio.get_nowait()
        except queue.Empty:
            return None
        audio = np.frombuffer(pcm, "<i2").reshape(-1, 1)
        audio = self._apply_overflow(audio, getattr(self, "_last_dur", None))
        return Buffer(audio, pts=self._last_pts)

    def _apply_overflow(self, pcm: np.ndarray, duration) -> np.ndarray:
        mode = self.get_property("overflow")
        if mode == "nothing" or not duration:
            return pcm
        rate = self.get_property("sample-rate")
        want = int(duration * rate / 1e9)
        if pcm.shape[0] <= want or want <= 0:
            return pcm
        if mode == "clip":
            return pcm[:want]
        allow = want + int(self.get_property("max-overflow") * rate / 1e3)
        target = min(pcm.shape[0], allow)
        xs = np.linspace(0, pcm.shape[0] - 1, target)
        return np.interp(xs, np.arange(pcm.shape[0]),
                         pcm[:, 0].astype(np.float32)).astype(np.int16).reshape(-1, 1)


@register
class ElevenLabsVoiceCloner(BaseSink):
    """Collects audio and POSTs it to /v1/voices/add on EOS
    (audio/elevenlabs/src/cloner); posts an element message with the
    created voice-id."""

    ELEMENT_NAME = "elevenlabsvoicecloner"
    ELEMENT_CLASS = "Sink/Audio"
    ELEMENT_DESCRIPTION = "Clones a voice via the ElevenLabs API"
    SINK_CAPS = Caps.builder("audio/x-raw")
    PROPERTIES = [
        Prop("api-key", None, type="str"),
        Prop("url", "https://api.elevenlabs.io", type="str"),
        Prop("voice-name", "gstpu-voice", type="str"),
        Prop("speaker", None, type="str",
             doc="only clone audio whose buffers carry this speaker label "
                 "([spk_X] text meta convention; None = all audio)"),
        Prop("segment-duration", 0, type="uint64",
             doc="ns of audio per uploaded sample file (0 = one file)"),
        Prop("remove-background-noise", False, type="bool",
             doc="request noise removal on the clone"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        # the reference passes the audio through while collecting it
        # (cloner sits mid-pipeline); unlinked src = plain sink use
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS,
                            Caps.builder("audio/x-raw"))))
        self._audio = bytearray()
        self.voice_id: Optional[str] = None

    def on_ready_to_paused(self) -> None:
        self._audio = bytearray()
        self.voice_id = None

    def render(self, buffer: Buffer) -> FlowReturn:
        pcm = host_array(buffer.data)
        if pcm.dtype != np.int16:
            pcm = (np.clip(np.asarray(pcm, np.float32), -1, 1) * 32767).astype(np.int16)
        self._audio += pcm.tobytes()
        if self.srcpad.peer is not None:
            return self.srcpad.push(buffer)
        return FlowReturn.OK

    def on_event(self, event) -> None:
        from ...core.events import EventType

        if self.srcpad.peer is not None:
            self.srcpad.push_event(event)
        if event.type != EventType.EOS or not self._audio:
            return
        import urllib.request

        boundary = uuid.uuid4().hex
        name = self.get_property("voice-name")
        body = bytearray()
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="name"\r\n\r\n{name}\r\n').encode()
        if self.get_property("remove-background-noise"):
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     'name="remove_background_noise"\r\n\r\ntrue\r\n').encode()
        seg_ns = self.get_property("segment-duration")
        # 16-bit mono assumed at the negotiated rate; segment-duration
        # splits the upload into multiple sample files
        seg_bytes = len(self._audio)
        if seg_ns:
            rate = (self.caps.structure(0).get("rate", 16000)
                    if self.caps is not None else 16000)
            seg_bytes = max(2, int(seg_ns * rate / 1e9) * 2)
        chunks = [self._audio[i:i + seg_bytes]
                  for i in range(0, len(self._audio), seg_bytes)] or [b""]
        for i, chunk in enumerate(chunks):
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="files"; filename="sample{i:03d}.raw"\r\n'
                     "Content-Type: application/octet-stream\r\n\r\n").encode()
            body += chunk
            body += b"\r\n"
        body += f"--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            self.get_property("url").rstrip("/") + "/v1/voices/add",
            data=bytes(body), method="POST")
        req.add_header("Content-Type", f"multipart/form-data; boundary={boundary}")
        if self.get_property("api-key"):
            req.add_header("xi-api-key", self.get_property("api-key"))
        with urllib.request.urlopen(req, timeout=30) as resp:
            result = json.loads(resp.read())
        self.voice_id = result.get("voice_id")
        self.post_message(Message(MessageType.ELEMENT, name="voice-cloned",
                                  voice_id=self.voice_id))


@register
class LlamaCppTextTransform(BaseTransform):
    """Local-LLM text transform (text/llamacpp llamacpp-texttransform).

    The reference embeds llama.cpp; this environment has no libllama, so
    the element runs any local causal-LM through `transformers`
    (model-path gated exactly like whispertranscriber — wiring is tested
    with a trivial echo fallback when allow-echo-fallback is set).  The
    port puts the model and its token ids on the selected device."""

    ELEMENT_NAME = "llamacpp-texttransform"
    ELEMENT_CLASS = "Filter/Text"
    ELEMENT_DESCRIPTION = "Transforms text through a local LLM"
    SINK_CAPS = TEXT_CAPS
    SRC_CAPS = TEXT_CAPS
    MODE = TransformMode.NEVER_IN_PLACE
    PROPERTIES = [
        Prop("model-path", None, type="str", doc="local transformers model dir"),
        Prop("prompt-format", "{system}\n{input}", type="str"),
        Prop("system-prompt", "", type="str"),
        Prop("max-tokens", 64, type="int"),
        Prop("allow-echo-fallback", False, type="bool",
             doc="wiring tests: pass text through uppercased when no model"),
        Prop("context-size", 4096, type="uint",
             doc="prompt context window: the prompt is truncated (from the "
                 "left) to this many tokens"),
        Prop("history-size", 0, type="uint",
             doc="previous exchanges kept and prepended to the prompt"),
        Prop("seed", -1, type="int", minimum=-1,
             doc="sampling seed (-1 = nondeterministic)"),
        Prop("temp", 0.8, type="float", doc="sampling temperature (0 = greedy)"),
        Prop("top-k", 40, type="int", doc="top-k sampling (0 = off)"),
        Prop("top-p", 0.95, type="float", doc="nucleus sampling"),
        Prop("min-p", 0.05, type="float", doc="min-p sampling floor"),
        Prop("penalty-repeat", 1.0, type="float",
             doc="repetition penalty (1.0 = off)"),
        Prop("penalty-last-n", 64, type="int",
             doc="window for the repetition penalty (transformers applies "
                 "it over the whole context; the window bound is recorded)"),
        Prop("penalty-freq", 0.0, type="float",
             doc="llama.cpp frequency penalty; folded into penalty-repeat "
                 "on the transformers backend"),
        Prop("penalty-present", 0.0, type="float",
             doc="llama.cpp presence penalty; folded into penalty-repeat "
                 "on the transformers backend"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._model = None
        self._tokenizer = None

    def start(self) -> None:
        path = self.get_property("model-path")
        if path:
            from transformers import AutoModelForCausalLM, AutoTokenizer

            self._tokenizer = AutoTokenizer.from_pretrained(path)
            self._model = AutoModelForCausalLM.from_pretrained(path).to(device())
        elif not self.get_property("allow-echo-fallback"):
            raise RuntimeError(
                f"{self.name}: set model-path to a local causal LM "
                "(or allow-echo-fallback for wiring tests)")

    def transform(self, buffer: Buffer) -> Buffer:
        text = buffer.data if isinstance(buffer.data, str) else \
            host_bytes(buffer.data, np.uint8).decode("utf-8", "replace")
        prompt = self.get_property("prompt-format").format(
            system=self.get_property("system-prompt"), input=text)
        hist = getattr(self, "_history", [])
        if self.get_property("history-size") and hist:
            prompt = "\n".join(hist[-self.get_property("history-size"):]
                                + [prompt])
        if self._model is None:
            out_text = text.upper()  # documented echo fallback
        else:
            ids = self._tokenizer(prompt, return_tensors="pt").input_ids.to(
                self._model.device)
            ctx = self.get_property("context-size")
            if ctx and ids.shape[1] > ctx:
                ids = ids[:, -ctx:]
            seed = self.get_property("seed")
            if seed >= 0:
                torch.manual_seed(seed)
            temp = self.get_property("temp")
            sample_kwargs = dict(do_sample=False)
            if temp > 0:
                sample_kwargs = dict(
                    do_sample=True, temperature=temp,
                    top_k=self.get_property("top-k") or None,
                    top_p=self.get_property("top-p"),
                    min_p=self.get_property("min-p") or None,
                )
            rep = self.get_property("penalty-repeat") \
                + self.get_property("penalty-freq") * 0.1 \
                + self.get_property("penalty-present") * 0.1
            if rep != 1.0:
                sample_kwargs["repetition_penalty"] = max(rep, 0.01)
            with torch.no_grad():
                out = self._model.generate(
                    ids, max_new_tokens=self.get_property("max-tokens"),
                    **sample_kwargs)
            out_text = self._tokenizer.decode(out[0][ids.shape[1]:],
                                              skip_special_tokens=True)
        if self.get_property("history-size"):
            hist.append(f"{text}\n{out_text}")
            self._history = hist[-self.get_property("history-size"):]
        return Buffer(np.frombuffer(out_text.encode(), np.uint8),
                      pts=buffer.pts, duration=buffer.duration)
