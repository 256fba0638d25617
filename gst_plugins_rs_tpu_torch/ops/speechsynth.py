"""Rule-based formant speech synthesizer (Klatt-lite, numpy).

The port's copy of gst_plugins_rs_tpu/ops/speechsynth.py (numpy and scipy
only; the same samples bit for bit).  The tests and chip_smoke.py take
their speech from it.

Purpose: generate real (if robotic) SPEECH with known transcripts inside
this no-egress environment, so the transcription elements can carry
weights trained in-repo — the same strategy that made audiornnoise and
demucs functional (models/rnnoise_train.py, models/demucs_train.py).
This is a data generator, not an element.

Source-filter synthesis: a glottal impulse train (voiced) or white noise
(unvoiced) is shaped by cascaded second-order formant resonators; stops
get closure+burst, fricatives get spectrally-shaped noise, diphthongs
interpolate formant targets across the vowel.  ~30-word command-style
lexicon with per-speaker pitch/formant/rate variation hooks.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

RATE = 16000

# phoneme -> (kind, params)
#   vowel: (F1,F2,F3) start and end targets (diphthongs differ)
#   stop:  (voiced, burst_center_hz)
#   fric:  (voiced, band_lo, band_hi, gain)
#   nasal: (F1, F2)
#   glide: vowel-like, shorter
_V = lambda f, g=None: ("vowel", (f, g or f))
PHONES: Dict[str, tuple] = {
    "iy": _V((270, 2290, 3010)),
    "ih": _V((390, 1990, 2550)),
    "eh": _V((530, 1840, 2480)),
    "ae": _V((660, 1720, 2410)),
    "aa": _V((730, 1090, 2440)),
    "ah": _V((640, 1190, 2390)),
    "ao": _V((570, 840, 2410)),
    "uw": _V((300, 870, 2240)),
    "uh": _V((440, 1020, 2240)),
    "er": _V((490, 1350, 1690)),
    "ey": _V((490, 2100, 2700), (330, 2200, 2900)),
    "ow": _V((500, 950, 2300), (330, 870, 2240)),
    "ay": _V((730, 1090, 2440), (330, 2200, 2800)),
    "aw": _V((730, 1090, 2440), (430, 900, 2240)),
    "p": ("stop", (False, 800)),
    "b": ("stop", (True, 800)),
    "t": ("stop", (False, 4000)),
    "d": ("stop", (True, 4000)),
    "k": ("stop", (False, 2500)),
    "g": ("stop", (True, 2500)),
    "s": ("fric", (False, 4000, 7600, 1.0)),
    "z": ("fric", (True, 4000, 7600, 0.8)),
    "sh": ("fric", (False, 2000, 5500, 1.0)),
    "f": ("fric", (False, 1000, 7000, 0.35)),
    "th": ("fric", (False, 1400, 7000, 0.3)),
    "v": ("fric", (True, 500, 4000, 0.4)),
    "h": ("fric", (False, 400, 6500, 0.4)),
    "m": ("nasal", (250, 1100)),
    "n": ("nasal", (250, 1500)),
    "ng": ("nasal", (250, 2000)),
    "l": ("glide", (360, 1300, 2700)),
    "r": ("glide", (420, 1300, 1600)),
    "w": ("glide", (300, 700, 2200)),
    "y": ("glide", (280, 2200, 2900)),
}

LEXICON: Dict[str, List[str]] = {
    "zero": ["z", "ih", "r", "ow"],
    "one": ["w", "ah", "n"],
    "two": ["t", "uw"],
    "three": ["th", "r", "iy"],
    "four": ["f", "ao", "r"],
    "five": ["f", "ay", "v"],
    "six": ["s", "ih", "k", "s"],
    "seven": ["s", "eh", "v", "eh", "n"],
    "eight": ["ey", "t"],
    "nine": ["n", "ay", "n"],
    "open": ["ow", "p", "eh", "n"],
    "close": ["k", "l", "ow", "z"],
    "door": ["d", "ao", "r"],
    "light": ["l", "ay", "t"],
    "on": ["aa", "n"],
    "off": ["ao", "f"],
    "start": ["s", "t", "aa", "r", "t"],
    "stop": ["s", "t", "aa", "p"],
    "play": ["p", "l", "ey"],
    "pause": ["p", "ao", "z"],
    "record": ["r", "eh", "k", "ao", "r", "d"],
    "volume": ["v", "aa", "l", "y", "uw", "m"],
    "up": ["ah", "p"],
    "down": ["d", "aw", "n"],
    "left": ["l", "eh", "f", "t"],
    "right": ["r", "ay", "t"],
    "yes": ["y", "eh", "s"],
    "no": ["n", "ow"],
    "hello": ["h", "eh", "l", "ow"],
    "world": ["w", "er", "l", "d"],
}

VOCABULARY = sorted(LEXICON)


def _resonator(x: np.ndarray, freq: float, bw: float) -> np.ndarray:
    """Second-order IIR formant resonator (same form as rnnoise_train)."""
    r = np.exp(-np.pi * bw / RATE)
    theta = 2 * np.pi * freq / RATE
    a1, a2 = -2 * r * np.cos(theta), r * r
    b0 = 1 - r  # rough unity-ish gain at resonance
    y = np.zeros_like(x)
    y1 = y2 = 0.0
    # vectorized biquad via lfilter-style scan in numpy (short signals)
    from scipy.signal import lfilter

    return lfilter([b0], [1.0, a1, a2], x).astype(np.float32)


def _voiced_source(n: int, pitch: float, rng: np.random.Generator) -> np.ndarray:
    """Impulse train with slight declination + jitter (vectorized)."""
    max_imp = int(n * 300.0 / RATE) + 4  # pitch never exceeds ~300 Hz here
    eps = rng.standard_normal(max_imp)
    f = pitch * np.cumprod(0.9995 * (1.0 + 0.01 * eps))
    f = np.maximum(60.0, f)
    pos = np.concatenate([[0.0], np.cumsum(RATE / f)])
    pos = pos[pos < n].astype(np.int64)
    out = np.zeros(n, np.float32)
    out[pos] = 1.0
    # glottal pulse shaping: simple 2-sample smoothing
    from scipy.signal import lfilter

    return lfilter([1.0, 0.8, 0.4], [1.0], out).astype(np.float32)


def _formant_fixed(src: np.ndarray, formants) -> np.ndarray:
    """Cascade resonators with fixed formant targets (3 lfilter passes)."""
    y = src
    for freq, bw in zip(formants, (60, 90, 140)):
        y = _resonator(y, float(freq), bw)
    return y


def _formant_signal(src: np.ndarray, fstart, fend) -> np.ndarray:
    """Gliding formants approximated by crossfading two fixed-formant
    renderings of the same source (6 lfilter passes total — the per-block
    time-varying filter was ~50x slower in Python)."""
    if np.allclose(fstart, fend):
        return _formant_fixed(src, fstart)
    a = _formant_fixed(src, fstart)
    b = _formant_fixed(src, fend)
    t = np.linspace(0.0, 1.0, src.shape[0], dtype=np.float32)
    return a * (1 - t) + b * t


def synth_phone(kind: str, params: tuple, dur: float, pitch: float,
                fscale: float, rng: np.random.Generator) -> np.ndarray:
    n = max(16, int(dur * RATE))
    if kind in ("vowel", "glide", "nasal"):
        if kind == "vowel":
            fstart, fend = params
        elif kind == "glide":
            fstart = fend = params
        else:  # nasal: damped low formants
            f1, f2 = params
            fstart = fend = (f1, f2, 2500)
        fstart = np.asarray(fstart, np.float64) * fscale
        fend = np.asarray(fend, np.float64) * fscale
        src = _voiced_source(n, pitch, rng)
        y = _formant_signal(src, fstart, fend)
        if kind == "nasal":
            y *= 0.5
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.015 * RATE))
        return (y * env).astype(np.float32)
    if kind == "stop":
        voiced, burst_hz = params
        closure = int((0.03 if voiced else 0.05) * RATE)
        burst_n = int(0.018 * RATE)
        burst = rng.standard_normal(burst_n).astype(np.float32)
        burst = _resonator(burst, burst_hz * fscale, 600.0)
        burst *= np.exp(-np.arange(burst_n) / (0.004 * RATE))
        out = np.concatenate([np.zeros(closure, np.float32), burst * 2.0])
        if voiced:
            vb = _voiced_source(closure, pitch, rng) * 0.15
            out[:closure] = _resonator(vb, 200.0, 80.0)
        return out
    if kind == "fric":
        voiced, lo, hi, gain = params
        noise = rng.standard_normal(n).astype(np.float32)
        mid = (lo + hi) / 2 * fscale
        bw = (hi - lo) * fscale
        y = _resonator(noise, mid, bw)
        if voiced:
            vsrc = _voiced_source(n, pitch, rng)
            y = y * 0.6 + _formant_fixed(
                vsrc, np.array([300.0, 1200.0, 2400.0]) * fscale) * 0.4
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.01 * RATE))
        return (y * env * gain).astype(np.float32)
    raise ValueError(kind)


_BASE_DUR = {"vowel": 0.16, "glide": 0.09, "nasal": 0.10,
             "stop": 0.0, "fric": 0.12}  # stop duration is internal


def synth_word(word: str, rng: np.random.Generator, pitch: float = 120.0,
               fscale: float = 1.0, rate_scale: float = 1.0) -> np.ndarray:
    parts = []
    for ph in LEXICON[word]:
        kind, params = PHONES[ph]
        dur = _BASE_DUR[kind] * rate_scale * (1.0 + 0.12 * rng.standard_normal())
        dur = max(0.05, dur)
        parts.append(synth_phone(kind, params, dur, pitch, fscale, rng))
    # 5 ms crossfades between phones
    xf = int(0.005 * RATE)
    out = parts[0]
    for seg in parts[1:]:
        if xf and out.shape[0] > xf and seg.shape[0] > xf:
            ramp = np.linspace(0, 1, xf, dtype=np.float32)
            mixed = out[-xf:] * (1 - ramp) + seg[:xf] * ramp
            out = np.concatenate([out[:-xf], mixed, seg[xf:]])
        else:
            out = np.concatenate([out, seg])
    peak = np.abs(out).max() or 1.0
    return (out / peak * 0.5).astype(np.float32)


def synth_sentence(words: List[str], seed: int = 0,
                   pitch: Optional[float] = None,
                   fscale: Optional[float] = None,
                   rate_scale: Optional[float] = None,
                   gap: float = 0.09,
                   noise_snr_db: Optional[float] = None) -> np.ndarray:
    """Deterministic sentence synthesis: words joined by silences, with
    optional speaker variation and additive noise (for augmentation)."""
    rng = np.random.default_rng(seed)
    pitch = pitch if pitch is not None else float(rng.uniform(85, 230))
    fscale = fscale if fscale is not None else float(rng.uniform(0.92, 1.12))
    rate_scale = rate_scale if rate_scale is not None else float(rng.uniform(0.85, 1.25))
    sil = np.zeros(int(gap * RATE), np.float32)
    parts = [sil]
    for w in words:
        parts.append(synth_word(w, rng, pitch, fscale, rate_scale))
        parts.append(np.zeros(int(gap * (0.7 + 0.6 * rng.random()) * RATE),
                              np.float32))
    out = np.concatenate(parts)
    if noise_snr_db is not None:
        sig_p = float((out ** 2).mean()) or 1e-9
        noise = rng.standard_normal(out.shape[0]).astype(np.float32)
        noise *= np.sqrt(sig_p / 10 ** (noise_snr_db / 10))
        out = out + noise
    return out


__all__ = ["LEXICON", "PHONES", "RATE", "VOCABULARY", "synth_phone",
           "synth_sentence", "synth_word"]
