"""The RNNoise denoiser of the PyTorch port against the JAX package, on the CPU.

The same inputs, made from seeds with numpy, go through both packages.
Gates and why:

- rfft_pair / irfft_pair: within 2e-6 of the output's scale (f32 FFTs of
  two libraries, pocketfft in torch and ducc in XLA, sum in other orders);
- the batched front end's features within FEATURE_TOL = 1e-4 (measured
  1.5e-5: FFTs and products in other orders, through log10), the pitch
  period equal except at frames whose top two autocorrelation scores lie
  within 1e-5 of each other (named, and excluded from the period check);
- rnn_frame and the frame loop within 1e-5 (products summed in another
  order, torch's and XLA's sigmoid/tanh; states relative to 1 + |ref|);
- denoise_frames_fast within FAST_TOL = 0.25 s16 units (measured 0.042;
  the JAX package's own fast-vs-scan slack is 60): a buffer's front end
  rounds as the JAX one up to the order of sums;
- the per-frame path within SCAN_TOL = 8 s16 units: the port's per-sample
  high-pass equals a numpy float32 recursion bit for bit, XLA's jitted scan
  rounds it otherwise, and the filter's pole near 1 amplifies that to ~2
  units at the input (~1.4 at the output);
- the audiornnoise element within FAST_TOL / 32767 a sample, the same PTS,
  durations and VAD zeroing, the level meta within one dB step.

Torch runs on one intra-op thread (tests/torch_parity_helpers.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.elements.audiofx.audiornnoise import AudioLevelMeta as JLevel
from gst_plugins_rs_tpu.models.rnnoise_train import synth_noise, synth_speech
from gst_plugins_rs_tpu.ops import rfft as jrfft
from gst_plugins_rs_tpu.ops import rnnoise as J
from gst_plugins_rs_tpu_torch.elements.audiofx.audiornnoise import AudioLevelMeta as TLevel
from gst_plugins_rs_tpu_torch.ops import rfft as trfft
from gst_plugins_rs_tpu_torch.ops import rnnoise as T
from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as TG
from torch_parity_helpers import port_on_cpu

FRAME = T.FRAME_SIZE
FEATURE_TOL = 1e-4
RNN_TOL = 1e-5
FAST_TOL = 0.25  # s16 units
SCAN_TOL = 8.0   # s16 units
PERIOD_TIE = 1e-5
PERIOD_INDEX = 40  # the pitch period feature


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _weights(kind):
    return J.random_weights(0) if kind == "random" else J.default_weights()


def _jw(w):
    return {k: jnp.asarray(v) for k, v in w.items()}


def _tw(w):
    return T.weights_to(w, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _signal(seed, K, C):
    """[K, C, FRAME] s16-scaled frames with a clear pitch: a harmonic tone
    (180 Hz + 360 Hz) with light noise, and synthetic speech."""
    rng = np.random.RandomState(seed)
    n = K * FRAME
    t = np.arange(n) / 48000.0
    chans = [0.3 * np.sin(2 * np.pi * 180 * t) + 0.2 * np.sin(2 * np.pi * 360 * t)
             + 0.02 * rng.randn(n)]
    if C > 1:
        speech, _ = synth_speech(np.random.RandomState(seed + 1), n)
        chans.append(speech + 0.01 * rng.randn(n))
    x = np.stack(chans[:C]).astype(np.float32) * 32767.0
    return np.ascontiguousarray(x.reshape(C, K, FRAME).transpose(1, 0, 2))


def _both_init(C):
    return J.denoise_init(C), T.denoise_init(C, "cpu")


# ---------------------------------------------------------------------------
# rfft
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [16, 32, 960, 1024, 4096])
def test_rfft_pair_matches_jax_and_numpy(n):
    x = np.random.RandomState(0).uniform(-1, 1, (3, n)).astype(np.float32)
    tre, tim = trfft.rfft_pair(torch.from_numpy(x), n)
    jre, jim = jrfft.rfft_pair(jnp.asarray(x), n)
    ref = np.fft.rfft(x.astype(np.float64), n, axis=-1)
    scale = np.abs(ref).max()
    for got, want in ((tre, ref.real), (tim, ref.imag), (tre, np.asarray(jre)),
                      (tim, np.asarray(jim))):
        assert np.abs(_np(got) - want).max() <= 2e-6 * scale


@pytest.mark.parametrize("n", [16, 960, 1024])
def test_irfft_roundtrip_matches_jax(n):
    x = np.random.RandomState(1).uniform(-1, 1, (2, n)).astype(np.float32)
    re, im = trfft.rfft_pair(torch.from_numpy(x), n)
    y = trfft.irfft_pair(re, im, n)
    assert np.abs(_np(y) - x).max() <= 2e-6
    jy = jrfft.irfft_pair(jnp.asarray(_np(re)), jnp.asarray(_np(im)), n)
    assert np.abs(_np(y) - np.asarray(jy)).max() <= 2e-6


def test_rfft_odd_padding():
    x = np.ones((50,), np.float32)
    re, im = trfft.rfft_pair(torch.from_numpy(x), 64)
    ref = np.fft.rfft(x, 64)
    np.testing.assert_allclose(_np(re), ref.real, atol=1e-5)
    np.testing.assert_allclose(_np(im), ref.imag, atol=1e-5)


def test_cmul_pair():
    a = np.random.RandomState(2).uniform(-1, 1, (4, 2))
    b = np.random.RandomState(3).uniform(-1, 1, (4, 2))
    ca = a[:, 0] + 1j * a[:, 1]
    cb = b[:, 0] + 1j * b[:, 1]
    re, im = trfft.cmul_pair(*(torch.from_numpy(v) for v in (a[:, 0], a[:, 1], b[:, 0], b[:, 1])))
    np.testing.assert_allclose(_np(re), (ca * cb).real, atol=1e-12)
    np.testing.assert_allclose(_np(im), (ca * cb).imag, atol=1e-12)


# ---------------------------------------------------------------------------
# Front end
# ---------------------------------------------------------------------------
def test_constants_match_jax():
    np.testing.assert_array_equal(T.vorbis_window(), J.vorbis_window())
    np.testing.assert_array_equal(T._band_matrix(), J._band_matrix())
    np.testing.assert_array_equal(T._dct_matrix(), J._dct_matrix())
    assert T.WEIGHT_KEYS == J.WEIGHT_KEYS
    for seed in (0, 5):
        a, b = J.random_weights(seed), T.random_weights(seed)
        assert all(np.array_equal(a[k], b[k]) for k in J.WEIGHT_KEYS)
    a, b = J.default_weights(), T.default_weights()
    assert all(np.array_equal(a[k], b[k]) for k in J.WEIGHT_KEYS)
    assert T.DEFAULT_WEIGHTS_PATH != J.DEFAULT_WEIGHTS_PATH  # the port's own copy


def _pitch_ties(pitch_bufs):
    """Indices of the windows [B, PITCH_BUF] whose two best autocorrelation
    scores over the period range lie within PERIOD_TIE of each other
    (relative to the lag-0 energy), in float64."""
    x = pitch_bufs - pitch_bufs.mean(-1, keepdims=True)
    F = np.fft.rfft(x, T.PITCH_FFT_LEN, axis=-1)
    ac = np.fft.irfft(np.abs(F) ** 2, T.PITCH_FFT_LEN, axis=-1)
    sc = np.sort(ac[:, T.PITCH_MIN_PERIOD:T.PITCH_MAX_PERIOD + 1], axis=-1)
    gap = (sc[:, -1] - sc[:, -2]) / np.maximum(ac[:, 0], 1e-9)
    return set(np.nonzero(gap < PERIOD_TIE)[0].tolist())


def _pitch_windows(state, chunk):
    """The pitch windows [K * C, PITCH_BUF] (frame-major) the batched front
    end searches, from the port's high-pass output, in float64."""
    K, C, _ = chunk.shape
    xf, _ = T._hp_filter_batch(state.hp_mem, torch.from_numpy(chunk))
    flat = torch.cat([state.pitch_buf, xf.permute(1, 0, 2).reshape(C, -1)], -1).double()
    win = flat.unfold(-1, T.PITCH_BUF_SIZE, FRAME)[:, 1:K + 1]
    return _np(win.transpose(0, 1).reshape(K * C, T.PITCH_BUF_SIZE))


def _features_gate(jf, tf, ties, C):
    """Features within FEATURE_TOL; the period equal outside the tie frames
    (indices k * C + c); the tie frames are named."""
    jf, tf = _np(jf), _np(tf)
    K = jf.shape[0]
    mask = np.ones((K, C), bool)
    for i in ties:
        mask[i // C, i % C] = False
    if ties:
        print(f"pitch ties (excluded from the period check): {sorted(ties)}")
    assert np.abs(jf[mask] - tf[mask]).max() <= FEATURE_TOL
    assert np.array_equal(jf[mask][:, PERIOD_INDEX], tf[mask][:, PERIOD_INDEX])


def test_front_end_features_match_jax():
    K, C = 12, 2
    frames = _signal(0, K, C)
    sj, st = _both_init(C)
    for chunk in (frames[:7], frames[7:]):  # state carried across two calls
        ties = _pitch_ties(_pitch_windows(st, chunk))
        sj, fj, Exj, Xrj, Xij, silj = J.analysis_frames_batch(sj, jnp.asarray(chunk))
        st, ft, Ext, Xrt, Xit, silt = T.analysis_frames_batch(st, torch.from_numpy(chunk))
        assert np.array_equal(np.asarray(silj), _np(silt))
        # FFT rounding is relative to the frame's spectrum, not to each band
        Ej = np.asarray(Exj)
        assert (np.abs(Ej - _np(Ext)) / Ej.max(-1, keepdims=True)).max() <= 1e-5
        _features_gate(fj, ft, ties, C)
    # the high-passed signal: block states from one product against the JAX
    # loop over blocks (as test_hp_filter_batch_matches_jax)
    pb = np.asarray(sj.pitch_buf)
    assert np.abs(_np(st.pitch_buf) - pb).max() <= 1e-5 * np.abs(pb).max()
    np.testing.assert_allclose(_np(st.cepstral_hist), np.asarray(sj.cepstral_hist), atol=FEATURE_TOL)
    assert st.ceps_idx == int(sj.ceps_idx)


def test_pitch_period_matches_jax_outside_ties():
    """The period feature (argmax of the autocorrelation over lags 60..768)
    is the same lag in both packages, except where two lags score within
    PERIOD_TIE (then FFT rounding may pick either)."""
    rng = np.random.RandomState(4)
    t = np.arange(T.PITCH_BUF_SIZE) / 48000.0
    bufs = [0.5 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 2 * f0 * t)
            + 0.01 * rng.randn(t.size) for f0 in (70.0, 110.0, 180.0, 260.0, 400.0, 650.0)]
    bufs.append(synth_speech(np.random.RandomState(8), T.PITCH_BUF_SIZE)[0])
    bufs.append(rng.randn(t.size))  # noise: no clear peak
    x = (np.stack(bufs) * 32767).astype(np.float32)
    pj, gj = J._pitch_search(jnp.asarray(x))
    pt, gt = T._pitch_search(torch.from_numpy(x))
    ties = _pitch_ties(x.astype(np.float64))
    keep = [i for i in range(len(bufs)) if i not in ties]
    assert len(keep) >= len(bufs) - 1
    assert np.array_equal(np.asarray(pj)[keep], _np(pt)[keep])
    np.testing.assert_allclose(_np(gt)[keep], np.asarray(gj)[keep], atol=1e-5)


def test_hp_filter_batch_matches_jax():
    frames = _signal(2, 6, 2)
    mem = np.random.RandomState(3).uniform(-3000, 3000, (2, 4)).astype(np.float32)
    yj, mj = J._hp_filter_batch(jnp.asarray(mem), jnp.asarray(frames))
    yt, mt = T._hp_filter_batch(torch.from_numpy(mem), torch.from_numpy(frames))
    scale = np.abs(np.asarray(yj)).max()
    # all block states from one product against the JAX loop over blocks
    assert np.abs(_np(yt) - np.asarray(yj)).max() <= 2e-6 * scale
    assert np.abs(_np(mt) - np.asarray(mj)).max() <= 2e-6 * scale


def test_hp_filter_keeps_the_direct_form():
    """RNNoise's high-pass runs ops/ebur128.py::biquad_apply in its
    direct-form coordinates (rotation=False) while the K-weighting runs the
    rotation basis.  On the frames of test_hp_filter_batch_matches_jax the
    rotation basis is the nearer to a float64 recursion, but it moves the
    output farther than that test's 2e-6 of scale from the JAX package's
    float32 block loop, which the direct form stays within: so the flag
    stays.  The readings print with -s."""
    from gst_plugins_rs_tpu_torch.ops.ebur128 import biquad_apply

    frames = _signal(2, 6, 2)
    mem = np.random.RandomState(3).uniform(-3000, 3000, (2, 4)).astype(np.float32)
    yj = np.asarray(J._hp_filter_batch(jnp.asarray(mem), jnp.asarray(frames))[0])
    K, C, F = frames.shape
    b = np.array([1.0, *T.HP_B])
    a = np.array([1.0, *T.HP_A])
    truth = np.empty((C, K * F))
    for c in range(C):  # the direct-form-I recursion in float64
        x1, x2, y1, y2 = mem[c].astype(np.float64)
        for n, v in enumerate(frames[:, c, :].astype(np.float64).reshape(-1)):
            y = v + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
            x1, x2, y1, y2 = v, x1, y, y1
            truth[c, n] = y
    truth = truth.reshape(C, K, F).transpose(1, 0, 2)
    scale = np.abs(yj).max()
    x1, x2, y1, y2 = torch.from_numpy(mem).unbind(1)
    zi = torch.stack([b[1] * x1 - a[1] * y1 + b[2] * x2 - a[2] * y2, b[2] * x1 - a[2] * y1])
    flat = torch.from_numpy(frames).permute(0, 2, 1).reshape(K * F, C)
    err = {}
    for rotation in (False, True):
        y, _ = biquad_apply(flat, b, a, zi, block_target=F, rotation=rotation)
        y = _np(y.reshape(K, F, C).permute(0, 2, 1))
        err[rotation] = (np.abs(y - truth).max() / scale, np.abs(y - yj).max() / scale)
    print(f"high-pass |d| / scale: direct form {err[False][0]:.3e} from float64, "
          f"{err[False][1]:.3e} from JAX; rotation basis {err[True][0]:.3e}, {err[True][1]:.3e}")
    assert err[False][1] <= 2e-6 < err[True][1]
    assert err[True][0] < err[False][0]


def test_hp_frame_is_the_float32_recursion():
    """The per-frame high-pass equals the direct-form-I recursion in numpy
    float32, bit for bit (the JAX scan's differences from it are XLA's)."""
    x = np.random.RandomState(5).uniform(-13000, 13000, (2, FRAME)).astype(np.float32)
    mem = np.random.RandomState(6).uniform(-100, 100, (2, 4)).astype(np.float32)
    hb, ha = J.HP_B.astype(np.float32), J.HP_A.astype(np.float32)
    x1, x2, y1, y2 = mem.T
    ys = []
    for n in range(FRAME):
        y = x[:, n] + hb[0] * x1 + hb[1] * x2 - ha[0] * y1 - ha[1] * y2
        x1, x2, y1, y2 = x[:, n], x1, y, y1
        ys.append(y)
    m, y = T._hp_frame(torch.from_numpy(mem), torch.from_numpy(x))
    assert np.array_equal(_np(y), np.stack(ys, 1))
    assert np.array_equal(_np(m), np.stack([x1, x2, y1, y2], 1))


# ---------------------------------------------------------------------------
# The GRU stack
# ---------------------------------------------------------------------------
def _rnn_inputs(seed, K, C):
    rng = np.random.RandomState(seed)
    feats = rng.randn(K, C, T.NB_FEATURES).astype(np.float32) * 2.0
    sil = rng.rand(K, C) < 0.25
    h = [rng.uniform(-0.5, 0.5, (C, n)).astype(np.float32) for n in (24, 48, 96)]
    h[1], h[2] = np.abs(h[1]), np.abs(h[2])  # ReLU GRU states are >= 0
    return feats, sil, h


def _state_err(js, ts):
    return max(float((np.abs(np.asarray(a) - _np(b)) / (1.0 + np.abs(np.asarray(a)))).max())
               for a, b in zip(js, ts))


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_rnn_frame_matches_jax(kind):
    w = _weights(kind)
    feats, _, h = _rnn_inputs(1, 1, 2)
    js, jg, jv = J.rnn_frame(J.RnnState(*map(jnp.asarray, h)), _jw(w), jnp.asarray(feats[0]))
    ts, tg, tv = T.rnn_frame(T.RnnState(*map(torch.from_numpy, h)), _tw(w),
                             torch.from_numpy(feats[0]))
    assert np.abs(np.asarray(jg) - _np(tg)).max() <= RNN_TOL
    assert np.abs(np.asarray(jv) - _np(tv)).max() <= RNN_TOL
    assert _state_err(js, ts) <= RNN_TOL


def _jax_gru_scan(rnn, weights, feats, sil):
    """The GRU scan of the JAX package's denoise_frames_fast (its inner
    `gru_step`, ops/rnnoise.py:510-521), jitted."""
    def step(r, xs):
        f, s = xs
        new, g, v = J.rnn_frame(r, weights, f)
        keep = s[:, None]
        r = J.RnnState(*(jnp.where(keep, o, n) for o, n in zip(r, new)))
        return r, (g, jnp.where(s, 0.0, v))

    r, (g, v) = jax.jit(lambda r, f, s: jax.lax.scan(step, r, (f, s)))(rnn, feats, sil)
    return g, v, r


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_rnn_frames_plain_matches_jax_scan(kind):
    w = _weights(kind)
    K, C = 16, 2
    feats, sil, h = _rnn_inputs(2, K, C)
    jg, jv, jr = _jax_gru_scan(J.RnnState(*map(jnp.asarray, h)), _jw(w), jnp.asarray(feats),
                               jnp.asarray(sil))
    tg, tv, tr = TG.rnn_frames(torch.from_numpy(feats), torch.from_numpy(sil),
                               T.RnnState(*map(torch.from_numpy, h)), _tw(w))
    jg, tg = np.asarray(jg), _np(tg)
    assert np.abs(jg[~sil] - tg[~sil]).max() <= RNN_TOL
    assert np.array_equal(tg[sil], np.ones_like(tg[sil]))  # the network did not run
    assert np.abs(np.asarray(jv) - _np(tv)).max() <= RNN_TOL
    assert np.array_equal(_np(tv)[sil], np.zeros(int(sil.sum()), np.float32))
    assert _state_err(jr, tr) <= RNN_TOL


def test_rnn_frames_rejects_bad_inputs():
    feats, sil, h = _rnn_inputs(3, 2, 1)
    w = _tw(J.random_weights(0))
    rnn = T.RnnState(*map(torch.from_numpy, h))
    f, s = torch.from_numpy(feats), torch.from_numpy(sil)
    with pytest.raises(ValueError, match="features"):
        TG.rnn_frames(f.double(), s, rnn, w)
    with pytest.raises(ValueError, match="silence"):
        TG.rnn_frames(f, s.float(), rnn, w)
    with pytest.raises(ValueError, match="states"):
        TG.rnn_frames(f, s, rnn._replace(noise_h=rnn.noise_h[:, :24]), w)
    with pytest.raises(ValueError, match="denoise_gru_u"):
        TG.rnn_frames(f, s, rnn, {**w, "denoise_gru_u": w["denoise_gru_u"].T})
    with pytest.raises(ValueError, match="features"):
        TG.rnn_frames(f[:0], s[:0], rnn, w)


# ---------------------------------------------------------------------------
# The denoiser
# ---------------------------------------------------------------------------
def _two_dispatches(K1, K2, C, seed):
    a = _signal(seed, K1 + K2, C)
    a[K1 + 2] = 0.0  # a silent frame: the freeze path
    return a[:K1], a[K1:]


@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_denoise_frames_fast_matches_jax(kind):
    w = _weights(kind)
    sj, st = _both_init(2)
    for chunk in _two_dispatches(7, 5, 2, 3):
        sj, oj, vj = J.denoise_frames_fast_jit(sj, _jw(w), jnp.asarray(chunk))
        st, ot, vt = T.denoise_frames_fast(st, _tw(w), torch.from_numpy(chunk))
        assert np.abs(np.asarray(oj) - _np(ot)).max() <= FAST_TOL
        assert np.abs(np.asarray(vj) - _np(vt)).max() <= RNN_TOL
    np.testing.assert_allclose(_np(st.synthesis_mem), np.asarray(sj.synthesis_mem), atol=FAST_TOL)
    assert _state_err(sj.rnn, st.rnn) <= 1e-4


def test_denoise_frames_scan_matches_jax():
    w = J.default_weights()
    sj, st = _both_init(2)
    for chunk in _two_dispatches(4, 3, 2, 5):
        sj, oj, vj = J.denoise_frames_scan_jit(sj, _jw(w), jnp.asarray(chunk))
        st, ot, vt = T.denoise_frames_scan(st, _tw(w), torch.from_numpy(chunk))
        assert np.abs(np.asarray(oj) - _np(ot)).max() <= SCAN_TOL
        assert np.abs(np.asarray(vj) - _np(vt)).max() <= 2e-3


def test_fast_path_matches_scan():
    """tests/test_audiornnoise.py::test_fast_path_matches_scan on the port:
    the batched path against the per-frame one, with that test's gates,
    across two dispatches and a silent frame."""
    w = _tw(T.default_weights())
    rng = np.random.RandomState(0)
    frames1 = (rng.uniform(-0.4, 0.4, (7, 2, FRAME)) * 32767).astype(np.float32)
    frames2 = (rng.uniform(-0.4, 0.4, (5, 2, FRAME)) * 32767).astype(np.float32)
    frames2[2] = 0.0
    s_a, s_b = T.denoise_init(2, "cpu"), T.denoise_init(2, "cpu")
    for fr in (frames1, frames2):
        s_a, oa, va = T.denoise_frames_scan(s_a, w, torch.from_numpy(fr))
        s_b, ob, vb = T.denoise_frames_fast(s_b, w, torch.from_numpy(fr))
        np.testing.assert_allclose(_np(oa), _np(ob), atol=60.0)
        np.testing.assert_allclose(_np(va), _np(vb), atol=2e-2)
    np.testing.assert_allclose(_np(s_a.synthesis_mem), _np(s_b.synthesis_mem), atol=60.0)
    np.testing.assert_allclose(_np(s_a.rnn.vad_h), _np(s_b.rnn.vad_h), atol=2e-2)


# ---------------------------------------------------------------------------
# The element
# ---------------------------------------------------------------------------
def _harness(pkg, channels=2, **props):
    elem = pkg.element_factory_make("audiornnoise")
    for k, v in props.items():
        elem.set_property(k.replace("_", "-"), v)
    h = pkg.Harness(elem)
    h.set_src_caps(pkg.Caps.builder("audio/x-raw", format="F32", rate=48000, channels=channels,
                                    layout="interleaved"))
    return h


def _run_both(pushes, channels=2, discont_at=None, **props):
    """Push the same buffers through both elements; (jax buffers, torch
    buffers)."""
    outs = []
    for pkg in (jfx, tfx):
        h = _harness(pkg, channels, **props)
        pts = 0
        for i, data in enumerate(pushes):
            b = pkg.Buffer(data.copy(), pts=pts * 10**9 // 48000)
            if i == discont_at:
                b.set_flag(pkg.BufferFlags.DISCONT)
            h.push(b)
            pts += data.shape[0]
        h.push_eos()
        outs.append(h.pull_all())
    return outs


def _element_input(seed, n, channels):
    sig = _signal(seed, -(-n // FRAME), channels).transpose(0, 2, 1).reshape(-1, channels)
    return (sig[:n] / 32767.0).astype(np.float32)


@pytest.mark.parametrize("threshold", [0.0, 0.5])
def test_audiornnoise_matches_jax_element(threshold):
    x = _element_input(7, 5000, 2)
    x[1440:1920] = 0.0  # a silent frame
    js, ts = _run_both([x[:1000], x[1000:3100], x[3100:]],
                       voice_activity_threshold=threshold)
    assert len(js) == len(ts) > 0
    zeroed = 0
    for a, b in zip(js, ts):
        assert (a.pts, a.duration) == (b.pts, b.duration)
        assert isinstance(b.data, torch.Tensor) and b.data.dtype == torch.float32
        ja, tb = np.asarray(a.data), _np(b.data)
        assert ja.shape == tb.shape
        assert np.abs(ja - tb).max() <= FAST_TOL / 32767.0
        # the same frames zeroed below the threshold
        n = ja.shape[0] // FRAME
        jz = [not ja[f * FRAME:(f + 1) * FRAME].any() for f in range(n)]
        assert jz == [not tb[f * FRAME:(f + 1) * FRAME].any() for f in range(n)]
        zeroed += sum(jz)
        ma, mb = a.get_meta(JLevel), b.get_meta(TLevel)
        assert abs(ma.level - mb.level) <= 1 and ma.voice_activity == mb.voice_activity
    if threshold > 0:
        assert zeroed > 0


def test_audiornnoise_drains_on_discont_like_jax():
    x = _element_input(8, 2500, 1)
    js, ts = _run_both([x[:700], x[700:1500], x[1500:]], channels=1, discont_at=1)
    assert [(b.pts, b.data.shape[0]) for b in js] == [(b.pts, b.data.shape[0]) for b in ts]
    assert [b.data.shape[0] for b in ts] == [480, 220, 480, 960, 360]
    for a, b in zip(js, ts):
        assert np.abs(np.asarray(a.data) - _np(b.data)).max() <= FAST_TOL / 32767.0


# mirrors of tests/test_audiornnoise.py on the port
def test_silence_in_zeros_out_and_conservation():
    h = _harness(tfx, 2)
    total_in = 0
    for _ in range(5):
        h.push(tfx.Buffer(np.zeros((1024, 2), np.float32), pts=total_in * 10**9 // 48000))
        total_in += 1024
    h.push_eos()
    outs = h.pull_all()
    assert sum(int(b.data.shape[0]) for b in outs) == total_in
    for b in outs:
        assert not _np(b.data).any()


def test_audio_level_meta_attached():
    h = _harness(tfx, 1)
    h.push(tfx.Buffer(np.zeros((960, 1), np.float32), pts=0))
    meta = h.pull().get_meta(TLevel)
    assert meta is not None and meta.level == 138 and meta.voice_activity is False


def test_output_framing():
    h = _harness(tfx, 1)
    h.push(tfx.Buffer(np.random.RandomState(0).uniform(-0.1, 0.1, (1000, 1)).astype(np.float32),
                      pts=0))
    assert h.pull().data.shape[0] == 960
    assert h.try_pull() is None
    h.push_eos()
    residue = h.pull()
    assert residue.data.shape[0] == 40 and residue.pts == 960 * 10**9 // 48000


def test_latency():
    h = _harness(tfx, 2)
    assert h.query_latency().result["min_latency"] == 480 * 10**9 // 48000


def test_vad_threshold_zeroes_everything():
    h = _harness(tfx, 1, voice_activity_threshold=1.0)
    sig = np.random.RandomState(1).uniform(-0.5, 0.5, (4800, 1)).astype(np.float32)
    h.push(tfx.Buffer(sig, pts=0))
    assert not _np(h.pull().data).any()


def test_denoiser_state_streams_across_buffers():
    sig = np.random.RandomState(2).uniform(-0.3, 0.3, (1920, 1)).astype(np.float32)
    h1 = _harness(tfx, 1, seed=3)
    h1.push(tfx.Buffer(sig, pts=0))
    o1 = np.concatenate([_np(b.data) for b in h1.pull_all()])
    h2 = _harness(tfx, 1, seed=3)
    h2.push(tfx.Buffer(sig[:500], pts=0))
    h2.push(tfx.Buffer(sig[500:], pts=500 * 10**9 // 48000))
    o2 = np.concatenate([_np(b.data) for b in h2.pull_all()])
    np.testing.assert_allclose(o1, o2, atol=1e-5)


def test_caps_restricted_to_48k():
    h = tfx.Harness(tfx.element_factory_make("audiornnoise"))
    caps = tfx.Caps.builder("audio/x-raw", format="F32", rate=44100, channels=1,
                            layout="interleaved")
    assert h.srcpad.peer.pad_template_caps().intersect(caps).is_empty()


def test_model_property_loads_weights(tmp_path):
    """`model` loads an .npz in both packages: the element's output with the
    random init saved to a file equals the JAX element's."""
    path = tmp_path / "w.npz"
    np.savez(path, **J.random_weights(4))
    x = _element_input(9, 1440, 1)
    js, ts = _run_both([x], channels=1, model=str(path))
    for a, b in zip(js, ts):
        assert np.abs(np.asarray(a.data) - _np(b.data)).max() <= FAST_TOL / 32767.0


# mirrors of tests/test_rnnoise_quality.py on the port's element path
def _mix(rng, n_frames, snr_db):
    n = n_frames * FRAME
    clean, active = synth_speech(rng, n)
    while not active.any():
        clean, active = synth_speech(rng, n)
    noise = synth_noise(rng, n)
    sp = np.mean(clean[active] ** 2)
    noise *= np.sqrt(sp / (10.0 ** (snr_db / 10.0)))
    return np.clip(clean + noise, -1, 1).astype(np.float32), clean, active


def _denoise(noisy, n_frames):
    """The mix through the port's audiornnoise (packaged weights), as one
    buffer: (out, per-frame VAD of the buffer's frames)."""
    frames = torch.from_numpy(noisy * 32767.0).reshape(n_frames, 1, FRAME)
    w = _tw(T.default_weights())
    _, outs, vads = T.denoise_frames_fast(T.denoise_init(1, "cpu"), w, frames)
    h = _harness(tfx, 1)
    h.push(tfx.Buffer(noisy[:, None].copy(), pts=0))
    out = _np(h.pull().data)[:, 0]
    assert np.abs(out - _np(outs).reshape(-1) / 32767.0).max() <= 1e-6
    return out, _np(vads)[:, 0]


def _snrs(noisy, clean, out):
    from scipy.signal import lfilter

    b = [1.0, J.HP_B[0], J.HP_B[1]]
    a = [1.0, J.HP_A[0], J.HP_A[1]]
    clean_hp = lfilter(b, a, clean)
    noisy_hp = lfilter(b, a, noisy)
    d = FRAME  # overlap-add latency: output lags input one frame
    ref, out_al, noisy_al = clean_hp[:-d], out[d:], noisy_hp[:-d]
    sig = np.mean(ref ** 2) + 1e-12
    snr_in = 10 * np.log10(sig / (np.mean((noisy_al - ref) ** 2) + 1e-12))
    snr_out = 10 * np.log10(sig / (np.mean((out_al - ref) ** 2) + 1e-12))
    return snr_in, snr_out


def test_snr_improvement_at_low_snr():
    """>= 8 dB mean SNR improvement on 0 dB synthetic mixes, the gate of
    tests/test_rnnoise_quality.py, through the port's element."""
    rng = np.random.RandomState(20260817)
    imps = []
    for _ in range(4):
        noisy, clean, active = _mix(rng, 150, snr_db=0.0)
        out, _ = _denoise(noisy, 150)
        snr_in, snr_out = _snrs(noisy, clean, out)
        imps.append(snr_out - snr_in)
    assert np.mean(imps) >= 8.0, f"mean improvement {np.mean(imps):.2f} dB"


def test_vad_accuracy():
    rng = np.random.RandomState(99)
    accs = []
    for _ in range(3):
        noisy, clean, active = _mix(rng, 150, snr_db=5.0)
        _, vads = _denoise(noisy, 150)
        vad_frame = active.reshape(150, FRAME).mean(1) > 0.5
        accs.append(((vads > 0.5) == vad_frame).mean())
    assert np.mean(accs) >= 0.85, f"vad accuracy {np.mean(accs):.2f}"


def test_silence_contract_still_exact():
    w = _tw(T.default_weights())
    frames = torch.zeros((10, 1, FRAME))
    for fn in (T.denoise_frames_fast, T.denoise_frames_scan):
        _, outs, vads = fn(T.denoise_init(1, "cpu"), w, frames)
        assert not _np(outs).any() and not _np(vads).any()
