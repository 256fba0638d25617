"""The EBU R-128 engine of the PyTorch port against the JAX package, on the CPU.

Both `EbuR128` analysers take the same seeded signals (numpy) in the same
chunks.  Gates, in f64: momentary, short-term, integrated loudness,
relative threshold and LRA within 1e-9 LU (the port's K-filter computes all
block states in one product, the JAX package walks them in a scan: the
same sums rounded in another order, ~1e-12 LU seen); the gating histograms
equal; sample and true peaks within 1e-12.  At 48 kHz the 4x true peak
(49-tap polyphase) runs, at 96 kHz the 2x, at 192 kHz none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import ebur128 as J
from gst_plugins_rs_tpu_torch.ops import ebur128 as T
from torch_parity_helpers import port_on_cpu

LU_TOL = 1e-9
PEAK_TOL = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _signal(rate, seconds, channels, seed):
    """Noise under a rising envelope, a 1 kHz tone burst and a gap of
    silence: the gates, the histogram and the LRA all see something."""
    rng = np.random.RandomState(seed)
    n = int(rate * seconds) + 777
    x = rng.uniform(-0.5, 0.5, (n, channels)) * np.linspace(0.01, 1.0, n)[:, None]
    t = np.arange(n) / rate
    burst = (t > 1.0) & (t < 1.7)
    x[burst] += 0.4 * np.sin(2 * np.pi * 1000 * t[burst])[:, None]
    x[(t > 2.0) & (t < 2.5)] = 0.0
    return x


def _feed(rate, x, channels, chunk):
    j, t = J.EbuR128(channels, rate), T.EbuR128(channels, rate)
    for i in range(0, x.shape[0], chunk):
        j.add_frames(x[i:i + chunk])
        t.add_frames(torch.from_numpy(x[i:i + chunk]))
    return j, t


def _values(r, channels):
    return (np.array([r.loudness_momentary(), r.loudness_shortterm(), r.loudness_global(),
                      r.relative_threshold(), r.loudness_range()]),
            np.array([[r.sample_peak(c), r.true_peak(c), r.prev_sample_peak(c),
                       r.prev_true_peak(c)] for c in range(channels)]))


@pytest.mark.parametrize("rate,channels,chunk", [
    (48000, 2, 4410), (48000, 1, 48000), (96000, 2, 9600), (192000, 2, 19200),
    (192000, 1, 25000), (44100, 2, 5000)])
def test_analyser_matches_jax(rate, channels, chunk):
    x = _signal(rate, 4.5, channels, seed=rate + channels)
    j, t = _feed(rate, x, channels, chunk)
    jl, jp = _values(j, channels)
    tl, tp = _values(t, channels)
    assert np.all(np.isfinite(tl))
    assert np.abs(jl - tl).max() <= LU_TOL, (jl, tl)
    assert np.abs(jp - tp).max() <= PEAK_TOL
    assert np.array_equal(np.asarray(j.state.block_hist), t.state.block_hist.numpy())
    assert np.array_equal(np.asarray(j.state.st_hist), t.state.st_hist.numpy())
    assert int(j.state.sb_count) == t.state.sb_count
    assert int(j.state.st_counter) == t.state.st_counter
    # the true peak interpolates (4x below 96 kHz, 2x below 192 kHz)
    if rate < 192000:
        assert np.all(tp[:, 1] >= tp[:, 0])


def test_k_weighting_and_true_peak_filters_equal_jax():
    for rate in (44100, 48000, 96000, 192000):
        jb, ja = J.k_weighting_coeffs(rate)
        tb, ta = T.k_weighting_coeffs(rate)
        assert np.array_equal(jb, tb) and np.array_equal(ja, ta)
    for factor in (2, 4):
        assert np.array_equal(J._true_peak_filter(factor), T._true_peak_filter(factor))
    for block in (480, 512):
        b, a = J.k_weighting_coeffs(192000)
        for jm, tm in zip(J._biquad_block_mats(b[1], a[1], block),
                          T._biquad_block_mats(b[1], a[1], block)):
            assert np.array_equal(jm, tm)


@pytest.mark.parametrize("n,rate", [(19200, 192000), (576000, 192000), (4800, 48000),
                                    (48000, 48000)])
def test_biquad_block_products_match_jax_scan(n, rate):
    """All blocks at once (the port) against the JAX block scan, f64, both
    stages: at 192 kHz the blocked form itself is good to ~2e-11 of the
    output's scale (both packages, against an 80-bit direct recursion: the
    Toeplitz rows of the near-unit-pole high-pass cancel), so outputs and
    exit states agree within 1e-10 of that scale."""
    rng = np.random.RandomState(n)
    x = rng.uniform(-1, 1, (n, 2))
    zi = rng.uniform(-0.1, 0.1, (2, 2, 2))
    b, a = J.k_weighting_coeffs(rate)
    jy, jz = J.k_filter_apply(jnp.asarray(x), b, a, jnp.asarray(zi))
    ty, tz = T.k_filter_apply(torch.from_numpy(x), b, a, torch.from_numpy(zi))
    scale = float(np.abs(np.asarray(jy)).max())
    assert np.abs(np.asarray(jy) - ty.numpy()).max() <= 1e-10 * scale
    assert np.abs(np.asarray(jz) - tz.numpy()).max() <= 1e-10 * scale


def test_weights_positions_and_empty_queries():
    pos = ["front-left", "front-right", "front-center", "lfe1", "rear-left", "rear-right"]
    assert np.array_equal(J.channel_weights(pos), T.channel_weights(pos))
    x = _signal(48000, 4.2, 6, seed=9)
    j, t = J.EbuR128(6, 48000, pos), T.EbuR128(6, 48000, pos)
    j.add_frames(x)
    t.add_frames(torch.from_numpy(x))
    assert np.abs(_values(j, 6)[0] - _values(t, 6)[0]).max() <= LU_TOL
    empty = T.EbuR128(2, 48000)
    assert empty.loudness_global() == -np.inf and empty.loudness_range() == 0.0
    assert J.EbuR128(2, 48000).loudness_global() == -np.inf


def test_remainder_reset_and_one_readback():
    """Sub-100 ms chunks wait in the remainder; reset clears state and
    remainder; all queries come from one read-back per state."""
    x = _signal(48000, 3.3, 2, seed=4)
    j, t = _feed(48000, x, 2, 1000)
    assert t._rem is not None and t._rem.shape[0] == np.asarray(j._rem).shape[0]
    q = t._q()
    assert t._q() is q  # cached for the same state
    t.reset()
    assert t._rem is None and t.state.sb_count == 0 and t.loudness_global() == -np.inf


def test_entry_point_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tfx.set_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.EbuR128(2, 48000)
