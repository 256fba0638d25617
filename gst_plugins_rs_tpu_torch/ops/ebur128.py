"""EBU R-128 / ITU-R BS.1770 loudness measurement engine, in PyTorch.

The port of gst_plugins_rs_tpu/ops/ebur128.py: the K-weighting prefilter
(two biquads), 400 ms gated momentary blocks every 100 ms, 3 s short-term
blocks every 1 s for LRA, the histogram mode (1000 bins of 0.1 LU from -70
LUFS), absolute -70 LUFS and relative -10 LU gating, the LRA percentiles,
the sample peak and the 4x/2x polyphase true peak.

State lives on the device as a NamedTuple of tensors, except the two
subblock counters: they depend only on how many 100 ms subblocks were fed,
so they are Python ints and no per-frame decision reads the device.

The K-filter runs in the blocked-IIR form of the JAX package (one [B,B]
Toeplitz product per block of B samples plus 2-element state terms), with
all blocks in one product: the block-start states s_k = AB^k s_0 +
sum_{j<k} AB^(k-1-j) G x_j come from one product with a block-lower-
triangular matrix of powers of AB (precomputed on the host in f64), so a
frame costs four matmuls per biquad instead of a loop over blocks.  At 192
kHz AB's powers decay (|eig| = r^B, ~e^-0.6 a block of 480 for the 38 Hz
high-pass), so the closed form is well conditioned; it agrees with the JAX
package's block loop to rounding (tests/test_torch_ebur128.py gates 1e-9
LU).  Products run in the input's dtype with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import device as _default_device, no_tf32

MODE_M = 1 << 0
MODE_S = 1 << 1
MODE_I = 1 << 2
MODE_LRA = 1 << 3
MODE_SAMPLE_PEAK = 1 << 4
MODE_TRUE_PEAK = 1 << 5
MODE_HISTOGRAM = 1 << 6

HIST_BINS = 1000
TP_TAPS = 49


# ---------------------------------------------------------------------------
# K-weighting filter design (host, f64)
# ---------------------------------------------------------------------------
def k_weighting_coeffs(rate: int) -> Tuple[np.ndarray, np.ndarray]:
    """(b, a) of the two cascaded biquads, each [2, 3] f64, from the BS.1770
    analog prototypes at any sample rate (libebur128's derivation)."""
    f0 = 1681.974450955533
    G = 3.999843853973347
    Q = 0.7071752369554196
    K = math.tan(math.pi * f0 / rate)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh**0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b1 = np.array([(Vh + Vb * K / Q + K * K) / a0,
                   2.0 * (K * K - Vh) / a0,
                   (Vh - Vb * K / Q + K * K) / a0])
    a1 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])

    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = math.tan(math.pi * f0 / rate)
    a0 = 1.0 + K / Q + K * K
    b2 = np.array([1.0, -2.0, 1.0])
    a2 = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    return np.stack([b1, b2]), np.stack([a1, a2])


def _pick_block(n: int, target: int = 2048) -> int:
    """Largest divisor of n that is <= target."""
    best = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            if d <= target:
                best = max(best, d)
            if n // d <= target:
                best = max(best, n // d)
        d += 1
    return best


_HOST_MATS: Dict[tuple, tuple] = {}
_DEVICE_MATS: Dict[tuple, tuple] = {}


def _biquad_block_mats(b, a, block: int):
    """Host f64 operators of the blocked IIR (the JAX package's
    `_biquad_block_mats`): with s[n] = A s[n-1] + Bv x[n] and
    y[n] = C s[n-1] + b0 x[n],

      y_block = T @ x_block + S0 @ s_in,   s_out = AB @ s_in + G @ x_block."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    b0, b1_, b2_ = b
    _, a1_, a2_ = a
    A = np.array([[-a1_, 1.0], [-a2_, 0.0]])
    Bv = np.array([b1_ - a1_ * b0, b2_ - a2_ * b0])
    pows = [np.eye(2)]
    for _ in range(block):
        pows.append(A @ pows[-1])
    f = np.array([(p @ Bv)[0] for p in pows])
    T = np.zeros((block, block))
    idx = np.arange(block)
    T[idx, idx] = b0
    for n in range(1, block):
        T[n, :n] = f[n - 1 - np.arange(n)]
    S0 = np.stack([pows[n][0, :] for n in range(block)])
    G = np.stack([pows[block - 1 - k] @ Bv for k in range(block)], axis=1)
    return T, S0, G, pows[block]


def _state_mats(AB: np.ndarray, nb: int):
    """M [2(nb+1), 2nb] and Q [2(nb+1), 2] (host f64) with the block-start
    states of all nb blocks and the exit state as M @ u + Q @ s_0, where
    u = (G x_0, ..., G x_{nb-1}) stacked: block (k, j) of M is AB^(k-1-j)
    for j < k, block k of Q is AB^k."""
    pows = [np.eye(2)]
    for _ in range(nb):
        pows.append(AB @ pows[-1])
    P = np.stack(pows)  # [nb + 1, 2, 2]
    lag = np.arange(nb + 1)[:, None] - 1 - np.arange(nb)[None, :]  # k - 1 - j
    blocks = P[np.clip(lag, 0, None)] * (lag >= 0)[:, :, None, None]  # [nb+1, nb, 2, 2]
    M = blocks.transpose(0, 2, 1, 3).reshape(2 * (nb + 1), 2 * nb)
    return M, P.reshape(2 * (nb + 1), 2)


def _mats(b, a, block: int, nb: int, dtype, dev):
    """(T, S0, G, M, Q) as tensors of dtype on dev, cached."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    key = (b.tobytes(), a.tobytes(), block, nb, dtype, str(dev))
    hit = _DEVICE_MATS.get(key)
    if hit is not None:
        return hit
    hkey = (b.tobytes(), a.tobytes(), block, nb)
    host = _HOST_MATS.get(hkey)
    if host is None:
        T, S0, G, AB = _biquad_block_mats(b, a, block)
        host = (T, S0, G, *_state_mats(AB, nb))
        _HOST_MATS[hkey] = host
    out = tuple(torch.as_tensor(m, dtype=dtype).to(dev) for m in host)
    _DEVICE_MATS[key] = out
    return out


def biquad_apply(x, b, a, zi, block_target: int = 512):
    """One biquad along the leading axis of x [N, ch]; zi [2, ch] is the
    direct-form-II-transposed state.  Returns (y [N, ch], zf [2, ch])."""
    N, ch = x.shape
    block = _pick_block(N, block_target)
    nb = N // block
    T, S0, G, M, Q = _mats(b, a, block, nb, x.dtype, x.device)
    with no_tf32():
        xc = x.reshape(nb, block, ch).permute(1, 0, 2).reshape(block, nb * ch)
        u = (G @ xc).reshape(2, nb, ch).permute(1, 0, 2).reshape(2 * nb, ch)
        states = (M @ u + Q @ zi).reshape(nb + 1, 2, ch)
        s_in = states[:nb].permute(1, 0, 2).reshape(2, nb * ch)
        y = T @ xc + S0 @ s_in
    y = y.reshape(block, nb, ch).permute(1, 0, 2).reshape(N, ch)
    return y, states[nb]


def k_filter_apply(x, coeffs_b, coeffs_a, zi):
    """The two-stage K-weighting cascade.  x [N, ch]; zi [2, 2, ch]."""
    y1, z1 = biquad_apply(x, coeffs_b[0], coeffs_a[0], zi[0])
    y2, z2 = biquad_apply(y1, coeffs_b[1], coeffs_a[1], zi[1])
    return y2, torch.stack([z1, z2])


def channel_weights(positions: Sequence) -> np.ndarray:
    """BS.1770 weights: 1.0 front/mono/side, 1.41 rear, 0 for LFE/none."""
    w = []
    for p in positions:
        name = getattr(p, "value", p)
        if name in ("lfe1", "lfe2", "none", "unused"):
            w.append(0.0)
        elif name in ("rear-left", "rear-right", "rear-center", "surround-left",
                      "surround-right"):
            w.append(1.41)
        else:
            w.append(1.0)
    return np.asarray(w, np.float64)


def _hist_constants():
    """Histogram bin energies [1000] and boundaries [1001] (host f64)."""
    i = np.arange(HIST_BINS)
    energies = 10.0 ** ((i / 10.0 - 69.95 + 0.691) / 10.0)
    boundaries = 10.0 ** ((np.arange(HIST_BINS + 1) / 10.0 - 70.0 + 0.691) / 10.0)
    return energies, boundaries


def energy_to_loudness(e):
    return -0.691 + 10.0 * torch.log10(torch.clamp_min(e, 1e-70))


def _hist_index(energy):
    """Bin index [..] int64 for energies above boundaries[0]."""
    l = -0.691 + 10.0 * torch.log10(torch.clamp_min(energy, 1e-70))
    return torch.clamp(torch.floor((l + 70.0) * 10.0), 0, HIST_BINS - 1).to(torch.int64)


# ---------------------------------------------------------------------------
# State and parameters
# ---------------------------------------------------------------------------
class R128State(NamedTuple):
    filt_z: torch.Tensor            # [2, 2, ch] biquad states
    subblocks: torch.Tensor         # [30] ring of 100 ms energy sums
    sb_count: int                   # subblocks seen
    st_counter: int                 # subblocks since the last short-term block
    block_hist: torch.Tensor        # [1000] momentary 400 ms block counts
    st_hist: torch.Tensor           # [1000] short-term 3 s block counts
    sample_peak: torch.Tensor       # [ch] all-time max
    prev_sample_peak: torch.Tensor  # [ch] of the last add
    true_peak: torch.Tensor         # [ch]
    prev_true_peak: torch.Tensor    # [ch]
    tp_tail: torch.Tensor           # [taps_per_phase - 1, ch] interpolator history


class R128Params(NamedTuple):
    coeffs_b: np.ndarray     # [2, 3] f64 (host: the block operators derive from it)
    coeffs_a: np.ndarray
    weights: torch.Tensor    # [ch]
    energies: torch.Tensor   # [1000] bin centres
    boundaries: torch.Tensor  # [1001]
    tp_filter: torch.Tensor  # [factor, taps_per_phase] polyphase FIR (or [1, 1])
    n100: int                # samples per 100 ms subblock
    tp_factor: int           # true-peak oversampling factor


def _true_peak_filter(factor: int) -> np.ndarray:
    """Windowed-sinc polyphase interpolator (49 taps, Hann), like libebur128."""
    taps = TP_TAPS
    m = np.arange(taps) - (taps - 1) / 2.0
    with np.errstate(invalid="ignore"):
        sinc = np.where(m == 0, 1.0, np.sin(m * np.pi / factor) / (m * np.pi / factor))
    win = 0.5 * (1.0 + np.cos(2.0 * np.pi * m / (taps - 1)))
    h = sinc * win
    poly = np.zeros((factor, int(np.ceil(taps / factor))), np.float64)
    for i in range(taps):
        poly[i % factor, i // factor] = h[i]
    return poly


def r128_params(rate: int, positions: Sequence, dtype=torch.float64, dev=None) -> R128Params:
    dev = _default_device() if dev is None else torch.device(dev)
    b, a = k_weighting_coeffs(rate)
    energies, boundaries = _hist_constants()
    factor = 4 if rate < 96000 else (2 if rate < 192000 else 1)
    tp = _true_peak_filter(factor) if factor > 1 else np.ones((1, 1))

    def t(v):
        return torch.as_tensor(v, dtype=dtype).to(dev)

    return R128Params(b, a, t(channel_weights(positions)), t(energies), t(boundaries), t(tp),
                      rate // 10, factor)


def r128_init(params: R128Params, channels: int) -> R128State:
    dtype, dev = params.weights.dtype, params.weights.device

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return R128State(z(2, 2, channels), z(30), 0, 0, z(HIST_BINS), z(HIST_BINS),
                     z(channels), z(channels), z(channels), z(channels),
                     z(params.tp_filter.shape[1] - 1, channels))


# ---------------------------------------------------------------------------
# Processing.  Every function takes any leading stream axes [...] on the state
# leaves and the input (none for one analyser, [N] for a bank of N): the two
# counters are shared, since a bank's streams advance in lockstep.  A bank's
# K-filter runs all N x ch columns through one set of block products and its
# histograms take one index_add over all streams.
# ---------------------------------------------------------------------------
def r128_update_peaks(state: R128State, params: R128Params, x, first: bool = True) -> R128State:
    """Sample and true peaks of a chunk x [..., L, ch].  `first` marks the
    first chunk of an add: the prev_* peaks restart there."""
    sp = x.abs().amax(-2)
    if params.tp_factor == 1:
        tp, tail = sp, state.tp_tail
    else:
        hist_len = state.tp_tail.shape[-2]
        ext = torch.cat([state.tp_tail, x], -2)
        windows = ext.unfold(-2, hist_len + 1, 1)  # [..., L, ch, taps_pp]: ext[l + j]
        with no_tf32():
            ups = torch.einsum("pj,...ncj->...npc", params.tp_filter.flip(1), windows)
        tp = ups.abs().amax((-3, -2))
        tail = ext[..., ext.shape[-2] - hist_len:, :]
    if first:
        prev_sp, prev_tp = sp, tp
    else:
        prev_sp = torch.maximum(state.prev_sample_peak, sp)
        prev_tp = torch.maximum(state.prev_true_peak, tp)
    return state._replace(sample_peak=torch.maximum(state.sample_peak, sp),
                          prev_sample_peak=prev_sp,
                          true_peak=torch.maximum(state.true_peak, tp),
                          prev_true_peak=prev_tp, tp_tail=tail)


def _counter_steps(state: R128State, B: int):
    """The subblock counters after B subblocks, and for each step whether a
    momentary block (from the 4th subblock on) and a short-term block (every
    10th step after the 30th) count.  The counters are host ints: which
    steps count is known without the data."""
    sb, st = state.sb_count, state.st_counter
    m_on, s_on = [], []
    for _ in range(B):
        sb += 1
        st += 1
        m_on.append(sb >= 4)
        fire = st >= 30
        s_on.append(fire)
        if fire:
            st = 20
    return sb, st, m_on, s_on


def _hist_add(hist, e, floor):
    """hist [..., HIST_BINS] plus one count for each energy of e [..., K]
    at or above floor: one index_add over all streams."""
    idx = _hist_index(e)
    if hist.dim() > 1:
        lead = hist.shape[:-1]
        rows = torch.arange(math.prod(lead), device=e.device).reshape(*lead, 1)
        idx = rows * HIST_BINS + idx
    return hist.reshape(-1).index_add(0, idx.reshape(-1),
                                      (e >= floor).to(e.dtype).reshape(-1)).reshape(hist.shape)


def _ingest_subblock_energies(state: R128State, params: R128Params, e) -> R128State:
    """The JAX package's per-subblock scan over e [..., B], all subblocks at
    once: the ring after subblock i is seq[i+1 : i+31] of seq = (ring, e)."""
    B = int(e.shape[-1])
    n100 = params.n100
    seq = torch.cat([state.subblocks, e], -1)
    me = seq.unfold(-1, 4, 1)[..., 27:27 + B, :].sum(-1) / (4.0 * n100)
    se = seq.unfold(-1, 30, 1)[..., 1:1 + B, :].sum(-1) / (30.0 * n100)
    sb, st, m_on, s_on = _counter_steps(state, B)
    floor = params.boundaries[0]
    block_hist, st_hist = state.block_hist, state.st_hist
    # momentary blocks count from the 4th subblock on (a suffix of the steps);
    # short-term blocks fire every 10th step: slices, no index upload
    if any(m_on):
        block_hist = _hist_add(block_hist, me[..., m_on.index(True):], floor)
    for i in (i for i, on in enumerate(s_on) if on):
        st_hist = _hist_add(st_hist, se[..., i:i + 1], floor)
    return state._replace(subblocks=seq[..., B:], sb_count=sb, st_counter=st,
                          block_hist=block_hist, st_hist=st_hist)


def r128_add_full_subblocks(state: R128State, params: R128Params, x) -> R128State:
    """x [..., B * n100, ch], a whole number of 100 ms subblocks: K-weighting,
    subblock energies, gating histograms, sample and true peaks."""
    n100 = params.n100
    *lead, L, ch = x.shape
    B = L // n100
    state = r128_update_peaks(state, params, x, first=True)
    cols = x.movedim(-2, 0).reshape(L, -1)  # stream-major columns
    zi = state.filt_z.movedim((-3, -2), (0, 1)).reshape(2, 2, -1)
    y, zf = k_filter_apply(cols, params.coeffs_b, params.coeffs_a, zi)
    filt_z = zf.reshape(2, 2, *lead, ch).movedim((0, 1), (-3, -2))
    wsq = (y * y).reshape(L, *lead, ch) @ params.weights  # [L, ...]
    e = wsq.reshape(B, n100, *lead).sum(1).movedim(0, -1)  # [..., B]
    return _ingest_subblock_energies(state._replace(filt_z=filt_z), params, e)


# ---------------------------------------------------------------------------
# Queries (device tensors; one value a stream)
# ---------------------------------------------------------------------------
def loudness_momentary(state: R128State, params: R128Params):
    return energy_to_loudness(state.subblocks[..., -4:].sum(-1) / (4.0 * params.n100))


def loudness_shortterm(state: R128State, params: R128Params):
    return energy_to_loudness(state.subblocks.sum(-1) / (30.0 * params.n100))


def relative_threshold_energy(state: R128State, params: R128Params):
    total = state.block_hist.sum(-1)
    mean_e = torch.where(total > 0,
                         (state.block_hist * params.energies).sum(-1) / torch.clamp_min(total, 1.0),
                         torch.zeros_like(total))
    return mean_e * 0.1


def _gate_start(boundaries, e):
    """[..., 1] first histogram bin at or above each energy of e [...]."""
    start = torch.searchsorted(boundaries[:HIST_BINS].contiguous(), e.unsqueeze(-1).contiguous(),
                               right=True) - 1
    return torch.clamp(start, 0, HIST_BINS - 1)


def loudness_global(state: R128State, params: R128Params):
    """Integrated loudness, absolute (-70) and relative (-10 LU) gated, each
    stream on its own histogram."""
    start = _gate_start(params.boundaries, relative_threshold_energy(state, params))
    mask = torch.arange(HIST_BINS, device=start.device) >= start
    hist = state.block_hist * mask
    cnt = hist.sum(-1)
    e = (hist * params.energies).sum(-1) / torch.clamp_min(cnt, 1.0)
    return torch.where(cnt > 0, energy_to_loudness(e), torch.full_like(e, -math.inf))


def loudness_range(state: R128State, params: R128Params):
    """LRA of one analyser: 10th..95th percentile of the relative-gated
    (-20 LU) short-term blocks."""
    hist = state.st_hist
    total = hist.sum()
    power = (hist * params.energies).sum() / torch.clamp_min(total, 1.0)
    start = _gate_start(params.boundaries, power * (10.0 ** (-20.0 / 10.0)))
    gated = hist * (torch.arange(HIST_BINS, device=start.device) >= start)
    n = gated.sum()
    cums = torch.cumsum(gated, 0)
    low_bin = (cums > (n - 1.0) * 0.10 + 0.5).to(torch.int32).argmax().reshape(1)
    high_bin = (cums > (n - 1.0) * 0.95 + 0.5).to(torch.int32).argmax().reshape(1)
    # index_select, not [bin]: a 0-d index tensor would be read back to the host
    lra = (energy_to_loudness(params.energies.index_select(0, high_bin))
           - energy_to_loudness(params.energies.index_select(0, low_bin)))[0]
    return torch.where((total > 0) & (n > 0), lra, torch.zeros_like(lra))


def queries(state: R128State, params: R128Params):
    """All query values of one analyser as one 1-D tensor (one read-back):
    momentary, short-term, global, relative threshold, LRA, then per channel
    the sample peak, true peak (>= sample peak), and the last add's two."""
    scalars = torch.stack([
        loudness_momentary(state, params),
        loudness_shortterm(state, params),
        loudness_global(state, params),
        energy_to_loudness(relative_threshold_energy(state, params)),
        loudness_range(state, params),
    ])
    return torch.cat([scalars, state.sample_peak,
                      torch.maximum(state.true_peak, state.sample_peak),
                      state.prev_sample_peak,
                      torch.maximum(state.prev_true_peak, state.prev_sample_peak)])


# ---------------------------------------------------------------------------
# A bank of N analysers (the stream bank): every state leaf but the two
# counters carries a leading [N] axis
# ---------------------------------------------------------------------------
def r128_init_batched(params: R128Params, channels: int, n: int) -> R128State:
    one = r128_init(params, channels)
    return one._replace(**{f: getattr(one, f).expand((n,) + getattr(one, f).shape).clone()
                           for f in R128State._fields if f not in ("sb_count", "st_counter")})


def merged_loudness_global(states_batched: R128State, params: R128Params):
    """Integrated loudness of N streams measured as one programme: the
    gated-block histograms summed over the stream axis, then the absolute
    and relative gating once on the merged histogram (the JAX package's
    `merged_loudness_global`, a psum when its stream axis is sharded)."""
    merged = states_batched.block_hist.sum(0)
    return loudness_global(states_batched._replace(block_hist=merged), params)


# ---------------------------------------------------------------------------
# Host-side streaming wrapper (ebur128level; audioloudnorm composes the
# functions above)
# ---------------------------------------------------------------------------
class EbuR128:
    """Streaming analyser: device state plus the sub-100 ms remainder."""

    def __init__(self, channels: int, rate: int, positions: Optional[Sequence] = None,
                 dtype=torch.float64, device=None):
        from ..core.audio import default_channel_positions

        self.channels = channels
        self.rate = rate
        self.dtype = dtype
        self.device = _default_device() if device is None else torch.device(device)
        positions = positions or default_channel_positions(channels)
        self.params = r128_params(rate, positions, dtype, self.device)
        self.state = r128_init(self.params, channels)
        self._rem = None
        self._qcache = None
        self._qcache_state = None

    def add_frames(self, x) -> None:
        """Feed frames [n, ch].  Loudness, histograms and peaks advance on the
        100 ms subblock grid; a trailing partial subblock waits for more."""
        x = torch.as_tensor(x).to(self.device, self.dtype)
        buf = torch.cat([self._rem, x], 0) if self._rem is not None else x
        n100 = self.params.n100
        pos, avail = 0, buf.shape[0]
        for bucket in (10 * n100, n100):
            while avail - pos >= bucket:
                self.state = r128_add_full_subblocks(self.state, self.params,
                                                     buf[pos:pos + bucket])
                pos += bucket
        self._rem = buf[pos:] if pos < avail else None

    def _q(self) -> np.ndarray:
        if self._qcache_state is not self.state:
            self._qcache = queries(self.state, self.params).cpu().numpy()
            self._qcache_state = self.state
        return self._qcache

    def loudness_momentary(self) -> float:
        return float(self._q()[0])

    def loudness_shortterm(self) -> float:
        return float(self._q()[1])

    def loudness_global(self) -> float:
        return float(self._q()[2])

    def relative_threshold(self) -> float:
        return float(self._q()[3])

    def loudness_range(self) -> float:
        return float(self._q()[4])

    def _peak(self, kind: int, ch: int) -> float:
        return float(self._q()[5 + kind * self.channels + ch])

    def sample_peak(self, ch: int) -> float:
        return self._peak(0, ch)

    def true_peak(self, ch: int) -> float:
        return self._peak(1, ch)

    def prev_sample_peak(self, ch: int) -> float:
        return self._peak(2, ch)

    def prev_true_peak(self, ch: int) -> float:
        return self._peak(3, ch)

    def reset(self) -> None:
        self.state = r128_init(self.params, self.channels)
        self._rem = None
        self._qcache_state = None


__all__ = [
    "MODE_M", "MODE_S", "MODE_I", "MODE_LRA", "MODE_SAMPLE_PEAK", "MODE_TRUE_PEAK",
    "MODE_HISTOGRAM", "EbuR128", "R128Params", "R128State", "biquad_apply",
    "channel_weights", "energy_to_loudness", "k_filter_apply", "k_weighting_coeffs",
    "loudness_global", "loudness_momentary", "loudness_range", "loudness_shortterm",
    "merged_loudness_global", "queries", "r128_add_full_subblocks", "r128_init",
    "r128_init_batched", "r128_params", "r128_update_peaks", "relative_threshold_energy",
]
