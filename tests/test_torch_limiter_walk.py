"""A host model of the limiter kernel's event walk, held bit for bit to the
plain per-sample FSM.

csrc/loudnorm_limiter.cu cannot run without a card, so this module keeps a
model of its algorithm in numpy and Python scalars, phase by phase:
detection at the window rows the output reads (the peaks in order and tp /
pv at each), the walk on one thread (the gaps between peaks in closed form,
the scan's step at each peak, one segment per change, a later change at the
same sample replacing the earlier), the carry at the frame's end, and the
fill (each sample's segment by a prefix count of the segment starts, its
gain with the scan's expressions and roundings, the scale and the clamp).
The model is held to `limiter_frame_plain` (which tests/test_torch_loudnorm.py
holds to the jitted JAX scan) on seeded frames, f64 and f32: sparse, dense,
clipped (every sample a peak), peaks at n = 0 and n = FRAME - 1, a peak-free
frame, a single late peak, from the standard carries and every boundary
carry (env 1,919, 1,920, 19,199, 19,200 with sus 0, 1, -1 in each state).
The card tests (tests/test_torch_kernels_cuda.py) hold the kernel itself
to the same plain version.
"""
import functools

import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim
from gst_plugins_rs_tpu_torch.ops.loudnorm_limiter import _fma32, _fma64

FRAME, L = lim.FRAME, lim.LIMITER_LOOKAHEAD
ATTACK, RELEASE = lim.LIMITER_ATTACK, lim.LIMITER_RELEASE
OUT, ATT, SUS, REL = lim.ST_OUT, lim.ST_ATTACK, lim.ST_SUSTAIN, lim.ST_RELEASE
W = 40320  # the limiter window audioloudnorm passes (FRAME + TAIL)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the port's other audio tests run: the frames
    are small, and the other test workers keep their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def detect(x, tp):
    """Phases 1-2: the peak positions in order and tp / pv there.  x is a
    numpy [W, ch] window, tp of its dtype.  A position is a peak where on
    some channel |x| at row L + n is above tp and none of rows L + n - 1,
    L + n + 1 .. L + n + 11 is higher; pv is the max |x| over the channels
    (NaN wins, as torch's amax)."""
    a = np.abs(x)
    idx = np.arange(FRAME)
    this = a[L + idx]
    nb = np.stack([a[L - 1 + idx]] + [a[L + j + idx] for j in range(1, 12)])
    peak = ((this > tp) & (nb <= this).all(0)).any(1)
    pos = np.flatnonzero(peak)
    pv = this[pos].max(1)
    one = x.dtype.type(1.0)
    gr = tp / np.where(pv > 0, pv, one)
    return pos, gr


class Walk:
    """The kernel's Walker: the FSM of one stream stepping from event to
    event, each change of state starting a segment [start, state, env -
    start, gr0, gr1]; model_frame steps over runs of peaks that change
    nothing but sus, as the kernel's warp does."""

    def __init__(self, carry_i, carry_f, F, fma):
        self.st, self.env, self.sus = (int(v) for v in carry_i)
        self.gr0, self.gr1 = (F(v) for v in carry_f)
        self.F, self.fma = F, fma
        self.segs = []

    def emit(self, start):
        rec = [start, self.st, self.env - start, self.gr0, self.gr1]
        if self.segs and self.segs[-1][0] == start:
            self.segs[-1] = rec  # a later change at the same sample replaces it
        else:
            self.segs.append(rec)

    def advance(self, a, t, later):
        """Samples a .. t-1, none a peak; later: a peak follows."""
        while a < t:
            if self.st == ATT:
                if self.env >= ATTACK:
                    self.st = SUS
                    self.emit(a)
                    continue
                n = min(t - a, ATTACK - self.env)
                a, self.env = a + n, self.env + n
            elif self.st == SUS:
                if later:
                    if self.sus > 0:
                        self.sus = max(self.sus - (t - a), 0)
                    return
                if self.sus > 0:
                    n = min(self.sus, t - a)
                    self.sus, a = self.sus - n, a + n
                    continue
                self.gr0, self.gr1, self.env, self.st = self.gr1, self.F(1.0), 0, REL
                self.emit(a)
            elif self.st == REL:
                if self.env >= RELEASE:
                    self.st = OUT
                    self.emit(a)
                    continue
                n = min(t - a, RELEASE - self.env)
                a, self.env = a + n, self.env + n
            else:
                return

    def peak(self, t, new_gr):
        F, fma = self.F, self.fma
        one, zero, tiny = F(1.0), F(0.0), F(-1e-30)
        att_den = F(ATTACK - 1.0)
        att_rcp, rel_rcp = one / att_den, one / F(RELEASE - 1.0)
        envf = F(self.env)
        chg = False
        if self.st == ATT and self.env >= ATTACK:
            self.st, chg = SUS, True
        if self.st == REL and self.env >= RELEASE:
            self.st, chg = OUT, True
        gr0, gr1 = self.gr0, self.gr1
        if self.st == OUT:
            self.gr0, self.gr1, self.env, self.sus, self.st = one, new_gr, 0, -1, ATT
            chg = True
        elif self.st == ATT:
            if new_gr < gr1:
                cur_att = fma(-(envf * att_rcp), gr0 - gr1, gr0)
                old_slope = -(gr0 - gr1)
                new_slope = -(cur_att - new_gr)
                if new_slope <= old_slope:
                    self.gr0, self.gr1, self.env, self.sus = cur_att, new_gr, 0, -1
                else:
                    safe = old_slope if old_slope != zero else tiny
                    new_end = max((new_gr - gr0) / safe, one)
                    adj_gr0 = fma(new_end - one, old_slope, gr0)
                    cur_pos = min(max((cur_att - adj_gr0) / safe, zero), one)
                    adj_env = int(att_den * cur_pos)
                    self.gr0, self.gr1, self.env, self.sus = adj_gr0, new_gr, adj_env, adj_env
                chg = True
            elif self.env < ATTACK:
                self.sus = self.env
        elif self.st == SUS:
            if new_gr < gr1:
                self.gr0, self.gr1, self.env, self.sus, self.st = gr1, new_gr, 0, -1, ATT
                chg = True
            else:
                self.sus = L
        else:
            cur_rel = fma(-(envf * rel_rcp), gr1 - gr0, gr0)
            if new_gr < cur_rel:
                self.gr0, self.gr1, self.env, self.sus, self.st = cur_rel, new_gr, 0, -1, ATT
            else:
                self.gr1, self.st = cur_rel, SUS
            chg = True
        if chg:
            self.emit(t)
        if self.st in (ATT, REL):
            self.env += 1


@functools.lru_cache(maxsize=None)
def _gain(f32, st, env, gr0, gr1):
    """An Attack's or a Release's gain at envelope count env, with the
    scan's roundings (a pure function of its arguments, so the many frames
    and carries of these tests share it; f32 is in the key because an f32
    gain equals an f64 one of the same value)."""
    F, fma = (np.float32, _fma32) if f32 else (float, _fma64)
    one = F(1.0)
    if st == ATT:
        return fma(-(F(env) * (one / F(ATTACK - 1.0))), gr0 - gr1, gr0)
    return fma(-(F(env) * (one / F(RELEASE - 1.0))), gr1 - gr0, gr0)


def model_frame(window, carry_i, carry_f, tp, peaks=None):
    """The kernel's four phases on the host: (out, carry_i, carry_f, peaks,
    segments).  peaks: detect()'s result for this window, if known."""
    x = window.numpy()
    dtype = window.dtype
    F, fma = (float, _fma64) if dtype == torch.float64 else (np.float32, _fma32)
    pos, gr = detect(x, x.dtype.type(tp)) if peaks is None else peaks
    if int(carry_i[0]) == OUT and len(pos) == 0:  # idle: decided from the count
        return (torch.clamp(window[:FRAME], -tp, tp), carry_i.clone(), carry_f.clone(), 0, 0)
    w = Walk(carry_i.tolist(), carry_f.tolist(), F, fma)
    w.emit(0)
    pos, gr = pos.tolist(), [F(g) for g in gr.tolist()]
    a = i = 0
    while i < len(pos):
        t = pos[i]
        w.advance(a, t, later=True)
        if w.st in (ATT, SUS):
            # a run of peaks that change nothing but sus, stepped over (the
            # kernel's warp tests 32 of them a ballot)
            q = t + (ATTACK - w.env) if w.st == ATT else FRAME
            j = i
            while j < len(pos) and pos[j] < q and not gr[j] < w.gr1:
                j += 1
            if j > i:
                if w.st == ATT:
                    w.sus = w.env + (pos[j - 1] - t)
                    w.env = w.sus + 1
                else:
                    w.sus = L
                a, i = pos[j - 1] + 1, j
                continue
        w.peak(t, gr[i])
        a, i = t + 1, i + 1
    w.advance(a, FRAME, later=False)
    segs = w.segs
    starts = [s[0] for s in segs]
    assert starts[0] == 0 and starts == sorted(set(starts)) and len(segs) <= FRAME
    # the fill: a sample's segment is the count of starts at or before it, less one
    start_bits = np.zeros(FRAME, np.int64)
    start_bits[starts] = 1
    seg_of = np.cumsum(start_bits) - 1
    np_dtype = x.dtype.type
    mult = np.empty(FRAME, np_dtype)
    for k, (start, st, env0, gr0, gr1) in enumerate(segs):
        end = starts[k + 1] if k + 1 < len(segs) else FRAME
        assert (seg_of[start:end] == k).all()
        if st == OUT:
            mult[start:end] = F(1.0)
        elif st == SUS:
            mult[start:end] = gr1
        else:
            mult[start:end] = [_gain(F is np.float32, st, env0 + n, gr0, gr1)
                                 for n in range(start, end)]
    out = torch.clamp(window[:FRAME] * torch.from_numpy(mult)[:, None], -tp, tp)
    return (out, torch.tensor([w.st, w.env, w.sus], dtype=torch.int32),
            torch.from_numpy(np.asarray([w.gr0, w.gr1], np_dtype)), len(pos), len(segs))


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------
def _frame(kind):
    """A [W, 2] window: quiet noise and the kind's peaks."""
    rng = np.random.RandomState(7)
    x = rng.uniform(-0.3, 0.3, (W, 2))
    if kind == "sparse":  # chip_smoke.py's peaky frame: a tick burst and two close peaks
        t = np.arange(2000) / 192000
        x[4000:6000] = 1.2 * np.sin(2 * np.pi * 440 * t)[:, None]
        x[12000, 0], x[13700, 1] = 0.95, 1.0
    elif kind == "dense":  # noise across the target: thousands of peaks, restarts, steepening
        x = np.random.RandomState(6).uniform(-1.2, 1.2, (W, 2))
        x[::7] *= 0.5
    elif kind == "clipped":  # a +-1.2 square wave: every sample a peak
        x[:] = np.where((np.arange(W) // 218) % 2 == 0, 1.2, -1.2)[:, None]
    elif kind == "edges":  # peaks at n = 0 and n = FRAME - 1, a higher one between
        x[L, 0], x[L + 9000, 1], x[L + FRAME - 1, 1] = 0.9, 1.1, 0.95
    elif kind == "late":  # one peak late in the frame: a Sustain holds until it
        x[L + 15000, 0] = 0.95
    return x


CARRIES = [(0, 0, -1, 0.0, 0.0), (1, 500, -1, 0.9, 0.6), (2, 0, 100, 0.7, 0.5),
           (3, 3000, -1, 0.5, 1.0)]
# every state at the envelope and sustain counts where a gap turns
BOUNDARY = [(st, env, sus, 0.8, 0.6) for st in (OUT, ATT, SUS, REL)
            for env in (1919, 1920, 19199, 19200) for sus in (0, 1, -1)]


@functools.lru_cache(maxsize=None)
def _case(kind, dtype):
    """(window, tp, precompute_peaks, detect) of a frame kind in a dtype."""
    npdt = np.float64 if dtype == "f64" else np.float32
    tp = float(npdt(10 ** (-2 / 20)))
    w = torch.from_numpy(_frame(kind).astype(npdt))
    return w, tp, lim.precompute_peaks(w, tp), detect(w.numpy(), npdt(tp))


def _check(kind, carry, dtype, expect=None):
    w, tp, (pk, pv, fut), peaks = _case(kind, dtype)
    ci = torch.tensor(carry[:3], dtype=torch.int32)
    cf = torch.tensor(carry[3:], dtype=w.dtype)
    out, mi, mf, peaks, segs = model_frame(w, ci, cf, tp, peaks)
    ref, ri, rf = lim.limiter_frame_plain(w, ci, cf, tp, pk, pv, fut)
    assert peaks == int(pk.sum())
    diff = np.flatnonzero((out != ref).any(1).numpy())
    assert diff.size == 0, f"{kind} {carry} {dtype}: first differing samples {diff[:5]}"
    assert torch.equal(mi, ri) and torch.equal(mf, rf), (kind, carry, dtype, mi, ri, mf, rf)
    if expect is not None:
        assert (peaks, segs) == expect, (kind, carry, peaks, segs)
    return peaks, segs


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_model_detection_equals_precompute_peaks(dtype):
    npdt = np.float64 if dtype == "f64" else np.float32
    tp = npdt(10 ** (-2 / 20))
    for kind in ("sparse", "dense", "clipped", "edges", "late", "none"):
        x = _frame(kind).astype(npdt)
        pos, gr = detect(x, tp)
        pk, pv, fut = lim.precompute_peaks(torch.from_numpy(x), float(tp))
        assert np.array_equal(np.flatnonzero(pk.numpy()), pos), kind
        # in the kernel, future[n] is n <= the last peak's position
        last = pos[-1] if pos.size else -1
        assert np.array_equal(fut.numpy(), np.arange(FRAME) <= last), kind
        assert np.array_equal(gr, tp / np.where(pv.numpy()[pos] > 0, pv.numpy()[pos], 1)), kind
    assert detect(_frame("clipped").astype(npdt), tp)[0].size == FRAME
    assert list(detect(_frame("edges").astype(npdt), tp)[0]) == [0, 9000, FRAME - 1]


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["sparse", "dense", "clipped", "edges"])
def test_walk_equals_plain(kind, dtype):
    for carry in CARRIES:
        _check(kind, carry, dtype)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_walk_clipped_frame_walks_every_sample_in_two_segments(dtype):
    """From Out: the attack at n = 0, the sustain at n = ATTACK; the 19,198
    other peaks change nothing."""
    assert _check("clipped", CARRIES[0], dtype, expect=(FRAME, 2)) == (FRAME, 2)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_walk_boundary_carries_equal_plain(dtype):
    """Every state at the counts where a gap turns, on a frame with no peak
    (future false from n = 0); an Attack and a Sustain also on one with a
    single late peak, which the Sustain holds for."""
    for carry in BOUNDARY:
        _check("none", carry, dtype)
        if carry[0] in (ATT, SUS):
            _check("late", carry, dtype)


def test_walk_sustain_after_attack():
    """sus == -1 after an attack: with no later peak the sustain releases on
    its first sample; with a later peak it holds until that peak."""
    _, segs = _check("none", (ATT, 1910, -1, 0.9, 0.6), "f64")
    assert segs == 2  # the attack's last 10 samples, then the release at once
    _, segs = _check("late", (ATT, 1910, -1, 0.9, 0.6), "f64")
    assert segs >= 2


def test_wrapper_equals_precompute_peaks_and_plain():
    """On the CPU the wrappers are precompute_peaks followed by the plain
    FSM, for one stream and for N."""
    x = np.stack([_frame(k) for k in ("sparse", "none", "edges")])
    w = torch.from_numpy(x)
    tp = 10 ** (-2 / 20)
    ci = torch.tensor([[0, 0, -1], [2, 1920, 1], [3, 19199, -1]], dtype=torch.int32)
    cf = torch.tensor([[0.0, 0.0], [0.7, 0.5], [0.5, 1.0]], dtype=torch.float64)
    out, ni, nf = lim.limiter_frames(w, ci, cf, tp)
    ref = lim.limiter_frames_plain(w, ci, cf, tp, *lim.precompute_peaks(w, tp))
    assert all(torch.equal(a, b) for a, b in zip((out, ni, nf), ref))
    for n in range(3):
        one = lim.limiter_frame(w[n], ci[n], cf[n], tp)
        ref = lim.limiter_frame_plain(w[n], ci[n], cf[n], tp, *lim.precompute_peaks(w[n], tp))
        assert all(torch.equal(a, b) for a, b in zip(one, ref))
        assert all(torch.equal(a, b[n]) for a, b in zip(one, (out, ni, nf)))
    with pytest.raises(ValueError):
        lim.limiter_frame(w[0], ci[0], cf[0], tp, walk_stats=torch.zeros(3, dtype=torch.int32))
