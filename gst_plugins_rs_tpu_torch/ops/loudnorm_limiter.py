"""The true-peak limiter over one 100 ms frame of one or N streams: a CUDA kernel.

The limiter is a per-sample finite-state machine (Out / Attack / Sustain /
Release, the reference's imp.rs:1377-1430) that the JAX package runs as a
`lax.scan` (gst_plugins_rs_tpu/ops/loudnorm.py: `_make_limiter_step`
:175-258, scanned by `_limiter_scan` :261-283) after a vectorised peak
detection (`_precompute_peaks` :146).  PyTorch has no scan, so on the card
detection and FSM are one kernel, csrc/loudnorm_limiter.cu.

`limiter_frame(window, carry_i, carry_f, target_tp)` runs the limiter over
the first FRAME samples of the window [>= LIMITER_LOOKAHEAD + FRAME + 11,
ch] and returns the clamped output [FRAME, ch] and the new carry: carry_i
int32 [3] = (state, envelope count, sustain count; -1 = none), carry_f [2]
of the window's dtype = (gr0, gr1).  target_tp is a Python float already
rounded to that dtype.  `limiter_frames` takes N streams at once (windows
[N, W, ch], carries [N, 3] and [N, 2]), as loudnormbank's tick and the JAX
package's `_limiter_scan_batched` (:286) do; `limiter_frame` is its N = 1
case, audioloudnorm's call.

For a CUDA window they launch the kernel once (N blocks), which reads the
window and the carry and nothing else, and count the launch in
`launches`.  The kernel finds the peaks itself, compacts their positions,
walks the FSM on one thread from event to event (the gaps between peaks in
closed form: an Attack runs out and turns to Sustain, a Sustain holds until
the frame's last peak is past, a Release runs out and turns to Out), writes
one segment (start, state, env, gr0, gr1) per change to a scratch, and then
all threads give every sample its segment's gain, scale and clamp.  The
output and the carry stay on the device: no host branch, no
synchronisation, each stream's idle case (state Out, no peak) decided by
its own block.  On a sparse frame the bytes through the block's one SM
bound it, on a dense one (a clipped plateau: every sample a peak) the
walk's chain; the kernel's header has the figures.  `walk_stats`, an
optional int32 [N, 3] CUDA tensor, receives each stream's (peaks,
segments, walk steps) as the kernel counted them (a step: one peak's
transition, or one ballot of the walking warp over 32 peaks).

For a CPU window they run `precompute_peaks` and then `limiter_frame_plain`
/ `limiter_frames_plain`, the plain versions the tests hold the kernel to.
`precompute_peaks(window, target_tp)` is the vectorised detection of
`_precompute_peaks` (local maxima above the target, confirmed over the next
2..11 samples of the same channel): pk, pv and future [FRAME] for output
positions 0..FRAME-1.  `limiter_frame_plain(window, carry_i, carry_f,
target_tp, pk, pv, future)` is a per-sample loop over Python floats (f64)
or numpy.float32 scalars (f32, every operation rounded to f32), with the
scan's idle fast path: state Out and no peak in the frame -> the clamped
input, carry unchanged; `limiter_frames_plain` runs it stream by stream.

Roundings.  XLA's CPU backend compiles the scan's envelope expressions
`gr0 - (env / (ATTACK - 1)) * (gr0 - gr1)` (and the release's) as a product
of env with the rounded reciprocal of the constant, followed by one fused
multiply-add, and `gr0 + (new_end - 1) * old_slope` as one fused
multiply-add.  The plain version and the kernel evaluate exactly that (an
exact FMA on the host, `fma` on the card; every other operation rounded on
its own), so both equal the JAX scan bit for bit
(tests/test_torch_loudnorm.py) and each other (tests/test_torch_kernels_cuda.py).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import count_launch

FRAME = 19_200            # 100 ms at 192 kHz
LIMITER_ATTACK = 1920     # 10 ms
LIMITER_RELEASE = 19_200  # 100 ms
LIMITER_LOOKAHEAD = 1920  # 10 ms
ST_OUT, ST_ATTACK, ST_SUSTAIN, ST_RELEASE = 0, 1, 2, 3
WINDOW_MIN = LIMITER_LOOKAHEAD + FRAME + 11  # samples the peak detection reads

launches = 0


def precompute_peaks(window, target_tp: float):
    """pk [FRAME] bool (a confirmed peak LIMITER_LOOKAHEAD ahead of output
    position n), pv [FRAME] (max |sample| over channels there) and future
    [FRAME] bool (a peak at any position >= n), as `_precompute_peaks`
    computes them on the window positions the output reads.  A window
    [N, W, ch] of N streams gives [N, FRAME] each."""
    if window.shape[-2] < WINDOW_MIN:
        raise ValueError(f"precompute_peaks: window needs >= {WINDOW_MIN} samples")
    L = LIMITER_LOOKAHEAD
    seg = window[..., L - 1:L + FRAME + 11, :].abs()  # positions L-1 .. L+FRAME+10
    prev, this, nxt = seg[..., 0:FRAME, :], seg[..., 1:FRAME + 1, :], seg[..., 2:FRAME + 2, :]
    # the next 2..11 samples of each position (seg[n+3 : n+13]) none higher
    follow = seg.unfold(-2, 10, 1)[..., 3:3 + FRAME, :, :].amax(-1)
    peak = (prev <= this) & (this >= nxt) & (this > target_tp) & (follow <= this)
    pk = peak.any(-1)
    pv = this.amax(-1)
    future = torch.flip(torch.cumsum(torch.flip(pk, (-1,)), -1), (-1,)) > 0
    return pk, pv, future


def _fma64(a: float, b: float, c: float) -> float:
    """a*b + c rounded once to f64 (Python 3.12 has no math.fma): the exact
    value as a ratio of ints over a power of two, and int true division,
    which rounds correctly."""
    na, da = a.as_integer_ratio()
    nb, db = b.as_integer_ratio()
    nc, dc = c.as_integer_ratio()
    d = da * db
    if d >= dc:
        return (na * nb + nc * (d // dc)) / d
    return (na * nb * (dc // d) + nc) / dc


def _fma32(a, b, c) -> np.float32:
    """a*b + c of float32 values rounded once to f32 (half to even)."""
    na, da = float(a).as_integer_ratio()
    nb, db = float(b).as_integer_ratio()
    nc, dc = float(c).as_integer_ratio()
    d = da * db
    if d >= dc:
        num, den = na * nb + nc * (d // dc), d
    else:
        num, den = na * nb * (dc // d) + nc, dc
    if num == 0:
        return np.float32(0.0)
    n = abs(num)
    # den is a power of two: n / den lies in [2^e, 2^(e+1)); keep 24 bits
    k = 23 - (n.bit_length() - den.bit_length())
    top, bot = (n << k, den) if k >= 0 else (n, den << -k)
    q, r = divmod(top, bot)
    if 2 * r > bot or (2 * r == bot and q & 1):
        q += 1
    return np.float32(math.copysign(math.ldexp(q, -k), num))


def _check_carry(carry_i, carry_f, dtype):
    if carry_i.dtype != torch.int32 or tuple(carry_i.shape) != (3,):
        raise ValueError("limiter: carry_i must be int32 [3] (state, env, sustain)")
    if carry_f.dtype != dtype or tuple(carry_f.shape) != (2,):
        raise ValueError(f"limiter: carry_f must be {dtype} [2] (gr0, gr1)")


def limiter_frame_plain(window, carry_i, carry_f, target_tp: float, pk, pv, future):
    """The FSM of `_make_limiter_step` over window[:FRAME], sample by sample
    on the host (window and the rest on the CPU)."""
    dtype = window.dtype
    _check_carry(carry_i, carry_f, dtype)
    xs = window[:FRAME]
    st, env, sus = carry_i.tolist()
    if st == ST_OUT and not bool(pk.any()):
        return torch.clamp(xs, -target_tp, target_tp), carry_i.clone(), carry_f.clone()
    F, fma = (float, _fma64) if dtype == torch.float64 else (np.float32, _fma32)
    gr0, gr1 = (F(v) for v in carry_f.tolist())
    one, zero, tp = F(1.0), F(0.0), F(target_tp)
    att_den, tiny = F(LIMITER_ATTACK - 1.0), F(-1e-30)
    # the envelope position env / (length - 1) as a product with the rounded
    # reciprocal, and gr0 -/+ pos * (gr0 - gr1) as one FMA: the roundings of
    # the JAX scan as XLA compiles it (see module docstring)
    att_rcp, rel_rcp = one / att_den, one / F(LIMITER_RELEASE - 1.0)
    pks, pvs, futs = pk.tolist(), pv.tolist(), future.tolist()
    mult = []
    for n in range(FRAME):
        p = pks[n]
        envf = F(env)
        if st == ST_ATTACK and env >= LIMITER_ATTACK:
            st = ST_SUSTAIN
        if st == ST_RELEASE and env >= LIMITER_RELEASE:
            st = ST_OUT
        if p:
            pvn = F(pvs[n])
            new_gr = tp / (pvn if pvn > zero else one)
            if st == ST_OUT:
                gr0, gr1, env, sus, st = one, new_gr, 0, -1, ST_ATTACK
            elif st == ST_ATTACK:
                cur_att = fma(-(envf * att_rcp), gr0 - gr1, gr0)
                old_slope = -(gr0 - gr1)
                new_slope = -(cur_att - new_gr)
                if new_gr < gr1 and new_slope <= old_slope:  # restart the attack
                    gr0, gr1, env, sus = cur_att, new_gr, 0, -1
                elif new_gr < gr1:  # steepen the running attack
                    safe = old_slope if old_slope != zero else tiny
                    new_end = max((new_gr - gr0) / safe, one)
                    adj_gr0 = fma(new_end - one, old_slope, gr0)
                    cur_pos = min(max((cur_att - adj_gr0) / safe, zero), one)
                    adj_env = int(att_den * cur_pos)
                    gr0, gr1, env, sus = adj_gr0, new_gr, adj_env, adj_env
                elif env < LIMITER_ATTACK:  # a lower peak inside the attack
                    sus = env
            elif st == ST_SUSTAIN:
                if new_gr < gr1:
                    gr0, gr1, env, sus, st = gr1, new_gr, 0, -1, ST_ATTACK
                else:
                    sus = LIMITER_LOOKAHEAD
            else:  # release
                cur_rel = fma(-(envf * rel_rcp), gr1 - gr0, gr0)
                if new_gr < cur_rel:
                    gr0, gr1, env, sus, st = cur_rel, new_gr, 0, -1, ST_ATTACK
                else:
                    gr1, st = cur_rel, ST_SUSTAIN
        if st == ST_SUSTAIN and not p and sus <= 0 and not futs[n]:
            gr0, gr1, env, st = gr1, one, 0, ST_RELEASE
        envf = F(env)
        if st == ST_OUT:
            m = one
        elif st == ST_ATTACK:
            m = fma(-(envf * att_rcp), gr0 - gr1, gr0)
        elif st == ST_SUSTAIN:
            m = gr1
        else:
            m = fma(-(envf * rel_rcp), gr1 - gr0, gr0)
        mult.append(m)
        if st == ST_ATTACK or st == ST_RELEASE:
            env += 1
        if st == ST_SUSTAIN and sus > 0 and not p:
            sus -= 1
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    m = torch.from_numpy(np.asarray(mult, np_dtype))
    out = torch.clamp(xs * m[:, None], -target_tp, target_tp)
    return (out, torch.tensor([st, env, sus], dtype=torch.int32),
            torch.from_numpy(np.asarray([gr0, gr1], np_dtype)))


def limiter_frames_plain(windows, carry_i, carry_f, target_tp: float, pk, pv, future):
    """N streams of `limiter_frame_plain`, one after the other:
    (out [N, FRAME, ch], carry_i [N, 3], carry_f [N, 2])."""
    res = [limiter_frame_plain(windows[n], carry_i[n], carry_f[n], target_tp, pk[n], pv[n],
                               future[n]) for n in range(windows.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*res))


def _lib():
    from ..utils.build import load

    lib = load("loudnorm_limiter")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.loudnorm_limiter.argtypes = [ptr, ctypes.c_longlong] + [ptr] * 7 + [
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr, ptr]
        lib.loudnorm_limiter.restype = ctypes.c_int
        lib.loudnorm_limiter_error_string.argtypes = [ctypes.c_int]
        lib.loudnorm_limiter_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def limiter_frames(windows, carry_i, carry_f, target_tp: float, walk_stats=None):
    """One frame of the limiter for N streams: windows [N, W, ch] (each
    stream's rows contiguous), carry_i int32 [N, 3], carry_f [N, 2].
    Returns (out [N, FRAME, ch], carry_i, carry_f).  On CUDA one launch of N
    blocks, one per stream; `walk_stats` (int32 [N, 3] on the card, or None)
    then receives each stream's (peaks, segments, walk steps)."""
    dev = windows.device
    if dev.type == "cpu":
        if walk_stats is not None:
            raise ValueError("limiter_frames: walk_stats counts the kernel's walk (CUDA only)")
        pk, pv, future = precompute_peaks(windows, target_tp)
        return limiter_frames_plain(windows, carry_i, carry_f, target_tp, pk, pv, future)
    if dev.type != "cuda":
        raise ValueError(f"limiter_frames: unsupported device {dev}")
    dtype = windows.dtype
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"limiter_frames: windows must be float64 or float32, got {dtype}")
    if windows.dim() != 3 or windows.shape[1] < WINDOW_MIN or windows.shape[0] < 1 \
            or windows.shape[2] < 1 or not windows[0].is_contiguous() or windows.stride(2) != 1:
        raise ValueError(f"limiter_frames: windows must be [N >= 1, >= {WINDOW_MIN}, ch >= 1] "
                         f"with each stream's rows contiguous")
    N, ch = windows.shape[0], windows.shape[2]
    if ch * ch * FRAME >= 2**32:  # the kernel finds an element's row as a 32-bit product
        raise ValueError(f"limiter_frames: {ch} channels; the kernel takes at most 472")
    if carry_i.dtype != torch.int32 or tuple(carry_i.shape) != (N, 3):
        raise ValueError(f"limiter_frames: carry_i must be int32 [{N}, 3] (state, env, sustain)")
    if carry_f.dtype != dtype or tuple(carry_f.shape) != (N, 2):
        raise ValueError(f"limiter_frames: carry_f must be {dtype} [{N}, 2] (gr0, gr1)")
    checked = [("carry_i", carry_i), ("carry_f", carry_f)]
    if walk_stats is not None:
        if walk_stats.dtype != torch.int32 or tuple(walk_stats.shape) != (N, 3):
            raise ValueError(f"limiter_frames: walk_stats must be int32 [{N}, 3]")
        checked.append(("walk_stats", walk_stats))
    for name, t in checked:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"limiter_frames: {name} must be contiguous on {dev}")
    out = torch.empty((N, FRAME, ch), dtype=dtype, device=dev)
    new_i, new_f = torch.empty_like(carry_i), torch.empty_like(carry_f)
    # scratch: each stream's segments (start, state, env - start, unused) and (gr0, gr1)
    seg_i = torch.empty((N, FRAME, 4), dtype=torch.int32, device=dev)
    seg_f = torch.empty((N, FRAME, 2), dtype=dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.loudnorm_limiter(windows.data_ptr(), windows.stride(0), carry_i.data_ptr(),
                                   carry_f.data_ptr(), new_i.data_ptr(), new_f.data_ptr(),
                                   seg_i.data_ptr(), seg_f.data_ptr(),
                                   None if walk_stats is None else walk_stats.data_ptr(),
                                   float(target_tp), ch, 1 if dtype == torch.float64 else 0, N,
                                   out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"limiter_frames launch failed: "
                           f"{lib.loudnorm_limiter_error_string(err).decode()}")
    count_launch(__name__, "launches")
    return out, new_i, new_f


def limiter_frame(window, carry_i, carry_f, target_tp: float, walk_stats=None):
    """One frame of the limiter for one stream, the N = 1 case of
    `limiter_frames`: (out [FRAME, ch], carry_i [3], carry_f [2])."""
    if window.device.type == "cpu":
        if walk_stats is not None:
            raise ValueError("limiter_frame: walk_stats counts the kernel's walk (CUDA only)")
        pk, pv, future = precompute_peaks(window, target_tp)
        return limiter_frame_plain(window, carry_i, carry_f, target_tp, pk, pv, future)
    if window.dim() != 2 or not window.is_contiguous():
        raise ValueError(f"limiter_frame: window must be a contiguous [>= {WINDOW_MIN}, ch]")
    _check_carry(carry_i, carry_f, window.dtype)
    stats = None if walk_stats is None else walk_stats.view(1, -1)
    out, new_i, new_f = limiter_frames(window[None], carry_i[None], carry_f[None], target_tp,
                                       stats)
    return out[0], new_i[0], new_f[0]


__all__ = ["FRAME", "LIMITER_ATTACK", "LIMITER_LOOKAHEAD", "LIMITER_RELEASE", "ST_ATTACK",
           "ST_OUT", "ST_RELEASE", "ST_SUSTAIN", "launches", "limiter_frame",
           "limiter_frame_plain", "limiter_frames", "limiter_frames_plain", "precompute_peaks"]
