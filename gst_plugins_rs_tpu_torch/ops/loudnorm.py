"""audioloudnorm compute engine: the EBU R-128 streaming loudness normaliser.

The port of the single-stream functions of gst_plugins_rs_tpu/ops/
loudnorm.py (the reference's ffmpeg-af_loudnorm-derived algorithm,
audio/audiofx/src/audioloudnorm/imp.rs).  Fixed 192 kHz: FRAME = 19,200
(100 ms), a 3 s gain lookahead, limiter attack 10 ms / release 100 ms /
lookahead 10 ms.

The state is a NamedTuple of device tensors: a FIFO backlog of 2.79 s of
raw input, a 110 ms scaled tail, the gain-delta ring, both EbuR128
analysers (ops/ebur128.py) and the limiter carry (int32 [3] and [2] of the
stream's dtype); the ring index is a host int (it advances by one a frame,
whatever the data).  Every frame is a chain of device ops with no
read-back: the loudness queries, the gaussian-smoothed gain, the gain ramp
and the limiter kernel (ops/loudnorm_limiter.py), which detects the peaks
inside its launch.  The JAX package scans K frames a dispatch; here the
element loops over frames.

Every step takes any leading stream axes on the state leaves and the input:
none for audioloudnorm, [N] for loudnormbank (parallel/streams.py, state
from `loudnorm_init_batched`; the ring index stays one host int, since a
bank's streams advance in lockstep).  The limiter then runs the N streams,
detection included, in one launch
(ops/loudnorm_limiter.py::limiter_frames).  The JAX module's
`inner_frames_scan_pre` serves the time-shard path, which waits for the
mesh layer (ROADMAP queue A, item 6).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .ebur128 import (
    R128Params,
    R128State,
    energy_to_loudness,
    loudness_global,
    loudness_shortterm,
    r128_add_full_subblocks,
    r128_init,
    r128_init_batched,
    r128_params,
    relative_threshold_energy,
)
from .loudnorm_limiter import (
    FRAME,
    LIMITER_ATTACK,
    LIMITER_LOOKAHEAD,
    LIMITER_RELEASE,
    ST_OUT,
    ST_SUSTAIN,
    limiter_frame,
    limiter_frames,
)

RATE = 192_000
GAIN_LOOKAHEAD = 3 * RATE                    # 3 s
TAIL = FRAME + LIMITER_LOOKAHEAD             # 110 ms scaled, not yet output
BACKLOG = GAIN_LOOKAHEAD - TAIL - FRAME      # 2.79 s of raw input
DRAIN_FRAMES = 30                            # frames of the final drain


def gaussian_weights() -> np.ndarray:
    """21-tap sigma=3.5 normalised gaussian (imp.rs:1893-1913), f64."""
    sigma = 3.5
    x = np.arange(21) - 10.0
    w = (1.0 / (sigma * np.sqrt(2.0 * np.pi))) * np.exp(-(x**2) / (2.0 * sigma**2))
    return w / w.sum()


class LoudnormParams(NamedTuple):
    target_i: float          # LUFS, rounded to the stream's dtype
    target_lra: float        # LU
    target_tp: float         # linear
    weights: torch.Tensor    # [21]
    gauss_idx: torch.Tensor  # [30, 21] int64: ring positions of _gaussian_gain(i)
    ramp: torch.Tensor       # [FRAME] n / FRAME
    r128: R128Params


class LoudnormState(NamedTuple):
    backlog: torch.Tensor     # [BACKLOG, ch] raw input awaiting gain scaling
    tail: torch.Tensor        # [TAIL, ch] scaled samples not yet output
    delta: torch.Tensor       # [30] gain delta ring
    index: int                # ring index
    prev_delta: torch.Tensor  # 0-d
    above: torch.Tensor       # 0-d bool: output short-term reached the target
    offset: torch.Tensor      # 0-d linear offset gain
    lim_i: torch.Tensor       # int32 [3] limiter state, envelope count, sustain count
    lim_f: torch.Tensor       # [2] limiter gr0, gr1
    r128_in: R128State
    r128_out: R128State


def _rounded(v: float, dtype) -> float:
    return float(np.float64(v) if dtype == torch.float64 else np.float32(v))


def loudnorm_params(loudness_target: float, loudness_range_target: float,
                    max_true_peak_db: float, channels: int, dtype=torch.float64,
                    dev=None) -> LoudnormParams:
    from .._device import device
    from ..core.audio import default_channel_positions

    dev = device() if dev is None else torch.device(dev)
    rp = r128_params(RATE, default_channel_positions(channels), dtype, dev)
    idx = np.stack([(np.where(i > 10, i - 10, i + 20) + np.arange(21)) % 30 for i in range(30)])
    return LoudnormParams(
        target_i=_rounded(loudness_target, dtype),
        target_lra=_rounded(loudness_range_target, dtype),
        target_tp=_rounded(10.0 ** (max_true_peak_db / 20.0), dtype),
        weights=torch.as_tensor(gaussian_weights(), dtype=dtype).to(dev),
        gauss_idx=torch.as_tensor(idx, dtype=torch.int64).to(dev),
        ramp=torch.arange(FRAME, dtype=dtype, device=dev) / FRAME,
        r128=rp,
    )


def loudnorm_init(params: LoudnormParams, channels: int, offset_db: float) -> LoudnormState:
    dtype, dev = params.weights.dtype, params.weights.device
    return LoudnormState(
        backlog=torch.zeros((BACKLOG, channels), dtype=dtype, device=dev),
        tail=torch.zeros((TAIL, channels), dtype=dtype, device=dev),
        delta=torch.zeros(30, dtype=dtype, device=dev),
        index=1,  # imp.rs:165 starts at 1
        prev_delta=torch.zeros((), dtype=dtype, device=dev),
        above=torch.zeros((), dtype=torch.bool, device=dev),
        offset=torch.tensor(10.0 ** (offset_db / 20.0), dtype=dtype, device=dev),
        lim_i=torch.tensor([ST_OUT, 0, -1], dtype=torch.int32, device=dev),
        lim_f=torch.zeros(2, dtype=dtype, device=dev),
        r128_in=r128_init(params.r128, channels),
        r128_out=r128_init(params.r128, channels),
    )


def _gaussian_gain(delta, params: LoudnormParams, i: int):
    """Gaussian-smoothed gain from the delta ring (imp.rs:1529-1541)."""
    return (params.weights * delta[..., params.gauss_idx[i]]).sum(-1)


def limit(window, lim_i, lim_f, target_tp: float):
    """The limiter over window[..., :FRAME, :]: peak detection and the FSM
    (on CUDA one kernel launch, which finds the peaks itself, for one stream
    or for a bank's N).  Returns (out [..., FRAME, ch], lim_i, lim_f)."""
    run = limiter_frame if window.dim() == 2 else limiter_frames
    return run(window, lim_i, lim_f, target_tp)


def _update_gain(state: LoudnormState, params: LoudnormParams) -> LoudnormState:
    """The gain update after every inner frame (imp.rs:526-608)."""
    rp = params.r128
    global_ = loudness_global(state.r128_in, rp)
    shortterm = loudness_shortterm(state.r128_in, rp)
    rel = energy_to_loudness(relative_threshold_energy(state.r128_in, rp))

    above = state.above
    ramp = (~above) & (shortterm > -70.0)
    prev_delta = torch.where(ramp, state.prev_delta * 1.0058, state.prev_delta)
    st_out = loudness_shortterm(state.r128_out, rp)
    above = above | ((~state.above) & (st_out >= params.target_i))

    env_diff = shortterm - global_
    one = torch.ones_like(env_diff)
    env_global = torch.where(env_diff.abs() < params.target_lra / 2.0, env_diff,
                             torch.where(env_diff < 0.0, -one, one))
    env_shortterm = params.target_i - shortterm
    new_delta = 10.0 ** ((env_global + env_shortterm) / 20.0)
    keep_prev = (shortterm < rel) | (shortterm <= -70.0) | (~above)
    d = torch.where(keep_prev, prev_delta, new_delta)
    delta = state.delta.clone()
    delta[..., state.index] = d
    return state._replace(delta=delta, prev_delta=d, above=above,
                          index=(state.index + 1) % 30)


def first_frame_step(state: LoudnormState, params: LoudnormParams, src):
    """The initial 3 s frame (imp.rs:368-442).  src [..., GAIN_LOOKAHEAD, ch];
    returns (state, out [..., FRAME, ch])."""
    rp = params.r128
    tp = params.target_tp
    r128_in = r128_add_full_subblocks(state.r128_in, rp, src)
    shortterm = loudness_shortterm(r128_in, rp)
    above = shortterm >= -70.0
    env_shortterm = torch.where(above, params.target_i - shortterm,
                                torch.zeros_like(shortterm))
    d0 = 10.0 ** (env_shortterm / 20.0)
    window = src[..., :FRAME + TAIL, :] * (d0 * state.offset)[..., None, None]

    # if the first 10 ms already exceed the target, start in sustain with
    # the needed reduction (imp.rs:1335-1375)
    mx = window[..., :LIMITER_LOOKAHEAD + 1, :].abs().amax((-2, -1))
    over = mx > tp
    lim_i = torch.stack([torch.where(over, ST_SUSTAIN, ST_OUT),
                         torch.zeros_like(over, dtype=torch.int64),
                         torch.where(over, LIMITER_LOOKAHEAD, -1)], -1).to(torch.int32)
    gr1 = torch.where(over, tp / torch.where(mx > 0, mx, torch.ones_like(mx)),
                      torch.zeros_like(mx))
    out, lim_i, lim_f = limit(window, lim_i, torch.stack([torch.zeros_like(gr1), gr1], -1), tp)

    r128_out = r128_add_full_subblocks(state.r128_out, rp, out)
    return state._replace(backlog=src[..., FRAME + TAIL:, :], tail=window[..., FRAME:, :],
                          delta=d0[..., None].expand(*d0.shape, 30).clone(), prev_delta=d0,
                          above=above, lim_i=lim_i, lim_f=lim_f, r128_in=r128_in,
                          r128_out=r128_out), out


def _scale_and_limit(state: LoudnormState, params: LoudnormParams, scale_src):
    """Gain-ramp FRAME samples of the backlog, limit tail + scaled."""
    gain = _gaussian_gain(state.delta, params, (state.index + 10) % 30)[..., None]
    gain_next = _gaussian_gain(state.delta, params, (state.index + 11) % 30)[..., None]
    gains = (gain + params.ramp * (gain_next - gain)) * state.offset[..., None]
    window = torch.cat([state.tail, scale_src * gains[..., None]], -2)
    out, lim_i, lim_f = limit(window, state.lim_i, state.lim_f, params.target_tp)
    return state._replace(tail=window[..., FRAME:, :], lim_i=lim_i, lim_f=lim_f), out


def _append_limit_update(state: LoudnormState, params: LoudnormParams, src):
    """Shift src into the backlog, scale and limit the frame that leaves it,
    feed the output analyser and update the gain."""
    scale_src = state.backlog[..., :FRAME, :]
    state = state._replace(backlog=torch.cat([state.backlog[..., FRAME:, :], src], -2))
    state, out = _scale_and_limit(state, params, scale_src)
    state = state._replace(r128_out=r128_add_full_subblocks(state.r128_out, params.r128, out))
    return _update_gain(state, params), out


def inner_frame_step(state: LoudnormState, params: LoudnormParams, src):
    """One 100 ms inner frame (imp.rs:609-647).  src [..., FRAME, ch]."""
    state = state._replace(r128_in=r128_add_full_subblocks(state.r128_in, params.r128, src))
    return _append_limit_update(state, params, src)


def final_append_step(state: LoudnormState, params: LoudnormParams, src):
    """One drain step (imp.rs:697-779): src is the zero-padded partial input
    or zeros; r128_in sees no partial subblock."""
    return _append_limit_update(state, params, src)


def final_frame_step(state: LoudnormState, params: LoudnormParams):
    return final_append_step(state, params, torch.zeros_like(state.backlog[..., :FRAME, :]))


def drain(state: LoudnormState, params: LoudnormParams, padded_src, steps: int = DRAIN_FRAMES):
    """The final drain: the append step, then steps - 1 zero-input steps,
    one limiter launch each.  padded_src [..., FRAME, ch]; returns (state,
    out [..., steps * FRAME, ch]).  The JAX package always runs 30
    (`drain_scan`); the element runs 29 when the 30th frame would be cut
    away (no partial input)."""
    state, out = final_append_step(state, params, padded_src)
    outs = [out]
    for _ in range(steps - 1):
        state, out = final_frame_step(state, params)
        outs.append(out)
    return state, torch.cat(outs, -2)


def linear_gain_from_global(state: LoudnormState, params: LoudnormParams):
    """Gain for streams shorter than 3 s (imp.rs:323-366): reach the target
    unless the scaled sample peak would exceed max-true-peak."""
    global_ = loudness_global(state.r128_in, params.r128)
    peak = state.r128_in.sample_peak.max()
    offset = 10.0 ** ((params.target_i - global_) / 20.0)
    safe_peak = torch.where(peak > 0, peak, torch.ones_like(peak))
    return torch.where(peak * offset < params.target_tp, offset, params.target_tp / safe_peak)


# ---------------------------------------------------------------------------
# N streams at once (loudnormbank): leaves [N, ...], the index a host int
# ---------------------------------------------------------------------------
def loudnorm_init_batched(params: LoudnormParams, channels: int, offset_db: float,
                          n: int) -> LoudnormState:
    one = loudnorm_init(params, channels, offset_db)
    tensors = {f: getattr(one, f).expand((n,) + getattr(one, f).shape).clone()
               for f in ("backlog", "tail", "delta", "prev_delta", "above", "offset", "lim_i",
                         "lim_f")}
    return one._replace(**tensors, r128_in=r128_init_batched(params.r128, channels, n),
                        r128_out=r128_init_batched(params.r128, channels, n))


__all__ = [
    "BACKLOG", "DRAIN_FRAMES", "FRAME", "GAIN_LOOKAHEAD", "LIMITER_ATTACK",
    "LIMITER_LOOKAHEAD", "LIMITER_RELEASE", "RATE", "TAIL", "LoudnormParams", "LoudnormState",
    "drain", "final_append_step", "final_frame_step", "first_frame_step", "gaussian_weights",
    "inner_frame_step", "limit", "linear_gain_from_global", "loudnorm_init",
    "loudnorm_init_batched", "loudnorm_params",
]
