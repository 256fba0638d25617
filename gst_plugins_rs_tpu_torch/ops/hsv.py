"""HSV conversion / filter / detect (video/hsv compute path).

Reference math: video/hsv/src/hsvutils.rs:40-198 (RGB<->HSV with EPSILON
sextant selection, wiki HSL_and_HSV formulation) and the per-pixel loops in
hsvfilter/imp.rs:76-120 and hsvdetector/imp.rs:100-160.

The port of gst_plugins_rs_tpu/ops/hsv.py in plain PyTorch: element-wise
operations over whole frames [..., H, W, C].  The u8 quantization (`as u8`
truncation for the filter path) is preserved.  The port's hsvfilter element
runs kernel B4 (ops/hsv_planes.py) instead of `hsv_filter_frame`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .pixels import restack, to_unit

EPSILON = 1e-5


def rgb_to_hsv(r, g, b):
    """r,g,b: f32 in [0,1] -> (h in [0,360), s, v in [0,1]).

    Mirrors hsvutils::from_rgb including the EPSILON-based sextant chain
    evaluated in r,g,b order."""
    value = torch.maximum(torch.maximum(r, g), b)
    minv = torch.minimum(torch.minimum(r, g), b)
    chroma = value - minv
    zero = torch.zeros_like(r)
    inv_c = 1.0 / torch.where(chroma == 0.0, 1.0, chroma)
    is_r = torch.abs(value - r) < EPSILON
    is_g = torch.abs(value - g) < EPSILON
    is_b = torch.abs(value - b) < EPSILON
    num = torch.where(is_r, g - b, torch.where(is_g, b - r, torch.where(is_b, r - g, zero)))
    base = torch.where(is_r, 0.0, torch.where(is_g, 2.0, torch.where(is_b, 4.0, zero)))
    hue = torch.where(chroma == 0.0, zero, 60.0 * (base + num * inv_c))
    hue = torch.where(hue < 0.0, hue + 360.0, hue)
    hue = torch.remainder(hue, 360.0)
    sat = chroma * (1.0 / torch.where(value == 0.0, 1.0, value))
    sat = torch.where(value == 0.0, zero, sat)
    return hue, torch.clamp(sat, 0.0, 1.0), torch.clamp(value, 0.0, 1.0)


def hsv_to_rgb(h, s, v):
    """Inverse of rgb_to_hsv; mirrors hsvutils::to_rgb sextant logic
    (boundaries with <=, zero outside [0,6])."""
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    zero = torch.zeros_like(c)

    def sel(c0, c1, c2, c3, c4, c5):
        # piecewise over sextants; hp<0 or hp>6 -> 0
        inner = torch.where(hp <= 6.0, c5, zero)
        for bound, ci in ((5.0, c4), (4.0, c3), (3.0, c2), (2.0, c1), (1.0, c0)):
            inner = torch.where(hp <= bound, ci, inner)
        return torch.where(hp < 0.0, zero, inner)

    m = v - c
    return (sel(c, x, zero, zero, x, c) + m,
            sel(x, c, c, x, zero, zero) + m,
            sel(zero, zero, x, c, c, x) + m)


def split_rgb(frame, offsets: Tuple[int, int, int]):
    """The r, g, b channels of a u8 frame as f32 planes in [0, 1]."""
    return tuple(to_unit(frame[..., off], 255.0) for off in offsets)


def quantize_u8(x):
    """clip(x * 255, 0, 255) truncated to u8, the reference's `as u8`."""
    return torch.clamp(x * 255.0, 0.0, 255.0).to(torch.uint8)


def hsv_filter_frame(frame, params, *, offsets: Tuple[int, int, int]):
    """Apply hue-shift / sat / value transform.

    frame: [..., C] uint8; params: [5] f32 (hue_shift, sat_mul, sat_off,
    val_mul, val_off); offsets: (r,g,b) channel positions.
    Returns a new frame of identical shape/dtype (non-RGB channels
    preserved).  Hue stays in sextant units (h/60): the reference's degrees
    round trip collapses to one add and two conditional subtracts, since
    base+num/chroma is in (-1, 5] and shift/60 in [0, 6); outputs stay
    within the documented <=1 u8 LSB of the strict-order reference math."""
    r, g, b = split_rgb(frame, offsets)
    value = torch.maximum(torch.maximum(r, g), b)
    minv = torch.minimum(torch.minimum(r, g), b)
    chroma = value - minv
    zero = torch.zeros_like(r)
    inv_c = 1.0 / torch.where(chroma == 0.0, 1.0, chroma)
    is_r = torch.abs(value - r) < EPSILON
    is_g = torch.abs(value - g) < EPSILON
    is_b = torch.abs(value - b) < EPSILON
    num = torch.where(is_r, g - b, torch.where(is_g, b - r, torch.where(is_b, r - g, zero)))
    base = torch.where(is_r, 0.0, torch.where(is_g, 2.0, torch.where(is_b, 4.0, zero)))
    hp = torch.where(chroma == 0.0, zero, base + num * inv_c)  # (-1, 5]
    hp = hp + params[0] * (1.0 / 60.0)  # shift already reduced mod 360 host-side
    hp = torch.where(hp < 0.0, hp + 6.0, hp)
    hp = torch.where(hp >= 6.0, hp - 6.0, hp)

    sat = chroma * (1.0 / torch.where(value == 0.0, 1.0, value))
    sat = torch.where(value == 0.0, zero, sat)
    s = torch.clamp(params[1] * sat + params[2], 0.0, 1.0)
    v = torch.clamp(params[3] * value + params[4], 0.0, 1.0)

    c = v * s
    x = c * (1.0 - torch.abs(hp - 2.0 * torch.floor(hp * 0.5) - 1.0))

    def sel(c0, c1, c2, c3, c4, c5):
        inner = torch.where(hp <= 5.0, c4, c5)
        for bound, ci in ((4.0, c3), (3.0, c2), (2.0, c1), (1.0, c0)):
            inner = torch.where(hp <= bound, ci, inner)
        return inner

    m = v - c
    r2 = sel(c, x, zero, zero, x, c) + m
    g2 = sel(x, c, c, x, zero, zero) + m
    b2 = sel(zero, zero, x, c, c, x) + m
    return restack(frame, offsets, [quantize_u8(t) for t in (r2, g2, b2)], torch.uint8)


def hsv_detect_frame(
    frame,
    params,
    *,
    in_offsets: Tuple[int, int, int],
    out_offsets: Tuple[int, int, int],
    out_channels: int,
    alpha_off: int,
):
    """Chroma-key detect: copy RGB, set alpha=255 inside the HSV window else 0.

    params: [6] f32 (hue_ref, hue_var, sat_ref, sat_var, val_ref, val_var).
    Output dtype uint8, shape [..., out_channels]."""
    r, g, b = split_rgb(frame, in_offsets)
    h, s, v = rgb_to_hsv(r, g, b)
    # circular hue distance via shift-to-180 (hsvdetector/imp.rs:141-149)
    shifted = h + (180.0 - params[0])
    shifted = torch.where(shifted < 0.0, shifted + 360.0, shifted)
    shifted = torch.remainder(shifted, 360.0)
    inside = (
        (torch.abs(shifted - 180.0) <= params[1])
        & (torch.abs(s - params[2]) <= params[3])
        & (torch.abs(v - params[4]) <= params[5])
    )
    alpha = torch.where(inside, 255, 0).to(torch.uint8)
    out = torch.zeros(frame.shape[:-1] + (out_channels,), dtype=torch.uint8,
                      device=frame.device)
    for i_off, o_off in zip(in_offsets, out_offsets):
        out[..., o_off] = frame[..., i_off]
    out[..., alpha_off] = alpha
    return out


__all__ = ["rgb_to_hsv", "hsv_to_rgb", "hsv_filter_frame", "hsv_detect_frame", "EPSILON",
           "quantize_u8", "split_rgb"]
