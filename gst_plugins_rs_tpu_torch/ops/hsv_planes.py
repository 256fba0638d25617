"""The hsvfilter core over planar f32 channels: kernel B4 on Hopper.

The port of gst_plugins_rs_tpu/ops/pallas_hsv.py.  `hsv_filter_planes(r, g,
b, params)` takes [H, W] f32 planes in [0, 1] and params [5] f32 (hue shift
in degrees reduced mod 360, sat mul, sat off, val mul, val off) and returns
the adjusted planes, with the contract of `hsv_filter_pallas`.  For a CUDA
tensor it launches csrc/hsv_planes.cu (design and bound noted there) or
raises; for a CPU tensor it runs `hsv_filter_planes_plain`, the same math
in plain PyTorch, operation by operation.  `launches` counts kernel
launches.  Unlike the JAX package, the port's hsvfilter element runs
through this function (elements/video/hsv.py).
"""
from __future__ import annotations

import ctypes

import torch

from .hsv import EPSILON
from . import count_launch

launches = 0


def hsv_filter_planes_plain(r, g, b, params):
    """B4's function in plain PyTorch (ops/pallas_hsv.py:32-74)."""
    shift_sextant = params[0] * (1.0 / 60.0)
    sat_mul, sat_off = params[1], params[2]
    val_mul, val_off = params[3], params[4]

    value = torch.maximum(torch.maximum(r, g), b)
    minv = torch.minimum(torch.minimum(r, g), b)
    chroma = value - minv
    inv_c = 1.0 / torch.where(chroma == 0.0, 1.0, chroma)
    is_r = torch.abs(value - r) < EPSILON
    is_g = torch.abs(value - g) < EPSILON
    is_b = torch.abs(value - b) < EPSILON
    zero = torch.zeros_like(r)
    num = torch.where(is_r, g - b, torch.where(is_g, b - r, torch.where(is_b, r - g, zero)))
    base = torch.where(is_r, 0.0, torch.where(is_g, 2.0, torch.where(is_b, 4.0, zero)))
    hp = torch.where(chroma == 0.0, zero, base + num * inv_c) + shift_sextant
    hp = torch.where(hp < 0.0, hp + 6.0, hp)
    hp = torch.where(hp >= 6.0, hp - 6.0, hp)

    sat = chroma * (1.0 / torch.where(value == 0.0, 1.0, value))
    sat = torch.where(value == 0.0, zero, sat)
    s = torch.clamp(sat_mul * sat + sat_off, 0.0, 1.0)
    v = torch.clamp(val_mul * value + val_off, 0.0, 1.0)

    c = v * s
    x = c * (1.0 - torch.abs(hp - 2.0 * torch.floor(hp * 0.5) - 1.0))

    def sel(c0, c1, c2, c3, c4, c5):
        return torch.where(
            hp <= 1.0, c0,
            torch.where(hp <= 2.0, c1,
                        torch.where(hp <= 3.0, c2,
                                    torch.where(hp <= 4.0, c3,
                                                torch.where(hp <= 5.0, c4, c5)))))

    m = v - c
    return (sel(c, x, zero, zero, x, c) + m,
            sel(x, c, c, x, zero, zero) + m,
            sel(zero, zero, x, c, c, x) + m)


def _lib():
    from ..utils.build import load

    lib = load("hsv_planes")
    if not getattr(lib, "_argtypes_set", False):
        ptr = ctypes.c_void_p
        lib.hsv_filter_planes.argtypes = [ptr] * 7 + [ctypes.c_longlong, ptr]
        lib.hsv_filter_planes.restype = ctypes.c_int
        lib.hsv_planes_error_string.argtypes = [ctypes.c_int]
        lib.hsv_planes_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def hsv_filter_planes(r, g, b, params):
    """[H, W] f32 planes in [0,1] -> adjusted (r, g, b) planes.

    params: [hue_shift_deg (pre-reduced mod 360), sat_mul, sat_off,
    val_mul, val_off] f32, on the planes' device."""
    if r.device.type == "cpu":
        return hsv_filter_planes_plain(r, g, b, params)
    if r.device.type != "cuda":
        raise ValueError(f"hsv_filter_planes: unsupported device {r.device}")
    for name, t in (("r", r), ("g", g), ("b", b)):
        if t.shape != r.shape or t.dtype != torch.float32 or t.device != r.device:
            raise ValueError(f"hsv_filter_planes: {name} must be float32 {tuple(r.shape)} "
                             f"on {r.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"hsv_filter_planes: {name} must be contiguous")
    if tuple(params.shape) != (5,) or params.dtype != torch.float32 or params.device != r.device:
        raise ValueError("hsv_filter_planes: params must be [5] float32 on the planes' device")
    outs = [torch.empty_like(r) for _ in range(3)]
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.hsv_filter_planes(r.data_ptr(), g.data_ptr(), b.data_ptr(), params.data_ptr(),
                                    *(o.data_ptr() for o in outs), r.numel(), stream)
    if err != 0:
        raise RuntimeError(f"hsv_filter_planes launch failed: "
                           f"{lib.hsv_planes_error_string(err).decode()}")
    count_launch(__name__, "launches")
    return tuple(outs)


__all__ = ["hsv_filter_planes", "hsv_filter_planes_plain", "launches"]
