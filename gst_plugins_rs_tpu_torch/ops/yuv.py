"""BT.601 studio-swing YUV <-> RGB conversion (4:2:0 planar), in PyTorch.

The port of gst_plugins_rs_tpu/ops/yuv.py: videoconvert's colorspace step,
the bridge between the RGB-domain elements and the I420-domain codecs.
Arithmetic runs on [H, W] f32 planes: ITU-R BT.601 with studio swing (Y
16..235, C 16..240), Y' = 16 + 219*(Kr*R + Kg*G + Kb*B)/255, Cb = 128 +
224/255 * (B - Y)/(2*(1-Kb)), Kr = .299, Kb = .114; values are rounded to
nearest (half to even) and clamped to [0, 255].  Chroma subsampling is the
2x2 mean, upsampling 2x nearest.  Every step is one elementwise op with a
fixed order (the 2x2 mean sums its four samples left to right), so the
card and the CPU give the same bytes.
"""
from __future__ import annotations

import torch

KR, KG, KB = 0.299, 0.587, 0.114


def _round_u8(x):
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _subsample(p):
    """[H, W] -> [H/2, W/2], the 2x2 mean (the video-converter default)."""
    return (((p[0::2, 0::2] + p[0::2, 1::2]) + p[1::2, 0::2]) + p[1::2, 1::2]) / 4.0


def _upsample(p):
    """[H/2, W/2] -> [H, W], 2x nearest."""
    h2, w2 = p.shape
    return p[:, None, :, None].expand(h2, 2, w2, 2).reshape(h2 * 2, w2 * 2)


def rgb_planes_to_i420(r, g, b):
    """Three u8/f32 [H, W] planes -> (y [H, W], u, v [H/2, W/2]) u8."""
    r = r.to(torch.float32)
    g = g.to(torch.float32)
    b = b.to(torch.float32)
    ey = KR * r + KG * g + KB * b  # 0..255 luma
    y = 16.0 + ey * (219.0 / 255.0)
    # chroma from the subsampled difference signal (linear, so subsampling
    # before or after the matrix is the same)
    cb = 128.0 + _subsample(b - ey) * (224.0 / 255.0 / (2.0 * (1.0 - KB)))
    cr = 128.0 + _subsample(r - ey) * (224.0 / 255.0 / (2.0 * (1.0 - KR)))
    return _round_u8(y), _round_u8(cb), _round_u8(cr)


def i420_to_rgb_planes(y, u, v):
    """(y, u, v) u8 planes -> three u8 [H, W] planes (r, g, b)."""
    yf = (y.to(torch.float32) - 16.0) * (255.0 / 219.0)
    cb = _upsample(u.to(torch.float32) - 128.0) * (255.0 / 224.0)
    cr = _upsample(v.to(torch.float32) - 128.0) * (255.0 / 224.0)
    r = yf + cr * (2.0 * (1.0 - KR))
    b = yf + cb * (2.0 * (1.0 - KB))
    g = (yf - KR * r - KB * b) * (1.0 / KG)
    return _round_u8(r), _round_u8(g), _round_u8(b)


def rgb_to_i420(rgb):
    """[H, W, >=3] u8 packed R,G,B[,A] -> (y, u, v) u8 planes."""
    return rgb_planes_to_i420(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def i420_to_rgb(y, u, v):
    """(y, u, v) u8 planes -> [H, W, 3] u8 packed RGB."""
    return torch.stack(i420_to_rgb_planes(y, u, v), dim=-1)


def uv_to_nv12(u, v):
    """Two [H/2, W/2] chroma planes -> one interleaved [H/2, W] NV12 plane."""
    h2, w2 = u.shape
    return torch.stack([u, v], dim=-1).reshape(h2, w2 * 2)


def nv12_to_uv(uv):
    """Interleaved [H/2, W] NV12 chroma -> two [H/2, W/2] planes."""
    h2, w = uv.shape
    d = uv.reshape(h2, w // 2, 2)
    return d[..., 0].contiguous(), d[..., 1].contiguous()


__all__ = ["KB", "KG", "KR", "i420_to_rgb", "i420_to_rgb_planes", "nv12_to_uv",
           "rgb_planes_to_i420", "rgb_to_i420", "uv_to_nv12"]
