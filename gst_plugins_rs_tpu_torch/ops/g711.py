"""ITU-T G.711 A-law / mu-law companding as elementwise tensor ops.

The reference payloads already-companded audio (audio/x-alaw / audio/x-mulaw
caps, net/rtp/src/pcmau/pay/imp.rs:37-59) and leaves the companding itself to
GStreamer's alawenc/mulawenc.  Here the companders are part of the framework
(elements/net/codecs.py) and run on the payload's device: branch-free
torch.where forms of the classic Sun Microsystems g711.c segment search,
bit-exact vs CPython's `audioop` implementation of the same tables
(tests/test_rtp.py oracle).

Everything stays in int32: torch's `>>` on a negative int32 is arithmetic,
as jnp's is, and no value passes through a float.  Inputs that are not
tensors (numpy arrays, lists) are taken on the CPU.
"""
from __future__ import annotations

import torch

_SEG_AEND = (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF)
_SEG_UEND = (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF)
_BIAS = 0x84  # mu-law bias (Sun g711.c)
_UCLIP = 8159


def _int32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def _segment(val: torch.Tensor, ends) -> torch.Tensor:
    """Index of the first segment end >= val (8 if none) — the seg_end search
    from g711.c, done as a sum of comparisons (branch-free)."""
    seg = torch.zeros_like(val)
    for e in ends:
        seg = seg + (val > e).to(torch.int32)
    return seg


def alaw_encode(pcm) -> torch.Tensor:
    """int16 linear PCM -> u8 A-law."""
    x = _int32(pcm) >> 3  # 13-bit magnitude domain
    neg = x < 0
    mask = torch.full_like(x, 0xD5).masked_fill(neg, 0x55)
    x = torch.where(neg, -x - 1, x)
    seg = _segment(x, _SEG_AEND)
    shift = torch.where(seg < 2, 1, seg)
    aval = (torch.clamp(seg, max=7) << 4) | ((x >> shift) & 0xF)
    out = torch.where(seg >= 8, 0x7F, aval) ^ mask
    return out.to(torch.uint8)


def alaw_decode(alaw) -> torch.Tensor:
    """u8 A-law -> int16 linear PCM."""
    a = _int32(alaw) ^ 0x55
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = torch.where(seg == 0, t + 8, (t + 0x108) << torch.clamp(seg - 1, min=0))
    return torch.where((a & 0x80) != 0, t, -t).to(torch.int16)


def mulaw_encode(pcm) -> torch.Tensor:
    """int16 linear PCM -> u8 mu-law."""
    x = _int32(pcm) >> 2  # 14-bit domain
    neg = x < 0
    mask = torch.full_like(x, 0xFF).masked_fill(neg, 0x7F)
    x = torch.clamp(torch.where(neg, -x, x), max=_UCLIP) + (_BIAS >> 2)
    seg = _segment(x, _SEG_UEND)
    uval = (torch.clamp(seg, max=7) << 4) | ((x >> (seg + 1)) & 0xF)
    out = torch.where(seg >= 8, 0x7F, uval) ^ mask
    return out.to(torch.uint8)


def mulaw_decode(mulaw) -> torch.Tensor:
    """u8 mu-law -> int16 linear PCM."""
    u = (~_int32(mulaw)) & 0xFF
    t = (((u & 0xF) << 3) + _BIAS) << ((u & 0x70) >> 4)
    return torch.where((u & 0x80) != 0, _BIAS - t, t - _BIAS).to(torch.int16)


__all__ = ["alaw_encode", "alaw_decode", "mulaw_encode", "mulaw_decode"]
