"""Fused YOLOX dark2 C3 (CspBottleneck) block: kernel B1 on Hopper.

The s2d engine (models/yolox_fast.py) runs stem+dark2 in the space-to-depth
domain.  This block replaces the per-conv chain of dark2's C3 with one
launch:

    x1 = silu(y @ W1 + b1)             # 1x1
    x2 = silu(y @ W2 + b2)             # 1x1
    n x bottleneck:
        t  = silu(x1 @ Wa_i + ba_i)    # 1x1
        t  = silu(conv3x3(t, Wb_i) + bb_i)
        x1 = x1 + t                    # shortcut (non-SPP C3 always)
    out = silu([x1 ++ x2] @ W3 + b3)   # 1x1 over the concat

The TPU kernel (gst_plugins_rs_tpu/ops/pallas_yolox_c3.py::c3_s2d_fused)
takes the convs as dense s2d matrices, three quarters of whose blocks are
zero by construction.  Here the operands are COMPACT: the folded original
convs as in x out matrices, C = C4/4 input and h = Ch/4 hidden channels:

    W1, W2 [C,h]   Wa [n,h,h]   Wb [9n,h,h] (taps row-major (u,v))
    W3 [2h,C] (rows [:h] x1, [h:] x2)
    b1, b2 [1,h]   ba, bb [n,1,h]   b3 [1,C]

Activations stay in the s2d layout [B,H,W,4C], in and out: normal-domain
pixel (2i+e, 2j+f), channel c, is y[b, i, j, (2e+f)*C + c].

- `c3_s2d_fused_compact` is what the engine calls.  For a CUDA tensor it
  launches csrc/yolox_c3.cu (design and bound are noted there) or raises;
  for a CPU tensor it runs `c3_s2d_fused_plain`, the same chain in plain
  PyTorch, which the CPU tests hold against the JAX kernel and
  chip_smoke.py holds the CUDA kernel against.  `launches` counts kernel
  launches.
- `c3_s2d_fused` keeps the TPU kernel's signature and dense operands; it
  reads the compact operands out of them (`compact_from_s2d`, which syncs
  the host) and calls the compact entry.
- `c3_smem_bytes` reckons a block's shared memory on the host as the
  library does, and `fused_tile` takes the first tile side that fits: the
  launch picks its tile by it, and models/yolox_fast.py chooses the C3's
  route by it when the engine is built (YOLOX-x in bf16 fits no tile).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from .._device import no_tf32
from . import count_launch

launches = 0

# A block may use at most 227 KB of shared memory on sm_90.
_MAX_SMEM = 232_448
# Normal-domain tile sides; the first that fits is taken.  10 was fastest at
# YOLOX-tiny 640 batch 1 in both types on an H100 (256 blocks: one wave);
# at batch 8 larger tiles win (chip_smoke.py's tile sweep, PERF.md §6).
_TILES = (10, 8, 6, 4, 2)
_NAMES = ("W1", "b1", "W2", "b2", "Wa", "ba", "Wb", "bb", "W3", "b3")


def s2d(x):
    """[B,H,W,C] -> [B,H/2,W/2,4C], channel (2e+f)*C + c."""
    b, h, w, c = x.shape
    y = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def un_s2d(x):
    """[B,H,W,4C] -> [B,2H,2W,C], the inverse of `s2d`."""
    b, h, w, c4 = x.shape
    c = c4 // 4
    y = x.reshape(b, h, w, 2, 2, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * 2, w * 2, c)


def _s2d_taps():
    """(s2d tap, input phase, output phase, original tap) of every non-zero
    block of a 3x3/s1 conv's s2d form, taps row-major; the convention of
    models/yolox_fast.py::s2d_kernel_s1."""
    for e in range(2):
        for u in range(3):
            rb, ep = divmod(e + u + 1, 2)
            for f in range(2):
                for v in range(3):
                    cb, fp = divmod(f + v + 1, 2)
                    yield rb * 3 + cb, 2 * ep + fp, 2 * e + f, u * 3 + v


def _s2d_from_compact(W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, *, n: int):
    """The TPU kernel's dense s2d operands of compact operands."""
    h = W1.shape[1]

    def diag(w):
        return torch.block_diag(w, w, w, w)

    def tile(b):
        return b.repeat(*([1] * (b.dim() - 1)), 4)

    Wbd = Wb.new_zeros(9 * n, 4 * h, 4 * h)
    for i in range(n):
        for tap, ip, op, orig in _s2d_taps():
            Wbd[i * 9 + tap, ip * h:(ip + 1) * h, op * h:(op + 1) * h] = Wb[i * 9 + orig]
    return dict(W1=diag(W1), b1=tile(b1), W2=diag(W2), b2=tile(b2),
                Wa=torch.stack([diag(Wa[i]) for i in range(n)]), ba=tile(ba), Wb=Wbd,
                bb=tile(bb), W3=torch.cat([diag(W3[:h]), diag(W3[h:])]), b3=tile(b3))


def compact_from_s2d(W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, *, n: int):
    """The compact operands held in the TPU kernel's dense s2d operands:
    the output-phase-0 blocks.  Tap (u,v) of output phase 0 sits at s2d tap
    ((u+1)//2, (v+1)//2), input phase 2*((u+1)%2) + (v+1)%2.  Raises
    ValueError unless the dense operands are exactly the s2d form of the
    compact ones (any other block non-zero, or the phases' blocks differ).
    Compares on the host: not for a hot path."""
    dense = dict(zip(_NAMES, (W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3)))
    C4, Ch = W1.shape
    if C4 % 4 or Ch % 4:
        raise ValueError(f"yolox_c3: s2d channels must be multiples of 4 (C4={C4}, Ch={Ch})")
    C, h = C4 // 4, Ch // 4
    taps = {orig: (tap, ip) for tap, ip, op, orig in _s2d_taps() if op == 0}
    compact = dict(
        W1=W1[:C, :h], b1=b1[:, :h], W2=W2[:C, :h], b2=b2[:, :h], Wa=Wa[:, :h, :h],
        ba=ba[..., :h],
        Wb=torch.stack([Wb[i * 9 + taps[o][0], taps[o][1] * h:(taps[o][1] + 1) * h, :h]
                        for i in range(n) for o in range(9)]),
        bb=bb[..., :h], W3=torch.cat([W3[:h, :C], W3[Ch:Ch + h, :C]]), b3=b3[:, :C])
    compact = {k: v.contiguous() for k, v in compact.items()}
    for k, v in _s2d_from_compact(**compact, n=n).items():
        if v.shape != dense[k].shape or not torch.equal(v, dense[k]):
            raise ValueError(f"yolox_c3: {k} is not the s2d form of a compact operand "
                             "(a block off the s2d structure is non-zero, or phases differ)")
    return compact


def c3_s2d_fused_plain(y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, *, width: int, n: int):
    """The compact chain in plain PyTorch over the normal-domain view of y:
    1x1 convs as matmuls, the 3x3 as 9 shifted products over a zero-padded
    map.  f32 arithmetic; weights and activations are rounded to y.dtype
    where the kernel stores them (x1, x2, t, each x1 update)."""
    B, H, Wd, C4 = y.shape
    if Wd != width:
        raise ValueError(f"yolox_c3: y must be [B,H,{width},C4], got {tuple(y.shape)}")
    dtype, f32 = y.dtype, torch.float32
    h = W1.shape[1]

    def stored(v):
        return v.to(dtype).to(f32)

    W1, W2, Wa, Wb, W3 = (stored(w) for w in (W1, W2, Wa, Wb, W3))
    b1, b2, ba, bb, b3 = (b.to(f32) for b in (b1, b2, ba, bb, b3))
    with no_tf32():
        x = un_s2d(y.to(f32))                      # [B, 2H, 2W, C]
        x1 = stored(F.silu(x @ W1 + b1))
        x2 = stored(F.silu(x @ W2 + b2))
        for i in range(n):
            t = stored(F.silu(x1 @ Wa[i] + ba[i]))
            tp = F.pad(t, (0, 0, 1, 1, 1, 1))
            acc = torch.zeros_like(t)
            for tap in range(9):
                u, v = divmod(tap, 3)
                acc = acc + tp[:, u:u + 2 * H, v:v + 2 * Wd, :] @ Wb[i * 9 + tap]
            x1 = stored(x1 + F.silu(acc + bb[i]))
        out = F.silu(x1 @ W3[:h] + x2 @ W3[h:] + b3)
    return s2d(out.to(dtype))


def _check(y, ops, width, n):
    if y.dim() != 4 or y.shape[2] != width:
        raise ValueError(f"yolox_c3: y must be [B,H,{width},C4], got {tuple(y.shape)}")
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"yolox_c3: y must be float32 or bfloat16, got {y.dtype}")
    C4, h = y.shape[3], ops["W1"].shape[1]
    if C4 % 32 or h % 8:
        raise ValueError(f"yolox_c3: normal-domain channels must be multiples of 8 "
                         f"(C={C4 / 4:g}, h={h})")
    C = C4 // 4
    expect = {"W1": (C, h), "b1": (1, h), "W2": (C, h), "b2": (1, h), "Wa": (n, h, h),
              "ba": (n, 1, h), "Wb": (9 * n, h, h), "bb": (n, 1, h), "W3": (2 * h, C),
              "b3": (1, C)}
    for name, shape in expect.items():
        t = ops[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"yolox_c3: {name} must be {shape}, got {tuple(t.shape)}")
        dtype = torch.float32 if name[0] == "b" else y.dtype
        if t.dtype != dtype:
            raise TypeError(f"yolox_c3: {name} must be {dtype}, got {t.dtype}")
    for name, t in [("y", y)] + list(ops.items()):
        if t.device != y.device:
            raise ValueError(f"yolox_c3: {name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"yolox_c3: {name} must be contiguous and 16-byte aligned")


def _lib():
    from ..utils.build import load

    lib = load("yolox_c3")
    if not getattr(lib, "_argtypes_set", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.yolox_c3_f32, lib.yolox_c3_bf16):
            fn.argtypes = [ptr] * 12 + [i32] * 7 + [ptr]
            fn.restype = ctypes.c_int
        lib.yolox_c3_smem_bytes.argtypes = [i32] * 5
        lib.yolox_c3_smem_bytes.restype = ctypes.c_int
        lib.yolox_c3_error_string.argtypes = [i32]
        lib.yolox_c3_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _padded(k: int) -> int:
    """A shared-memory row stride of k bf16 elements: an odd number of
    16-byte units (csrc/yolox_c3.cu `padded`)."""
    return k if (k // 8) % 2 else k + 8


def c3_smem_bytes(bf16: bool, C: int, h: int, n: int, tile: int) -> int:
    """Dynamic shared memory of one block of B1, in bytes: the host twin of
    csrc/yolox_c3.cu's `yolox_c3_smem_bytes` (`Bf16Smem` for bf16, the f32
    kernel's region and tile buffers otherwise), reckoned without the
    library so that the engine can choose its route before any build or
    launch."""
    S = tile + 2 * n
    if not bf16:
        return (2 * S * S + tile * tile) * h * 4
    ldC, ldh, ld2h = _padded(C), _padded(h), _padded(2 * h)
    elems = (S * S * max(ldC, ldh) + S * S * ldh + tile * tile * ldh
             + max(2 * h * ldC, C * ld2h) + 10 * h * ldh)
    return elems * 2


def fused_tile(bf16: bool, C: int, h: int, n: int) -> Optional[int]:
    """The first tile side of _TILES whose block fits _MAX_SMEM, or None
    when none does (YOLOX-x's dark2 C3 in bf16: models/yolox_fast.py then
    runs the per-conv chain)."""
    return next((ts for ts in _TILES if c3_smem_bytes(bf16, C, h, n, ts) <= _MAX_SMEM), None)


def _pick_tile(bf16: bool, C: int, h: int, n: int) -> int:
    ts = fused_tile(bf16, C, h, n)
    if ts is None:
        raise ValueError(
            f"yolox_c3: C={C}, h={h}, n={n} need more than one block's shared memory "
            f"({_MAX_SMEM} bytes) even at the smallest tile")
    return ts


def c3_s2d_fused_compact(y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, *, width: int, n: int):
    """Fused C3 over an s2d-domain activation y [B,H,W,4C] (float32 or
    bfloat16) with the compact operands of the module docstring.  Returns
    [B,H,W,4C] in y.dtype.  On CUDA the weights must be in y.dtype and the
    biases in float32 (the engine prepares them once), and C and h
    multiples of 8."""
    if y.device.type == "cpu":
        return c3_s2d_fused_plain(y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3,
                                  width=width, n=n)
    if y.device.type != "cuda":
        raise ValueError(f"yolox_c3: unsupported device {y.device}")
    ops = dict(zip(_NAMES, (W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3)))
    _check(y, ops, width, n)
    B, H, Wd, C4 = y.shape
    C, h = C4 // 4, W1.shape[1]
    bf16 = y.dtype == torch.bfloat16
    lib = _lib()
    tile = _pick_tile(bf16, C, h, n)
    fn = lib.yolox_c3_bf16 if bf16 else lib.yolox_c3_f32
    out = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (y, *ops.values(), out)),
                 B, H, Wd, C, h, n, tile, stream)
    if err != 0:
        raise RuntimeError(f"yolox_c3 launch failed: {lib.yolox_c3_error_string(err).decode()}")
    count_launch(__name__, "launches")
    return out


def c3_s2d_fused(y, W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, *, width: int, n: int):
    """Fused C3 with the TPU kernel's signature and operands.

    y: [B, H, W, C4] (C4 = 4 * normal-domain channels), float32 or bfloat16;
    weights are the FOLDED (BN-absorbed) s2d-domain matrices:
      W1, W2: [C4, Ch]   b1, b2: [1, Ch]
      Wa: [n, Ch, Ch]    ba: [n, 1, Ch]
      Wb: [n*9, Ch, Ch]  bb: [n, 1, Ch]   (9 taps, row-major (du, dv))
      W3: [2*Ch, C4]     b3: [1, C4]      (rows [:Ch] = x1, [Ch:] = x2)
    Returns [B, H, W, C4] in y.dtype.  Reads the compact operands out of the
    dense ones (a host sync) and runs `c3_s2d_fused_compact`."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"yolox_c3: unsupported device {y.device}")
    compact = compact_from_s2d(W1, b1, W2, b2, Wa, ba, Wb, bb, W3, b3, n=n)
    return c3_s2d_fused_compact(y, **compact, width=width, n=n)


__all__ = ["c3_s2d_fused", "c3_s2d_fused_compact", "c3_s2d_fused_plain", "c3_smem_bytes",
           "compact_from_s2d", "fused_tile", "launches", "s2d", "un_s2d"]
