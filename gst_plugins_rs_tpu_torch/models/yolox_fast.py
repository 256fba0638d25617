"""The s2d-domain YOLOX inference engine (engine=fast / fast-bf16).

Same weights, same outputs (float-associativity tolerance) as the reference
graph (models/yolox.py), and the same schedule as the JAX package's engine
(gst_plugins_rs_tpu/models/yolox_fast.py): the stem and dark2 run in the
space-to-depth domain, activations [H/2, W/2, 4C] with kernels constructed
EXACTLY from the original 3x3/1x1 kernels; BatchNorm is folded into the conv
weights.  On CUDA, dark2's C3 runs as one hand-written kernel
(ops/yolox_c3.py, `fuse_c3=True`); its operands are the compact matrices
of the original folded convs built here (`_c3_compact_weights`), and the
kernel works in the normal domain over the s2d activations.

XLA folded the weights at trace time; eager PyTorch would redo ~40 small
scatters per frame, so `FastEngine` folds the weights and builds the s2d
kernels once per weights, and `apply_fast` caches one engine per
(model, state, dtypes, device).

Activations are NHWC, as in the JAX package; each conv hands cuDNN a
channels_last view of them (no copies), and the weights are prepared
channels_last once.

The forward runs float32 convolutions and matmuls with TF32 off
(no_tf32): cuDNN's TF32 default keeps ~3 digits and the model is held
to a relative error of 1e-3 over ~60 chained convolutions.

s2d conventions (phase-major channels, c = (2*e + f) * C + c_orig with
e = row offset, f = col offset):
  - 3x3 stride-1 conv  -> k=3/s=1 conv over 4C -> 4C_out blocks, tap
    (u, e) lands on block row rb = (e+u+1)//2, phase e' = (e+u+1)%2.
  - 3x3 stride-2 conv  -> k=3/s=2: rb = (2e+u-1)//2 + 1, e' = (2e+u+1-2rb).
  - 1x1 conv           -> block-diagonal 1x1 over phases.
Kernels here are OIHW: K[out, in, row, col].
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._device import no_tf32
from ..ops.yolox_c3 import c3_s2d_fused_compact, s2d, un_s2d
from .yolox import Yolox, decode, decode_grid, upsample2

_EPS = 1e-3
_CL = torch.channels_last


def _fold_bn(state, prefix: str):
    """Fold inference BatchNorm into conv kernel + bias (exact), in f32."""
    W = state[f"{prefix}.conv.weight"].float()
    inv = state[f"{prefix}.bn.weight"].float() * torch.rsqrt(
        state[f"{prefix}.bn.running_var"].float() + _EPS)
    b = state[f"{prefix}.bn.bias"].float() - state[f"{prefix}.bn.running_mean"].float() * inv
    return W * inv[:, None, None, None], b


def _conv(x, W, b, stride: int = 1, act: bool = True):
    """NHWC conv + bias (+ SiLU); W OIHW, both already in x's dtype."""
    p = (W.shape[-1] - 1) // 2
    y = F.conv2d(x.permute(0, 3, 1, 2), W, b, stride, p).permute(0, 2, 3, 1)
    return F.silu(y) if act else y


# ---------------------------------------------------------------------------
# s2d kernel constructors (exact; tests/test_torch_yolox.py)
# ---------------------------------------------------------------------------
# s2d and un_s2d live in ops/yolox_c3.py, beside the kernel that reads the layout.
def s2d_kernel_s1(W):
    """3x3/s1 kernel [Co,Ci,3,3] -> s2d-domain [4Co,4Ci,3,3]."""
    co, ci = W.shape[0], W.shape[1]
    K = W.new_zeros(4 * co, 4 * ci, 3, 3)
    for e in range(2):
        for u in range(3):
            rb, ep = (e + u + 1) // 2, (e + u + 1) % 2
            for f in range(2):
                for v in range(3):
                    cb, fp = (f + v + 1) // 2, (f + v + 1) % 2
                    ip, op = 2 * ep + fp, 2 * e + f
                    K[op * co:(op + 1) * co, ip * ci:(ip + 1) * ci, rb, cb] = W[:, :, u, v]
    return K


def s2d_kernel_s2(W):
    """3x3/s2 kernel [Co,Ci,3,3] -> s2d-in/s2d-out [4Co,4Ci,3,3] (k=3/s=2
    on the block grid: input [H/2,W/2,4Ci] -> output [H/4,W/4,4Co])."""
    co, ci = W.shape[0], W.shape[1]
    K = W.new_zeros(4 * co, 4 * ci, 3, 3)
    for e in range(2):
        for u in range(3):
            rb = (2 * e + u - 1) // 2 + 1
            ep = 2 * e + u + 1 - 2 * rb
            for f in range(2):
                for v in range(3):
                    cb = (2 * f + v - 1) // 2 + 1
                    fp = 2 * f + v + 1 - 2 * cb
                    ip, op = 2 * ep + fp, 2 * e + f
                    K[op * co:(op + 1) * co, ip * ci:(ip + 1) * ci, rb, cb] = W[:, :, u, v]
    return K


def s2d_kernel_1x1(W):
    """1x1 kernel [Co,Ci,1,1] -> block-diagonal [4Co,4Ci,1,1]."""
    co, ci = W.shape[0], W.shape[1]
    K = W.new_zeros(4 * co, 4 * ci, 1, 1)
    for p in range(4):
        K[p * co:(p + 1) * co, p * ci:(p + 1) * ci] = W
    return K


def _interleave_rows(K, c_a: int, c_b: int):
    """Reorder a canonical s2d kernel's input channels (phase, concat(a,b))
    to consume a NAIVE concat of two s2d tensors ((phase,a) ++ (phase,b))."""
    c = c_a + c_b
    order = np.concatenate([
        (np.arange(4)[:, None] * c + np.arange(c_a)[None, :]).reshape(-1),
        (np.arange(4)[:, None] * c + c_a + np.arange(c_b)[None, :]).reshape(-1),
    ])
    return K[:, torch.from_numpy(order).to(K.device)]


def _tile4(b):
    return b.repeat(4)


def _c3_normal_weights(state, prefix: str, n: int) -> Dict[str, Tuple]:
    """The folded convs (OIHW, f32) of a non-SPP C3 in the normal domain:
    conv1, conv2, m_i.conv1 (1x1), m_i.conv2 (3x3), conv3 over cat(x1, x2)."""
    keys = ["conv1", "conv2"] + [f"m_{i}.conv{j}" for i in range(n) for j in (1, 2)] + ["conv3"]
    return {k: _fold_bn(state, f"{prefix}.{k}") for k in keys}


def _c3_s2d_weights(state, prefix: str, n: int) -> Dict[str, Tuple]:
    """Per-conv s2d weights (OIHW, f32) of a non-SPP C3 run in the s2d
    domain: the unfused form of `_c3_fused_weights`."""
    w = _c3_normal_weights(state, prefix, n)
    hidden = w["conv1"][0].shape[0]
    s = {k: (s2d_kernel_s1(W) if W.shape[-1] == 3 else s2d_kernel_1x1(W), _tile4(b))
         for k, (W, b) in w.items()}
    s["conv3"] = (_interleave_rows(s["conv3"][0], hidden, hidden), s["conv3"][1])
    return s


def _c3_s2d(w, y, n: int):
    """CspBottleneck (shortcut branch form — the non-SPP CspBlock C3) on an
    NHWC input, one cuDNN conv per layer; `w` from _c3_s2d_weights on an
    s2d-domain input (or _c3_normal_weights on a normal-domain one), cast to
    y's dtype."""
    x1 = _conv(y, *w["conv1"])
    x2 = _conv(y, *w["conv2"])
    for i in range(n):
        t = _conv(x1, *w[f"m_{i}.conv1"])
        t = _conv(t, *w[f"m_{i}.conv2"])
        x1 = x1 + t  # non-SPP C3 always shortcut
    return _conv(torch.cat([x1, x2], dim=-1), *w["conv3"])


def _c3_normal(w, y, n: int):
    """The C3 on an s2d activation through the normal domain: un_s2d, one
    cuDNN conv per original layer (`w` from _c3_normal_weights, cast to y's
    dtype), s2d.  A yardstick of kernel B1 (chip_smoke.py); the engine never
    calls it."""
    return s2d(_c3_s2d(w, un_s2d(y), n))


def _matrices(w, n: int) -> Dict[str, torch.Tensor]:
    """Per-conv weights as the fused kernel's operands: in x out matrices,
    the 3x3's taps row-major, biases [1, out]."""
    def mat(K):  # 1x1 OIHW [O,I,1,1] -> [I,O]
        return K[:, :, 0, 0].t().contiguous()

    Wb = [w[f"m_{i}.conv2"][0][:, :, u, v].t() for i in range(n)
          for u in range(3) for v in range(3)]
    return dict(
        W1=mat(w["conv1"][0]), b1=w["conv1"][1][None],
        W2=mat(w["conv2"][0]), b2=w["conv2"][1][None],
        Wa=torch.stack([mat(w[f"m_{i}.conv1"][0]) for i in range(n)]),
        ba=torch.stack([w[f"m_{i}.conv1"][1][None] for i in range(n)]),
        Wb=torch.stack(Wb).contiguous(),
        bb=torch.stack([w[f"m_{i}.conv2"][1][None] for i in range(n)]),
        W3=mat(w["conv3"][0]), b3=w["conv3"][1][None],
    )


def _c3_fused_weights(state, prefix: str, n: int) -> Dict[str, torch.Tensor]:
    """The TPU kernel's operands: the dense s2d matrices (in x out), f32."""
    return _matrices(_c3_s2d_weights(state, prefix, n), n)


def _c3_compact_weights(state, prefix: str, n: int) -> Dict[str, torch.Tensor]:
    """Kernel B1's compact operands (ops/yolox_c3.py): the original folded
    convs as in x out matrices, f32; `compact_from_s2d` of
    `_c3_fused_weights`, exactly."""
    return _matrices(_c3_normal_weights(state, prefix, n), n)


def _prep(W, b, dtype, device):
    return (W.to(device=device, dtype=dtype).contiguous(memory_format=_CL),
            b.to(device=device, dtype=dtype))


class FastEngine:
    """The folded, s2d-prepared weights of one model + state, and the
    forward over them.  Build once per weights; call per batch of frames
    [B,H,W,3] (u8 or float, NHWC) on `device`."""

    def __init__(self, model: Yolox, state, dtype=torch.float32, s2d_dtype=None,
                 fuse_c3: bool = False, device=None):
        self.model = model
        self.dtype = dtype
        self.s2d_dtype = s2d_dtype or dtype
        self.fuse_c3 = fuse_c3
        self.device = torch.device(device) if device is not None else next(
            iter(state.values())).device
        self.base_depth = max(round(model.depth * 3), 1)
        self.n_neck = round(3 * model.depth)
        self._grids: Dict[Tuple, Tuple] = {}
        if model.depthwise:
            # depthwise variants (nano) run the reference graph
            self._state = {k: v.to(self.device) for k, v in state.items()}
            return
        with torch.no_grad():
            self._prepare(state)

    # -- weights, once ---------------------------------------------------
    def _prepare(self, state):
        dev, dt, sdt = self.device, self.dtype, self.s2d_dtype
        bb = "backbone.backbone"
        W, b = _fold_bn(state, f"{bb}.stem.conv")
        self.stem = _prep(s2d_kernel_s1(W), _tile4(b), sdt, dev)
        W, b = _fold_bn(state, f"{bb}.dark2.conv")
        self.dark2_conv = _prep(s2d_kernel_s2(W), _tile4(b), sdt, dev)
        if self.fuse_c3:
            w = _c3_compact_weights(state, f"{bb}.dark2.c3", self.base_depth)
            self.c3 = {k: v.to(device=dev, dtype=torch.float32 if k[0] == "b" else sdt).contiguous()
                       for k, v in w.items()}
        else:
            w = _c3_s2d_weights(state, f"{bb}.dark2.c3", self.base_depth)
            self.c3 = {k: _prep(W, b, sdt, dev) for k, (W, b) in w.items()}
        self.convs = {}
        for key in state:
            if not key.endswith(".conv.weight"):
                continue
            prefix = key[: -len(".conv.weight")]
            if prefix.startswith((f"{bb}.stem", f"{bb}.dark2")):
                continue
            self.convs[prefix] = _prep(*_fold_bn(state, prefix), dt, dev)
        self.preds = []
        for i in range(self.model.head.n_levels):
            # fused prediction conv: one 1x1 over concat([rf, cf]) emitting
            # [reg4 | obj1 | cls] directly in output order — exact block
            # rewrite of the three separate preds (reg/obj read rf, cls cf)
            Wr = state[f"head.reg_preds_{i}.weight"].float()
            Wo = state[f"head.obj_preds_{i}.weight"].float()
            Wc = state[f"head.cls_preds_{i}.weight"].float()
            hc = Wr.shape[1]
            K = Wr.new_zeros(5 + Wc.shape[0], 2 * hc, 1, 1)
            K[0:4, :hc] = Wr
            K[4:5, :hc] = Wo
            K[5:, hc:] = Wc
            bias = torch.cat([state[f"head.{n}_preds_{i}.bias"].float()
                              for n in ("reg", "obj", "cls")])
            self.preds.append(_prep(K, bias, dt, dev))

    # -- forward ------------------------------------------------------------
    def __call__(self, x):
        with torch.no_grad(), no_tf32():
            if self.model.depthwise:
                return torch.func.functional_call(self.model, self._state, (x,))
            return self._forward(x)

    def _base(self, prefix: str, x, stride: int = 1):
        return _conv(x, *self.convs[prefix], stride)

    def _csp_bottleneck(self, prefix: str, x, n: int, shortcut: bool):
        x1 = self._base(f"{prefix}.conv1", x)
        x2 = self._base(f"{prefix}.conv2", x)
        for i in range(n):
            y = self._base(f"{prefix}.m_{i}.conv1", x1)
            y = self._base(f"{prefix}.m_{i}.conv2", y)
            x1 = x1 + y if shortcut else y
        return self._base(f"{prefix}.conv3", torch.cat([x1, x2], dim=-1))

    def _spp(self, prefix: str, x):
        x = self._base(f"{prefix}.conv1", x)
        xc = x.permute(0, 3, 1, 2)
        # max_pool2d pads with -inf, as reduce_window's max does
        pools = [x] + [F.max_pool2d(xc, k, 1, k // 2).permute(0, 2, 3, 1) for k in (5, 9, 13)]
        return self._base(f"{prefix}.conv2", torch.cat(pools, dim=-1))

    def _csp_block(self, prefix: str, x, n: int, spp: bool):
        x = self._base(f"{prefix}.conv", x, stride=2)
        if spp:
            x = self._spp(f"{prefix}.spp", x)
        return self._csp_bottleneck(f"{prefix}.c3", x, n, not spp)

    def _stem_dark2_s2d(self, x):
        """stem + dark2 in the s2d domain: [B,H,W,3] -> [B,H/4,W/4,2*bc]."""
        b, h, w, c = x.shape
        # fused Focus(s2d, reference channel order (f1,e1,c)) + second s2d:
        # image row = 4p + 2e2 + e1, col = 4q + 2f2 + f1; channels
        # (e2,f2, f1,e1,c) phase-major over the Focus channel (f1*2+e1)*3+c.
        # The transpose runs in the input dtype (u8 moves 4x fewer bytes).
        y = x.reshape(b, h // 4, 2, 2, w // 4, 2, 2, c)
        y = y.permute(0, 1, 4, 2, 5, 6, 3, 7).reshape(b, h // 4, w // 4, 16 * c)
        y = y.to(self.s2d_dtype)
        y = _conv(y, *self.stem)                       # [B,H/4,W/4,4*bc]
        y = _conv(y, *self.dark2_conv, stride=2)       # [B,H/8,W/8,8*bc]
        if self.fuse_c3:
            y = c3_s2d_fused_compact(y.contiguous(), **self.c3, width=y.shape[2],
                                     n=self.base_depth)
        else:
            y = _c3_s2d(self.c3, y, self.base_depth)
        return un_s2d(y).to(self.dtype)                # [B,H/4,W/4,2*bc]

    def _forward(self, x):
        if x.is_floating_point() and x.dtype != self.dtype:
            x = x.to(self.dtype)
        bd, nn_ = self.base_depth, self.n_neck
        bb = "backbone.backbone"
        x = self._stem_dark2_s2d(x)
        f1 = self._csp_block(f"{bb}.dark3", x, bd * 3, False)
        f2 = self._csp_block(f"{bb}.dark4", f1, bd * 3, False)
        f3 = self._csp_block(f"{bb}.dark5", f2, bd, True)

        fpn_out0 = self._base("backbone.lateral_conv0", f3)
        y = torch.cat([_up2(fpn_out0), f2], dim=-1)
        f_out0 = self._csp_bottleneck("backbone.c3_p4", y, nn_, False)

        fpn_out1 = self._base("backbone.reduce_conv1", f_out0)
        y = torch.cat([_up2(fpn_out1), f1], dim=-1)
        pan_out2 = self._csp_bottleneck("backbone.c3_p3", y, nn_, False)

        y = self._base("backbone.bu_conv2", pan_out2, stride=2)
        y = torch.cat([y, fpn_out1], dim=-1)
        pan_out1 = self._csp_bottleneck("backbone.c3_n3", y, nn_, False)

        y = self._base("backbone.bu_conv1", pan_out1, stride=2)
        y = torch.cat([y, fpn_out0], dim=-1)
        pan_out0 = self._csp_bottleneck("backbone.c3_n4", y, nn_, False)

        outs, shapes = [], []
        for i, feat in enumerate((pan_out2, pan_out1, pan_out0)):
            feat = self._base(f"head.stems_{i}", feat)
            cf = self._base(f"head.cls_convs_{i}.conv0", feat)
            cf = self._base(f"head.cls_convs_{i}.conv1", cf)
            rf = self._base(f"head.reg_convs_{i}.conv0", feat)
            rf = self._base(f"head.reg_convs_{i}.conv1", rf)
            out = _conv(torch.cat([rf, cf], dim=-1), *self.preds[i], act=False)
            out = torch.cat([out[..., :4], torch.sigmoid(out[..., 4:])], dim=-1)
            b_, h_, w_, c_ = out.shape
            shapes.append((h_, w_))
            outs.append(out.reshape(b_, h_ * w_, c_))
        out = torch.cat(outs, dim=1).to(torch.float32)
        key = tuple(shapes)
        if key not in self._grids:
            self._grids[key] = decode_grid(shapes, torch.float32, out.device)
        return decode(out, shapes, self._grids[key])


def _up2(x):
    """Nearest 2x upsampling of an NHWC tensor."""
    return upsample2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


_ENGINES: Dict[Tuple, Tuple] = {}
_MAX_ENGINES = 8


def apply_fast(model: Yolox, state, x, dtype=torch.float32, s2d_dtype=None,
               fuse_c3: bool = False):
    """Drop-in replacement for the reference graph's forward over `state`
    (the model's state_dict; non-depthwise variants, others run the
    reference graph).  Runs where `x` lies.

    s2d_dtype: activation dtype for the s2d stem+dark2 stage only
    (defaults to dtype); bfloat16 is the engine=fast-bf16 path.
    fuse_c3: run dark2's C3 as the fused kernel (ops/yolox_c3.py): the CUDA
    kernel for a CUDA tensor, its plain version on the CPU.

    The folded weights are cached per (model, state, dtypes, fuse_c3,
    device) and rebuilt when a state tensor is modified in place."""
    key = (id(model), id(state), dtype, s2d_dtype, fuse_c3, x.device)
    version = sum(t._version for t in state.values())
    hit = _ENGINES.get(key)
    if hit is None or hit[0] is not state or hit[1] != version:
        if len(_ENGINES) >= _MAX_ENGINES:
            _ENGINES.pop(next(iter(_ENGINES)))
        engine = FastEngine(model, state, dtype, s2d_dtype, fuse_c3, device=x.device)
        hit = _ENGINES[key] = (state, version, engine)
    return hit[2](x)


__all__ = ["FastEngine", "apply_fast", "s2d", "un_s2d", "s2d_kernel_s1", "s2d_kernel_s2",
           "s2d_kernel_1x1"]
