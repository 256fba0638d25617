"""Tensor (model) parallelism for the YOLOX zoo: one forward pass over a
device mesh with every conv's OUTPUT-CHANNEL axis sharded.

The port of gst_plugins_rs_tpu/parallel/modelparallel.py (SURVEY section
2.3: "shard model across TPU mesh with pjit if needed (YOLOX-X)").  The JAX
package gives GSPMD a sharding per flax variable and lets it insert the
collectives; here the schedule is explicit, on parallel/mesh.py's
single-process mesh:

- a conv kernel is sharded along its output channels when they divide the
  mesh (OIHW axis 0 here; the JAX package's HWIO axis 3), and so are the
  1-D per-channel vectors of that width (the BatchNorm scale, shift, mean
  and variance, a prediction conv's bias);
- each shard computes its slice of a conv's outputs (conv, BatchNorm, SiLU)
  from the replicated input, and the slices are gathered along the channels
  before the next layer (the all_gather GSPMD puts where a conv needs its
  full input depth);
- a conv whose output channels do not divide the mesh (the 85-channel head
  at 8 shards: its 4-channel reg and 1-channel obj predictions) runs
  replicated, once, on the mesh's first device.

It runs the reference-shaped graph (models/yolox.py) in float32 with TF32
off, as the JAX package's tensor mode runs `model.apply`.  `variables` is
the model's state_dict.  The element surface is yoloxinference
`shard=true shard-mode=tensor`.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .._device import no_tf32
from .mesh import Mesh, gather, replicate, shard

Spec = Tuple[Optional[str], ...]


def yolox_tp_shardings(variables: Dict[str, torch.Tensor], mesh: Mesh,
                       axis: str = "tp") -> Dict[str, Spec]:
    """The partition spec of every variable: (axis, None, None, None) for a
    conv kernel whose output channels divide the mesh, (axis,) for a
    per-channel vector that does, () (replicated) for the rest."""
    n = mesh.shape[axis]

    def spec(t) -> Spec:
        if t.dim() == 4 and t.shape[0] % n == 0:
            return (axis, None, None, None)
        if t.dim() == 1 and t.shape[0] % n == 0:
            return (axis,)
        return ()

    return {k: spec(v) for k, v in variables.items()}


def shard_yolox_variables(variables: Dict[str, torch.Tensor], mesh: Mesh,
                          axis: str = "tp") -> Dict[str, List[torch.Tensor]]:
    """Every variable as per-shard parts: output-channel slices where its
    spec shards it, replicas elsewhere."""
    specs = yolox_tp_shardings(variables, mesh, axis)
    return {k: shard(v, mesh) if specs[k] else replicate(v, mesh)
            for k, v in variables.items()}


def _conv_parts(x, mesh: Mesh, conv: nn.Conv2d, w, b):
    """Each shard's output-channel slice of conv(x) for sharded kernel parts
    w (and bias parts b, or None): a grouped conv reads the input channels
    of its groups."""
    n = mesh.size
    per = conv.out_channels // n
    groups = conv.groups if conv.groups == 1 else per // (conv.out_channels // conv.groups)
    cin = w[0].shape[1] * groups  # input channels a shard reads
    out = []
    for k, d in enumerate(mesh.devices):
        xin = x if conv.groups == 1 else x[:, k * cin:(k + 1) * cin]
        out.append(F.conv2d(xin.to(d, non_blocking=True), w[k], None if b is None else b[k],
                            conv.stride, conv.padding, conv.dilation, groups))
    return out


def tp_forward(model: nn.Module, sharded: Dict[str, List[torch.Tensor]], mesh: Mesh,
               axis: str = "tp") -> Callable[[torch.Tensor], torch.Tensor]:
    """The tensor-parallel forward of `model`'s graph over sharded variables
    (shard_yolox_variables): frames [B, H, W, 3] (u8 or float, NHWC) on any
    device -> [B, anchors, 5 + classes] float32 on the mesh's first device.
    The graph is a shell of the model built on the meta device, whose convs
    run the schedule of the module docstring."""
    from ..models.yolox import BN_EPS, BaseConv, Yolox

    home = mesh.devices[0]
    with torch.device("meta"):
        shell = Yolox(model.num_classes, model.depth, model.width, model.depthwise)
    specs = yolox_tp_shardings(shell.state_dict(), mesh, axis)

    def base_conv(name: str, mod: BaseConv):
        def forward(x):
            p = {k: sharded[f"{name}.{k}"] for k in (
                "conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")}
            if specs[f"{name}.conv.weight"]:
                ys = _conv_parts(x, mesh, mod.conv, p["conv.weight"], None)
                idx = range(mesh.size)
            else:
                ys = [F.conv2d(x, p["conv.weight"][0], None, mod.conv.stride, mod.conv.padding,
                               mod.conv.dilation, mod.conv.groups)]
                idx = [0]
            ys = [F.silu(F.batch_norm(y, p["bn.running_mean"][k], p["bn.running_var"][k],
                                      p["bn.weight"][k], p["bn.bias"][k], False, 0.0, BN_EPS))
                  for y, k in zip(ys, idx)]
            return gather(ys, dim=1, device=home)
        return forward

    def conv(name: str, mod: nn.Conv2d):
        def forward(x):
            w, b = sharded[f"{name}.weight"], sharded.get(f"{name}.bias")
            if specs[f"{name}.weight"]:
                return gather(_conv_parts(x, mesh, mod, w, b), dim=1, device=home)
            return F.conv2d(x, w[0], None if b is None else b[0], mod.stride, mod.padding,
                            mod.dilation, mod.groups)
        return forward

    for name, mod in shell.named_modules():
        if isinstance(mod, BaseConv):
            mod.forward = base_conv(name, mod)
        elif isinstance(mod, nn.Conv2d):
            mod.forward = conv(name, mod)  # the head's prediction convs

    def run(x):
        with torch.no_grad(), no_tf32():
            return shell(x.to(home, non_blocking=True))

    return run


def apply_tp(model: nn.Module, variables: Dict[str, torch.Tensor], x, mesh: Mesh,
             axis: str = "tp", *, shard_variables: bool = True):
    """One tensor-parallel forward: weights channel-sharded over `axis`,
    input replicated, output gathered on the mesh's first device.

    Returns (out, sharded_variables); pass the sharded variables back with
    shard_variables=False to skip re-distributing the weights (or keep
    `tp_forward` of them)."""
    if shard_variables:
        variables = shard_yolox_variables(variables, mesh, axis)
    return tp_forward(model, variables, mesh, axis)(x), variables


__all__ = ["apply_tp", "shard_yolox_variables", "tp_forward", "yolox_tp_shardings"]
