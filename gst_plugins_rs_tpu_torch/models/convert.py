"""Weight carrier: a flax variables tree (as numpy) -> the port's state_dict.

The JAX package keeps YOLOX weights as flax variables {"params",
"batch_stats"}; the port's modules are named after that tree
(models/yolox.py), so each leaf maps to one state_dict entry:

    .../conv/kernel  [kh,kw,I,O] (HWIO)  -> .../conv/weight [O,I,kh,kw] (OIHW)
    .../bn/scale, bias                    -> .../bn/weight, bias
    .../bn/mean, var      (batch_stats)   -> .../bn/running_mean, running_var
    .../*_preds_i/kernel, bias            -> weight (OIHW), bias

It takes nested dicts of numpy arrays, not JAX arrays, so the port needs no
JAX import to carry weights across (the parity tests call it with
`jax.tree_util.tree_map(np.asarray, variables)`).

Demucs (models/demucs.py) has its own pair, `demucs_state_dict` and its
inverse `demucs_flax_tree`:

    Conv_i/kernel           [k, I, O]   -> Conv_i.weight [O, I, k]
    ConvTranspose_i/kernel  [k, I, O]   -> ConvTranspose_i.weight [I, O, k],
        flipped along k: flax keeps the kernel unflipped
        (transpose_kernel=False), torch's transposed convolution flips it
    _BiLSTM_0/Dense_0/kernel [I, O]     -> _BiLSTM_0.Dense_0.weight [O, I]
    _BiLSTM_0/LSTMCell_j    (j = 2l forward, 2l + 1 backward of layer l)
        ii/if/ig/io kernels [I, H]      -> LSTM_l.weight_ih_l0[_reverse]
                                           [4H, I], gates in the order i, f, g, o
        hi/hf/hg/ho kernels [H, H]      -> ...weight_hh_l0[_reverse] [4H, H]
        hi/hf/hg/ho biases              -> ...bias_hh_l0[_reverse]; bias_ih = 0

asr-lite (ops/asr.py) keeps the JAX package's flat names and layouts:
`asr_weights` carries gru{0,1}{f,b}_{wz,wr,wh} [D + H, H],
gru..._{bz,br,bh} [H], out_w [2H, 28] and out_b [28] as float32 tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def variables_from_jax(params_np: Dict[str, Any],
                       batch_stats_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params + batch_stats (nested dicts of numpy arrays) -> a
    state_dict for the port's module of the same architecture."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params_np):
        arr = np.asarray(arr)
        leaf = path[-1]
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f"unhandled flax param {'/'.join(path)}")
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[".".join(path[:-1] + (_PARAM_LEAVES[leaf],))] = torch.tensor(arr, dtype=torch.float32)
    for path, arr in _flatten(batch_stats_np):
        leaf = path[-1]
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"unhandled flax batch stat {'/'.join(path)}")
        base = ".".join(path[:-1])
        sd[f"{base}.{_STAT_LEAVES[leaf]}"] = torch.tensor(np.asarray(arr), dtype=torch.float32)
        # nn.BatchNorm2d's counter; unused at inference
        sd[f"{base}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def variables_to_numpy(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """The inverse carrier: a state_dict -> {"params", "batch_stats"} nested
    dicts of numpy arrays in the flax layout."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    inv_stats = {v: k for k, v in _STAT_LEAVES.items()}
    for name, t in state_dict.items():
        *mods, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        arr = t.detach().cpu().numpy()
        if leaf in inv_stats:
            tree, leaf = out["batch_stats"], inv_stats[leaf]
        else:
            tree = out["params"]
            if leaf == "weight":
                if arr.ndim == 4:
                    leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)  # OIHW -> HWIO
                else:
                    leaf = "scale"
        for m in mods:
            tree = tree.setdefault(m, {})
        tree[leaf] = arr
    return out


_GATES_I = ("ii", "if", "ig", "io")
_GATES_H = ("hi", "hf", "hg", "ho")


def demucs_state_dict(flax_tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Demucs flax tree ({"params": ...} or the params themselves; numpy
    arrays, or torch tensors, which stay on their device) -> the state_dict
    of the port's models.demucs.Demucs."""
    params = flax_tree.get("params", flax_tree)

    def t(arr):
        return torch.as_tensor(arr, dtype=torch.float32)

    sd: Dict[str, torch.Tensor] = {}
    for name, mod in params.items():
        if name.startswith("ConvTranspose_"):
            sd[f"{name}.weight"] = t(mod["kernel"]).permute(1, 2, 0).flip(-1).contiguous()
            sd[f"{name}.bias"] = t(mod["bias"]).clone()
        elif name.startswith("Conv_"):
            sd[f"{name}.weight"] = t(mod["kernel"]).permute(2, 1, 0).contiguous()
            sd[f"{name}.bias"] = t(mod["bias"]).clone()
        elif name.startswith("_BiLSTM_"):
            for sub, leaves in mod.items():
                if sub.startswith("Dense_"):
                    sd[f"{name}.{sub}.weight"] = t(leaves["kernel"]).T.contiguous()
                    sd[f"{name}.{sub}.bias"] = t(leaves["bias"]).clone()
                elif sub.startswith("LSTMCell_"):
                    j = int(sub.split("_")[1])
                    base = f"{name}.LSTM_{j // 2}."
                    sfx = "_l0" + ("_reverse" if j % 2 else "")
                    sd[base + "weight_ih" + sfx] = torch.cat(
                        [t(leaves[g]["kernel"]).T for g in _GATES_I])
                    sd[base + "weight_hh" + sfx] = torch.cat(
                        [t(leaves[g]["kernel"]).T for g in _GATES_H])
                    bias = torch.cat([t(leaves[g]["bias"]) for g in _GATES_H])
                    sd[base + "bias_ih" + sfx] = torch.zeros_like(bias)
                    sd[base + "bias_hh" + sfx] = bias
                else:
                    raise KeyError(f"unhandled flax module {name}/{sub}")
        else:
            raise KeyError(f"unhandled flax module {name}")
    return sd


def demucs_flax_tree(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, Any]]:
    """The inverse of demucs_state_dict: {"params": ...} of numpy arrays.  An
    LSTM's two biases become flax's one (bias_ih + bias_hh)."""
    params: Dict[str, Any] = {}
    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    for key, arr in sd.items():
        *mods, leaf = key.split(".")
        if mods[0].startswith("ConvTranspose_"):
            params.setdefault(mods[0], {})["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(arr[:, :, ::-1].transpose(2, 0, 1)) if leaf == "weight"
                else arr)
        elif mods[0].startswith("Conv_"):
            params.setdefault(mods[0], {})["kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(arr.transpose(2, 1, 0)) if leaf == "weight" else arr)
        elif mods[1].startswith("Dense_"):
            params.setdefault(mods[0], {}).setdefault(mods[1], {})[
                "kernel" if leaf == "weight" else "bias"] = (
                np.ascontiguousarray(arr.T) if leaf == "weight" else arr)
        elif leaf.startswith(("weight_", "bias_hh")):
            layer = int(mods[1].split("_")[1])
            cell = f"LSTMCell_{2 * layer + (1 if leaf.endswith('_reverse') else 0)}"
            tree = params.setdefault(mods[0], {}).setdefault(cell, {})
            gates = _GATES_I if leaf.startswith("weight_ih") else _GATES_H
            if leaf.startswith("bias_hh"):
                bias = arr + sd[key.replace("bias_hh", "bias_ih")]
                for g, part in zip(gates, np.split(bias, 4)):
                    tree.setdefault(g, {})["bias"] = part
            else:
                for g, part in zip(gates, np.split(arr, 4)):
                    tree.setdefault(g, {})["kernel"] = np.ascontiguousarray(part.T)
    return {"params": params}



ASR_KEYS = tuple(f"gru{layer}{d}_{kind}{g}" for layer in (0, 1) for d in ("f", "b")
                 for kind in ("w", "b") for g in ("z", "r", "h")) + ("out_w", "out_b")


def asr_weights(np_tree: Dict[str, Any], dev=None) -> Dict[str, torch.Tensor]:
    """asr-lite's weights (a dict of numpy arrays under the JAX package's
    names) -> contiguous float32 tensors on dev (default: the selected
    device)."""
    from .._device import device

    dev = device() if dev is None else torch.device(dev)
    missing = [k for k in ASR_KEYS if k not in np_tree]
    if missing:
        raise KeyError(f"asr_weights: missing {missing}")
    return {k: torch.as_tensor(np.asarray(np_tree[k], np.float32)).to(dev).contiguous()
            for k in ASR_KEYS}


__all__ = ["ASR_KEYS", "asr_weights", "demucs_flax_tree", "demucs_state_dict", "variables_from_jax",
           "variables_to_numpy"]
