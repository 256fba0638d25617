"""Demucs music source separation (time-domain v2 architecture) in PyTorch.

The port of gst_plugins_rs_tpu/models/demucs.py: the classic time-domain
Demucs (Defossez et al., arXiv:1911.13254): a conv encoder with GLU
activations, a BiLSTM bottleneck, a transposed-conv decoder with U-Net
skips and one waveform head per source.  `Demucs` is an `nn.Module` whose
submodules are named after the flax tree (Conv_i, ConvTranspose_i,
_BiLSTM_0 with one bidirectional nn.LSTM per layer and Dense_0), so the
weight carrier (models/convert.py::demucs_state_dict) maps each flax leaf
to one state_dict entry.  It computes channels-first [B, C, T] inside and
is channels-last at its boundary, as the flax module: [B, T, C] in,
[B, S, T, C] out.  Convolutions, the LSTMs and the Linear run in full
float32 (`_device.no_tf32`).

`init_weights(config, seed, device)` draws flax's default initialisers
from a torch.Generator on `device` (on the card for the element there: the
published size's 265M draws are slow on the host); the numbers differ
from `jax.random.PRNGKey(seed)`, and the card's from the CPU's.  `load_npz` reads the JAX
package's `save_npz` files; `save_npz` writes them.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .._device import no_tf32
from .convert import demucs_flax_tree, demucs_state_dict

SOURCES = ("drums", "bass", "other", "vocals")


@dataclass
class DemucsConfig:
    sources: Tuple[str, ...] = SOURCES
    audio_channels: int = 2
    channels: int = 64  # first encoder width (v2 default 64; tests shrink this)
    depth: int = 6
    kernel_size: int = 8
    stride: int = 4
    lstm_layers: int = 2
    growth: float = 2.0

    def valid_length(self, length: int) -> int:
        """Smallest input length >= `length` the stride tree reconstructs
        exactly (mirrors demucs.utils.valid_length)."""
        for _ in range(self.depth):
            length = -(-max(length, 1) // self.stride) + self.kernel_size - self.stride
            length = max(length, 1)
        for _ in range(self.depth):
            length = (length - 1) * self.stride + self.kernel_size
        return int(length)


class _BiLSTM(nn.Module):
    """flax's _BiLSTM: per layer a forward and a backward LSTM whose outputs
    are concatenated (one bidirectional nn.LSTM), then a Dense to `hidden`."""

    def __init__(self, in_features: int, hidden: int, layers: int):
        super().__init__()
        for layer in range(layers):
            self.add_module(f"LSTM_{layer}", nn.LSTM(
                in_features if layer == 0 else 2 * hidden, hidden,
                batch_first=True, bidirectional=True))
        self.layers = layers
        self.Dense_0 = nn.Linear(2 * hidden, hidden)

    def forward(self, x):  # [B, T, C]
        for layer in range(self.layers):
            x, _ = getattr(self, f"LSTM_{layer}")(x)
        return self.Dense_0(x)


class Demucs(nn.Module):
    def __init__(self, config: DemucsConfig):
        super().__init__()
        cfg = self.config = config
        k, s = cfg.kernel_size, cfg.stride
        ch_in, ch = cfg.audio_channels, cfg.channels
        for i in range(cfg.depth):
            self.add_module(f"Conv_{2 * i}", nn.Conv1d(ch_in, ch, k, stride=s))
            self.add_module(f"Conv_{2 * i + 1}", nn.Conv1d(ch, 2 * ch, 1))
            ch_in, ch = ch, int(ch * cfg.growth)
        ch = int(ch / cfg.growth)
        self._BiLSTM_0 = _BiLSTM(ch, ch, cfg.lstm_layers)
        for i in range(cfg.depth):
            last = i == cfg.depth - 1
            out_ch = len(cfg.sources) * cfg.audio_channels if last else int(ch / cfg.growth)
            self.add_module(f"Conv_{2 * cfg.depth + i}", nn.Conv1d(ch, 2 * ch, 3, padding=1))
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose1d(ch, out_ch, k, stride=s))
            ch = out_ch

    def forward(self, mix):  # [B, T, audio_channels] -> [B, S, T, audio_channels]
        cfg = self.config
        with no_tf32():
            mono_ref = mix.mean(dim=-1, keepdim=True)
            std = mono_ref.std(dim=1, keepdim=True, correction=0) + 1e-5  # population std
            x = (mix / std).transpose(1, 2)  # [B, C, T]
            skips: List[torch.Tensor] = []
            for i in range(cfg.depth):
                x = F.relu(getattr(self, f"Conv_{2 * i}")(x))
                x = F.glu(getattr(self, f"Conv_{2 * i + 1}")(x), dim=1)
                skips.append(x)
            x = self._BiLSTM_0(x.transpose(1, 2)).transpose(1, 2)
            for i in range(cfg.depth):
                x = x + skips.pop()
                x = F.glu(getattr(self, f"Conv_{2 * cfg.depth + i}")(x), dim=1)
                x = getattr(self, f"ConvTranspose_{i}")(x)
                if i != cfg.depth - 1:
                    x = F.relu(x)
            b, _, t = x.shape
            x = x.reshape(b, len(cfg.sources), cfg.audio_channels, t).permute(0, 1, 3, 2)
            return x * std[:, None]


# truncated_normal(-2, 2) has std 0.8796; flax's lecun_normal rescales by it
_TRUNC_STD = 0.87962566103423978
_CDF2 = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0  # the normal CDF at 2


def _lecun_normal(shape, fan_in: int, g: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at 2 sigma with std
    sqrt(1/fan_in), by the inverse CDF (nn.init.trunc_normal_'s method,
    written out in place: that function was slower on the CPU)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    w = torch.empty(shape, device=g.device)
    w.uniform_(1.0 - 2.0 * _CDF2, 2.0 * _CDF2 - 1.0, generator=g)
    w.erfinv_().mul_(std * math.sqrt(2.0))
    return w.clamp_(-2.0 * std, 2.0 * std)


def _orthogonal(n: int, g: torch.Generator) -> torch.Tensor:
    return nn.init.orthogonal_(torch.empty(n, n, device=g.device), generator=g)


def init_flax_tree(config: DemucsConfig, seed: int = 0, device="cpu") -> Dict[str, Dict]:
    """{"params": ...} in the flax layout, as float32 tensors on `device`,
    with flax's default initialisers (lecun_normal kernels, orthogonal LSTM
    recurrent kernels, zero biases) drawn from a torch.Generator on `device`
    seeded `seed`, in the flax module's creation order.  A generator on the
    card draws other numbers than one on the CPU."""
    g = torch.Generator(device=device).manual_seed(seed)
    cfg, k = config, config.kernel_size
    params: Dict[str, Dict] = {}

    def zeros(n):
        return torch.zeros(n, device=g.device)

    def conv(name, kk, cin, cout):
        params[name] = {"kernel": _lecun_normal((kk, cin, cout), kk * cin, g),
                        "bias": zeros(cout)}

    ch_in, ch = cfg.audio_channels, cfg.channels
    for i in range(cfg.depth):
        conv(f"Conv_{2 * i}", k, ch_in, ch)
        conv(f"Conv_{2 * i + 1}", 1, ch, 2 * ch)
        ch_in, ch = ch, int(ch * cfg.growth)
    ch = int(ch / cfg.growth)
    lstm: Dict[str, Dict] = {}
    n_in = ch
    for layer in range(cfg.lstm_layers):
        for direction in range(2):
            cell = {gate: {"kernel": _lecun_normal((n_in, ch), n_in, g)} for gate in
                    ("ii", "if", "ig", "io")}
            for gate in ("hi", "hf", "hg", "ho"):
                cell[gate] = {"kernel": _orthogonal(ch, g), "bias": zeros(ch)}
            lstm[f"LSTMCell_{2 * layer + direction}"] = cell
        n_in = 2 * ch
    lstm["Dense_0"] = {"kernel": _lecun_normal((2 * ch, ch), 2 * ch, g), "bias": zeros(ch)}
    params["_BiLSTM_0"] = lstm
    for i in range(cfg.depth):
        last = i == cfg.depth - 1
        out_ch = len(cfg.sources) * cfg.audio_channels if last else int(ch / cfg.growth)
        conv(f"Conv_{2 * cfg.depth + i}", 3, ch, 2 * ch)
        params[f"ConvTranspose_{i}"] = {"kernel": _lecun_normal((k, ch, out_ch), k * ch, g),
                                        "bias": zeros(out_ch)}
        ch = out_ch
    return {"params": params}


def init_weights(config: DemucsConfig, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """The state_dict of `init_flax_tree(config, seed, device)`, on `device`."""
    return demucs_state_dict(init_flax_tree(config, seed, device))


def build(config: DemucsConfig, state_dict: Dict[str, torch.Tensor], device) -> Demucs:
    """A Demucs in eval mode on `device` holding `state_dict`."""
    model = Demucs(config).eval()
    model.load_state_dict(state_dict, strict=True)
    return model.to(device)


def param_count(config: DemucsConfig) -> int:
    """Number of parameters, counted on the meta device (nothing allocated).
    The torch LSTMs hold a second bias (bias_ih) that flax does not have;
    it is not counted."""
    with torch.device("meta"):
        model = Demucs(config)
    return sum(p.numel() for n, p in model.named_parameters() if "bias_ih" not in n)


_KEY = re.compile(r"\['([^']*)'\]")


def save_npz(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """Write the JAX package's save_npz format (flax key paths)."""
    flat = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            if isinstance(value, dict):
                walk(value, prefix + f"['{key}']")
            else:
                flat[prefix + f"['{key}']"] = np.asarray(value)

    walk(demucs_flax_tree(state_dict), "")
    np.savez(path, **flat)


def load_npz(path: str, config: DemucsConfig) -> Dict[str, torch.Tensor]:
    """Read a save_npz file into the config's state_dict; a missing
    parameter raises KeyError, a shape that differs ValueError."""
    with np.load(path) as data:
        tree: Dict = {}
        for key in data.files:
            *mods, leaf = _KEY.findall(key)
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = data[key]
    with torch.device("meta"):
        template = Demucs(config).state_dict()
    sd = demucs_state_dict(tree)
    for key, v in template.items():
        if key not in sd:
            raise KeyError(f"missing parameter {key}")
        if tuple(sd[key].shape) != tuple(v.shape):
            raise ValueError(f"{key}: shape {tuple(sd[key].shape)} != expected {tuple(v.shape)}")
    return {key: sd[key] for key in template}


__all__ = ["Demucs", "DemucsConfig", "SOURCES", "build", "init_flax_tree", "init_weights",
           "load_npz", "param_count", "save_npz"]
