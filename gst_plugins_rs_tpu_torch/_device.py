"""Device switch and numeric scopes shared by the port's entry points.

Entry points (sources that put frames on the device, inference elements)
run on CUDA unless the caller asked for the CPU with `set_device("cpu")`.
With no CUDA device and no such request, `device()` raises: the port never
carries on quietly on the CPU.

`visible_devices()` lists the devices a mesh spans (parallel/mesh.py): every
CUDA device, or the one CPU device when the caller asked for the CPU.
`set_virtual_devices(n)` makes it list n logical devices that cycle over the
real ones, the counterpart of XLA's
`--xla_force_host_platform_device_count`: 8 shards on the CPU in the tests,
4 shards on one card in chip_smoke.py.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

_requested: Optional[str] = None
_virtual: Optional[int] = None


def set_device(name: Optional[str]) -> None:
    """Select where entry points run: "cuda", "cpu", or None (= CUDA,
    raising when there is none)."""
    global _requested
    if name is not None and torch.device(name).type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}: expected 'cuda' or 'cpu'")
    _requested = name


def requested_device() -> Optional[str]:
    return _requested


def device() -> torch.device:
    """The device entry points put their tensors on."""
    if _requested is not None and torch.device(_requested).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; call "
            "gst_plugins_rs_tpu_torch.set_device('cpu') to run on the CPU")
    return torch.device(_requested or "cuda")


def set_virtual_devices(n: Optional[int]) -> None:
    """Let `visible_devices()` list n logical devices cycling over the real
    ones (None: the real devices themselves)."""
    global _virtual
    if n is not None and int(n) < 1:
        raise ValueError(f"virtual device count must be >= 1, got {n}")
    _virtual = None if n is None else int(n)


def visible_devices() -> List[torch.device]:
    """The devices a mesh spans: every CUDA device, or the CPU when the
    caller asked for it; with `set_virtual_devices(n)`, n entries cycling
    over those."""
    dev = device()
    real = ([dev] if dev.type == "cpu"
            else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    if _virtual is None:
        return real
    return [real[i % len(real)] for i in range(_virtual)]


@contextlib.contextmanager
def no_tf32():
    """Run float32 convolutions and matmuls in full float32 inside the scope.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the YOLOX engine chains ~60 convolutions and is
    held to a relative error of 1e-3, so its forward turns TF32 off and
    restores both flags on exit."""
    cudnn_flag = torch.backends.cudnn.allow_tf32
    matmul_flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_flag
        torch.backends.cuda.matmul.allow_tf32 = matmul_flag


__all__ = ["device", "no_tf32", "requested_device", "set_device", "set_virtual_devices",
           "visible_devices"]
