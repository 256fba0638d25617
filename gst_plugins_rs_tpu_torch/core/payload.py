"""Payload helpers for elements that work on bytes or build payloads.

A payload is a `torch.Tensor` (on the device, or on the CPU) or a host numpy
array.  Byte elements (file sinks, compressors, ciphers, parsers) need the
bytes on the host: `host_array` reads a tensor back once, explicitly, and
then behaves as `np.asarray(payload, dtype)` does on a host array.  Elements
that build a payload next to an incoming one (silence, black frames) use
`zeros_like_payload` so the new payload lies where the incoming one does:
a CUDA payload gets a CUDA fill and a host array a host fill.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch


def host_array(data: Any, dtype: Optional[Any] = None) -> np.ndarray:
    """The payload as a host numpy array; a tensor is copied to the host
    once (one device-to-host copy for a CUDA tensor)."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    return np.asarray(data) if dtype is None else np.asarray(data, dtype)


def host_bytes(data: Any, dtype: Optional[Any] = None) -> bytes:
    """The payload's bytes in C order, read back from the device once."""
    return host_array(data, dtype).tobytes()


def zeros_like_payload(data: Any, shape: Optional[Sequence[int]] = None):
    """Zeros of the payload's type (and shape, unless one is given) where
    the payload lies: a tensor on its device, otherwise a host array."""
    if isinstance(data, torch.Tensor):
        if shape is None:
            return torch.zeros_like(data)
        return torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    arr = np.asarray(data)
    return np.zeros_like(arr) if shape is None else np.zeros(tuple(shape), arr.dtype)


__all__ = ["host_array", "host_bytes", "zeros_like_payload"]
