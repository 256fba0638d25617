"""ctypes bindings for the native host-ops library (native/hostops.cpp).

The library is the repository's shared one, built at first use with `make
-C native libgstpu_hostops.so` (utils/native_build.py), never with the whole
Makefile; every entry point has a NumPy version that runs when it cannot be
built, so the framework stays functional without a compiler.  These are
host-memory helpers: nothing here touches the device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from . import native_build

NATIVE_DIR = native_build.NATIVE_DIR  # the loader reads it at its first call
LIB_NAME = "libgstpu_hostops.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # only this library's own target (Makefile variable TARGET)
    lib = native_build.load(NATIVE_DIR, "TARGET", LIB_NAME)
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    st = ctypes.c_size_t
    lib.repack_strided.argtypes = [u8p, u8p, st, st, st]
    lib.unpack_strided.argtypes = [u8p, u8p, st, st, st]
    lib.deinterleave_f32.argtypes = [f32p, f32p, st, st]
    lib.interleave_f32.argtypes = [f32p, f32p, st, st]
    lib.ring_new.restype = ctypes.c_void_p
    lib.ring_new.argtypes = [st]
    lib.ring_free.argtypes = [ctypes.c_void_p]
    lib.ring_readable.argtypes = [ctypes.c_void_p]
    lib.ring_readable.restype = st
    lib.ring_writable.argtypes = [ctypes.c_void_p]
    lib.ring_writable.restype = st
    lib.ring_write.argtypes = [ctypes.c_void_p, u8p, st]
    lib.ring_write.restype = st
    lib.ring_read.argtypes = [ctypes.c_void_p, u8p, st]
    lib.ring_read.restype = st
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def repack_strided(src: np.ndarray, height: int, row_bytes: int, src_stride: int) -> np.ndarray:
    """Strided plane -> tightly packed bytes."""
    lib = _load()
    dst = np.empty(height * row_bytes, np.uint8)
    if lib is not None:
        src = np.ascontiguousarray(src.reshape(-1).view(np.uint8))
        lib.repack_strided(_u8(src), _u8(dst), height, row_bytes, src_stride)
        return dst
    rows = src.reshape(height, src_stride)
    return np.ascontiguousarray(rows[:, :row_bytes]).reshape(-1)


def unpack_strided(src: np.ndarray, height: int, row_bytes: int, dst_stride: int) -> np.ndarray:
    lib = _load()
    dst = np.zeros(height * dst_stride, np.uint8)
    if lib is not None:
        src = np.ascontiguousarray(src.reshape(-1).view(np.uint8))
        lib.unpack_strided(_u8(src), _u8(dst), height, row_bytes, dst_stride)
        return dst
    out = dst.reshape(height, dst_stride)
    out[:, :row_bytes] = src.reshape(height, row_bytes)
    return dst


def deinterleave_f32(samples: np.ndarray) -> np.ndarray:
    """[frames, ch] f32 -> [ch, frames] f32."""
    lib = _load()
    frames, ch = samples.shape
    if lib is not None:
        src = np.ascontiguousarray(samples, np.float32)
        dst = np.empty((ch, frames), np.float32)
        lib.deinterleave_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames,
            ch,
        )
        return dst
    return np.ascontiguousarray(samples.T)


def interleave_f32(planes: np.ndarray) -> np.ndarray:
    """[ch, frames] f32 -> [frames, ch] f32."""
    lib = _load()
    ch, frames = planes.shape
    if lib is not None:
        src = np.ascontiguousarray(planes, np.float32)
        dst = np.empty((frames, ch), np.float32)
        lib.interleave_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames,
            ch,
        )
        return dst
    return np.ascontiguousarray(planes.T)


class SpscRing:
    """Lock-free single-producer single-consumer byte ring (native), with a
    Python deque fallback."""

    def __init__(self, capacity_pow2: int = 1 << 20):
        assert capacity_pow2 & (capacity_pow2 - 1) == 0, "capacity must be a power of two"
        self._lib = _load()
        self._cap = capacity_pow2
        if self._lib is not None:
            self._handle = self._lib.ring_new(capacity_pow2)
        else:
            from collections import deque

            self._q = deque()
            self._size = 0

    def write(self, data: bytes) -> bool:
        if self._lib is not None:
            arr = np.frombuffer(data, np.uint8)
            return bool(self._lib.ring_write(self._handle, _u8(arr), len(data)))
        if self._cap - self._size < len(data):
            return False
        self._q.append(data)
        self._size += len(data)
        return True

    def read(self, n: int) -> Optional[bytes]:
        if self._lib is not None:
            out = np.empty(n, np.uint8)
            got = self._lib.ring_read(self._handle, _u8(out), n)
            return out.tobytes() if got else None
        if self._size < n:
            return None
        chunks = []
        need = n
        while need:
            c = self._q.popleft()
            if len(c) <= need:
                chunks.append(c)
                need -= len(c)
            else:
                chunks.append(c[:need])
                self._q.appendleft(c[need:])
                need = 0
        self._size -= n
        return b"".join(chunks)

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_readable(self._handle))
        return self._size

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_handle", None):
            self._lib.ring_free(self._handle)


__all__ = [
    "native_available",
    "repack_strided",
    "unpack_strided",
    "deinterleave_f32",
    "interleave_f32",
    "SpscRing",
]
