"""Native batch UDP receiver (native/netio.cpp via ctypes).

The threadshare runtime analog at the IO layer: one epoll instance
drains many UDP sockets with recvmmsg — whole batches of datagrams per
Python call instead of one recvfrom per GIL round trip.  Used by the
multi-stream paths (benchmark harness, StreamBank feeders); ts-udpsrc
keeps the portable socket path as fallback when the shim is unavailable.

The shim is the repository's shared native library, not a copy of the
port's: it is built from native/netio.cpp with `make -C native
libgstpu_netio.so` at first use when the library is missing (`*.so` files
are not committed; utils/native_build.py).
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..utils import native_build

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    lib = native_build.load(native_build.NATIVE_DIR, "NETIO", "libgstpu_netio.so")
    if lib is not None:
        lib.gstpu_netio_new.restype = ctypes.c_void_p
        lib.gstpu_netio_add_socket.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_uint32]
        lib.gstpu_netio_remove_socket.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.gstpu_netio_poll.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int, ctypes.c_int]
        lib.gstpu_netio_poll.restype = ctypes.c_int
        lib.gstpu_netio_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class BatchReceiver:
    """Drains N sockets in batches: poll() -> [(tag, payload bytes), ...]."""

    def __init__(self, arena_bytes: int = 1 << 20, max_msgs: int = 1024):
        lib = _load()
        if lib is None:
            raise RuntimeError("netio shim unavailable (native build failed)")
        self._lib = lib
        self._h = lib.gstpu_netio_new()
        if not self._h:
            raise RuntimeError("epoll_create failed")
        self._arena = np.empty(arena_bytes, np.uint8)
        self._hdrs = np.empty(2 * max_msgs, np.uint32)
        self._max_msgs = max_msgs

    def add_socket(self, sock, tag: int) -> None:
        if self._lib.gstpu_netio_add_socket(self._h, sock.fileno(), tag) != 0:
            raise OSError("epoll_ctl ADD failed")

    def remove_socket(self, sock) -> None:
        self._lib.gstpu_netio_remove_socket(self._h, sock.fileno())

    def poll(self, timeout_ms: int = 100) -> List[Tuple[int, bytes]]:
        n = self._lib.gstpu_netio_poll(
            self._h,
            self._arena.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._arena.size,
            self._hdrs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self._max_msgs, timeout_ms)
        out: List[Tuple[int, bytes]] = []
        off = 0
        for i in range(n):
            tag = int(self._hdrs[2 * i])
            ln = int(self._hdrs[2 * i + 1])
            out.append((tag, self._arena[off:off + ln].tobytes()))
            off += ln
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.gstpu_netio_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
