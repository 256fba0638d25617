"""Shared network contexts — the threadshare Context/Scheduler analog.

Parity target: generic/threadshare/src/runtime (Context::acquire with a
name + wait period; elements naming the same context share one
scheduler thread — udpsrc/imp.rs:815,897).  Here a context is one
thread driving the native epoll+recvmmsg receiver (net/netio.py, with a
portable selectors fallback): all ts-udpsrc elements naming the same
context share that single drain loop, and each element pops complete
datagram batches from its per-socket queue.

    Context.acquire("capture", wait_ms=5)   # one thread, N sockets
"""
from __future__ import annotations

import queue
import selectors
import threading
from typing import Dict, Optional

from . import netio


class Context:
    """Named shared drain loop; refcounted like the reference's Context."""

    _registry: Dict[str, "Context"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def acquire(cls, name: str, wait_ms: int = 5) -> "Context":
        with cls._registry_lock:
            ctx = cls._registry.get(name)
            if ctx is None:
                ctx = cls._registry[name] = Context(name, wait_ms)
            ctx._refs += 1
            return ctx

    def release(self) -> None:
        with Context._registry_lock:
            self._refs -= 1
            if self._refs <= 0:
                Context._registry.pop(self.name, None)
                self._stop.set()

    def __init__(self, name: str, wait_ms: int):
        self.name = name
        self.wait_ms = max(1, wait_ms)
        self._refs = 0
        self._tags = 0
        self._queues: Dict[int, "queue.Queue[bytes]"] = {}
        self._socks: Dict[int, object] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._rx = None
        self._sel: Optional[selectors.BaseSelector] = None
        if netio.available():
            self._rx = netio.BatchReceiver(arena_bytes=4 << 20, max_msgs=4096)
        else:
            self._sel = selectors.DefaultSelector()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"gstpu-ctx-{name}")
        self._thread.start()

    # -- socket registration ------------------------------------------------
    def add_socket(self, sock) -> "queue.Queue[bytes]":
        """Registers a non-blocking UDP socket; returns its datagram queue."""
        with self._lock:
            tag = self._tags
            self._tags += 1
            q: "queue.Queue[bytes]" = queue.Queue()
            self._queues[tag] = q
            self._socks[tag] = sock
            sock.setblocking(False)
            if self._rx is not None:
                self._rx.add_socket(sock, tag)
            else:
                self._sel.register(sock, selectors.EVENT_READ, tag)
        return q

    def remove_socket(self, sock) -> None:
        with self._lock:
            for tag, s in list(self._socks.items()):
                if s is sock:
                    del self._socks[tag]
                    self._queues.pop(tag, None)
                    try:
                        if self._rx is not None:
                            self._rx.remove_socket(sock)
                        else:
                            self._sel.unregister(sock)
                    except (KeyError, OSError, ValueError):
                        pass

    # -- drain loop -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            if self._rx is not None:
                batch = self._rx.poll(timeout_ms=self.wait_ms)
                if not batch:
                    continue
                with self._lock:
                    for tag, payload in batch:
                        q = self._queues.get(tag)
                        if q is not None:
                            q.put(payload)
            else:
                events = self._sel.select(timeout=self.wait_ms / 1000)
                for key, _ in events:
                    tag = key.data
                    try:
                        while True:
                            data, _addr = key.fileobj.recvfrom(65536)
                            q = self._queues.get(tag)
                            if q is not None:
                                q.put(data)
                    except (BlockingIOError, OSError):
                        continue
        if self._rx is not None:
            self._rx.close()
        elif self._sel is not None:
            self._sel.close()
