"""Operators of the port: kernels written by hand for Hopper, each beside its plain PyTorch version.

Each kernel's wrapper counts its launches in a module-level int of its own
module (`launches`, `packed_launches`, ...) through `count_launch`, where it
launches the kernel and nowhere else.  A thread that is capturing a CUDA
graph (parallel/fuse.py) notes its own launches with `noting_launches`, so
each replay can add them again; launches of other threads are not noted.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Iterator, List, Tuple

_thread = threading.local()


def count_launch(module: str, counter: str) -> None:
    """Add one to the launch counter `counter` of the ops module `module`."""
    mod = sys.modules[module]
    setattr(mod, counter, getattr(mod, counter) + 1)
    noted = getattr(_thread, "noted", None)
    if noted is not None:
        noted.append((module, counter))


@contextlib.contextmanager
def noting_launches() -> Iterator[List[Tuple[str, str]]]:
    """The (module, counter) of every launch this thread counts in the scope."""
    outer = getattr(_thread, "noted", None)
    _thread.noted = noted = []
    try:
        yield noted
    finally:
        _thread.noted = outer
