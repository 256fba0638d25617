"""Builds one library of the repository's shared native directory.

The libraries under `native/` (the FLAC frame decoder, the libavcodec shim,
the batch UDP receiver) are the repository's, not copies of the port's, and `*.so` files are not
committed: a loader builds its own target at first use with `make -C
native <target>`, never the whole Makefile, so a library that cannot link on
a machine (the libavcodec shim where libavcodec is missing) stops no other.
"""
from __future__ import annotations

import os
import subprocess

NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "native"))


def build_target(native_dir: str, var: str, name: str, timeout: float = 180) -> str:
    """Build the target that make variable `var` names in native_dir's
    Makefile, under a name of this process's own, then move it to `name`,
    so that no process loads a library another is still writing.  Returns
    its path; raises OSError or subprocess.SubprocessError when the build
    fails."""
    path = os.path.join(native_dir, name)
    tmp = f"{name[:-3]}.tmp{os.getpid()}.so"
    try:
        subprocess.run(["make", "-C", native_dir, "-s", f"{var}={tmp}", tmp],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(os.path.join(native_dir, tmp), path)
    finally:
        if os.path.exists(os.path.join(native_dir, tmp)):
            os.remove(os.path.join(native_dir, tmp))
    return path


def load(native_dir: str, var: str, name: str):
    """ctypes.CDLL of native_dir/name, built first when it is missing, and
    built again once when it does not load (a library another process was
    still writing); None when neither gives a library."""
    import ctypes

    path = os.path.join(native_dir, name)
    for build in (not os.path.exists(path), True):
        try:
            if build:
                build_target(native_dir, var, name)
            return ctypes.CDLL(path)
        except (OSError, subprocess.SubprocessError):
            continue
    return None


__all__ = ["NATIVE_DIR", "build_target", "load"]
