"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled on first use, with nvcc alone, into a shared library
with a plain C interface, which is loaded with ctypes (no PyTorch headers,
so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

Sources named in EXTRA_FLAGS get those flags as well.  The libraries go to
`gst_plugins_rs_tpu_torch/build/` (git-ignored).  A build is skipped while
the library is newer than its source.  Nothing here runs at import: the
CPU-only test environment has no nvcc.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# The per-pixel kernels and the limiter round every product and sum on its
# own, as their plain PyTorch versions do: no a*b+c contracted into one FMA
# rounding (the limiter's explicit fma calls stay).
EXTRA_FLAGS: Dict[str, List[str]] = {
    name: ["-fmad=false"]
    for name in ("colorlut_lowrank", "colorlut_mxu", "hsv_planes", "loudnorm_limiter")
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> List[str]:
    """Names of every kernel source in csrc/ (without the .cu)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(name: str, verbose: bool = False) -> str:
    """Compile csrc/<name>.cu unless its library is newer.  Returns the
    compiler's report (ptxas register/shared-memory lines with verbose)."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if lib.exists() and lib.stat().st_mtime > src.stat().st_mtime:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", *EXTRA_FLAGS.get(name, []), "-o", tmp, str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stdout + proc.stderr


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Build every csrc/*.cu, one nvcc per source, all started together.
    Returns the seconds each build took."""
    def one(name: str):
        t0 = time.perf_counter()
        report = build(name, verbose)
        return name, time.perf_counter() - t0, report

    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        results = list(pool.map(one, names))
    for name, _, report in results:
        if verbose and report:
            print(f"[build {name}]\n{report.strip()}")
    return {name: secs for name, secs, _ in results}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib: Optional[ctypes.CDLL] = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


__all__ = ["BUILD_DIR", "CSRC_DIR", "EXTRA_FLAGS", "build", "build_all", "library_path", "load",
           "nvcc_path", "sources"]
