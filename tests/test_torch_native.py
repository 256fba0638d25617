"""The port's host-ops bindings (utils/native.py) against the JAX package's.

tests/test_native.py runs on the port with the same inputs and assertions
(its TestNetIo on the port's net/netio.py).  Then: the loader builds only
its own library, never the whole Makefile; the native routines and their
NumPy versions give the JAX package's results; the ring behaves as the JAX
package's does, with and without the library."""
import shutil

import numpy as np
import pytest

from gst_plugins_rs_tpu.utils import native as jnative
from gst_plugins_rs_tpu_torch.utils import native, native_build
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_native.py", globals())


def test_loader_builds_only_its_own_target(tmp_path, monkeypatch):
    """From a native directory without libraries, the first call builds
    libgstpu_hostops.so (Makefile variable TARGET) and nothing else: the
    FLAC decoder, the libavcodec shim and the UDP receiver stay unbuilt."""
    for f in ("Makefile", "hostops.cpp", "flacdec.cpp", "avshim.cpp", "netio.cpp"):
        shutil.copy(f"{native_build.NATIVE_DIR}/{f}", tmp_path / f)
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.native_available()
    assert sorted(p.name for p in tmp_path.glob("*.so")) == ["libgstpu_hostops.so"]
    assert not list(tmp_path.glob("*.tmp*"))


@pytest.fixture(params=["native", "numpy"])
def impl(request, monkeypatch):
    """The port's routines with the library, and with their NumPy versions
    (the library unavailable, as on a machine without a compiler)."""
    if request.param == "native":
        assert native.native_available()
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        assert not native.native_available()
    return request.param


@pytest.mark.parametrize("h,row,stride", [(5, 12, 16), (1, 3, 3), (64, 100, 128)])
def test_strided_copies_equal_the_jax_packages(impl, h, row, stride):
    rng = np.random.default_rng(h + row)
    src = rng.integers(0, 256, h * stride, dtype=np.uint8)
    packed = native.repack_strided(src, h, row, stride)
    assert np.array_equal(packed, jnative.repack_strided(src, h, row, stride))
    strided = native.unpack_strided(packed, h, row, stride)
    assert np.array_equal(strided, jnative.unpack_strided(packed, h, row, stride))


@pytest.mark.parametrize("frames,ch", [(100, 3), (1, 1), (4800, 2)])
def test_interleave_equals_the_jax_packages(impl, frames, ch):
    x = np.random.default_rng(frames).uniform(-1, 1, (frames, ch)).astype(np.float32)
    planes = native.deinterleave_f32(x)
    assert planes.dtype == np.float32 and np.array_equal(planes, jnative.deinterleave_f32(x))
    assert np.array_equal(native.interleave_f32(planes), jnative.interleave_f32(planes))


def test_ring_behaves_as_the_jax_packages(impl):
    """The same writes and reads give the same results in both packages'
    rings, through wrap-around and a refused overflow."""
    ops = [("w", b"hello"), ("w", b"world" * 30), ("r", 5), ("r", 150), ("r", 1),
           ("w", bytes(range(200)) * 4), ("r", 800), ("w", b"x" * 2048), ("n", 0)]
    results = []
    for ring in (native.SpscRing(1 << 10), jnative.SpscRing(1 << 10)):
        out = []
        for op, arg in ops:
            if op == "w":
                out.append(ring.write(arg))
            elif op == "r":
                out.append(ring.read(arg))
            else:
                out.append(ring.readable())
        results.append(out)
    assert results[0] == results[1]
