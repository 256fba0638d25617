"""colorlut precision=approx against precision=exact at full size, on the CPU.

The JAX element's doc promises "<=2 u8 LSB guaranteed" for approx.  Its
load-time check bounds the f32 fit's error at the LUT nodes; the sampling
chain (B2 on RGBA, here its plain version) rounds the factors and hat
weights to bf16 on top of it.  This test measures the whole chain on one
seeded random 1080p RGBA frame through the port's element with the 33^3
saturation-and-tint grade that chip_smoke.py writes (`write_grade`, fitted
at rank 16), and the JAX element's approx on the same frame, and holds both
to the bound the port's property doc states
(`elements/video/colorlut.py::APPROX_MEASURED_LSB`, 5 u8 LSB measured).
"""
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.core import Buffer as JBuffer
from gst_plugins_rs_tpu.core import Caps as JCaps
from gst_plugins_rs_tpu.core import Fraction as JFraction
from gst_plugins_rs_tpu.core import Harness as JHarness
from gst_plugins_rs_tpu.core import element_factory_make as jmake
from gst_plugins_rs_tpu_torch.core import Buffer as TBuffer
from gst_plugins_rs_tpu_torch.core import Caps as TCaps
from gst_plugins_rs_tpu_torch.core import Fraction as TFraction
from gst_plugins_rs_tpu_torch.core import Harness as THarness
from gst_plugins_rs_tpu_torch.core import element_factory_make as tmake
from gst_plugins_rs_tpu_torch.elements.video.colorlut import APPROX_MEASURED_LSB, ColorLut
from torch_parity_helpers import port_on_cpu

LUT_SIZE = 33
HD_H, HD_W = 1080, 1920


@pytest.fixture(autouse=True)
def _on_cpu():
    with port_on_cpu():
        yield


def _write_grade(path):
    """chip_smoke.py's grade: 5% saturation boost, +0.01 green, +0.02 blue,
    clipped, at 33^3."""
    g = np.linspace(0, 1, LUT_SIZE)
    Bz, Gy, Rx = np.meshgrid(g, g, g, indexing="ij")
    Y = 0.299 * Rx + 0.587 * Gy + 0.114 * Bz
    table = np.stack([np.clip(Y + 1.05 * (Rx - Y), 0, 1),
                      np.clip(Y + 1.05 * (Gy - Y) + 0.01, 0, 1),
                      np.clip(Y + 1.05 * (Bz - Y) + 0.02, 0, 1)], -1).reshape(-1, 3)
    path.write_text(f'TITLE "smoke grade"\nLUT_3D_SIZE {LUT_SIZE}\n'
                    + "\n".join(f"{r:.6f} {gg:.6f} {b:.6f}" for r, gg, b in table) + "\n")
    return path


def _grade(pkg, precision, location, frame):
    make, harness, buffer, caps, frac = pkg
    e = make("colorlut")
    e.set_property("location", str(location))
    e.set_property("precision", precision)
    h = harness(e)
    h.set_src_caps(caps.builder("video/x-raw", format="RGBA", width=HD_W, height=HD_H,
                                framerate=frac(30, 1)))
    h.push(buffer(torch.from_numpy(frame) if make is tmake else frame, pts=0))
    out = h.pull().data
    return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def _max_lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def test_approx_against_exact_at_1080p(tmp_path):
    loc = _write_grade(tmp_path / "grade33.cube")
    frame = np.random.RandomState(0).randint(0, 256, (HD_H, HD_W, 4)).astype(np.uint8)
    port = (tmake, THarness, TBuffer, TCaps, TFraction)
    jax_pkg = (jmake, JHarness, JBuffer, JCaps, JFraction)
    port_lsb = _max_lsb(_grade(port, "approx", loc, frame), _grade(port, "exact", loc, frame))
    jax_lsb = _max_lsb(_grade(jax_pkg, "approx", loc, frame),
                       _grade(jax_pkg, "exact", loc, frame))
    print(f"approx vs exact, 1080p, 33^3 grade: port {port_lsb} LSB, JAX {jax_lsb} LSB")
    assert port_lsb <= APPROX_MEASURED_LSB
    assert jax_lsb <= APPROX_MEASURED_LSB
    doc = next(p.doc for p in ColorLut.PROPERTIES if p.name == "precision")
    assert f"<={APPROX_MEASURED_LSB} u8 LSB" in doc and "guaranteed" not in doc
