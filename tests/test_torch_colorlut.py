"""colorlut of the PyTorch port against the JAX package, on the CPU.

The same .cube files and numpy-seeded frames go through both packages.  On
the CPU the port's kernels B2, B3 (ops/colorlut_lowrank_fused.py) and B5
(ops/colorlut_mxu.py) run their plain versions; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_colorlut.py does.  The CUDA
kernels themselves are held against the plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances:
- exact and fast grades, port vs JAX: <= 1 u8 LSB (the same f32 lerps;
  XLA may contract or reorder them, which moves a value across a rounding
  boundary at most);
- B2/B3 and the elements' approx path, port vs JAX: <= 1 u8 LSB, raw f32
  outputs within 1e-5: the rank sum is taken in another order, which
  matters only at rounding ties (PERF_NOTES.md "colorlut gather analysis");
- B5 through lut3d_apply_mxu: <= 1 LSB (the four bf16 products of a lane
  are summed in another order than the MXU's), RGBA64 with a domain other
  than [0, 1] one u8 LSB (XLA's fma grid coordinates, as for packed64);
- B5's packed entries against its TPU signature with the glue in torch:
  bit-equal (the same chain and roundings);
- B2 against B3 in the port: bit-equal (one shared chain), as
  tests/test_colorlut.py::test_packed_kernel_matches_fused holds the TPU
  kernels;
- fit_lowrank: the same factors (the same numpy code and seed).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu.core import Buffer as JBuffer
from gst_plugins_rs_tpu.core import Caps as JCaps
from gst_plugins_rs_tpu.core import Fraction as JFraction
from gst_plugins_rs_tpu.core import Harness as JHarness
from gst_plugins_rs_tpu.core import element_factory_make as jmake
from gst_plugins_rs_tpu.ops import colorlut as jcl
from gst_plugins_rs_tpu.ops import colorlut_lowrank as jlr
from gst_plugins_rs_tpu.ops import pallas_colorlut as jmxu
from gst_plugins_rs_tpu.ops import pallas_colorlut_lowrank as jfused

from gst_plugins_rs_tpu_torch import requested_device, set_device
from gst_plugins_rs_tpu_torch.core import Buffer as TBuffer
from gst_plugins_rs_tpu_torch.core import Caps as TCaps
from gst_plugins_rs_tpu_torch.core import Fraction as TFraction
from gst_plugins_rs_tpu_torch.core import Harness as THarness
from gst_plugins_rs_tpu_torch.core import element_factory_make as tmake
from gst_plugins_rs_tpu_torch.ops import colorlut as tcl
from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank as tlr
from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as tfused
from gst_plugins_rs_tpu_torch.ops import colorlut_mxu as tmxu
from gst_plugins_rs_tpu_torch.ops.pixels import restack
from test_colorlut import IDENTITY_2, SWAP_RB_2, _smooth_grade_lut_text, oracle_3d


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = requested_device()
    set_device("cpu")
    yield
    set_device(prev)


def _lut_text(table, size, header=""):
    return header + f"LUT_3D_SIZE {size}\n" + "\n".join(
        " ".join(f"{v:.6f}" for v in row) for row in table)


def _grade_table(size, boost=1.2, tint=0.03):
    """A non-separable saturation-and-tint grade, flat [size^3, 3]."""
    g = np.linspace(0, 1, size)
    Bz, Gy, Rx = np.meshgrid(g, g, g, indexing="ij")
    Y = 0.299 * Rx + 0.587 * Gy + 0.114 * Bz
    return np.stack([
        np.clip(Y + boost * (Rx - Y), 0, 1),
        np.clip(Y + boost * (Gy - Y), 0, 1),
        np.clip(Y + boost * (Bz - Y) + tint, 0, 1)], -1).reshape(-1, 3).astype(np.float32)


def _write(tmp_path, text, name="grade.cube"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _run(pkg, frame, location, fmt="RGBA", precision="exact"):
    """(output frame as numpy, the element) through one package's colorlut."""
    make, harness, buffer, caps, frac = pkg
    elem = make("colorlut")
    elem.set_property("location", location)
    elem.set_property("precision", precision)
    h = harness(elem)
    hh, ww = frame.shape[:2]
    h.set_src_caps(caps.builder("video/x-raw", format=fmt, width=ww, height=hh,
                                framerate=frac(30, 1)))
    data = torch.from_numpy(frame) if pkg is TPKG else frame
    h.push(buffer(data, pts=0))
    out = h.pull().data
    return (out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)), elem


JPKG = (jmake, JHarness, JBuffer, JCaps, JFraction)
TPKG = (tmake, THarness, TBuffer, TCaps, TFraction)


def _max_lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


# --- parser and tables ------------------------------------------------------

_PARSE_CASES = [
    IDENTITY_2,
    "LUT_1D_SIZE 2\n\nTITLE \"t\"\nDOMAIN_MIN 0.0 0.0 0.0\nDOMAIN_MAX 1.0 1.0 1.0\n"
    "0.0 0.0 0.0\n1.0 0.5 0.7\n",
    "DOMAIN_MIN 0.1 0.0 0.2\nDOMAIN_MAX 0.5 0.9 1.0\n" + SWAP_RB_2,
    "LUT_1D_SIZE 2\n0.0 0.0 0.0\n1.0 0.0 0.0\nTITLE \"invalid\"\n",
    "LUT_1D_SIZE 2\nLUT_3D_SIZE 2\n0.0 0.0 0.0\n1.0 1.0 1.0\n",
    "0.0 0.0 0.0\n",
    "LUT_3D_SIZE 1\n0.0 0.0 0.0\n",
    "LUT_1D_SIZE 2\n0.0 0.0 0.0\n",
    "LUT_1D_SIZE 2\nDOMAIN_MIN 1.0 1.0 1.0\n0.0 0.0 0.0\n1.0 1.0 1.0\n",
    "TITLE \"empty\"\n",
    "LUT_1D_SIZE 2\n0.0 x 0.0\n1.0 0.0 0.0\n",
]


@pytest.mark.parametrize("text", _PARSE_CASES)
def test_parser_matches_jax(text):
    try:
        ref = jcl.CubeLut.parse(text)
    except jcl.CubeParseError as e:
        with pytest.raises(tcl.CubeParseError) as got:
            tcl.CubeLut.parse(text)
        assert str(got.value) == str(e)
        return
    got = tcl.CubeLut.parse(text)
    assert (got.is_3d, got.size) == (ref.is_3d, ref.size)
    for f in ("domain_scale", "domain_offset", "table"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("size", [2, 9, 17])
def test_packed_tables_match_jax(size):
    table = _grade_table(size)
    assert np.array_equal(tcl.pack_corner_table(table, size), jcl.pack_corner_table(table, size))
    assert np.array_equal(tmxu.pack_matmul_table(table, size),
                          jmxu.pack_matmul_table(table, size))
    fit = jlr.fit_lowrank(table, size, tolerance=2.0 / 255.0) if size > 2 else None
    if fit is not None:
        for a, b in zip(tfused.pack_factors(fit.U, fit.V, fit.W, fit.C),
                        jfused.pack_factors(fit.U, fit.V, fit.W, fit.C)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("size", [9, 17])
def test_fit_lowrank_matches_jax(size):
    table = _grade_table(size)
    ref = jlr.fit_lowrank(table, size, tolerance=2.0 / 255.0)
    got = tlr.fit_lowrank(table, size, tolerance=2.0 / 255.0)
    assert ref is not None and got is not None
    for f in "UVWC":
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.max_node_err == ref.max_node_err <= 2.0 / 255.0


# --- exact and fast grades through the element -------------------------------


@pytest.mark.parametrize("case", ["identity", "swap_rb", "random5", "domain", "grade17", "1d"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_element_matches_jax(tmp_path, case, precision):
    rng = np.random.RandomState(11)
    text = {
        "identity": IDENTITY_2,
        "swap_rb": SWAP_RB_2,
        "random5": _lut_text(rng.uniform(0, 1, (125, 3)), 5),
        "domain": "DOMAIN_MIN 0.0 0.0 0.0\nDOMAIN_MAX 0.5 0.5 0.5\n" + IDENTITY_2,
        "grade17": _lut_text(_grade_table(17), 17),
        "1d": "LUT_1D_SIZE 3\n1.0 1.0 1.0\n0.2 0.5 0.7\n0.0 0.0 0.0\n",
    }[case]
    loc = _write(tmp_path, text)
    frame = rng.randint(0, 256, (24, 32, 4)).astype(np.uint8)
    ref, _ = _run(JPKG, frame, loc, precision=precision)
    got, _ = _run(TPKG, frame, loc, precision=precision)
    assert got.dtype == np.uint8 and got.shape == frame.shape
    assert _max_lsb(ref, got) <= 1
    assert np.array_equal(got[..., 3], frame[..., 3])
    if case == "identity" and precision == "exact":
        assert np.array_equal(got, frame)  # test_identity_lut_is_exact
    if case in ("random5", "domain") and precision == "exact":
        lut = tcl.CubeLut.parse(text)
        assert _max_lsb(got[..., :3], oracle_3d(frame, lut)) <= 1


def test_1d_inversion_values(tmp_path):
    """test_colorlut.py::test_1d_lut, through the port."""
    loc = _write(tmp_path, "LUT_1D_SIZE 2\n1.0 1.0 1.0\n0.0 0.0 0.0\n")
    frame = np.array([[[255, 0, 100, 77]]], np.uint8)
    got, _ = _run(TPKG, frame, loc)
    assert got[0, 0].tolist() == [0, 255, 155, 77]


@pytest.mark.parametrize("fmt", ["RGBA64LE", "RGBA64BE"])
def test_rgba64_matches_jax(tmp_path, fmt):
    """test_colorlut.py::test_rgba64, and the u16 round trip: an identity
    LUT hands every 16-bit value back unchanged."""
    loc = _write(tmp_path, SWAP_RB_2)
    frame = np.zeros((2, 2, 4), np.uint16)
    frame[..., 0] = 65535
    frame[..., 3] = 40000
    got, _ = _run(TPKG, frame, loc, fmt=fmt)
    assert got.dtype == np.uint16
    assert got[0, 0].tolist() == [0, 0, 65535, 40000]
    rng = np.random.RandomState(4)
    frame = rng.randint(0, 65536, (8, 16, 4)).astype(np.uint16)
    frame[0, :4] = [[0, 1, 65534, 65535]] * 4
    ident = _write(tmp_path, IDENTITY_2, "identity.cube")
    got, _ = _run(TPKG, frame, ident, fmt=fmt)
    assert got.dtype == np.uint16 and np.array_equal(got, frame)
    grade = _write(tmp_path, _lut_text(_grade_table(9), 9), "grade9.cube")
    ref, _ = _run(JPKG, frame, grade, fmt=fmt)
    got, _ = _run(TPKG, frame, grade, fmt=fmt)
    assert _max_lsb(ref, got) <= 1 and np.array_equal(got[..., 3], frame[..., 3])


# --- precision=approx: kernels B2, B3 and the element --------------------------


def _factors(size, seed=0):
    fit = jlr.fit_lowrank(_grade_table(size), size, tolerance=2.0 / 255.0)
    assert fit is not None
    packs = jfused.pack_factors(fit.U, fit.V, fit.W, fit.C)
    return fit, [jnp.asarray(a) for a in packs], [torch.from_numpy(a) for a in packs]


_SCALE, _OFFSET = [1.05, 1.0, 0.95], [0.01, 0.0, -0.02]


@pytest.mark.parametrize("size", [9, 17])
def test_b3_plain_matches_jax_kernel(size):
    """B3: the port's plain version (CPU) against the Pallas kernel in
    interpret mode, on the same grid coordinates and through the wrapper."""
    _, jops, tops = _factors(size)
    rng = np.random.RandomState(size)
    xyz = rng.uniform(0, size - 1, (3, 4096)).astype(np.float32)
    xyz[:, :3] = [[0.0, size - 1.0, size / 2.0]] * 3  # the ends and a node
    ref = np.asarray(jfused.lowrank_sample_pallas(jnp.asarray(xyz), *jops, interpret=True))
    before = tfused.fused_launches
    got = tfused.lowrank_sample_fused(torch.from_numpy(xyz), *tops).numpy()
    assert tfused.fused_launches == before  # a CPU tensor runs the plain version
    assert got.shape == (3, 4096) and float(np.abs(got - ref).max()) <= 1e-5
    frame = rng.randint(0, 256, (48, 64, 4)).astype(np.uint8)
    kw = dict(size=size, offsets=(2, 1, 0), bits=8)
    a = np.asarray(jfused.lut3d_apply_lowrank_fused(jnp.asarray(frame), *jops, _SCALE, _OFFSET,
                                                    interpret=True, **kw))
    b = tfused.lut3d_apply_lowrank_fused(torch.from_numpy(frame), *tops, _SCALE, _OFFSET,
                                         **kw).numpy()
    assert _max_lsb(a, b) <= 1 and np.array_equal(b[..., 3], frame[..., 3])


@pytest.mark.parametrize("size", [9, 17])
def test_b2_plain_matches_jax_kernel(size):
    """B2 through lut3d_apply_lowrank_packed: port (plain) vs Pallas
    (interpret), <= 1 LSB, alpha riding through."""
    _, jops, tops = _factors(size)
    frame = np.random.RandomState(5).randint(0, 256, (48, 64, 4)).astype(np.uint8)
    kw = dict(size=size, offsets=(0, 1, 2), bits=8)
    ref = np.asarray(jfused.lut3d_apply_lowrank_packed(jnp.asarray(frame), *jops, _SCALE,
                                                       _OFFSET, interpret=True, **kw))
    before = tfused.packed_launches
    got = tfused.lut3d_apply_lowrank_packed(torch.from_numpy(frame), *tops, _SCALE, _OFFSET,
                                            **kw)
    assert tfused.packed_launches == before
    assert got.dtype == torch.uint8 and tuple(got.shape) == frame.shape
    got = got.numpy()
    assert _max_lsb(ref, got) <= 1 and np.array_equal(got[..., 3], frame[..., 3])


@pytest.mark.parametrize("size", [9, 17])
def test_b2_b3_bit_equal(size):
    """The port's B2 and B3 (plain versions here) are bit-equal on RGBA, as
    test_colorlut.py::test_packed_kernel_matches_fused holds the TPU
    kernels; raw-px shapes other than the TPU's [Pr, 4096] work too."""
    _, _, tops = _factors(size)
    frame = torch.from_numpy(np.random.RandomState(6).randint(0, 256, (37, 53, 4))
                             .astype(np.uint8))
    kw = dict(size=size, offsets=(0, 1, 2), bits=8)
    a = tfused.lut3d_apply_lowrank_fused(frame, *tops, _SCALE, _OFFSET, **kw)
    b = tfused.lut3d_apply_lowrank_packed(frame, *tops, _SCALE, _OFFSET, **kw)
    assert torch.equal(a, b)


def _frame16(seed, h=48, w=64):
    """A seeded RGBA64 frame with the domain's ends (0, 65535) in its first
    row and the codes of grid nodes at S = 9 and 17 (v = 65535 i / 8) in its
    second; the JAX element's frames are native-endian u16, LE or BE."""
    frame = np.random.RandomState(seed).randint(0, 65536, (h, w, 4)).astype(np.uint16)
    frame[0, :4] = [[0, 65535, 0, 1], [65535, 0, 65535, 2], [0, 0, 0, 0],
                    [65535, 65535, 65535, 65535]]
    frame[1, :9, :3] = (65535 * np.arange(9) // 8)[:, None]
    return frame


@pytest.mark.parametrize("domain", ["identity", "graded"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("size", [9, 17])
def test_packed64_plain_matches_jax_kernel(size, compute_dtype, domain):
    """packed64 (RGBA64 pixels through B3's chain, the glue in the kernel):
    the port's plain twin (CPU) against the JAX package's
    lut3d_apply_lowrank_fused (B3 in interpret mode, glue as XLA ops),
    alpha bit-equal, within 1 u16 LSB, except for bf16 with a domain other
    than [0, 1]: XLA folds scale / maxval into one constant and contracts
    v * that + offset into one FMA, which moves about a fifth of the grid
    coordinates by an f32 ulp, and the bf16 rounding of the hat weights
    turns that into tens of u16 LSBs (95 seen at S = 9); there the gate is
    one u8 LSB (257), the approx path's own unit
    (test_packed64_jax_gap_is_its_coordinates shows the cause)."""
    _, jops, tops = _factors(size)
    frame = _frame16(size)
    scale, offset = (_SCALE, _OFFSET) if domain == "graded" else ([1.0] * 3, [0.0] * 3)
    kw = dict(size=size, offsets=(0, 1, 2), bits=16, compute_dtype=compute_dtype)
    ref = np.asarray(jfused.lut3d_apply_lowrank_fused(
        jnp.asarray(frame), *jops, jnp.asarray(scale, jnp.float32),
        jnp.asarray(offset, jnp.float32), interpret=True, **kw))
    before = tfused.packed64_launches
    got = tfused.lut3d_apply_lowrank_packed(torch.from_numpy(frame), *tops, scale, offset, **kw)
    assert tfused.packed64_launches == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.uint16 and tuple(got.shape) == frame.shape
    got = got.numpy()
    tol = 257 if (compute_dtype, domain) == ("bfloat16", "graded") else 1
    assert _max_lsb(ref, got) <= tol and np.array_equal(got[..., 3], frame[..., 3])


@pytest.mark.parametrize("size", [9, 17])
def test_packed64_jax_gap_is_its_coordinates(size):
    """Why the bf16 graded case above needs its wider gate: on the CPU the
    JAX element's grid coordinates are fma(v, f32(scale * f32(1/maxval)),
    offset), one rounding, where the port (and the kernel) rounds v/maxval,
    then the product with scale, then the sum.  The port's chain at JAX's
    coordinates matches the JAX output within 1 u16 LSB; at its own it does
    not.  The fma is taken in f64, exact here: v has 16 bits and the
    constant 24."""
    _, jops, tops = _factors(size)
    frame = _frame16(size)
    ref = np.asarray(jfused.lut3d_apply_lowrank_fused(
        jnp.asarray(frame), *jops, jnp.asarray(_SCALE, jnp.float32),
        jnp.asarray(_OFFSET, jnp.float32), interpret=True, size=size, offsets=(0, 1, 2),
        bits=16, compute_dtype="bfloat16"))
    v = frame[..., :3].reshape(-1, 3).astype(np.float32)
    scale, offset = np.float32(_SCALE), np.float32(_OFFSET)
    inv = np.float32(1.0) / np.float32(65535.0)
    coords = {"jax": (v.astype(np.float64) * (scale * inv).astype(np.float64)
                      + offset.astype(np.float64)).astype(np.float32),
              "port": v * inv * scale + offset}
    lsb = {}
    for name, t in coords.items():
        xyz = torch.from_numpy(np.ascontiguousarray((np.clip(t, 0.0, 1.0)
                                                     * np.float32(size - 1)).T))
        out = tfused.lowrank_sample_fused_plain(xyz, *tops, compute_dtype="bfloat16")
        q = tcl.quantize(out, 65535.0).numpy().T.reshape(frame.shape[:-1] + (3,))
        lsb[name] = _max_lsb(ref[..., :3], q)
    assert lsb["jax"] <= 1 < lsb["port"], lsb


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("size", [9, 17])
def test_packed64_plain_bit_equal_fused(size, compute_dtype):
    """packed64's plain twin is bit-equal to the f32-coordinate wrapper (B3
    with the glue in torch) on the same RGBA64 frame, as the kernels are on
    the card."""
    _, _, tops = _factors(size)
    frame = torch.from_numpy(_frame16(size + 1, 37, 53))
    kw = dict(size=size, offsets=(0, 1, 2), bits=16, compute_dtype=compute_dtype)
    a = tfused.lut3d_apply_lowrank_fused(frame, *tops, _SCALE, _OFFSET, **kw)
    b = tfused.lut3d_apply_lowrank_packed(frame, *tops, _SCALE, _OFFSET, **kw)
    assert a.dtype == b.dtype == torch.uint16 and torch.equal(a, b)
    px = frame.contiguous().view(torch.int64)
    params = torch.tensor(_SCALE + _OFFSET + [65535.0, 0.0])
    direct = tfused.lowrank_sample_packed64(px, params, *tops, size=size,
                                            compute_dtype=compute_dtype)
    assert torch.equal(direct.view(torch.uint16).reshape(frame.shape), b)


def test_b3_plain_matches_jax_at_full_basis():
    """At S = SB = 48 the hat's second row at x = 47 is row 48, past the
    factor layout: the plain chain reads it from a zero column, as the
    kernel reads the zero second half of its last bf16 pair or the zero
    word that ends an f32 row, and still matches the Pallas kernel."""
    rng = np.random.RandomState(48)
    ops = [rng.uniform(-1.0, 1.0, (16, tfused.SB)).astype(np.float32) for _ in range(3)]
    c = np.zeros((8, 16), np.float32)
    c[:3] = rng.uniform(0.0, 0.5, (3, 16))
    xyz = rng.uniform(0, 47, (3, 4096)).astype(np.float32)  # a multiple of its TPL
    xyz[:, :4] = [[0.0, 47.0, 46.0, 23.0]] * 3
    ref = np.asarray(jfused.lowrank_sample_pallas(jnp.asarray(xyz), *map(jnp.asarray, ops),
                                                  jnp.asarray(c), interpret=True))
    got = tfused.lowrank_sample_fused(torch.from_numpy(xyz), *map(torch.from_numpy, ops),
                                      torch.from_numpy(c)).numpy()
    assert float(np.abs(got - ref).max()) <= 1e-5


def test_shared_memory_check_follows_layout():
    """The kernels' shared-memory need (C as float4, the factors as 32-bit
    words: [K, 48] bf16 pairs, [K, 49] f32 entries) decides which ranks a
    wrapper takes."""
    assert tfused.smem_bytes(128, "bfloat16") == 16 * 128 + 3 * 128 * 48 * 4  # 75,776
    assert tfused.smem_bytes(128, "float32") == 16 * 128 + 3 * 128 * 49 * 4  # 77,312
    ops = [torch.zeros(392, tfused.SB) for _ in range(3)] + [torch.zeros(8, 392)]
    ref = torch.zeros(3, 8)
    assert tfused._check_factors("t", ref, *ops, "bfloat16") == 392
    with pytest.raises(ValueError, match="shared memory"):
        tfused._check_factors("t", ref, *ops, "float32")


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_dense_lowrank_matches_jax(compute_dtype):
    fit, _, _ = _factors(9)
    frame = np.random.RandomState(7).randint(0, 256, (16, 24, 4)).astype(np.uint8)
    kw = dict(size=9, offsets=(0, 1, 2), bits=8, compute_dtype=compute_dtype)
    ref = np.asarray(jlr.lut3d_apply_lowrank(
        jnp.asarray(frame), *(jnp.asarray(m) for m in (fit.U, fit.V, fit.W, fit.C)),
        jnp.ones(3), jnp.zeros(3), **kw))
    got = tlr.lut3d_apply_lowrank(
        torch.from_numpy(frame), *(torch.from_numpy(m) for m in (fit.U, fit.V, fit.W, fit.C)),
        [1.0] * 3, [0.0] * 3, **kw).numpy()
    assert _max_lsb(ref, got) <= 1


@pytest.mark.parametrize("fmt", ["RGBA", "RGBA64LE", "RGBA64BE"])
def test_element_approx_matches_jax(tmp_path, fmt):
    """TestColorLutApprox through both packages: RGBA takes B2, RGBA64LE/BE
    packed64 in the port (B3 with its glue as XLA ops in the JAX package);
    port vs JAX <= 1 LSB, alpha bit-equal, and within the approx tolerance
    (2 LSB node error + 1 LSB rounding) of the exact grade."""
    loc = _write(tmp_path, _smooth_grade_lut_text())
    rng = np.random.RandomState(3)
    if fmt == "RGBA":
        frame = rng.randint(0, 256, (24, 32, 4)).astype(np.uint8)
        counter, lsb = "packed_launches", 1
    else:
        frame = rng.randint(0, 65536, (24, 32, 4)).astype(np.uint16)
        counter, lsb = "packed64_launches", 257
    ref, jelem = _run(JPKG, frame, loc, fmt=fmt, precision="approx")
    before = getattr(tfused, counter)
    got, telem = _run(TPKG, frame, loc, fmt=fmt, precision="approx")
    assert getattr(tfused, counter) == before
    assert jelem._cp is not None and telem._cp is not None
    for a, b in zip(jelem._cp, telem._cp):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert got.dtype == frame.dtype
    assert _max_lsb(ref, got) <= 1
    assert np.array_equal(got[..., 3], frame[..., 3])
    exact, _ = _run(TPKG, frame, loc, fmt=fmt)
    assert _max_lsb(got[..., :3], exact[..., :3]) <= 3 * lsb


def test_approx_falls_back_when_unfittable(tmp_path):
    """A noise LUT does not factor within 2 LSB at rank <= 128: approx runs
    the exact path, in both packages."""
    vals = np.random.RandomState(0).uniform(0, 1, (9**3, 3))
    loc = _write(tmp_path, _lut_text(vals, 9))
    frame = np.random.RandomState(3).randint(0, 256, (8, 8, 4)).astype(np.uint8)
    exact, _ = _run(TPKG, frame, loc)
    got, telem = _run(TPKG, frame, loc, precision="approx")
    ref, jelem = _run(JPKG, frame, loc, precision="approx")
    assert telem._cp is None and jelem._cp is None
    assert np.array_equal(got, exact)
    assert _max_lsb(ref, got) <= 1


def test_approx_falls_back_for_1d(tmp_path):
    loc = _write(tmp_path, "LUT_1D_SIZE 2\n1.0 1.0 1.0\n0.0 0.0 0.0\n")
    frame = np.array([[[255, 0, 100, 77]]], np.uint8)
    got, telem = _run(TPKG, frame, loc, precision="approx")
    assert telem._cp is None and got[0, 0].tolist() == [0, 255, 155, 77]


# --- B5: lut3d_apply_mxu -------------------------------------------------------


@pytest.mark.parametrize("size", [9, 17, 33])
def test_b5_plain_matches_jax_kernel(size):
    table = _grade_table(size, boost=1.3, tint=0.05)
    t2 = jmxu.pack_matmul_table(table, size)
    frame = np.random.RandomState(size).randint(0, 256, (48, 64, 4)).astype(np.uint8)
    frame[0, :3, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 128]]  # the LUT's edges
    kw = dict(size=size, offsets=(0, 1, 2), bits=8)
    # the Pallas kernel's lane sums come out f64 under jax_enable_x64 (set by
    # tests/conftest.py), which its interpreter refuses: run it in 32 bits
    with jax.enable_x64(False):
        ref = np.asarray(jmxu.lut3d_apply_mxu(
            jnp.asarray(frame), jnp.asarray(t2).astype(jnp.bfloat16),
            jnp.asarray(_SCALE), jnp.asarray(_OFFSET), interpret=True, **kw))
    before = tmxu.launches
    got = tmxu.lut3d_apply_mxu(torch.from_numpy(frame), torch.from_numpy(t2).to(torch.bfloat16),
                               _SCALE, _OFFSET, **kw)
    assert tmxu.launches == before
    got = got.numpy()
    assert _max_lsb(ref, got) <= 1 and np.array_equal(got[..., 3], frame[..., 3])
    # and within 1 LSB of the exact f32 grade (bf16 table and weights)
    exact = tcl.lut3d_apply(torch.from_numpy(frame), torch.from_numpy(table), _SCALE, _OFFSET,
                            **kw).numpy()
    assert _max_lsb(exact, got) <= 1


def test_b5_rejects_large_lut():
    with pytest.raises(ValueError, match="size <= 42"):
        tmxu.pack_matmul_table(np.zeros((43**3, 3), np.float32), 43)


def _mxu_glue(frame, t2, scale, offset, *, size, offsets, bits):
    """lut3d_apply_mxu's TPU-signature route built from public pieces: grid
    coordinates in torch, lut3d_positions_mxu, quantize and restack."""
    maxval = float(2**bits - 1)
    fi = frame.to(torch.int32)
    pos = [tcl.grid_coord(fi, off, scale[c], offset[c], size, maxval).reshape(-1)
           for c, off in enumerate(offsets)]
    rgb = tmxu.lut3d_positions_mxu(*pos, t2, size=size)
    return restack(fi, offsets, [tcl.quantize(c.reshape(fi.shape[:-1]), maxval) for c in rgb],
                   frame.dtype)


def _jax_mxu(frame, t2, scale, offset, **kw):
    # the Pallas kernel's lane sums come out f64 under jax_enable_x64, which
    # its interpreter refuses: run it in 32 bits (test_b5_plain_matches_jax_kernel)
    with jax.enable_x64(False):
        return np.asarray(jmxu.lut3d_apply_mxu(
            jnp.asarray(frame), jnp.asarray(t2).astype(jnp.bfloat16),
            jnp.asarray(scale, jnp.float32), jnp.asarray(offset, jnp.float32), interpret=True,
            **kw))


@pytest.mark.parametrize("bits,size,domain", [
    (8, 9, "graded"), (8, 17, "graded"), (8, 33, "graded"), (16, 17, "identity"),
    (16, 17, "graded")])
def test_b5_packed_plain_matches_jax_kernel(bits, size, domain):
    """The packed entries' plain twin, through lut3d_apply_mxu's packed
    route on the CPU, against the JAX lut3d_apply_mxu (Pallas in interpret
    mode, glue as XLA ops): <= 1 LSB of the frame's type, alpha equal,
    except RGBA64 with a domain other than [0, 1], where XLA's fma grid
    coordinates meet B5's bf16 weights (128 u16 LSB seen at S = 17): there
    the gate is one u8 LSB (257), as for packed64
    (test_b5_packed64_jax_gap_is_its_coordinates shows the cause)."""
    table = _grade_table(size, boost=1.3, tint=0.05)
    t2 = jmxu.pack_matmul_table(table, size)
    if bits == 8:
        frame = np.random.RandomState(size).randint(0, 256, (48, 64, 4)).astype(np.uint8)
        frame[0, :3, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 128]]  # the LUT's edges
    else:
        frame = _frame16(size)
    scale, offset = (_SCALE, _OFFSET) if domain == "graded" else ([1.0] * 3, [0.0] * 3)
    kw = dict(size=size, offsets=(0, 1, 2), bits=bits)
    ref = _jax_mxu(frame, t2, scale, offset, **kw)
    before = (tmxu.launches, tmxu.packed_launches)
    got = tmxu.lut3d_apply_mxu(torch.from_numpy(frame), torch.from_numpy(t2).to(torch.bfloat16),
                               scale, offset, **kw)
    assert (tmxu.launches, tmxu.packed_launches) == before  # plain on the CPU
    assert got.dtype == torch.from_numpy(frame).dtype and tuple(got.shape) == frame.shape
    got = got.numpy()
    tol = 257 if (bits, domain) == (16, "graded") else 1
    assert _max_lsb(ref, got) <= tol and np.array_equal(got[..., 3], frame[..., 3])


@pytest.mark.parametrize("size", [17, 33])
def test_b5_packed64_jax_gap_is_its_coordinates(size):
    """Why the RGBA64 graded case above needs its wider gate: the JAX
    element's grid coordinates on the CPU are fma(v, f32(scale *
    f32(1/maxval)), offset) (test_packed64_jax_gap_is_its_coordinates).  B5's
    plain chain at JAX's coordinates matches the JAX output within 1 u16
    LSB; at the port's own it does not."""
    table = _grade_table(size, boost=1.3, tint=0.05)
    t2 = jmxu.pack_matmul_table(table, size)
    frame = _frame16(size)
    ref = _jax_mxu(frame, t2, _SCALE, _OFFSET, size=size, offsets=(0, 1, 2), bits=16)
    v = frame[..., :3].reshape(-1, 3).astype(np.float32)
    scale, offset = np.float32(_SCALE), np.float32(_OFFSET)
    inv = np.float32(1.0) / np.float32(65535.0)
    coords = {"jax": (v.astype(np.float64) * (scale * inv).astype(np.float64)
                      + offset.astype(np.float64)).astype(np.float32),
              "port": v * inv * scale + offset}
    t2 = torch.from_numpy(t2).to(torch.bfloat16)
    lsb = {}
    for name, t in coords.items():
        pos = [torch.from_numpy(np.ascontiguousarray(np.clip(t[:, c], 0.0, 1.0)
                                                     * np.float32(size - 1)))
               for c in range(3)]
        out = tmxu.lut3d_positions_mxu_plain(*pos, t2, size=size)
        q = torch.stack([tcl.quantize(o, 65535.0) for o in out], -1).numpy()
        lsb[name] = _max_lsb(ref[..., :3], q.reshape(frame.shape[:-1] + (3,)))
    assert lsb["jax"] <= 1 < lsb["port"], lsb


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("size", [2, 9, 33])
def test_b5_packed_route_bit_equal_glue(size, bits):
    """On the same frame the packed entries (plain twins here) equal the
    TPU-signature route with its glue in torch, bit for bit, codes 0 and
    max included; lut3d_apply_mxu's packed route is the direct call."""
    rng = np.random.RandomState(size + bits)
    table = rng.uniform(0, 1, (size**3, 3)).astype(np.float32)
    t2 = torch.from_numpy(tmxu.pack_matmul_table(table, size)).to(torch.bfloat16)
    if bits == 8:
        frame = torch.from_numpy(rng.randint(0, 256, (37, 53, 4)).astype(np.uint8))
        entry, word = tmxu.lut3d_sample_mxu_packed, torch.int32
    else:
        frame = torch.from_numpy(_frame16(size, 37, 53))
        entry, word = tmxu.lut3d_sample_mxu_packed64, torch.int64
    top = 2**bits - 1
    frame[1, :3, :3] = torch.tensor([[0, 0, 0], [top, top, top], [top, 0, top]])
    kw = dict(size=size, offsets=(0, 1, 2), bits=bits)
    glue = _mxu_glue(frame, t2, _SCALE, _OFFSET, **kw)
    got = tmxu.lut3d_apply_mxu(frame, t2, _SCALE, _OFFSET, **kw)
    assert got.dtype == frame.dtype and torch.equal(got, glue)
    params = torch.tensor(_SCALE + _OFFSET + [float(top), 0.0])
    direct = entry(frame.view(word), params, t2, size=size)
    assert torch.equal(direct.view(frame.dtype).reshape(frame.shape), glue)


@pytest.mark.parametrize("size", [2, 5, 33])
def test_b5_cells_are_a_gather_of_t2(size):
    """pack_cells, the kernel's table of 32-byte cells, against a gather of
    the LUT (T2's entries): cell (y, z, x) holds, per channel, (z, x),
    (z, x1), (z1, x), (z1, x1) of row y, clamped at S-1, then 4 zeros."""
    table = np.random.RandomState(size).uniform(0, 1, (size**3, 3)).astype(np.float32)
    t2 = torch.from_numpy(jmxu.pack_matmul_table(table, size)).to(torch.bfloat16)
    cells = tmxu.pack_cells(t2, size)
    assert cells.dtype == torch.bfloat16 and tuple(cells.shape) == (size,) * 3 + (tmxu.CELL,)
    lut = torch.from_numpy(table.reshape(size, size, size, 3)).to(torch.bfloat16).float().numpy()
    ar = np.arange(size)
    nxt = np.minimum(ar + 1, size - 1)
    Y, Z, X = np.meshgrid(ar, ar, ar, indexing="ij")
    want = np.zeros((size, size, size, 16), np.float32)
    for c in range(3):
        for k, (zz, xx) in enumerate(((Z, X), (Z, nxt[X]), (nxt[Z], X), (nxt[Z], nxt[X]))):
            want[..., 4 * c + k] = lut[zz, Y, xx, c]  # lut is [z, y, x, c]
    got = cells.float().numpy()
    assert np.array_equal(got, want)
    # the clamped edges: at x = S-1 lane x1 is lane x, at z = S-1 row z1 is row z
    for c in range(3):
        assert np.array_equal(got[:, :, -1, 4 * c + 1], got[:, :, -1, 4 * c])
        assert np.array_equal(got[:, -1, :, 4 * c + 2], got[:, -1, :, 4 * c])
    assert not got[..., 12:].any()


@pytest.mark.parametrize("case,route", [
    ("rgba", "packed"), ("rgba64", "packed64"), ("bgra", "positions"),
    ("argb", "positions"), ("rgb", "positions"), ("strided", "positions"),
    ("rgba64 at 8 bits", "positions")])
def test_b5_route_by_layout(monkeypatch, case, route):
    """lut3d_apply_mxu sends contiguous RGBA u8 / RGBA64 u16 frames with
    offsets (0, 1, 2) to the packed entries and every other layout through
    lut3d_positions_mxu; both routes give the glue's frame."""
    rng = np.random.RandomState(0)
    u8 = torch.from_numpy(rng.randint(0, 256, (6, 10, 4)).astype(np.uint8))
    u16 = torch.from_numpy(_frame16(1, 6, 10))
    frame, offsets, bits = {
        "rgba": (u8, (0, 1, 2), 8), "rgba64": (u16, (0, 1, 2), 16),
        "bgra": (u8, (2, 1, 0), 8), "argb": (u8, (1, 2, 3), 8),
        "rgb": (u8[..., :3].contiguous(), (0, 1, 2), 8),
        "strided": (u8[:, ::2], (0, 1, 2), 8), "rgba64 at 8 bits": (u16, (0, 1, 2), 8)}[case]
    t2 = torch.from_numpy(tmxu.pack_matmul_table(_grade_table(9), 9)).to(torch.bfloat16)
    calls = []
    for name in ("lut3d_sample_mxu_packed", "lut3d_sample_mxu_packed64", "lut3d_positions_mxu"):
        fn = getattr(tmxu, name)
        monkeypatch.setattr(tmxu, name, lambda *a, _fn=fn, _name=name, **k:
                            calls.append(_name) or _fn(*a, **k))
    kw = dict(size=9, offsets=offsets, bits=bits)
    got = tmxu.lut3d_apply_mxu(frame, t2, _SCALE, _OFFSET, **kw)
    want = {"packed": "lut3d_sample_mxu_packed", "packed64": "lut3d_sample_mxu_packed64",
            "positions": "lut3d_positions_mxu"}[route]
    assert calls == [want]
    calls.clear()
    assert torch.equal(got, _mxu_glue(frame, t2, _SCALE, _OFFSET, **kw))


def test_b5_wrappers_reject_other_devices():
    """The packed entries, like the TPU signature, take the plain version
    only for CPU tensors and raise on any other non-CUDA device."""
    t2 = torch.empty(128, 128, dtype=torch.bfloat16, device="meta")
    params = torch.empty(8, device="meta")
    for entry, word in ((tmxu.lut3d_sample_mxu_packed, torch.int32),
                        (tmxu.lut3d_sample_mxu_packed64, torch.int64)):
        with pytest.raises(ValueError, match="unsupported device"):
            entry(torch.empty(8, dtype=word, device="meta"), params, t2, size=9)
    before = (tmxu.launches, tmxu.packed_launches)
    for dtype, offsets, bits in ((torch.uint8, (0, 1, 2), 8), (torch.uint16, (0, 1, 2), 16),
                                 (torch.uint8, (2, 1, 0), 8)):
        with pytest.raises(ValueError, match="unsupported device"):
            tmxu.lut3d_apply_mxu(torch.empty(2, 3, 4, dtype=dtype, device="meta"), t2, _SCALE,
                                 _OFFSET, size=9, offsets=offsets, bits=bits)
    assert (tmxu.launches, tmxu.packed_launches) == before


def test_wrappers_reject_other_devices():
    """Only CPU tensors take the plain versions; any other non-CUDA device
    raises instead of falling back."""
    _, _, tops = _factors(9)
    meta = [t.to("meta") for t in tops]
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.lowrank_sample_fused(torch.empty(3, 8, device="meta"), *meta)
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.lowrank_sample_packed(torch.empty(8, dtype=torch.int32, device="meta"),
                                     torch.empty(8, device="meta"), *meta, size=9)
    p = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmxu.lut3d_positions_mxu(p, p, p, torch.empty(128, 128, dtype=torch.bfloat16,
                                                      device="meta"), size=9)
    with pytest.raises(ValueError, match="RGBA uint8"):
        tfused.lut3d_apply_lowrank_packed(torch.zeros(2, 2, 3, dtype=torch.uint8), *tops,
                                          _SCALE, _OFFSET, size=9, offsets=(0, 1, 2), bits=8)
    with pytest.raises(ValueError, match="unsupported device"):
        tfused.lowrank_sample_packed64(torch.empty(8, dtype=torch.int64, device="meta"),
                                       torch.empty(8, device="meta"), *meta, size=9)
    with pytest.raises(ValueError, match="RGBA64 uint16"):
        tfused.lut3d_apply_lowrank_packed(torch.zeros(2, 2, 4, dtype=torch.uint8), *tops,
                                          _SCALE, _OFFSET, size=9, offsets=(0, 1, 2), bits=16)
