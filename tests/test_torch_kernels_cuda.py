"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests are marked `cuda` and skip
where there is no CUDA device.  This file imports nothing of JAX, so it also
runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_kernels_cuda.py

Tolerances of B1 (yolox_c3, compact operands): f32 max abs error <= 1e-4
of the output's scale (the kernel and the plain version sum the same f32
products in another order); bf16 |ref - got| / (|ref| + 0.1) < 0.05, the gate of
tests/test_yolox_c3_pallas.py (the two round to bf16 at the same points,
but a 1-ulp difference upstream can flip a later rounding).  B2-B5: below.
"""
import numpy as np
import pytest
import torch

from gst_plugins_rs_tpu_torch.ops import colorlut_lowrank_fused as lowrank
from gst_plugins_rs_tpu_torch.ops import colorlut_mxu, hsv_planes, yolox_c3
from gst_plugins_rs_tpu_torch.ops.colorlut import grid_coord, quantize
from port_test_loader import load_test_module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(seed, B, H, W, C4, Ch, n, dtype, dev):
    """y [B,H,W,C4] in the s2d layout and B1's compact operands for the s2d
    widths C4, Ch: C = C4/4 channels in and out, h = Ch/4 hidden."""
    rng = np.random.RandomState(seed)
    C, h = C4 // 4, Ch // 4

    def t(shape, scale, dt):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dev, dt)

    ops = dict(
        W1=t((C, h), C ** -0.5, dtype), b1=t((1, h), 0.1, torch.float32),
        W2=t((C, h), C ** -0.5, dtype), b2=t((1, h), 0.1, torch.float32),
        Wa=t((n, h, h), h ** -0.5, dtype), ba=t((n, 1, h), 0.1, torch.float32),
        Wb=t((9 * n, h, h), (9 * h) ** -0.5, dtype), bb=t((n, 1, h), 0.1, torch.float32),
        W3=t((2 * h, C), (2 * h) ** -0.5, dtype), b3=t((1, C), 0.1, torch.float32),
    )
    return t((B, H, W, C4), 1.0, dtype), ops


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C4,Ch,n", [
    (2, 80, 80, 192, 96, 1),   # YOLOX-tiny dark2 at 640
    (2, 10, 6, 64, 32, 2),     # ragged tiles, two bottlenecks, h = 8 (a k8 tail alone)
    (1, 13, 11, 256, 128, 3),  # three bottlenecks: a smaller tile where the halo grows
])
def test_c3_kernel_matches_plain(cuda, dtype, B, H, W, C4, Ch, n):
    y, ops = _operands(B * 100 + n, B, H, W, C4, Ch, n, dtype, cuda)
    before = yolox_c3.launches
    got = yolox_c3.c3_s2d_fused_compact(y, **ops, width=W, n=n)
    torch.cuda.synchronize()
    assert yolox_c3.launches == before + 1
    ref = yolox_c3.c3_s2d_fused_plain(y, **ops, width=W, n=n).float()
    assert got.shape == y.shape and got.dtype == y.dtype
    got = got.float()
    assert torch.isfinite(got).all()
    if dtype == torch.float32:
        err = float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))
        assert err <= 1e-4, err
    else:
        rel = float(((got - ref).abs() / (ref.abs() + 0.1)).max())
        assert rel < 0.05, rel


@pytest.mark.cuda
def test_c3_kernel_rejects_bad_operands(cuda):
    y, ops = _operands(0, 1, 8, 8, 64, 32, 1, torch.float32, cuda)
    before = yolox_c3.launches
    with pytest.raises(TypeError):
        yolox_c3.c3_s2d_fused_compact(y, **{**ops, "W1": ops["W1"].double()}, width=8, n=1)
    with pytest.raises(ValueError):
        yolox_c3.c3_s2d_fused_compact(y.transpose(1, 2), **ops, width=8, n=1)
    # normal-domain widths the kernel does not take: C = 12, then h = 4
    y12, ops12 = _operands(0, 1, 8, 8, 48, 32, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        yolox_c3.c3_s2d_fused_compact(y12, **ops12, width=8, n=1)
    y4, ops4 = _operands(0, 1, 8, 8, 64, 16, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        yolox_c3.c3_s2d_fused_compact(y4, **ops4, width=8, n=1)
    # the TPU kernel's dense operands must have the s2d structure
    dense = {k: torch.randn(*v.shape, device=cuda).to(v.dtype) for k, v in
             yolox_c3._s2d_from_compact(**ops, n=1).items()}
    with pytest.raises(ValueError, match="s2d form"):
        yolox_c3.c3_s2d_fused(y, **dense, width=8, n=1)
    assert yolox_c3.launches == before


@pytest.mark.cuda
def test_c3_dense_entry_matches_compact(cuda):
    """The TPU-signature entry reads the compact operands out of the dense
    ones and launches the same kernel."""
    y, ops = _operands(5, 1, 12, 10, 64, 32, 1, torch.float32, cuda)
    dense = yolox_c3._s2d_from_compact(**ops, n=1)
    got = yolox_c3.c3_s2d_fused(y, **dense, width=10, n=1)
    ref = yolox_c3.c3_s2d_fused_compact(y, **ops, width=10, n=1)
    assert torch.equal(got, ref)


# --- kernels B2-B5 of the per-pixel effects --------------------------------
#
# Tolerances: the kernels are built with -fmad=false and round every product
# and sum where their plain versions do, so they are expected to agree bit
# for bit; the gates are those of chip_smoke.py: B4 planes within 1e-5 and
# 1 LSB after quantization, the others bit-equal.  B2, B3 and packed64
# (B3's chain on RGBA64 pixels) share one per-pixel chain, and so do B5's
# TPU signature and its packed entries: each group is held to its plain
# versions and to itself bit for bit.

def _factors(S, K, seed, dev):
    """Synthetic CP factors in the kernel layout: ut/vt/wt [K,48] with rows
    >= S zero, c [8,K] with rows >= 3 zero, outputs mostly inside [0,1]."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(3):
        f = np.zeros((K, lowrank.SB), np.float32)
        f[:, :S] = rng.uniform(0.0, 1.0, (K, S))
        ops.append(f)
    c = np.zeros((8, K), np.float32)
    c[:3] = rng.uniform(0.0, 8.0 / K, (3, K))
    return [torch.from_numpy(a).to(dev) for a in ops + [c]]


def _quantized(t):
    return torch.round(torch.clamp(t, 0.0, 1.0) * 255.0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 33, 47])
@pytest.mark.parametrize("K", [16, 128])
def test_lowrank_kernels_match_plain(cuda, S, K):
    P = 100_003  # ragged: no multiple of a block
    ut, vt, wt, c = _factors(S, K, S * 1000 + K, cuda)
    gen = torch.Generator(device=cuda).manual_seed(S + K)
    xyz = torch.rand(3, P, generator=gen, device=cuda) * (S - 1)
    xyz[:, :3] = torch.tensor([0.0, S - 1.0, (S - 1) / 2.0], device=cuda)
    before = lowrank.fused_launches
    got = lowrank.lowrank_sample_fused(xyz, ut, vt, wt, c)
    torch.cuda.synchronize()
    assert lowrank.fused_launches == before + 1
    ref = lowrank.lowrank_sample_fused_plain(xyz, ut, vt, wt, c)
    assert got.shape == (3, P) and torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= 1e-5
    assert float((_quantized(got) - _quantized(ref)).abs().max()) <= 1

    px = torch.randint(-2**31, 2**31 - 1, (P,), generator=gen, device=cuda, dtype=torch.int32)
    params = torch.tensor([1.05, 1.0, 0.95, 0.01, 0.0, -0.02, 255.0, 0.0], device=cuda)
    before = lowrank.packed_launches
    got = lowrank.lowrank_sample_packed(px, params, ut, vt, wt, c, size=S)
    torch.cuda.synchronize()
    assert lowrank.packed_launches == before + 1
    ref = lowrank.lowrank_sample_packed_plain(px, params, ut, vt, wt, c, size=S)
    gb, rb = got.view(torch.uint8).reshape(P, 4), ref.view(torch.uint8).reshape(P, 4)
    assert int((gb.int() - rb.int()).abs().max()) <= 1
    assert torch.equal(gb[:, 3], px.view(torch.uint8).reshape(P, 4)[:, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 47])
def test_lowrank_packed_and_fused_bit_equal(cuda, S):
    ut, vt, wt, c = _factors(S, 32, S, cuda)
    gen = torch.Generator(device=cuda).manual_seed(S)
    frame = torch.randint(0, 256, (37, 531, 4), generator=gen, device=cuda, dtype=torch.uint8)
    kw = dict(size=S, offsets=(0, 1, 2), bits=8)
    scale, offset = [1.05, 1.0, 0.95], [0.01, 0.0, -0.02]
    a = lowrank.lut3d_apply_lowrank_fused(frame, ut, vt, wt, c, scale, offset, **kw)
    b = lowrank.lut3d_apply_lowrank_packed(frame, ut, vt, wt, c, scale, offset, **kw)
    assert a.device.type == "cuda" and torch.equal(a, b)
    frame16 = torch.randint(0, 65536, (9, 77, 4), generator=gen, device=cuda,
                            dtype=torch.int32).to(torch.uint16)
    out = lowrank.lut3d_apply_lowrank_fused(frame16, ut, vt, wt, c, scale, offset,
                                            size=S, offsets=(0, 1, 2), bits=16)
    assert out.dtype == torch.uint16 and torch.equal(out[..., 3].int(), frame16[..., 3].int())


def _lowrank_inputs(S, P, seed, dev):
    """Grid coordinates xyz [3,P] in [0,S-1] whose first columns are every
    grid node (0 and S-1 among them), and RGBA (int32) and RGBA64 (int64)
    bit patterns whose first pixels hold the codes 0 and maxval."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xyz = torch.rand(3, P, generator=gen, device=dev) * (S - 1)
    nodes = torch.arange(S, dtype=torch.float32, device=dev)
    xyz[:, :S] = nodes
    xyz[1, :S] = nodes.flip(0)
    words = []
    for lane, word in ((torch.uint8, torch.int32), (torch.uint16, torch.int64)):
        top = torch.iinfo(lane).max
        lanes = torch.randint(0, top + 1, (P, 4), generator=gen, device=dev, dtype=torch.int32)
        lanes[0, :3], lanes[1, :3] = 0, top
        lanes[2, :3] = torch.tensor([0, top, 0], device=dev)
        words.append(lanes.to(lane).view(word).reshape(P))
    return (xyz, *words)


def _params(maxval):
    return torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, maxval, 0.0], device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [1, 17, 64, 128])
@pytest.mark.parametrize("S", [9, 33, 48])
def test_lowrank_kernels_bit_equal_plain(cuda, S, K, compute_dtype):
    """B2, B3 and packed64 against their plain versions, bit for bit
    (-fmad=false, the same roundings and k ascending), at padded and
    unpadded ranks (K = 1, 17), with the edge coordinates and grid nodes.
    At S = 48 the hat's second row at x = 47 is row 48, past the factor
    layout: the kernels read the zero second half of the last bf16 pair or
    the zero word that ends an f32 row, as the plain version reads its zero
    column."""
    P = 100_003
    ops = _factors(S, K, S * 1000 + K, cuda)
    xyz, px, px64 = _lowrank_inputs(S, P, S + K, cuda)
    kw = dict(compute_dtype=compute_dtype)
    before = (lowrank.fused_launches, lowrank.packed_launches, lowrank.packed64_launches)
    got3 = lowrank.lowrank_sample_fused(xyz, *ops, **kw)
    got2 = lowrank.lowrank_sample_packed(px, _params(255.0), *ops, size=S, **kw)
    got64 = lowrank.lowrank_sample_packed64(px64, _params(65535.0), *ops, size=S, **kw)
    torch.cuda.synchronize()
    assert (lowrank.fused_launches, lowrank.packed_launches, lowrank.packed64_launches) == \
        tuple(n + 1 for n in before)
    assert torch.isfinite(got3).all()
    assert torch.equal(got3, lowrank.lowrank_sample_fused_plain(xyz, *ops, **kw))
    assert torch.equal(got2, lowrank.lowrank_sample_packed_plain(px, _params(255.0), *ops,
                                                                  size=S, **kw))
    assert torch.equal(got64, lowrank.lowrank_sample_packed_plain(
        px64, _params(65535.0), *ops, size=S, bits=16, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("K", [1, 17, 64, 128])
@pytest.mark.parametrize("S", [9, 33])
def test_lowrank_packed_entries_equal_quantized_b3(cuda, S, K, compute_dtype):
    """B2 and packed64 equal B3 on the same pixels, quantized at 255 and
    65535 and repacked with the input's alpha, bit for bit: one chain."""
    P = 100_003
    ops = _factors(S, K, S + K, cuda)
    _, px, px64 = _lowrank_inputs(S, P, S * K, cuda)
    kw = dict(compute_dtype=compute_dtype)
    for t, bits, sample in ((px, 8, lowrank.lowrank_sample_packed),
                            (px64, 16, lowrank.lowrank_sample_packed64)):
        maxval = float(2**bits - 1)
        lanes = t.view(torch.uint8 if bits == 8 else torch.uint16).view(P, 4).to(torch.int32)
        xyz = torch.stack([grid_coord(lanes, c, 1.0, 0.0, S, maxval) for c in range(3)])
        q = quantize(lowrank.lowrank_sample_fused(xyz.contiguous(), *ops, **kw), maxval)
        q = q.to(t.dtype)
        want = (q[0] | (q[1] << bits) | (q[2] << 2 * bits)
                | torch.bitwise_and(t, -(1 << 3 * bits)))
        got = sample(t, _params(maxval), *ops, size=S, **kw)
        assert torch.equal(got, want), bits
        assert torch.equal(_alpha(got, bits), _alpha(t, bits)), bits


def _alpha(t, bits):
    return torch.bitwise_right_shift(t, 3 * bits) & ((1 << bits) - 1)


@pytest.mark.cuda
def test_lowrank_packed64_rejects_bad_operands(cuda):
    ops = _factors(9, 16, 0, cuda)
    px64 = torch.zeros(64, dtype=torch.int64, device=cuda)
    p16 = _params(65535.0)
    before = (lowrank.fused_launches, lowrank.packed_launches, lowrank.packed64_launches)
    with pytest.raises(ValueError, match="int64"):
        lowrank.lowrank_sample_packed64(px64.int(), p16, *ops, size=9)
    with pytest.raises(ValueError, match="int64"):
        lowrank.lowrank_sample_packed64(torch.zeros(8, 2, dtype=torch.int64, device=cuda).t(),
                                        p16, *ops, size=9)
    with pytest.raises(ValueError, match="params"):
        lowrank.lowrank_sample_packed64(px64, p16[:6], *ops, size=9)
    with pytest.raises(ValueError, match="size"):
        lowrank.lowrank_sample_packed64(px64, p16, *ops, size=49)
    with pytest.raises(TypeError):
        lowrank.lowrank_sample_packed64(px64, p16, ops[0].double(), *ops[1:], size=9)
    with pytest.raises(ValueError, match="K >= 1"):
        lowrank.lowrank_sample_packed64(px64, p16, ops[0][:, :40].contiguous(), *ops[1:],
                                        size=9)
    big = _factors(9, 400, 0, cuda)  # factors of rank 400 exceed 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        lowrank.lowrank_sample_packed64(px64, p16, *big, size=9)
    with pytest.raises(ValueError, match="shared memory"):
        lowrank.lowrank_sample_fused(torch.zeros(3, 8, device=cuda), *big,
                                     compute_dtype="float32")
    assert before == (lowrank.fused_launches, lowrank.packed_launches,
                      lowrank.packed64_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(37, 301), (1080, 1920)])
def test_hsv_kernel_matches_plain(cuda, H, W):
    gen = torch.Generator(device=cuda).manual_seed(H)
    frame = torch.randint(0, 256, (H, W, 3), generator=gen, device=cuda, dtype=torch.uint8)
    planes = [frame[..., i].float() * float(np.float32(1.0) / np.float32(255.0))
              for i in range(3)]
    params = torch.tensor([123.0, 1.1, -0.05, 0.95, 0.02], device=cuda)
    before = hsv_planes.launches
    got = hsv_planes.hsv_filter_planes(*planes, params)
    torch.cuda.synchronize()
    assert hsv_planes.launches == before + 1
    ref = hsv_planes.hsv_filter_planes_plain(*planes, params)
    for g, r in zip(got, ref):
        assert g.shape == (H, W) and float((g - r).abs().max()) <= 1e-5
        q = lambda t: torch.clamp(t * 255.0, 0.0, 255.0).to(torch.uint8).int()  # noqa: E731
        assert int((q(g) - q(r)).abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 33, 42])
def test_mxu_kernel_matches_plain(cuda, S):
    rng = np.random.RandomState(S)
    t2 = torch.from_numpy(colorlut_mxu.pack_matmul_table(
        rng.uniform(0, 1, (S**3, 3)).astype(np.float32), S)).to(cuda, torch.bfloat16)
    P = 70_001
    gen = torch.Generator(device=cuda).manual_seed(S)
    pos = [torch.rand(P, generator=gen, device=cuda) * (S - 1) for _ in range(3)]
    for p in pos:
        p[:2] = torch.tensor([0.0, S - 1.0], device=cuda)
    before = colorlut_mxu.launches
    got = colorlut_mxu.lut3d_positions_mxu(*pos, t2, size=S)
    torch.cuda.synchronize()
    assert colorlut_mxu.launches == before + 1
    ref = colorlut_mxu.lut3d_positions_mxu_plain(*pos, t2, size=S)
    for g, r in zip(got, ref):
        assert g.shape == (P,) and torch.equal(g, r)


def _mxu_table(S, dev):
    rng = np.random.RandomState(S)
    return torch.from_numpy(colorlut_mxu.pack_matmul_table(
        rng.uniform(0, 1, (S**3, 3)).astype(np.float32), S)).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 33, 42])
def test_mxu_cells_kernel_matches_pack_cells(cuda, S):
    """The cell table B5 builds on the card in each call (through its C
    test hook) equals pack_cells, pad zeros included."""
    t2 = _mxu_table(S, cuda)
    cells = torch.full((S, S, S, colorlut_mxu.CELL), float("nan"), dtype=torch.bfloat16,
                       device=cuda)
    lib = colorlut_mxu._lib()
    err = lib.colorlut_mxu_cells(t2.data_ptr(), cells.data_ptr(), S,
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(cells.view(torch.int16), colorlut_mxu.pack_cells(t2, S).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("S", [2, 33, 42])
def test_mxu_packed_kernels_match_plain(cuda, S, bits):
    """B5's packed entries against their plain twin and against quantize
    and repack of lut3d_positions_mxu on the same pixels, bit for bit, at an
    odd P with the codes 0 and maxval."""
    P = 70_001
    t2 = _mxu_table(S, cuda)
    _, px, px64 = _lowrank_inputs(S, P, S + bits, cuda)
    t = px if bits == 8 else px64
    entry = (colorlut_mxu.lut3d_sample_mxu_packed if bits == 8
             else colorlut_mxu.lut3d_sample_mxu_packed64)
    maxval = float(2**bits - 1)
    params = torch.tensor([1.05, 1.0, 0.95, 0.01, 0.0, -0.02, maxval, 0.0], device=cuda)
    before = (colorlut_mxu.launches, colorlut_mxu.packed_launches)
    got = entry(t, params, t2, size=S)
    torch.cuda.synchronize()
    assert (colorlut_mxu.launches, colorlut_mxu.packed_launches) == (before[0], before[1] + 1)
    assert got.dtype == t.dtype and got.shape == (P,)
    assert torch.equal(got, colorlut_mxu.lut3d_sample_mxu_packed_plain(t, params, t2, size=S,
                                                                        bits=bits))
    lanes = t.view(torch.uint8 if bits == 8 else torch.uint16).view(P, 4).to(torch.int32)
    pos = [grid_coord(lanes, c, [1.05, 1.0, 0.95][c], [0.01, 0.0, -0.02][c], S, maxval)
           for c in range(3)]
    q = [quantize(o, maxval).to(t.dtype)
         for o in colorlut_mxu.lut3d_positions_mxu(*pos, t2, size=S)]
    want = q[0] | (q[1] << bits) | (q[2] << 2 * bits) | torch.bitwise_and(t, -(1 << 3 * bits))
    assert torch.equal(got, want)
    assert torch.equal(_alpha(got, bits), _alpha(t, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 16])
def test_mxu_apply_routes(cuda, bits):
    """lut3d_apply_mxu on the card: an RGBA / RGBA64 frame takes one packed
    launch, BGRA offsets one launch of the TPU signature, and the two routes
    give the same frame on the same pixels."""
    S = 33
    t2 = _mxu_table(S, cuda)
    gen = torch.Generator(device=cuda).manual_seed(bits)
    top = 2**bits - 1
    frame = torch.randint(0, top + 1, (37, 531, 4), generator=gen, device=cuda,
                          dtype=torch.int32).to(torch.uint8 if bits == 8 else torch.uint16)
    args = (t2, [1.05, 1.0, 0.95], [0.01, 0.0, -0.02])
    # PyTorch's CUDA backend lacks some uint16 kernels: permute and compare
    # the same bits as signed integers
    signed = torch.int8 if bits == 8 else torch.int16
    before = (colorlut_mxu.launches, colorlut_mxu.packed_launches)
    packed = colorlut_mxu.lut3d_apply_mxu(frame, *args, size=S, bits=bits)
    torch.cuda.synchronize()
    assert (colorlut_mxu.launches, colorlut_mxu.packed_launches) == (before[0], before[1] + 1)
    bgra = frame.view(signed)[..., [2, 1, 0, 3]].contiguous().view(frame.dtype)
    swapped = colorlut_mxu.lut3d_apply_mxu(bgra, *args, size=S, offsets=(2, 1, 0), bits=bits)
    torch.cuda.synchronize()
    assert (colorlut_mxu.launches, colorlut_mxu.packed_launches) == (before[0] + 1, before[1] + 1)
    assert packed.dtype == swapped.dtype == frame.dtype
    assert torch.equal(swapped.view(signed)[..., [2, 1, 0, 3]], packed.view(signed))


@pytest.mark.cuda
def test_mxu_packed_rejects_bad_operands(cuda):
    t2 = _mxu_table(9, cuda)
    px = torch.zeros(64, dtype=torch.int32, device=cuda)
    p8 = _params(255.0)
    before = (colorlut_mxu.launches, colorlut_mxu.packed_launches)
    with pytest.raises(ValueError, match="int32"):
        colorlut_mxu.lut3d_sample_mxu_packed(px.long(), p8, t2, size=9)
    with pytest.raises(ValueError, match="int64"):
        colorlut_mxu.lut3d_sample_mxu_packed64(px, p8, t2, size=9)
    with pytest.raises(ValueError, match="int32"):
        colorlut_mxu.lut3d_sample_mxu_packed(px.view(8, 8).t(), p8, t2, size=9)
    with pytest.raises(ValueError, match="params"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8[:6], t2, size=9)
    with pytest.raises(ValueError, match="params"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8.cpu(), t2, size=9)
    with pytest.raises(ValueError, match="size"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8, t2, size=43)
    with pytest.raises(ValueError, match="t2"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8, t2.float(), size=9)
    with pytest.raises(ValueError, match="t2"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8, t2[:64], size=9)
    with pytest.raises(ValueError, match="t2"):
        colorlut_mxu.lut3d_sample_mxu_packed(px, p8, t2.cpu(), size=9)
    assert before == (colorlut_mxu.launches, colorlut_mxu.packed_launches)


@pytest.mark.cuda
def test_effect_kernels_reject_bad_operands(cuda):
    ut, vt, wt, c = _factors(9, 16, 0, cuda)
    before = (lowrank.fused_launches, lowrank.packed_launches, hsv_planes.launches,
              colorlut_mxu.launches)
    with pytest.raises(ValueError):
        lowrank.lowrank_sample_fused(torch.zeros(3, 8, device=cuda).t(), ut, vt, wt, c)
    with pytest.raises(TypeError):
        lowrank.lowrank_sample_fused(torch.zeros(3, 8, device=cuda), ut.double(), vt, wt, c)
    with pytest.raises(ValueError):
        lowrank.lowrank_sample_packed(torch.zeros(8, device=cuda), torch.zeros(8, device=cuda),
                                      ut, vt, wt, c, size=9)
    r = torch.zeros(4, 4, device=cuda)
    with pytest.raises(ValueError):
        hsv_planes.hsv_filter_planes(r, r, r.double(), torch.zeros(5, device=cuda))
    with pytest.raises(ValueError):
        colorlut_mxu.lut3d_positions_mxu(r[0], r[0], r[0],
                                         torch.zeros(64, 128, device=cuda), size=9)
    assert before == (lowrank.fused_launches, lowrank.packed_launches, hsv_planes.launches,
                      colorlut_mxu.launches)


# The limiter (csrc/loudnorm_limiter.cu) against its plain version, bit for
# bit in f64 and f32: the kernel is built with -fmad=false and evaluates the
# same roundings, explicit FMAs included (ops/loudnorm_limiter.py).  It
# detects the peaks itself; the plain version takes precompute_peaks' flags.


def _limiter_window(seed, dtype, dev):
    """[40320, 2] 192 kHz window: quiet noise with bursts and close peak pairs
    (restarts and steepened attacks), the limiter's window length."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.3, 0.3, (40320, 2))
    for _ in range(12):
        p = rng.randint(0, 40270)
        x[p:p + rng.randint(1, 40), rng.randint(0, 2)] *= rng.uniform(0.7, 1.5) / 0.3
    for p, gap, a, b in ((3000, 1700, 0.95, 1.0), (9000, 1500, 0.9, 0.95)):
        x[p, 0], x[p + gap, 1] = a, b
    return torch.from_numpy(x).to(dev, dtype).contiguous()


def _limiter_kind(kind, dtype, dev):
    """[40320, 2] windows of the walk's hard cases: "clipped" (a +-1.2
    square wave, every sample a peak), "none" (no peak: future false from
    n = 0), "late" (one peak at n = 15,000), "edges" (peaks at n = 0 and
    n = FRAME - 1)."""
    x = np.random.RandomState(7).uniform(-0.3, 0.3, (40320, 2))
    L, F = 1920, 19200
    if kind == "clipped":
        x[:] = np.where((np.arange(40320) // 218) % 2 == 0, 1.2, -1.2)[:, None]
    elif kind == "late":
        x[L + 15000, 0] = 0.95
    elif kind == "edges":
        x[L, 0], x[L + 9000, 1], x[L + F - 1, 1] = 0.9, 1.1, 0.95
    return torch.from_numpy(x).to(dev, dtype).contiguous()


def _plain(lim, w, ci, cf, tp):
    """The plain twin on the CPU copies, after precompute_peaks."""
    w, ci, cf = w.cpu(), ci.cpu(), cf.cpu()
    run = lim.limiter_frame_plain if w.dim() == 2 else lim.limiter_frames_plain
    return run(w, ci, cf, tp, *lim.precompute_peaks(w, tp))


def _assert_limiter_equal(lim, w, ci, cf, tp, stats=None):
    before = lim.launches
    run = lim.limiter_frame if w.dim() == 2 else lim.limiter_frames
    out, ni, nf = run(w, ci, cf, tp, walk_stats=stats)
    torch.cuda.synchronize()
    assert lim.launches == before + 1
    ref, ri, rf = _plain(lim, w, ci, cf, tp)
    assert out.device.type == "cuda" and ni.device.type == "cuda"
    assert torch.equal(out.cpu(), ref)
    assert torch.equal(ni.cpu(), ri) and torch.equal(nf.cpu(), rf)
    return out


LIMITER_CARRIES = [(0, 0, -1, 0.0, 0.0), (1, 500, -1, 0.9, 0.6), (2, 0, 100, 0.7, 0.5),
                   (3, 3000, -1, 0.5, 1.0)]
# every state at the envelope and sustain counts where a gap turns
LIMITER_BOUNDARY = [(st, env, sus, 0.8, 0.6) for st in range(4)
                    for env in (1919, 1920, 19199, 19200) for sus in (0, 1, -1)]


def _tp(dtype):
    return float((np.float64 if dtype == torch.float64 else np.float32)(10 ** (-2 / 20)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("carry", LIMITER_CARRIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_limiter_kernel_bit_equal_plain(cuda, seed, carry, dtype):
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = _limiter_window(seed, dtype, cuda)
    ci = torch.tensor(carry[:3], dtype=torch.int32, device=cuda)
    cf = torch.tensor(carry[3:], dtype=dtype, device=cuda)
    stats = torch.zeros(3, dtype=torch.int32, device=cuda)
    _assert_limiter_equal(lim, w, ci, cf, _tp(dtype), stats)
    pk = lim.precompute_peaks(w, _tp(dtype))[0]
    assert int(stats[0]) == int(pk.sum()) and 1 <= int(stats[1]) <= lim.FRAME
    assert 1 <= int(stats[2]) <= 2 * int(stats[0])  # at most a ballot and a step a peak


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_limiter_kernel_idle_frame(cuda, dtype):
    """State Out and no peak: the kernel copies the clamped frame and keeps
    the carry, with no host branch."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = torch.from_numpy(np.random.RandomState(4).uniform(-0.5, 0.5, (40320, 2))).to(cuda, dtype)
    ci = torch.tensor([0, 7, -1], dtype=torch.int32, device=cuda)
    cf = torch.tensor([0.25, 0.5], dtype=dtype, device=cuda)
    stats = torch.full((3,), -1, dtype=torch.int32, device=cuda)
    out, ni, nf = lim.limiter_frame(w, ci, cf, 0.79, walk_stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(out, w[:lim.FRAME]) and torch.equal(ni, ci) and torch.equal(nf, cf)
    assert stats.tolist() == [0, 0, 0]


@pytest.mark.cuda
def test_limiter_kernel_rejects_bad_operands(cuda):
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = torch.zeros(40320, 2, dtype=torch.float64, device=cuda)
    ci = torch.tensor([0, 0, -1], dtype=torch.int32, device=cuda)
    cf = torch.zeros(2, dtype=torch.float64, device=cuda)
    before = lim.launches
    with pytest.raises(ValueError):
        lim.limiter_frame(w[:1000], ci, cf, 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frame(w, ci.long(), cf, 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frame(w, ci, cf.float(), 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frame(w, ci, cf, 0.79, walk_stats=torch.zeros(2, dtype=torch.int64,
                                                                  device=cuda))
    with pytest.raises(ValueError):
        lim.limiter_frame(w, ci.cpu(), cf, 0.79)
    assert lim.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("carry", LIMITER_CARRIES)
def test_limiter_kernel_clipped_frame(cuda, carry, dtype):
    """Every sample a peak (a clipped plateau): the inert runs are stepped
    over 32 peaks a ballot; from Out the kernel writes two segments (the
    attack, the sustain)."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = _limiter_kind("clipped", dtype, cuda)
    ci = torch.tensor(carry[:3], dtype=torch.int32, device=cuda)
    cf = torch.tensor(carry[3:], dtype=dtype, device=cuda)
    stats = torch.zeros(3, dtype=torch.int32, device=cuda)
    _assert_limiter_equal(lim, w, ci, cf, _tp(dtype), stats)
    assert int(stats[0]) == lim.FRAME and int(stats[2]) < lim.FRAME // 16
    if carry[0] == lim.ST_OUT:
        assert int(stats[1]) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("kind", ["none", "late", "edges"])
def test_limiter_kernel_boundary_carries(cuda, kind, dtype):
    """Every state at env 1,919, 1,920, 19,199, 19,200 and sus 0, 1, -1, on a
    frame with no peak, one late peak, and peaks at n = 0 and FRAME - 1."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = _limiter_kind(kind, dtype, cuda)
    for carry in LIMITER_BOUNDARY:
        ci = torch.tensor(carry[:3], dtype=torch.int32, device=cuda)
        cf = torch.tensor(carry[3:], dtype=dtype, device=cuda)
        _assert_limiter_equal(lim, w, ci, cf, _tp(dtype))


@pytest.mark.cuda
def test_limiter_cuda_window_never_runs_the_plain_twin(cuda, monkeypatch):
    """On the card the wrappers launch the kernel, which finds the peaks
    itself: neither precompute_peaks nor a plain FSM runs."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm, loudnorm_limiter as lim

    def refuse(*_a, **_k):
        raise AssertionError("a plain limiter function ran on a CUDA window")

    for name in ("precompute_peaks", "limiter_frame_plain", "limiter_frames_plain"):
        monkeypatch.setattr(lim, name, refuse)
    w = _limiter_window(0, torch.float64, cuda)
    ci = torch.tensor([0, 0, -1], dtype=torch.int32, device=cuda)
    cf = torch.zeros(2, dtype=torch.float64, device=cuda)
    before = lim.launches
    lim.limiter_frame(w, ci, cf, 0.79)
    lim.limiter_frames(w[None], ci[None], cf[None], 0.79)
    loudnorm.limit(w, ci, cf, 0.79)
    loudnorm.limit(w[None].expand(3, -1, -1), ci.expand(3, 3).contiguous(),
                   cf.expand(3, 2).contiguous(), 0.79)
    torch.cuda.synchronize()
    assert lim.launches == before + 4


# Kernel R1, the RNNoise GRU stack over a buffer's frames
# (csrc/rnnoise_gru.cu), against its plain version (a frame loop of the
# port's rnn_frame): the same products summed in another order and expf /
# tanhf against torch's sigmoid and tanh, so within R1_TOL, not bit-equal:
# gains and VAD (in [0, 1]) absolutely, the states relative to 1 + |ref|.
R1_TOL = 1e-5


def _r1_inputs(kind, K, C, seed, dev):
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    rng = np.random.RandomState(seed)
    w = rn.random_weights(seed) if kind == "random" else rn.default_weights()
    feats = torch.from_numpy(rng.randn(K, C, rn.NB_FEATURES).astype(np.float32) * 2.0).to(dev)
    sil = torch.from_numpy(rng.rand(K, C) < 0.2).to(dev)
    h = [torch.from_numpy(np.abs(rng.uniform(-0.5, 0.5, (C, n))).astype(np.float32)).to(dev)
         for n in (24, 48, 96)]
    return feats, sil, rn.RnnState(*h), rn.weights_to(w, dev)


def _r1_errors(got, ref):
    (g, v, s), (rg, rv, rs) = got, ref
    state = max(float(((a.cpu() - b) / (1 + b.abs())).abs().max()) for a, b in zip(s, rs))
    return float((g.cpu() - rg).abs().max()), float((v.cpu() - rv).abs().max()), state


def _r1_check(feats, sil, rnn, w):
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    before = gru.launches
    got = gru.rnn_frames(feats, sil, rnn, w)
    torch.cuda.synchronize()
    assert gru.launches == before + 1
    assert all(t.device.type == "cuda" for t in (got[0], got[1], *got[2]))
    ref = gru.rnn_frames_plain(feats.cpu(), sil.cpu(), type(rnn)(*(h.cpu() for h in rnn)),
                               {k: t.cpu() for k, t in w.items()})
    assert torch.equal(got[0].cpu()[sil.cpu()], torch.ones_like(ref[0][sil.cpu()]))
    assert torch.equal(got[1].cpu()[sil.cpu()], torch.zeros_like(ref[1][sil.cpu()]))
    errs = _r1_errors(got, ref)
    assert max(errs) <= R1_TOL, errs


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "packaged"])
@pytest.mark.parametrize("K,C", [(1, 1), (10, 2), (100, 2), (37, 5), (16, 16), (100, 16)])
def test_rnnoise_gru_kernel_matches_plain(cuda, kind, K, C):
    _r1_check(*_r1_inputs(kind, K, C, K + C, cuda))


@pytest.mark.cuda
def test_rnnoise_gru_kernel_on_front_end_features(cuda):
    """100 frames of a harmonic-plus-noise stereo signal through the port's
    batched front end on the card, then R1 against its plain version."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn

    rng = np.random.RandomState(11)
    t = np.arange(100 * rn.FRAME_SIZE) / 48000.0
    sig = np.stack([0.3 * np.sin(2 * np.pi * 150 * t) + 0.05 * rng.randn(t.size),
                    0.2 * np.sin(2 * np.pi * 233 * t) + 0.1 * rng.randn(t.size)])
    sig[:, 20 * rn.FRAME_SIZE:25 * rn.FRAME_SIZE] = 0.0  # silent frames
    frames = torch.from_numpy((sig * 32767).astype(np.float32).reshape(2, 100, -1)
                              .transpose(1, 0, 2).copy()).to(cuda)
    state = rn.denoise_init(2, cuda)
    _, feats, _, _, _, sil = rn.analysis_frames_batch(state, frames)
    assert bool(sil.any()) and not bool(sil.all())
    _r1_check(feats, sil, state.rnn, rn.weights_to(rn.default_weights(), cuda))


@pytest.mark.cuda
def test_rnnoise_gru_kernel_rejects_bad_operands(cuda):
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    feats, sil, rnn, w = _r1_inputs("random", 4, 2, 0, cuda)
    before = gru.launches
    with pytest.raises(ValueError):
        gru.rnn_frames(feats.double(), sil, rnn, w)
    with pytest.raises(ValueError):
        gru.rnn_frames(feats, sil.cpu(), rnn, w)
    with pytest.raises(ValueError):
        gru.rnn_frames(feats, sil, rnn, {**w, "vad_gru_u": w["vad_gru_u"].cpu()})
    with pytest.raises(ValueError):
        gru.rnn_frames(feats, sil, rnn._replace(vad_h=rnn.vad_h[:1]), w)
    assert gru.launches == before


def _r1_edge_inputs(case, kind, cuda):
    """The edge cases of chip_smoke.py phase 3d: one frame; a buffer whose
    frames are all silent; channels silent first that then speak (and one
    that stops); one channel; 33 channels (more blocks than the bank's)."""
    K, C = {"one_frame": (1, 2), "all_silent": (10, 2), "silent_then_speaking": (12, 3),
            "one_channel": (100, 1), "c33": (16, 33)}[case]
    feats, sil, rnn, w = _r1_inputs(kind, K, C, 40 + K + C, cuda)
    if case == "all_silent":
        sil = torch.ones_like(sil)
    elif case == "silent_then_speaking":
        sil = torch.zeros_like(sil)
        sil[:5, 0] = True
        sil[:1, 1] = True
        sil[7:, 2] = True
    return feats, sil, rnn, w


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "packaged"])
@pytest.mark.parametrize("case", ["one_frame", "all_silent", "silent_then_speaking",
                                  "one_channel", "c33"])
def test_rnnoise_gru_kernel_edge_cases(cuda, case, kind):
    """Each edge case against the plain version within R1_TOL, and against a
    float64 evaluation within twice the plain f32 version's own error
    (phase 3d''s rule).  Where the plain version is itself more than R1_TOL /
    2 from float64, two f32 versions as close to it as the plain one can
    disagree by more than R1_TOL (the 100 packaged frames of one channel:
    the kernel and the plain version sit on opposite sides of float64);
    there the float64 rule alone holds the kernel."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    feats, sil, rnn, w = _r1_edge_inputs(case, kind, cuda)
    before = gru.launches
    got = gru.rnn_frames(feats, sil, rnn, w)
    torch.cuda.synchronize()
    assert gru.launches == before + 1
    f, s = feats.cpu(), sil.cpu()
    h = rn.RnnState(*(x.cpu() for x in rnn))
    ref = gru.rnn_frames_plain(f, s, h, {k: t.cpu() for k, t in w.items()})
    ref64 = gru.rnn_frames_plain(f.double(), s, rn.RnnState(*(x.double() for x in h)),
                                 {k: t.cpu().double() for k, t in w.items()})
    assert torch.equal(got[0].cpu()[s], torch.ones_like(ref[0][s]))
    assert torch.equal(got[1].cpu()[s], torch.zeros_like(ref[1][s]))
    plain64 = max(_r1_errors(ref, ref64))
    assert max(_r1_errors(got, ref64)) <= max(R1_TOL, 2 * plain64)
    if plain64 <= R1_TOL / 2:
        errs = _r1_errors(got, ref)
        assert max(errs) <= R1_TOL, errs
    if case == "all_silent":  # the states pass through untouched
        assert all(torch.equal(a, b) for a, b in zip(got[2], rnn))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 16])
def test_rnnoise_gru_kernel_back_to_back_over_stale_memory(cuda, K):
    """8,000 calls at K frames x 16 channels enqueued back to back, each
    after tensors of R1's sizes were filled with large values and freed, so
    its scratch and outputs start as other values: every call equals the
    first (which matches the plain version).  Before the recurrence read
    the hoisted products by coherent loads after griddepcontrol.wait
    (ROADMAP C.2), 5 calls of 8,000 at K = 1 and 2 at K = 16 differed."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    feats, sil, rnn, w = _r1_inputs("packaged", K, 16, 70 + K, cuda)
    _r1_check(feats, sil, rnn, w)
    ref = gru.rnn_frames(feats, sil, rnn, w)
    sizes = [K * 16 * n for n in (504, 22, 1)] + [16 * n for n in (24, 48, 96)]
    diffs = []
    for i in range(8000):
        junk = [torch.full((n,), 1e4 * (1 + (i + j) % 7), device=cuda)
                for j, n in enumerate(sizes)]
        del junk
        got = gru.rnn_frames(feats, sil, rnn, w)
        diffs.append(torch.stack([(a - b).abs().max() for a, b in
                                  zip((got[0], got[1], *got[2]), (ref[0], ref[1], *ref[2]))]).max())
    diffs = torch.stack(diffs).cpu()
    assert float(diffs.max()) == 0.0, (diffs > 0).nonzero().flatten().tolist()[:10]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "packaged"])
def test_rnnoise_gru_kernel_chained_calls(cuda, kind):
    """Two calls of K frames, the first's states into the second, equal one
    call of 2K frames to float rounding (the kernel's gate), the first call
    ending on a silent frame of every channel."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    feats, sil, rnn, w = _r1_inputs(kind, 20, 4, 44, cuda)
    sil[9] = True
    g1, v1, s1 = gru.rnn_frames(feats[:10].contiguous(), sil[:10].contiguous(), rnn, w)
    g2, v2, s2 = gru.rnn_frames(feats[10:].contiguous(), sil[10:].contiguous(), s1, w)
    g, v, s = gru.rnn_frames(feats, sil, rnn, w)
    errs = _r1_errors((torch.cat([g1, g2]), torch.cat([v1, v2]), s2),
                      (g.cpu(), v.cpu(), type(rnn)(*(h.cpu() for h in s))))
    assert max(errs) <= R1_TOL, errs


@pytest.mark.cuda
def test_rnnoise_gru_cuda_never_runs_the_plain_version(cuda, monkeypatch):
    """On the card rnn_frames and denoise_frames_fast make the kernel call:
    neither the plain frame loop nor the port's rnn_frame runs."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    def refuse(*_a, **_k):
        raise AssertionError("a plain GRU-stack function ran on CUDA tensors")

    monkeypatch.setattr(gru, "rnn_frames_plain", refuse)
    monkeypatch.setattr(gru, "rnn_frame", refuse)
    monkeypatch.setattr(rn, "rnn_frame", refuse)
    feats, sil, rnn, w = _r1_inputs("packaged", 10, 2, 45, cuda)
    before = gru.launches
    gru.rnn_frames(feats, sil, rnn, w)
    x = torch.from_numpy((np.random.RandomState(46).uniform(-0.3, 0.3, (10, 2, rn.FRAME_SIZE))
                          * 32767).astype(np.float32)).to(cuda)
    rn.denoise_frames_fast(rn.denoise_init(2, cuda), w, x)
    torch.cuda.synchronize()
    assert gru.launches == before + 2


@pytest.mark.cuda
def test_denoise_frames_fast_card_vs_cpu(cuda):
    """The batched denoiser (front end, R1, synthesis) on the card against
    the same function on the CPU, over two buffers: within 0.25 s16 units
    (cuFFT against pocketfft, cuBLAS sums, R1's roundings)."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    rng = np.random.RandomState(12)
    x = (rng.uniform(-0.4, 0.4, (20, 2, rn.FRAME_SIZE)) * 32767).astype(np.float32)
    x[13] = 0.0
    w = rn.default_weights()
    sc, sh = rn.denoise_init(2, cuda), rn.denoise_init(2, "cpu")
    wc, wh = rn.weights_to(w, cuda), rn.weights_to(w, "cpu")
    before = gru.launches
    for chunk in (x[:10], x[10:]):
        sc, oc, vc = rn.denoise_frames_fast(sc, wc, torch.from_numpy(chunk).to(cuda))
        sh, oh, vh = rn.denoise_frames_fast(sh, wh, torch.from_numpy(chunk))
        assert float((oc.cpu() - oh).abs().max()) <= 0.25
        assert float((vc.cpu() - vh).abs().max()) <= 1e-4
    assert gru.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_compositor_operators_card_vs_cpu(cuda, method):
    """skiacompositor's Porter-Duff closed forms (no hand kernel: torch ops on
    [H, W*C] f32 canvases) on the card against the CPU: each operator's
    canvas within 1e-5 of 255, and the composited u8 frame (a downscaled pad
    with alpha 0.7, a cropped pad, jax.image.resize's weights) within 1 LSB."""
    from gst_plugins_rs_tpu_torch.elements.video import compositor as comp

    rng = np.random.RandomState(13)
    H, W = 270, 480
    base = torch.from_numpy(rng.randint(0, 256, (H, W, 4)).astype(np.uint8))
    pad = torch.from_numpy(rng.randint(0, 256, (180, 320, 4)).astype(np.uint8))
    crop = torch.from_numpy(rng.randint(0, 256, (60, 90, 3)).astype(np.uint8))
    dst = torch.from_numpy(rng.uniform(0, 255, (64, 96)).astype(np.float32))
    img = torch.from_numpy(rng.uniform(0, 255, (64, 96)).astype(np.float32))
    for op in comp.OPERATORS:
        for a in (0.0, 0.3, 0.7, 1.0):
            got = comp.blend(op, dst.to(cuda), img.to(cuda), a).cpu()
            assert float((got - comp.blend(op, dst, img, a)).abs().max()) <= 1e-5 * 255, op
        args = dict(out_h=H, out_w=W, channels=4, background="checker",
                    operators=("over", op, "add"), methods=("nearest", method, method))
        placements = ((0, 0, W, H), (40, 30, 120, 68), (420, 0, 60, 40))
        alphas = (1.0, 0.7, 0.45)
        got = comp.composite([t.to(cuda) for t in (base, pad, crop)], alphas, placements,
                             **args)
        want = comp.composite([base, pad, crop], alphas, placements, **args)
        assert got.device.type == "cuda"
        assert int((got.cpu().to(torch.int32) - want.to(torch.int32)).abs().max()) <= 1, op


# L1 over N streams a launch (loudnormbank's tick): half the streams peaky
# from mixed carries, half idle (state Out, no peak), against the plain twin
# (the per-stream host loop), bit for bit; one launch for all N.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("N", [1, 4, 16])
def test_limiter_kernel_n_streams_bit_equal_plain(cuda, N, dtype):
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    quiet = np.random.RandomState(40).uniform(-0.5, 0.5, (N, 40320, 2))
    rows, ci, cf = [], [], []
    for n in range(N):
        peaky = n % 2 == 0 or N == 1
        rows.append(_limiter_window(n, dtype, cuda) if peaky
                    else torch.from_numpy(quiet[n]).to(cuda, dtype))
        c = LIMITER_CARRIES[(n // 2) % 4] if peaky else (0, 0, -1, 0.0, 0.0)
        ci.append(c[:3])
        cf.append(c[3:])
    w = torch.stack(rows).contiguous()
    ci = torch.tensor(ci, dtype=torch.int32, device=cuda)
    cf = torch.tensor(cf, dtype=dtype, device=cuda)
    out = _assert_limiter_equal(lim, w, ci, cf, _tp(dtype))
    assert out.shape == (N, lim.FRAME, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_limiter_kernel_mixed_bank_of_16(cuda, dtype):
    """16 streams of one launch: idle, peaky, clipped and the walk's hard
    frames from standard and boundary carries, the windows 40,960 rows
    apart (a bank's stride longer than the window), each stream's walk
    counted."""
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    N, stride = 16, 40960
    quiet = np.random.RandomState(41).uniform(-0.5, 0.5, (40320, 2))
    kinds = ["idle", "peaky", "clipped", "none", "late", "edges"]
    carries = LIMITER_CARRIES + LIMITER_BOUNDARY[13::5]
    store = torch.zeros((N, stride, 2), dtype=dtype, device=cuda)
    ci, cf = [], []
    for n in range(N):
        kind = kinds[n % len(kinds)]
        if kind == "idle":
            store[n, :40320] = torch.from_numpy(quiet).to(cuda, dtype)
            c = (0, 0, -1, 0.0, 0.0)
        else:
            store[n, :40320] = (_limiter_window(n, dtype, cuda) if kind == "peaky"
                                else _limiter_kind(kind, dtype, cuda))
            c = carries[n % len(carries)]
        ci.append(c[:3])
        cf.append(c[3:])
    w = store[:, :40320]
    assert not w.is_contiguous() and w.stride(0) == stride * 2
    ci = torch.tensor(ci, dtype=torch.int32, device=cuda)
    cf = torch.tensor(cf, dtype=dtype, device=cuda)
    stats = torch.zeros((N, 3), dtype=torch.int32, device=cuda)
    _assert_limiter_equal(lim, w, ci, cf, _tp(dtype), stats)
    pk = lim.precompute_peaks(w, _tp(dtype))[0]
    assert stats[:, 0].tolist() == pk.sum(1).tolist()
    for n in range(N):
        idle = kinds[n % len(kinds)] == "idle" or (int(ci[n, 0]) == 0 and int(pk[n].sum()) == 0)
        assert (int(stats[n, 1]) == 0) == idle


@pytest.mark.cuda
def test_limiter_kernel_n_streams_rejects_bad_operands(cuda):
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter as lim

    w = torch.zeros(4, 40320, 2, dtype=torch.float32, device=cuda)
    ci = torch.tensor([[0, 0, -1]] * 4, dtype=torch.int32, device=cuda)
    cf = torch.zeros(4, 2, dtype=torch.float32, device=cuda)
    before = lim.launches
    with pytest.raises(ValueError):
        lim.limiter_frames(w, ci[:3], cf, 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frames(w.transpose(1, 2), ci, cf, 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frames(w, ci, cf.double(), 0.79)
    with pytest.raises(ValueError):
        lim.limiter_frames(w, ci, cf, 0.79,
                           walk_stats=torch.zeros(3, 3, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):  # past the kernel's 32-bit row index
        lim.limiter_frames(torch.zeros(1, lim.WINDOW_MIN, 473, device=cuda), ci[:1], cf[:1],
                           0.79)
    assert lim.launches == before


# Kernel T1, asr-lite's BiGRU recurrence (csrc/asr_gru.cu), against its plain
# version (a step loop of torch ops): the same products summed in another
# order, expf / tanhf against torch's sigmoid and tanh; the hidden states
# within T1_TOL of 1 + |ref|.
T1_TOL = 1e-5


def _asr_inputs(source, dev):
    """(weights on dev, layer-0 features [1, T, 40] on dev): the log-mel
    features of synthesised speech or of silence padded to a multiple of 50
    frames, as transcribe runs them, or seeded random features at T = 500."""
    from gst_plugins_rs_tpu_torch.ops import asr
    from gst_plugins_rs_tpu_torch.ops.speechsynth import synth_sentence

    w = asr.load_weights(dev=dev)
    if source == "random":
        return w, torch.from_numpy(np.random.RandomState(8).randn(1, 500, 40)
                                   .astype(np.float32)).to(dev)
    audio = (synth_sentence(["open", "door", "seven", "volume", "up"], seed=5, noise_snr_db=30)
             if source == "speech" else np.zeros(80000, np.float32))
    feats, _ = asr.padded_features(torch.from_numpy(audio).to(dev))
    return w, feats[None]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["speech", "silence", "random"])
def test_asr_gru_kernel_matches_plain(cuda, source):
    """Both layers and both directions: layer 1 takes the plain layer 0's
    states, so each layer is held on its own inputs."""
    from gst_plugins_rs_tpu_torch.ops import asr, asr_gru

    w, x = _asr_inputs(source, cuda)
    for layer in range(2):
        Wx, b, U = asr.layer_mats(w, layer)
        X = asr.input_projections(x, Wx, b)
        before = asr_gru.launches
        got = asr_gru.bigru(X, U)
        torch.cuda.synchronize()
        assert asr_gru.launches == before + 1
        ref = asr_gru.bigru_plain(X, U)
        assert got.shape == ref.shape and torch.isfinite(got).all()
        err = float(((got - ref).abs() / (1 + ref.abs())).max())
        assert err <= T1_TOL, (layer, err)
        x = torch.cat([ref[:, 0], ref[:, 1]], -1)


@pytest.mark.cuda
def test_asr_gru_kernel_batches_utterances(cuda):
    from gst_plugins_rs_tpu_torch.ops import asr, asr_gru

    w = asr.load_weights(dev=cuda)
    Wx, b, U = asr.layer_mats(w, 0)
    x = torch.from_numpy(np.random.RandomState(3).randn(3, 120, 40).astype(np.float32)).to(cuda)
    X = asr.input_projections(x, Wx, b)
    both = asr_gru.bigru(X, U)
    for i in range(3):
        assert torch.equal(both[i:i + 1], asr_gru.bigru(X[i:i + 1].contiguous(), U))


@pytest.mark.cuda
def test_asr_gru_kernel_rejects_bad_operands(cuda):
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    X = torch.zeros(1, 2, 50, 288, device=cuda)
    U = torch.zeros(2, 3, 96, 96, device=cuda)
    before = asr_gru.launches
    with pytest.raises(ValueError):
        asr_gru.bigru(X.double(), U)
    with pytest.raises(ValueError):
        asr_gru.bigru(X[..., :96], U)
    with pytest.raises(ValueError):
        asr_gru.bigru(X, U.cpu())
    assert asr_gru.launches == before


def _t1_err(got, ref):
    return float(((got - ref).abs() / (1 + ref.abs())).max())


def _t1_layer_inputs(x, layer, cuda):
    """(X, U) of one layer of the packaged model on layer inputs x [B, T, D]."""
    from gst_plugins_rs_tpu_torch.ops import asr

    Wx, b, U = asr.layer_mats(asr.load_weights(dev=cuda), layer)
    return asr.input_projections(x, Wx, b), U


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 2, 50])
def test_asr_gru_kernel_short_utterances(cuda, T):
    """The ring of X prefetched kDepth - 1 steps ahead, on utterances shorter
    than it (T = 1, 2) and on the shortest bucket: both layers within
    T1_TOL, one launch a call."""
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    _, x = _asr_inputs("speech", cuda)
    x = x[:, :T]
    for layer in range(2):
        X, U = _t1_layer_inputs(x, layer, cuda)
        before = asr_gru.launches
        got = asr_gru.bigru(X, U)
        torch.cuda.synchronize()
        assert asr_gru.launches == before + 1
        ref = asr_gru.bigru_plain(X, U)
        assert got.shape == (1, 2, T, 96) and torch.isfinite(got).all()
        assert _t1_err(got, ref) <= T1_TOL, (layer, _t1_err(got, ref))
        x = torch.cat([ref[:, 0], ref[:, 1]], -1)


@pytest.mark.cuda
def test_asr_gru_kernel_six_utterances(cuda):
    """B = 6 at T = 500 (six chunks in one call): each utterance equal to
    its call alone, all within T1_TOL of the plain version, one launch."""
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    x = torch.from_numpy(np.random.RandomState(6).randn(6, 500, 40).astype(np.float32)).to(cuda)
    X, U = _t1_layer_inputs(x, 0, cuda)
    before = asr_gru.launches
    six = asr_gru.bigru(X, U)
    torch.cuda.synchronize()
    assert asr_gru.launches == before + 1
    assert _t1_err(six, asr_gru.bigru_plain(X, U)) <= T1_TOL
    for i in range(6):
        assert torch.equal(six[i:i + 1], asr_gru.bigru(X[i:i + 1].contiguous(), U))


@pytest.mark.cuda
def test_asr_gru_kernel_saturated_gates(cuda):
    """Layer inputs 20x: the gates at 0 or 1 and the candidate at +-1, where
    the MUFU's ex2 over- and underflows; both layers within T1_TOL."""
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    _, x = _asr_inputs("speech", cuda)
    for layer in range(2):
        X, U = _t1_layer_inputs(20.0 * x, layer, cuda)
        got = asr_gru.bigru(X, U)
        torch.cuda.synchronize()
        ref = asr_gru.bigru_plain(X, U)
        assert torch.isfinite(got).all() and _t1_err(got, ref) <= T1_TOL, layer
        x = torch.cat([ref[:, 0], ref[:, 1]], -1)


@pytest.mark.cuda
def test_asr_gru_kernel_unaligned_input(cuda):
    """X contiguous but 4 bytes past a 16-byte boundary (the kernel copies
    X in 16-byte pieces): the same states as an aligned copy."""
    from gst_plugins_rs_tpu_torch.ops import asr_gru

    _, x = _asr_inputs("random", cuda)
    X, U = _t1_layer_inputs(x[:, :60], 0, cuda)
    buf = torch.empty(X.numel() + 1, device=cuda)
    shifted = buf[1:].view(X.shape)
    shifted.copy_(X)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert torch.equal(asr_gru.bigru(shifted, U), asr_gru.bigru(X, U))


@pytest.mark.cuda
def test_transcribe_card_vs_cpu(cuda):
    """The packaged model on a command: the same transcript on the card (T1)
    and on the CPU (the plain recurrence), logits within 1e-4."""
    from gst_plugins_rs_tpu_torch.ops import asr
    from gst_plugins_rs_tpu_torch.ops.speechsynth import synth_sentence

    audio = synth_sentence(["volume", "up"], seed=77_000_002, noise_snr_db=30)
    feats, t = asr.padded_features(torch.from_numpy(audio))
    card = asr.forward(asr.load_weights(dev=cuda), feats.to(cuda)).cpu()
    host = asr.forward(asr.load_weights(dev="cpu"), feats)
    assert float((card - host).abs().max()) <= 1e-4
    assert asr.transcribe(asr.load_weights(dev=cuda), audio) == "volume up"


@pytest.mark.cuda
def test_denoise_16_streams_card_vs_cpu(cuda):
    """bench.py's denoiser bank: 16 mono streams of uniform +-0.3 full-scale
    noise as the channels of one denoise_frames_fast call (one R1 launch a
    call, a block a stream), on the card against the CPU, over two calls:
    a sample within 1e-4 of full scale (3.28 s16 units, chip_smoke.py's
    gate of the denoised path), the VADs within 1e-4.  The stream that
    starts silent is the least-conditioned case at its onset (large
    spectral-variance features through the ReLU GRUs, where the two f32
    versions of R1 already differ by more than 1e-5; chip_smoke.py phases
    3d' and 5d' print it beside the other streams)."""
    from gst_plugins_rs_tpu_torch.ops import rnnoise as rn
    from gst_plugins_rs_tpu_torch.ops import rnnoise_gru as gru

    rng = np.random.RandomState(13)
    x = (rng.uniform(-0.3, 0.3, (32, 16, rn.FRAME_SIZE)) * 32767).astype(np.float32)
    x[:2, 5] = 0.0  # a stream that starts silent
    w = rn.default_weights()
    sc, sh = rn.denoise_init(16, cuda), rn.denoise_init(16, "cpu")
    wc, wh = rn.weights_to(w, cuda), rn.weights_to(w, "cpu")
    before = gru.launches
    for chunk in (x[:16], x[16:]):
        sc, oc, vc = rn.denoise_frames_fast(sc, wc, torch.from_numpy(chunk).to(cuda))
        sh, oh, vh = rn.denoise_frames_fast(sh, wh, torch.from_numpy(chunk))
        assert float((oc.cpu() - oh).abs().max()) <= 1e-4 * 32767
        assert float((vc.cpu() - vh).abs().max()) <= 1e-4
    assert gru.launches == before + 2


# Chain fusion on the card (parallel/fuse.py): a fused run replays one CUDA
# graph per input signature, B4 and B2 launched from inside it; its output is
# held bit for bit against the unfused pipeline's on every buffer of frames
# that differ from one another.


def _write_small_grade(path, size=9):
    g = np.linspace(0, 1, size)
    Bz, Gy, Rx = np.meshgrid(g, g, g, indexing="ij")
    Y = 0.299 * Rx + 0.587 * Gy + 0.114 * Bz
    table = np.stack([np.clip(Y + 1.05 * (Rx - Y), 0, 1),
                      np.clip(Y + 1.05 * (Gy - Y) + 0.01, 0, 1),
                      np.clip(Y + 1.05 * (Bz - Y) + 0.02, 0, 1)], -1).reshape(-1, 3)
    path.write_text(f"LUT_3D_SIZE {size}\n"
                    + "\n".join(f"{r:.6f} {gg:.6f} {b:.6f}" for r, gg, b in table) + "\n")
    return path


def _appsrc_frames(desc, frames, fused, fmt="RGBA"):
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.parallel.fuse import fuse_pipeline

    p = g.parse_launch(f"appsrc name=src ! {desc} ! appsink name=sink")
    n = fuse_pipeline(p) if fused else None
    src = p.by_name("src")
    h, w = (frames[0][0] if isinstance(frames[0], tuple) else frames[0]).shape[:2]
    src.set_property("caps", g.parse_caps(
        f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"))
    for i, f in enumerate(frames):
        src.push_buffer(g.Buffer(f, pts=i * 33_333_333, duration=33_333_333))
    src.end_of_stream()
    p.play_until_eos()
    return n, [s.buffer.data for s in p.by_name("sink").samples]


@pytest.mark.cuda
@pytest.mark.parametrize("chain", ["effects", "mixed"])
def test_fused_graph_matches_unfused_on_differing_frames(cuda, tmp_path, chain):
    from gst_plugins_rs_tpu_torch.parallel import fuse

    loc = _write_small_grade(tmp_path / "grade9.cube")
    desc = {"effects": f"hsvfilter hue-shift=120 ! colorlut location={loc} precision=approx",
            "mixed": "hsvfilter hue-shift=90 ! videoscale method=nearest "
                     "! video/x-raw,width=40,height=24 ! videoflip method=rotate-180"}[chain]
    gen = torch.Generator(device=cuda).manual_seed(7)
    frames = [torch.randint(0, 256, (48, 80, 4), generator=gen, device=cuda, dtype=torch.uint8)
              for _ in range(12)]
    _, ref = _appsrc_frames(desc, frames, fused=False)
    before = (hsv_planes.launches, lowrank.packed_launches, fuse.captures, fuse.replays)
    n, got = _appsrc_frames(desc, frames, fused=True)
    torch.cuda.synchronize()
    after = (hsv_planes.launches, lowrank.packed_launches, fuse.captures, fuse.replays)
    assert n == 1 and len(got) == len(ref) == len(frames)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert a.device.type == "cuda" and torch.equal(a, b), f"buffer {i}"
    assert len({a.data_ptr() for a in got}) == len(got)  # no two buffers share the graph's output
    b2 = len(frames) if chain == "effects" else 0
    assert [a - b for a, b in zip(after, before)] == [len(frames), b2, 1, len(frames) - 1]


@pytest.mark.cuda
def test_fused_capture_failure_raises(cuda):
    """A kernel that synchronises cannot be captured: the fused run raises
    (after its eager warm-up on the first buffer) and the card stays usable."""
    from gst_plugins_rs_tpu_torch.parallel.fuse import FusedRun

    run = FusedRun([lambda x: x + 1, lambda x: x * float(x.sum())], ["add", "sync"], cuda)
    with pytest.raises(RuntimeError, match="capture failed"):
        run(torch.ones(8, device=cuda))
    assert float(torch.ones(4, device=cuda).sum()) == 4.0
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)


@pytest.mark.cuda
def test_fused_identity_run_captures_no_graph(cuda):
    """A run whose kernels all return their input (videoflip method=none and
    a videoscale to the same size) moves no data: it captures no graph and
    passes each frame on, as the unfused chain does."""
    from gst_plugins_rs_tpu_torch.parallel import fuse

    gen = torch.Generator(device=cuda).manual_seed(8)
    frames = [torch.randint(0, 256, (24, 40, 4), generator=gen, device=cuda, dtype=torch.uint8)
              for _ in range(3)]
    desc = "videoflip method=none ! videoscale"
    _, ref = _appsrc_frames(desc, frames, fused=False)
    before = (fuse.captures, fuse.replays)
    n, got = _appsrc_frames(desc, frames, fused=True)
    assert n == 1 and (fuse.captures, fuse.replays) == before
    for a, b, f in zip(got, ref, frames):
        assert torch.equal(a, f) and a.data_ptr() == b.data_ptr() == f.data_ptr()


@pytest.mark.cuda
def test_fused_planar_passthrough_plane_is_not_overwritten(cuda):
    """I420 -> NV12 at the same size: the scaler is the identity and the
    converter hands its Y plane on untouched, so one output plane of the
    run is an input plane.  Every buffer, the first included, stays equal
    to the unfused chain's after later buffers have gone through the graph."""
    from gst_plugins_rs_tpu_torch.parallel import fuse

    gen = torch.Generator(device=cuda).manual_seed(9)

    def plane(h, w):
        return torch.randint(0, 256, (h, w), generator=gen, device=cuda, dtype=torch.uint8)

    frames = [(plane(48, 80), plane(24, 40), plane(24, 40)) for _ in range(6)]
    desc = "videoscale ! videoconvert ! video/x-raw,format=NV12"
    _, ref = _appsrc_frames(desc, frames, fused=False, fmt="I420")
    before = (fuse.captures, fuse.replays)
    n, got = _appsrc_frames(desc, frames, fused=True, fmt="I420")
    torch.cuda.synchronize()
    assert n == 1 and len(got) == len(ref) == len(frames)
    assert (fuse.captures - before[0], fuse.replays - before[1]) == (1, len(frames) - 1)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert len(a) == len(b) == 2, f"buffer {i}"
        for pa, pb in zip(a, b):
            assert pa.device.type == "cuda" and torch.equal(pa, pb), f"buffer {i}"


@pytest.mark.cuda
def test_c3_smem_bytes_matches_the_library(cuda):
    """The host reckoning that chooses the engine's C3 route is the
    library's own, for every zoo model's dark2 C3, both dtypes and every
    tile side."""
    from gst_plugins_rs_tpu_torch.models.yolox import VARIANTS, expand

    lib = yolox_c3._lib()
    for depth, width, _ in VARIANTS.values():
        C = 2 * expand(64, width)
        h, n = expand(C, 0.5), max(round(depth * 3), 1)
        for bf16 in (False, True):
            for tile in yolox_c3._TILES:
                assert yolox_c3.c3_smem_bytes(bf16, C, h, n, tile) == \
                    lib.yolox_c3_smem_bytes(int(bf16), C, h, n, tile), (C, h, n, bf16, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("props", ["engine=fast-bf16", "engine=fast precision=bf16"])
def test_yolox_x_bf16_card_matches_cpu(cuda, props):
    """YOLOX-x in bf16 by both routes, 64x64, init_weights(seed=0): on the
    card its dark2 C3 takes the per-conv route (no tile of B1 fits) and B1
    is not launched.  That C3, card against CPU on one bf16 input, is within
    2e-2 of its output's scale (5.6e-3 read on an H100; two output channels
    swapped read 0.455).  Through the element, fast-bf16's scores (columns
    4:) are within 0.05 of the CPU's (the bf16 gate of
    tests/test_yolox_fast.py::test_bf16_close); precision=bf16's whole net
    is not held to it (ROADMAP C.1: bf16 moves the deep random-init
    variants' scores past 0.05 from f32 on either device)."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import TensorMeta
    from gst_plugins_rs_tpu_torch.models.yolox import Yolox, init_weights
    from gst_plugins_rs_tpu_torch.models.yolox_fast import FastEngine

    frame = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (64, 64, 3))
                             .astype(np.uint8))
    model = init_weights(Yolox.from_variant("x"), seed=0)
    state = model.state_dict()
    kw = (dict(s2d_dtype=torch.bfloat16) if props == "engine=fast-bf16"
          else dict(dtype=torch.bfloat16))
    host = FastEngine(model, state, **kw)
    card = FastEngine(model, {k: v.to(cuda) for k, v in state.items()}, fuse_c3=True,
                      device=cuda, **kw)
    assert card.c3_route == "per-conv"
    y = host.dark2_c3_input(frame[None])
    before = yolox_c3.launches
    got = card.dark2_c3(y.to(cuda)).float().cpu()
    want = host.dark2_c3(y).float()
    assert yolox_c3.launches == before
    assert float((got - want).abs().max() / want.abs().max()) <= 2e-2

    def run(dev):
        prev = g.requested_device()
        g.set_device(dev)
        try:
            p = g.parse_launch("appsrc name=src ! yoloxinference name=det model-type=x "
                               f"{props} ! appsink name=sink")
            p.by_name("src").set_property("caps", g.parse_caps(
                "video/x-raw,format=RGB,width=64,height=64,framerate=30/1"))
            p.by_name("src").push_buffer(g.Buffer(frame.to(dev), pts=0))
            p.by_name("src").end_of_stream()
            p.play_until_eos()
            buf = p.by_name("sink").samples[0].buffer
            return next(iter(buf.iter_meta(TensorMeta))).tensors[0].data
        finally:
            g.set_device(prev)

    before = yolox_c3.launches
    out = run("cuda")
    torch.cuda.synchronize()
    assert yolox_c3.launches == before
    ref = run("cpu")
    out = out.float().cpu()
    assert out.shape == ref.shape == (1, 84, 85) and torch.isfinite(out).all()
    if props == "engine=fast-bf16":
        assert float((out[..., 4:] - ref[..., 4:]).abs().max()) < 0.05


# -- the host-only elements with payloads on the card ----------------------------
# Byte elements read a card payload back once and must give the bytes a CPU
# tensor gives; togglerecord's clip of a card tensor is a view of it; the
# fills of livesync and fallbacksrc are made on the card.
_OCTETS = "application/octet-stream"


def _byte_outputs(launch, payloads, caps=_OCTETS, host=True):
    import gst_plugins_rs_tpu_torch as g

    p = g.parse_launch(f"appsrc name=src ! {launch} ! appsink name=sink")
    p.by_name("src").set_property("caps", g.parse_caps(caps))
    for i, t in enumerate(payloads):
        p.by_name("src").push_buffer(g.Buffer(t, pts=i * 1_000_000, duration=1_000_000))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    out = [s.buffer.data for s in p.by_name("sink").samples]
    if not host:
        return out
    assert out and all(isinstance(o, np.ndarray) and o.dtype == np.uint8 for o in out)
    return [o.tobytes() for o in out]


_KEY_S, _KEY_R = bytes(range(1, 33)), bytes(range(40, 72))


def _sodium_pair():
    from gst_plugins_rs_tpu_torch.net.nacl import x25519_public_key

    return (f"sodiumencrypter sender-key={_KEY_S.hex()} "
            f"receiver-key={x25519_public_key(_KEY_R).hex()} block-size=4096 "
            f"nonce={bytes(range(24)).hex()}",
            f"sodiumdecrypter sender-key={x25519_public_key(_KEY_S).hex()} "
            f"receiver-key={_KEY_R.hex()}")


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [
    "compressenc", "compressenc format=deflate ! compressdec format=deflate",
    "zlibcompress ! zlibdecompress", "brotlicompress", "brotlicompress ! brotlidecompress",
    "sodium", "sodium-roundtrip", "debugseimetainserter", "s302mparse", "ac4parse",
])
def test_byte_elements_take_card_payloads(cuda, launch):
    gen = torch.Generator(device="cuda").manual_seed(12)
    frames = [torch.randint(0, 256, (48, 64, 4), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(3)]
    caps = {"debugseimetainserter": "video/x-h264,stream-format=avc",
            "s302mparse": "audio/x-smpte-302m", "ac4parse": "audio/x-ac4"}.get(launch, _OCTETS)
    enc, dec = _sodium_pair()
    chain = {"sodium": enc, "sodium-roundtrip": f"{enc} ! {dec}"}.get(launch, launch)
    if launch == "ac4parse":  # frames behind an AC-4 sync word and size
        frames = [torch.cat([torch.tensor([0xAC, 0x40, 0x30, 0x00], dtype=torch.uint8,
                                          device="cuda"), f.flatten()]) for f in frames]
    if launch == "s302mparse":  # parses the header, then hands the payload on
        frames = [torch.cat([torch.tensor([0, 240, 0x80, 0x20], dtype=torch.uint8,
                                          device="cuda"), f.flatten()]) for f in frames]
        assert _byte_outputs(chain, frames, caps, host=False) == frames
        return
    got = _byte_outputs(chain, frames, caps)
    assert got == _byte_outputs(chain, [f.cpu() for f in frames], caps)
    if launch.endswith("roundtrip") or "!" in launch:
        assert b"".join(got) == b"".join(f.cpu().numpy().tobytes() for f in frames)


@pytest.mark.cuda
def test_rsfilesink_writes_card_payloads(cuda, tmp_path):
    import gst_plugins_rs_tpu_torch as g

    frames = [torch.arange(4096, device="cuda", dtype=torch.int32).reshape(64, 64) * (i + 1)
              for i in range(3)]
    path = tmp_path / "card.bin"
    p = g.parse_launch(f"appsrc name=src ! rsfilesink location={path}")
    p.by_name("src").set_property("caps", g.parse_caps(_OCTETS))
    for i, f in enumerate(frames):
        p.by_name("src").push_buffer(g.Buffer(f[:, ::2], pts=i))  # a strided view
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    assert path.read_bytes() == b"".join(f[:, ::2].cpu().numpy().tobytes() for f in frames)


@pytest.mark.cuda
def test_togglerecord_clips_card_tensors_to_views(cuda):
    ns = load_test_module("test_togglerecord.py", port=True)
    MS = 1_000_000
    tr, main, (sec,) = ns["_make"](record=False, n_secondary=1)
    sec.set_caps(ns["Caps"].builder("audio/x-raw", format="F32", rate=48000, channels=2,
                                    layout="interleaved"))
    main.run([ns["_buf"](0), lambda: tr.set_property("record", True), ns["_buf"](10),
              ns["_buf"](20), ns["_buf"](30), lambda: tr.set_property("record", False),
              ns["_buf"](40), ns["_buf"](50), ns["Event"].new_eos()])
    sent = [torch.randn(960, 2, device="cuda") for _ in range(3)]
    sec.run([ns["Buffer"](d, pts=t * MS, duration=20 * MS) for t, d in zip((0, 20, 40), sent)]
            + [ns["Event"].new_eos()])
    main.join()
    sec.join()
    lens = [b.data.shape[0] for b in sec.buffers]
    assert lens == [480, 960]
    assert sec.buffers[0].data._base is sent[0] and sec.buffers[0].data.is_cuda
    assert torch.equal(sec.buffers[0].data, sent[0][480:])
    assert sec.buffers[1].data is sent[1]


@pytest.mark.cuda
def test_livesync_fills_on_the_card(cuda):
    ns = load_test_module("test_livesync.py", port=True)
    tc, ls, h = ns["_mk"](False, latency=0)
    h.set_src_caps(ns["Caps"].builder("audio/x-raw", format="F64", rate=48000, channels=2,
                                      layout="interleaved"))
    slot = 100_000_000
    sent = [torch.randn(4800, 2, device="cuda", dtype=torch.float64) for _ in range(3)]
    out = []
    h.push(ns["Buffer"](sent[0], pts=0, duration=slot))
    h.push(ns["Buffer"](sent[1], pts=slot, duration=slot))
    for _ in range(3):  # slot 1, then two slots of silence (slot 0 left at the push)
        assert tc.crank()
        out += h.pull_all()
    h.push(ns["Buffer"](sent[2], pts=4 * slot, duration=slot))
    assert tc.crank()
    out += h.pull_all()
    gap = ns["BufferFlags"].GAP
    fills = [b for b in out if b.has_flag(gap)]
    assert [b.data for b in out if not b.has_flag(gap)] == sent
    assert len(fills) == 2
    for b in fills:
        assert b.data.is_cuda and b.data.dtype == torch.float64
        assert tuple(b.data.shape) == (4800, 2) and not bool(b.data.any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["audio", "video"])
def test_fallbacksrc_dummies_on_the_card(cuda, tmp_path, kind):
    import time

    import gst_plugins_rs_tpu_torch as g

    ns = load_test_module("test_fallbacksrc.py", port=True)
    props = {"uri": f"file://{tmp_path}/missing.bin", "restart-timeout": 20_000_000,
             "timeout": 50_000_000}
    if kind == "video":
        props.update({"enable-audio": False, "dummy-video-caps":
                      "video/x-raw,format=RGB,width=16,height=8,framerate=50/1"})
    prev = g.requested_device()
    g.set_device("cuda")
    try:
        p, src, sink = ns["build"](**props)
        p.set_state(ns["State"].PLAYING)
        deadline = time.monotonic() + 8  # the JAX file's `collect` reads numpy payloads
        while len(sink.samples) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        got = [s.buffer.data for s in sink.samples[:2]]
        p.set_state(ns["State"].NULL)
    finally:
        g.set_device(prev)
    assert len(got) == 2
    for d in got:
        assert isinstance(d, torch.Tensor) and d.is_cuda and not bool(d.any())
        assert d.dtype == (torch.float32 if kind == "audio" else torch.uint8)


def _caption_frames(n, seed, h=180, w=320):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randint(0, 256, (h, w, 4), generator=gen, device="cuda", dtype=torch.uint8)
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("factory", ["cea608overlay", "cea708overlay"])
def test_caption_overlay_composites_on_the_card(cuda, factory):
    """cea608overlay (caption metas) and cea708overlay (a cc_data stream)
    composite card frames on the card, within 1 LSB of the same element on
    the CPU, with their masks cached on the card."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.core import FlowReturn, VideoCaptionMeta
    from gst_plugins_rs_tpu_torch.ops import cea608, cea708

    pairs = cea608.encode_pop_on(["ON THE CARD", "CAPTIONS"])
    frames = _caption_frames(4, seed=21)

    def run(dev):
        g.set_device(dev)
        try:
            el = g.element_factory_make(factory)
            el.on_ready_to_paused()
            out = []
            if factory == "cea708overlay":
                cc = b"".join(cea708.cc_data_triplet(0, hi, lo) for hi, lo in pairs)
                el.ccpad.current_caps = g.parse_caps("closedcaption/x-cea-708,format=cc_data")
                el.set_property("cea608-channel", 1)
                el._cc_chain(el.ccpad, g.Buffer(np.frombuffer(cc, np.uint8).copy(), pts=0))
            el.srcpad.push = lambda buf: out.append(buf) or FlowReturn.OK
            for i, f in enumerate(frames):
                b = g.Buffer(f.to(dev), pts=i * 33_333_333, duration=33_333_333)
                if factory == "cea608overlay" and i == 1:
                    b.add_meta(VideoCaptionMeta("cea608-raw", bytes(x for pr in pairs for x in pr)))
                el._video_chain(el.sinkpad, b)
            return el, out
        finally:
            g.set_device("cuda")

    el, card = run("cuda")
    _, host = run("cpu")
    assert all(b.data.device.type == "cuda" and b.data.dtype == torch.uint8 for b in card)
    renderer = el if factory == "cea608overlay" else el._renderer
    assert renderer._mask_cache and all(m.device.type == "cuda" and x.device.type == "cuda"
                                        for m, x in renderer._mask_cache.values())
    d = max(int((a.data.cpu().to(torch.int32) - b.data.to(torch.int32)).abs().max())
            for a, b in zip(card, host))
    assert d <= 1
    assert any(bool((a.data != f).any()) for a, f in zip(card, frames))


@pytest.mark.cuda
def test_cmafmux_reads_each_card_payload_back_once(cuda):
    """cmafmux on card payloads: one device-to-host copy a video frame and
    an audio buffer (torch.profiler), and the same file as from the same
    payloads on the host; a float frame is clipped and cast on the card
    before its copy."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    frames = _caption_frames(6, seed=22, h=48, w=64)
    gen = torch.Generator(device="cuda").manual_seed(23)
    audio = [torch.randn(1600, 1, generator=gen, device="cuda") for _ in range(4)]

    def run(vf, af):
        out = {}
        for name, caps, bufs, dur in (
                ("v", "video/x-raw,format=RGBA,width=64,height=48,framerate=30/1", vf, 33_333_333),
                ("a", "audio/x-raw,format=F32,rate=16000,channels=1", af, 100_000_000)):
            p = g.parse_launch(f"appsrc name=src ! cmafmux fragment-duration=100000000 "
                               f"! appsink name=sink")
            p.by_name("src").set_property("caps", g.parse_caps(caps))
            for i, b in enumerate(bufs):
                p.by_name("src").push_buffer(g.Buffer(b, pts=i * dur, duration=dur))
            p.by_name("src").end_of_stream()
            p.play_until_eos()
            out[name] = b"".join(np.asarray(s.buffer.data).tobytes()
                                 for s in p.by_name("sink").samples)
        return out

    run(frames, audio)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run(frames, audio)
        torch.cuda.synchronize()
    dtoh = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
    assert dtoh == len(frames) + len(audio)
    assert got == run([f.cpu() for f in frames], [a.cpu() for a in audio])
    floats = [f.float() * 1.5 - 64 for f in frames]
    want = run([f.cpu().clamp(0, 255).to(torch.uint8) for f in floats], audio)["v"]
    assert run(floats, audio)["v"] == want


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["alaw", "mulaw"])
def test_g711_on_the_card_matches_cpu(cuda, law):
    """G.711 (ops/g711.py, int32 torch ops) on the card over every S16
    value and every code: bit-equal to the CPU, on the card."""
    from gst_plugins_rs_tpu_torch.ops import g711

    pcm = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    enc, dec = getattr(g711, f"{law}_encode"), getattr(g711, f"{law}_decode")
    card_enc, card_dec = enc(pcm.to(cuda)), dec(codes.to(cuda))
    assert card_enc.device.type == card_dec.device.type == "cuda"
    assert torch.equal(card_enc.cpu(), enc(pcm)) and torch.equal(card_dec.cpu(), dec(codes))


@pytest.mark.cuda
def test_onvif_overlay_draws_on_the_card(cuda):
    """onvifmetadataoverlay on card frames: the frame stays on the card, no
    device-to-host copy (torch.profiler), bit-equal to the same element on
    the CPU."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.elements.analytics.meta import AnalyticsRelationMeta
    from gst_plugins_rs_tpu_torch.elements.analytics.onvif import (
        OnvifXMLFrameMeta, build_metadata_xml)
    from torch.profiler import ProfilerActivity, profile

    frames = _caption_frames(3, seed=24, h=48, w=64)
    rel = AnalyticsRelationMeta()
    for box in ((4, 5, 20, 10), (-3, 30, 70, 40), (50, 2, 8, 8)):
        rel.add_od_mtd("person", *box, 0.5)
    xml = build_metadata_xml(rel, 0, 64, 48)

    def run(dev):
        g.set_device(dev)
        try:
            p = g.parse_launch("appsrc name=src ! onvifmetadataoverlay ! appsink name=sink")
            p.by_name("src").set_property("caps", g.parse_caps(
                "video/x-raw,format=RGBA,width=64,height=48,framerate=30/1"))
            for i, f in enumerate(frames):
                b = g.Buffer(f.to(dev), pts=i)
                b.add_meta(OnvifXMLFrameMeta([xml]))
                p.by_name("src").push_buffer(b)
            p.by_name("src").end_of_stream()
            p.play_until_eos()
            return [s.buffer.data for s in p.by_name("sink").samples]
        finally:
            g.set_device("cuda")

    run("cuda")  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        card = run("cuda")
        torch.cuda.synchronize()
    dtoh = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
    assert dtoh == 0 and all(c.device.type == "cuda" for c in card)
    host = run("cpu")
    assert all(torch.equal(c.cpu(), h) for c, h in zip(card, host))
    assert any(bool((c.cpu() != f.cpu()).any()) for c, f in zip(card, frames))


@pytest.mark.cuda
def test_pcmu_payloader_reads_each_card_buffer_back_once(cuda):
    """mulawenc ! rtppcmupay2 on card audio: the companding on the card,
    one device-to-host copy a buffer at the payloader, and the packets of
    the same audio on the host."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(25)
    audio = [torch.randint(-32768, 32768, (160, 1), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int16) for _ in range(8)]

    def run(bufs):
        p = g.parse_launch("appsrc name=src ! mulawenc ! rtppcmupay2 ssrc=1 "
                           "timestamp-offset=0 seqnum-offset=0 max-ptime=20000000 "
                           "! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            "audio/x-raw,format=S16,rate=8000,channels=1,layout=interleaved"))
        for i, b in enumerate(bufs):
            p.by_name("src").push_buffer(g.Buffer(b, pts=i * 20_000_000, duration=20_000_000))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return [np.asarray(s.buffer.data).tobytes() for s in p.by_name("sink").samples]

    run(audio)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run(audio)
        torch.cuda.synchronize()
    dtoh = sum(e.count for e in prof.key_averages() if e.key.startswith("Memcpy DtoH"))
    assert dtoh == len(audio) and len(got) == len(audio)
    g.set_device("cpu")
    try:
        assert got == run([a.cpu() for a in audio])
    finally:
        g.set_device("cuda")


@pytest.mark.cuda
def test_vraw_link_copies_each_frame_once_each_way(cuda):
    """rtpvrawpay2 ! rtpvrawdepay2 on card RGBA frames: one device-to-host
    copy a frame at the payloader, one host-to-device copy a frame at the
    depayloader's marker (torch.profiler), the frames back on the card bit
    for bit, and the packets of the same frames on the host."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(26)
    frames = [torch.randint(0, 256, (48, 64, 4), generator=gen, device="cuda",
                            dtype=torch.uint8) for _ in range(4)]

    def run(bufs, depay=True):
        p = g.parse_launch("appsrc name=src ! rtpvrawpay2 mtu=600 ssrc=1 timestamp-offset=0 "
                           f"seqnum-offset=0 {'! rtpvrawdepay2 ' if depay else ''}! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            "video/x-raw,format=RGBA,width=64,height=48,framerate=30/1"))
        for i, b in enumerate(bufs):
            p.by_name("src").push_buffer(g.Buffer(b, pts=i * 33_333_333, duration=33_333_333))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return [s.buffer.data for s in p.by_name("sink").samples]

    run(frames)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run(frames)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dtoh = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    htod = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
    assert (dtoh, htod) == (len(frames), len(frames))
    assert all(o.device.type == "cuda" and torch.equal(o, f) for o, f in zip(out, frames))
    packets = [np.asarray(d).tobytes() for d in run(frames, depay=False)]
    g.set_device("cpu")
    try:
        assert packets == [np.asarray(d).tobytes() for d in run([f.cpu() for f in frames],
                                                                depay=False)]
    finally:
        g.set_device("cuda")


@pytest.mark.cuda
def test_l24_payloader_reads_each_card_buffer_back_once(cuda):
    """rtpL24pay2 ! rtpL24depay2 on card S24 samples (int32): one
    device-to-host copy a buffer at the payloader, none after, the samples
    back bit for bit."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(27)
    audio = [torch.randint(-(1 << 23), 1 << 23, (1920, 2), generator=gen, device="cuda",
                           dtype=torch.int32) for _ in range(6)]

    def run():
        p = g.parse_launch("appsrc name=src ! rtpL24pay2 mtu=1400 ssrc=1 timestamp-offset=0 "
                           "seqnum-offset=0 ! rtpL24depay2 ! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            "audio/x-raw,format=S24,rate=192000,channels=2,layout=interleaved"))
        for i, b in enumerate(audio):
            p.by_name("src").push_buffer(g.Buffer(b, pts=i * 10_000_000, duration=10_000_000))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return np.concatenate([np.asarray(s.buffer.data) for s in p.by_name("sink").samples])

    run()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dtoh = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    htod = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
    assert (dtoh, htod) == (len(audio), 0)
    np.testing.assert_array_equal(got, torch.cat(audio).cpu().numpy())


def _image_pipeline(g, launch, caps, bufs):
    p = g.parse_launch(f"appsrc name=src ! {launch} ! appsink name=sink")
    p.by_name("src").set_property("caps", g.parse_caps(caps))
    for b in bufs:
        p.by_name("src").push_buffer(g.Buffer(b))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return [s.buffer.data for s in p.by_name("sink").samples]


def _seeded_rgba(seed, h=72, w=96):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    f = np.stack([(x * 3 + y * (k + 1) + 50 * k) % 256 for k in range(4)], -1)
    f = (f + rng.integers(0, 6, f.shape)).clip(0, 255).astype(np.uint8)
    f[..., 3] = 255
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("props", ["offset-x=-10 offset-y=-5 alpha=0.8",
                                   "offset-x=-50 offset-y=60 alpha=0.35",
                                   "positioning-mode=pixels-absolute offset-x=70 offset-y=-6"])
def test_imagersoverlay_on_card_within_one_lsb_of_cpu(cuda, tmp_path, props):
    """imagersoverlay on card frames against the same element on the CPU:
    within 1 u8 LSB (the composite is the same f32 blend; the placed alpha is
    a true division on both), over offsets cropped at each side."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.elements.image.codecs import pillow

    logo = np.random.default_rng(5).integers(0, 256, (30, 40, 4), dtype=np.uint8)
    path = tmp_path / "logo.png"
    pillow().fromarray(logo, "RGBA").save(path)
    frames = [_seeded_rgba(s) for s in range(3)]
    launch = f"imagersoverlay location={path} {props}"
    caps = "video/x-raw,format=RGBA,width=96,height=72,framerate=30/1"
    card = _image_pipeline(g, launch, caps, [torch.from_numpy(f).cuda() for f in frames])
    g.set_device("cpu")
    try:
        host = _image_pipeline(g, launch, caps, [torch.from_numpy(f) for f in frames])
    finally:
        g.set_device("cuda")
    assert all(c.device.type == "cuda" for c in card)
    for c, h in zip(card, host):
        assert (c.cpu().to(torch.int16) - h.to(torch.int16)).abs().max() <= 1


@pytest.mark.cuda
def test_imagersdec_uploads_and_rspngenc_reads_back_once_an_image(cuda):
    """A PNG through imagersdec: one host-to-device copy an image, the frame
    on the card; card frames through rspngenc: one device-to-host copy an
    image, the PNG bytes equal to the same element's on the CPU
    (torch.profiler)."""
    import gst_plugins_rs_tpu_torch as g
    from torch.profiler import ProfilerActivity, profile

    frames = [_seeded_rgba(10 + s) for s in range(3)]
    caps = "video/x-raw,format=RGBA,width=96,height=72,framerate=30/1"
    g.set_device("cpu")
    try:
        pngs = [np.asarray(d).tobytes() for d in _image_pipeline(
            g, "rspngenc", caps, [torch.from_numpy(f) for f in frames])]
    finally:
        g.set_device("cuda")

    def decode(data):
        return _image_pipeline(g, "imagersdec", "image/png",
                               [np.frombuffer(data, np.uint8).copy()])[0]

    decode(pngs[0])  # warm
    card = [torch.from_numpy(f).cuda() for f in frames]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = [decode(p) for p in pngs]
        torch.cuda.synchronize()
    events = prof.key_averages()
    htod = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
    dtoh = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    assert (htod, dtoh) == (len(pngs), 0)
    assert all(x.device.type == "cuda" and torch.equal(x, c) for x, c in zip(got, card))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = _image_pipeline(g, "rspngenc", caps, card)
        torch.cuda.synchronize()
    events = prof.key_averages()
    htod = sum(e.count for e in events if e.key.startswith("Memcpy HtoD"))
    dtoh = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    assert (dtoh, htod) == (len(card), 0)
    assert [np.asarray(d).tobytes() for d in out] == pngs


def _profiled_copies(run, host_calls=False):
    """(run's result, Memcpy DtoH, Memcpy HtoD[, the host's synchronising
    CUDA calls]) over one call of run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_calls else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        got = run()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    counts = [sum(e.count for e in ev if e.key.startswith(k))
              for k in ("Memcpy DtoH", "Memcpy HtoD")]
    if host_calls:
        counts.append(sum(e.count for e in ev if e.key in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaStreamQuery", "cudaEventQuery")))
    return (got, *counts)


def _sink_files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.cuda
def test_hls_and_dash_sinks_read_each_card_frame_back_once(cuda, tmp_path):
    """hlscmafsink and dashsink2 on card frames: one device-to-host copy a
    frame a sink (their embedded muxers' to_sample; the sinks write the
    muxers' host bytes as they are), and the same files as from the same
    frames on the host."""
    import sys
    from pathlib import Path

    import gst_plugins_rs_tpu_torch as g

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    frames = [torch.from_numpy(_seeded_rgba(30 + i)).cuda() for i in range(4)]
    chip_smoke.origin_run(g, tmp_path / "warm", frames, fps=2)
    _, dtoh, htod = _profiled_copies(
        lambda: chip_smoke.origin_run(g, tmp_path / "card", frames, fps=2))
    assert (dtoh, htod) == (2 * len(frames), 0)
    chip_smoke.origin_run(g, tmp_path / "host", [f.cpu() for f in frames], fps=2)
    card, host = _sink_files(tmp_path / "card"), _sink_files(tmp_path / "host")
    assert card == host and sum(k.endswith(".m4s") for k in card) == 4


@pytest.mark.cuda
def test_icecastsink_reads_each_card_buffer_back_once(cuda):
    """icecastsink on u8 buffers on the card: one device-to-host copy a
    buffer (core/payload.py's host_bytes), the body the buffers' bytes."""
    import socket
    import threading

    import gst_plugins_rs_tpu_torch as g

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    body = []

    def serve():
        conn, _ = srv.accept()
        data = b""
        while b"\r\n\r\n" not in data:
            data += conn.recv(4096)
        conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
        rest = data.partition(b"\r\n\r\n")[2]
        conn.settimeout(1.0)
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                rest += chunk
        except socket.timeout:
            pass
        body.append(rest)
        conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    gen = torch.Generator(device="cuda").manual_seed(5)
    bufs = [torch.randint(0, 256, (4096,), generator=gen, device="cuda", dtype=torch.uint8)
            for _ in range(5)]

    def run():
        p = g.parse_launch(f"appsrc name=src ! icecastsink port={srv.getsockname()[1]}")
        p.by_name("src").set_property("caps", g.parse_caps("application/ogg"))
        for b in bufs:
            p.by_name("src").push_buffer(g.Buffer(b))
        p.by_name("src").end_of_stream()
        p.play_until_eos()

    _, dtoh, _ = _profiled_copies(run)
    t.join(5)
    srv.close()
    assert dtoh == len(bufs)
    assert body == [b"".join(b.cpu().numpy().tobytes() for b in bufs)]


@pytest.mark.cuda
def test_tracers_read_nothing_back_and_wait_on_nothing(cuda, tmp_path, monkeypatch):
    """Every tracer of GSTPU_TRACERS on a pipeline of card frames: the same
    device-to-host copies and host synchronising calls as without them
    (torch.profiler), and memory-tracer counts the frames' bytes."""
    import gst_plugins_rs_tpu_torch as g

    frames = [torch.from_numpy(_seeded_rgba(40 + i)).cuda() for i in range(6)]
    spec = ";".join(f"{n}(file={tmp_path / n}.out)" for n in (
        "pad-push-timings", "queue-levels", "buffer-lateness", "memory-tracer",
        "chrome-tracer", "perfetto-tracer", "fmt-tracer")) + ";py-tracing;pipeline-snapshot"

    def run(traced):
        if traced:
            monkeypatch.setenv("GSTPU_TRACERS", spec)
        else:
            monkeypatch.delenv("GSTPU_TRACERS", raising=False)
        p = g.parse_launch("appsrc name=src ! hsvfilter name=hsv hue-shift=30 "
                           "! videoflip method=rotate-180 ! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            "video/x-raw,format=RGBA,width=96,height=72,framerate=30/1"))
        for i, f in enumerate(frames):
            p.by_name("src").push_buffer(g.Buffer(f, pts=i * 33_333_333, duration=33_333_333))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        for t in p.tracers:
            t.close()
        return len(p.tracers)

    run(False)  # warm
    plain = _profiled_copies(lambda: run(False), host_calls=True)
    traced = _profiled_copies(lambda: run(True), host_calls=True)
    assert (plain[0], traced[0]) == (0, 9)
    assert traced[1:] == plain[1:]
    rows = (tmp_path / "memory-tracer.out").read_text().splitlines()
    assert f"hsv,6,{6 * 96 * 72 * 4}" in rows


@pytest.mark.cuda
def test_validate_reads_the_last_card_frame_back_once(cuda):
    """check-last-frame-qrcode on card frames: one device-to-host copy, of
    the last frame, at the end of the run."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.codecs import qr
    from gst_plugins_rs_tpu_torch.utils import validate

    img = qr.rasterize(qr.encode('{"seed": 1}'), module_px=4)
    page = np.full((120, 160, 3), 255, np.uint8)
    page[:img.shape[0], :img.shape[1]] = img[..., None]
    frames = [torch.zeros((120, 160, 3), dtype=torch.uint8, device="cuda")] * 3 + [
        torch.from_numpy(page).cuda()]
    p = g.parse_launch("appsrc name=src ! appsink name=sink")
    p.by_name("src").set_property("caps", g.parse_caps(
        "video/x-raw,format=RGB,width=160,height=120,framerate=1/1"))
    for f in frames:
        p.by_name("src").push_buffer(g.Buffer(f))
    p.by_name("src").end_of_stream()
    _, dtoh, htod = _profiled_copies(p.play_until_eos)
    assert (dtoh, htod) == (0, 0)
    got, dtoh, htod = _profiled_copies(lambda: validate.run_action(
        "check-last-frame-qrcode", p, expected_fields={"seed": 1}))
    assert (got, dtoh, htod) == ('{"seed": 1}', 1, 0)


def _smoke():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


@pytest.mark.cuda
def test_rtpjpegdepay2_into_imagersdec_uploads_each_frame_once(cuda):
    """The WHIP ingest's media leg: JPEGs through rtpjpegpay2 ! rtpjpegdepay2
    (host bytes), each then through imagersdec: one host-to-device copy a
    frame, none back, and the frames on cuda:0 equal to the host decode."""
    import gst_plugins_rs_tpu_torch as g

    cs = _smoke()
    jpegs = [cs.jpeg_of(f) for f in cs.camera_frames(3, size=64, seed=31)]
    carried = cs.rfc2435_jpegs(g, jpegs)

    def run():
        return [cs.decode_images(g, data, caps="image/jpeg")[0] for data in carried]

    run()  # warm
    frames, dtoh, htod = _profiled_copies(run)
    assert (dtoh, htod) == (0, len(jpegs))
    assert all(f.device == torch.device("cuda", 0) for f in frames)
    assert all(np.array_equal(f.cpu().numpy(), cs.jpeg_pixels(j)) for f, j in zip(frames, jpegs))


@pytest.mark.cuda
def test_webrtcsink_l16_chain_reads_each_card_buffer_back_once(cuda):
    """webrtcsink on card S16 audio builds its rtpL16pay2 chain: one
    device-to-host copy a buffer, in the payloader (none in the stack), and
    the packets of the same audio on the host."""
    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.net.webrtc_signalling import SignallingServer

    gen = torch.Generator(device="cuda").manual_seed(27)
    audio = [torch.randint(-32768, 32768, (4800, 1), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.int16) for _ in range(6)]
    server = SignallingServer()

    def run(bufs):
        p = g.parse_launch(f"appsrc name=src ! webrtcsink name=tx signaller-uri={server.uri}")
        p.by_name("src").set_property("caps", g.parse_caps(
            "audio/x-raw,format=S16,rate=48000,channels=1,layout=interleaved"))
        tx, packets = p.by_name("tx"), []
        send = tx._send_rtp_buffer
        tx._send_rtp_buffer = lambda buf: (packets.append(np.asarray(buf.data).tobytes()),
                                           send(buf))[1]
        for i, b in enumerate(bufs):
            p.by_name("src").push_buffer(g.Buffer(b, pts=i * 100_000_000))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        return packets

    try:
        run(audio)  # warm
        packets, dtoh, htod = _profiled_copies(lambda: run(audio))
        assert (dtoh, htod) == (len(audio), 0) and len(packets) > len(audio)
        g.set_device("cpu")
        try:
            assert packets == run([a.cpu() for a in audio])
        finally:
            g.set_device("cuda")
    finally:
        server.stop()


@pytest.mark.cuda
def test_received_l16_reaches_audioloudnorm_on_the_card(cuda):
    """The voice consumer's chain after webrtcsrc: L16 packets through
    rtpL16depay2 (host samples) ! audioconvert ! audioresample !
    audioconvert ! audioloudnorm: one host-to-device copy a packet beyond
    the same chain fed the samples on the card, every buffer at
    audioloudnorm's sink pad on cuda:0, L1 launched once a 100 ms output
    frame, the output within 5r's gate of the same chain on the CPU."""
    from types import SimpleNamespace

    import gst_plugins_rs_tpu_torch as g
    from gst_plugins_rs_tpu_torch.ops import loudnorm_limiter

    cs = _smoke()
    # 5 s: a stream shorter than audioloudnorm's 3 s lookahead ends without L1
    voice = (cs.noisy_voice(5, seed=41) * 32767).astype(np.int16)
    g.set_device("cpu")
    try:
        p = g.parse_launch("appsrc name=src ! rtpL16pay2 ssrc=1 timestamp-offset=0 "
                           "seqnum-offset=0 ! appsink name=sink")
        p.by_name("src").set_property("caps", g.parse_caps(
            "audio/x-raw,format=S16,rate=48000,channels=1,layout=interleaved"))
        for i in range(0, len(voice), 4800):
            p.by_name("src").push_buffer(g.Buffer(voice[i:i + 4800], pts=i * 10**9 // 48000))
        p.by_name("src").end_of_stream()
        p.play_until_eos()
        packets = [np.asarray(s.buffer.data).tobytes() for s in p.by_name("sink").samples]
    finally:
        g.set_device("cuda")

    def run():
        q = g.parse_launch(f"appsrc name=src ! {cs.VOICE_CONSUMER}")
        q.by_name("src").set_property("caps", g.parse_caps(
            "application/x-rtp,media=audio,payload=96,encoding-name=L16,clock-rate=48000"))
        tap = cs.BufferTrace("up:sink", "norm:sink")
        q.add_tracer(tap)
        for pkt in packets:
            q.by_name("src").push_buffer(g.Buffer(np.frombuffer(pkt, np.uint8).copy()))
        q.by_name("src").end_of_stream()
        q.play_until_eos()
        return tap.seen, [s.buffer for s in q.by_name("sink").samples]

    seen, _ = run()  # warm
    on_card = [SimpleNamespace(data=torch.from_numpy(np.asarray(b.data)).cuda(), pts=b.pts,
                               duration=b.duration) for b in seen["up:sink"]]
    cs.voice_plain(g, on_card)  # warm

    def counted():
        loudnorm_limiter.launches = 0
        return run(), loudnorm_limiter.launches

    # sessions that hold both marker kernels (chip_smoke._profiled, ROADMAP C.3)
    ((seen, out), launches), dtoh, htod = cs._profiled(counted, htod=True)
    out = cs._samples(out)
    _, plain_dtoh, plain_htod = cs._profiled(lambda: cs.voice_plain(g, on_card), htod=True)
    assert len(seen["up:sink"]) == len(packets)
    assert (htod - plain_htod, dtoh - plain_dtoh) == (len(packets), 0)
    assert seen["norm:sink"] and all(b.data.device == torch.device("cuda", 0)
                                     for b in seen["norm:sink"])
    assert launches == -(-out.shape[0] // cs.LN_FRAME)
    g.set_device("cpu")
    try:
        ref = cs._samples(run()[1])
    finally:
        g.set_device("cuda")
    assert out.shape == ref.shape and float(np.abs(out - ref).max()) <= cs.LOUDNORM_GATE
