"""Chain fusion of the PyTorch port (parallel/fuse.py) against the JAX package,
on the CPU.

The mirror of tests/test_fuse.py, plus the comparison with the JAX package's
fused pipelines and a run over frames that differ from buffer to buffer.  On
the CPU the port's fused callable runs the kernels eagerly, one after
another; on the card it replays one CUDA graph per input signature
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 4j).

Tolerances:
- port fused vs port unfused: bit-equal on every buffer (the same kernels on
  the same frames);
- port fused vs JAX fused: <= 1 u8 LSB where hsvfilter is in the run (the
  port runs B4, the JAX element the XLA op; u8 truncation boundaries depend
  on the order of f32 operations, the gate of tests/test_torch_hsv.py),
  otherwise bit-equal (layout ops, nearest scaling with one-hot matrices,
  channel repacks and the exact LUT);
- hsvfilter ! colorlut precision=approx, port fused vs JAX fused: <= 2 u8
  LSB, the sum of the two elements' gates: hsvfilter's 1 LSB enters a LUT of
  slope <= 1 (the test's channel swap), and B2 against the JAX package's B3
  chain is held to 1 LSB (tests/test_torch_colorlut.py).
"""
import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as jfx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.parallel.fuse import fusable_runs as jruns
from gst_plugins_rs_tpu.parallel.fuse import fuse_pipeline as jfuse
from gst_plugins_rs_tpu_torch.parallel.fuse import fusable_runs, fuse, fuse_pipeline

LUT = """LUT_3D_SIZE 2
0 0 0
0 0 1
0 1 0
0 1 1
1 0 0
1 0 1
1 1 0
1 1 1
"""
HSV_LSB = 1
HSV_APPROX_LSB = 2


@pytest.fixture(autouse=True)
def _on_cpu():
    prev = tfx.requested_device()
    tfx.set_device("cpu")
    yield
    tfx.set_device(prev)


def _desc(tmp_path):
    loc = tmp_path / "swap.cube"
    loc.write_text(LUT)
    return ("videotestsrc pattern=smpte num-buffers=3 "
            "! video/x-raw,format=RGBA,width=320,height=180 "
            f"! hsvfilter hue-shift=120 ! colorlut location={loc} ! appsink name=sink")


MIXED = ("videotestsrc pattern=smpte num-buffers=2 "
         "! video/x-raw,format=RGB,width=128,height=64 "
         "! hsvfilter hue-shift=90 "
         "! videoscale method=nearest ! video/x-raw,format=RGB,width=64,height=32 "
         "! videoflip method=rotate-180 ! appsink name=sink")


def _frames(p):
    return [np.asarray(s.buffer.data) for s in p.by_name("sink").samples]


def _play(pkg, desc, fused):
    p = pkg.parse_launch(desc)
    n = (jfuse if pkg is jfx else fuse_pipeline)(p) if fused else None
    p.play_until_eos()
    return n, _frames(p)


def _max_lsb(a, b):
    return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def _check(desc, n_runs, n_frames, lsb):
    """The port's fused pipeline: `n_runs` runs, `n_frames` buffers, each
    bit-equal to the unfused pipeline's and within `lsb` of the JAX
    package's fused pipeline."""
    _, ref = _play(tfx, desc, fused=False)
    n, got = _play(tfx, desc, fused=True)
    jn, jgot = _play(jfx, desc, fused=True)
    assert n == jn == n_runs
    assert len(got) == len(ref) == len(jgot) == n_frames
    for g, r, j in zip(got, ref, jgot):
        np.testing.assert_array_equal(g, r)
        assert g.shape == j.shape and g.dtype == j.dtype
        assert _max_lsb(g, j) <= lsb
    return got


def test_fused_matches_unfused(tmp_path):
    _check(_desc(tmp_path), 1, 3, HSV_LSB)


def test_fusable_run_detection(tmp_path):
    p = tfx.parse_launch(_desc(tmp_path))
    runs = fusable_runs(p)
    assert len(runs) == 1
    assert [e.ELEMENT_NAME for e in runs[0]] == ["hsvfilter", "colorlut"]


def test_no_fuse_single_element():
    p = tfx.parse_launch(
        "videotestsrc num-buffers=1 ! video/x-raw,format=RGB,width=64,height=64 "
        "! hsvfilter ! appsink name=sink")
    assert fuse_pipeline(p) == 0
    p.play_until_eos()
    assert len(p.by_name("sink").samples) == 1


def test_mixed_chain_with_scaler_and_flip_fuses():
    """hsvfilter + videoscale + videoflip compose into one run (the interior
    capsfilter rides along as an identity kernel) and match the unfused
    pipeline bit for bit."""
    p = tfx.parse_launch(MIXED)
    assert [e.ELEMENT_NAME for e in fusable_runs(p)[0]] == [
        "hsvfilter", "videoscale", "capsfilter", "videoflip"]
    got = _check(MIXED, 1, 2, HSV_LSB)
    assert got[0].shape == (32, 64, 3)


@pytest.mark.parametrize("desc", [
    pytest.param("videotestsrc num-buffers=1 ! video/x-raw,format=RGBA,width=32,height=16 "
                 "! identity ! hsvfilter ! identity ! colorlut location={lut} ! identity "
                 "! appsink name=sink", id="identity-ends-trimmed"),
    pytest.param(MIXED, id="mixed"),
    pytest.param("videotestsrc num-buffers=1 ! video/x-raw,format=RGB,width=32,height=16 "
                 "! videoconvert ! video/x-raw,format=BGRx ! hsvfilter ! videoflip "
                 "method=clockwise ! queue ! videoscale ! video/x-raw,width=8,height=8 "
                 "! videoflip ! appsink name=sink", id="two-runs-split-by-queue"),
])
def test_fusable_runs_match_jax(tmp_path, desc):
    """fusable_runs finds the same runs as the JAX package's."""
    loc = tmp_path / "swap.cube"
    loc.write_text(LUT)
    desc = desc.format(lut=loc)

    def runs(pkg, find):
        p = pkg.parse_launch(desc)
        # element names carry per-package counters: compare places and kinds
        return [[(p.elements.index(e), e.ELEMENT_NAME) for e in run] for run in find(p)]

    got = runs(tfx, fusable_runs)
    assert got == runs(jfx, jruns)
    assert got


def test_fused_layout_chain_matches_jax_bit_for_bit():
    """A run without hsvfilter (channel repack, nearest scaling, flips) is
    bit-equal to the JAX package's fused run."""
    desc = ("videotestsrc pattern=smpte num-buffers=2 "
            "! video/x-raw,format=RGB,width=96,height=48 "
            "! videoconvert ! video/x-raw,format=BGRx "
            "! videoscale method=nearest ! video/x-raw,width=48,height=24 "
            "! videoflip method=upper-right-diagonal ! appsink name=sink")
    got = _check(desc, 1, 2, 0)
    assert got[0].shape == (48, 24, 4)


def _appsrc_run(pkg, desc, frames, fused, fmt="RGBA"):
    p = pkg.parse_launch(desc)
    n = (jfuse if pkg is jfx else fuse_pipeline)(p) if fused else None
    src = p.by_name("src")
    h, w = (frames[0][0] if isinstance(frames[0], tuple) else frames[0]).shape[:2]
    src.set_property("caps", pkg.parse_caps(
        f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"))

    def payload(f):
        if pkg is not tfx:
            return f
        return tuple(map(torch.from_numpy, f)) if isinstance(f, tuple) else torch.from_numpy(f)

    for i, f in enumerate(frames):
        src.push_buffer(pkg.Buffer(payload(f), pts=i * 33_333_333, duration=33_333_333))
    src.end_of_stream()
    p.play_until_eos()
    return n, p.by_name("sink").samples


@pytest.mark.parametrize("precision", ["exact", "approx"])
def test_fused_differing_frames_every_buffer(tmp_path, precision):
    """Seeded frames that differ from one another through appsrc: every
    buffer of the fused run equals the unfused pipeline's, keeps its PTS,
    and is within the module's gates of the JAX package's fused run."""
    loc = tmp_path / "swap.cube"
    loc.write_text(LUT)
    desc = (f"appsrc name=src ! hsvfilter hue-shift=120 ! colorlut location={loc} "
            f"precision={precision} ! appsink name=sink")
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 256, (24, 40, 4)).astype(np.uint8) for _ in range(5)]
    _, ref = _appsrc_run(tfx, desc, frames, fused=False)
    n, got = _appsrc_run(tfx, desc, frames, fused=True)
    jn, jgot = _appsrc_run(jfx, desc, frames, fused=True)
    assert n == jn == 1
    assert len(got) == len(ref) == len(jgot) == len(frames)
    outs = [np.asarray(s.buffer.data) for s in got]
    for i, (g, r, j) in enumerate(zip(outs, ref, jgot)):
        np.testing.assert_array_equal(g, np.asarray(r.buffer.data), err_msg=f"buffer {i}")
        assert got[i].buffer.pts == r.buffer.pts == i * 33_333_333
        lsb = HSV_LSB if precision == "exact" else HSV_APPROX_LSB
        assert _max_lsb(g, np.asarray(j.buffer.data)) <= lsb, f"buffer {i}"
    assert all(_max_lsb(a, b) > 0 for a, b in zip(outs, outs[1:]))  # the frames differ


def test_fused_planar_passthrough_every_buffer():
    """I420 -> NV12 at the same size: the scaler is the identity and the
    converter hands its Y plane on, so one output plane of the run is an
    input plane.  Every buffer equals the unfused pipeline's and, bit for
    bit, the JAX package's fused run."""
    desc = "appsrc name=src ! videoscale ! videoconvert ! video/x-raw,format=NV12 ! appsink name=sink"
    rng = np.random.RandomState(6)
    frames = [tuple(rng.randint(0, 256, s).astype(np.uint8) for s in ((24, 40), (12, 20), (12, 20)))
              for _ in range(4)]
    _, ref = _appsrc_run(tfx, desc, frames, fused=False, fmt="I420")
    n, got = _appsrc_run(tfx, desc, frames, fused=True, fmt="I420")
    jn, jgot = _appsrc_run(jfx, desc, frames, fused=True, fmt="I420")
    assert n == jn == 1
    assert len(got) == len(ref) == len(jgot) == len(frames)
    for i, (g, r, j) in enumerate(zip(got, ref, jgot)):
        planes = [tuple(np.asarray(q) for q in x.buffer.data) for x in (g, r, j)]
        assert [len(x) for x in planes] == [2, 2, 2], f"buffer {i}"
        for pg, pr, pj in zip(*planes):
            np.testing.assert_array_equal(pg, pr, err_msg=f"buffer {i}")
            np.testing.assert_array_equal(pg, pj, err_msg=f"buffer {i}")
        np.testing.assert_array_equal(planes[0][0], frames[i][0])


def test_capture_notes_only_its_own_threads_launches():
    """A capturing thread notes the launches it counts itself; a launch that
    another thread counts meanwhile goes to the counter alone."""
    import threading

    from gst_plugins_rs_tpu_torch.ops import count_launch, hsv_planes, noting_launches

    before = hsv_planes.launches
    other = threading.Thread(target=count_launch, args=(hsv_planes.__name__, "launches"))
    with noting_launches() as noted:
        count_launch(hsv_planes.__name__, "launches")
        other.start()
        other.join()
        with noting_launches() as inner:
            count_launch(hsv_planes.__name__, "launches")
    hsv_planes.launches = before
    assert noted == [(hsv_planes.__name__, "launches")]
    assert inner == [(hsv_planes.__name__, "launches")]


def test_fuse_needs_pure_kernels():
    with pytest.raises(TypeError, match="pure_kernel"):
        fuse([tfx.element_factory_make("volume")])
