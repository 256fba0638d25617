"""The port's image elements against the JAX package's.

tests/test_image_flv.py's image codec, imagersoverlay and CD+G classes run on
the port with the same inputs and the same assertions (its FLV demuxer
cases run in tests/test_torch_g711.py).  Then, on seeded input, from numpy
and from tensor payloads: rspngenc and gifenc write the JAX elements'
bytes; imagersdec, gifdec and rswebpdec decode the JAX elements' frames
(gifdec's later frames carry alpha 255 where the JAX decoder hands on
3-channel frames under RGBA caps); imagersoverlay is within 1 u8 LSB of the
JAX element over each offset sign and alpha; cdgdec renders the JAX
element's frames from chip_smoke.py's seeded CD+G stream; the smoke's
stills, GIF and CD+G paths run end to end at a small size; and neither
importing the port nor running cea608overlay loads Pillow."""
import io
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import mirror_jax_tests, port_on_cpu, run_launch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


FLV = "tests/test_torch_g711.py (rsflvdemux)"
MIRRORED = mirror_jax_tests("test_image_flv.py", globals(), skip={"TestFlvDemux": FLV})


def _caps(fmt, w, h):
    return f"video/x-raw,format={fmt},width={w},height={h},framerate=10/1"


def _frames(n, fmt="RGBA", w=48, h=32, seed=0):
    """Seeded smooth frames with grain (so a GIF palette has work to do)."""
    rng = np.random.default_rng(seed)
    c = {"RGBA": 4, "RGB": 3}[fmt]
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        f = (np.stack([(x * 5 + y * (k + 1) + 20 * i + 40 * k) % 256 for k in range(c)], -1)
             + rng.integers(0, 4, (h, w, c))).clip(0, 255).astype(np.uint8)
        if c == 4:
            f[..., 3] = 255
        out.append(f)
    return out


def _bufs(frames, tensor):
    return [dict(data=torch.from_numpy(f.copy()) if tensor else f, pts=i * 10**8,
                 duration=10**8) for i, f in enumerate(frames)]


def _enc(pkg, launch, frames, fmt, tensor=False):
    h, w = frames[0].shape[:2]
    samples, msgs = run_launch(pkg, f"appsrc name=src ! {launch} ! appsink name=sink",
                               _bufs(frames, tensor and pkg is tfx), caps=_caps(fmt, w, h))
    return samples, msgs


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("fmt,level", [("RGBA", 6), ("RGB", 6), ("RGBA", 1)])
def test_rspngenc_bytes_equal_jax(fmt, level, payload):
    frames = _frames(3, fmt, seed=level)
    launch = f"rspngenc compression-level={level}"
    assert _enc(tfx, launch, frames, fmt, payload == "torch") == _enc(fx, launch, frames, fmt)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("props", ["repeat=0", "repeat=-1 speed=20", "repeat=3"])
def test_gifenc_bytes_equal_jax(props, payload):
    frames = _frames(5, "RGBA", seed=7)
    ref = _enc(fx, f"gifenc {props}", frames, "RGBA")
    assert len(ref[0]) == 1
    assert _enc(tfx, f"gifenc {props}", frames, "RGBA", payload == "torch") == ref


def _decode(pkg, factory, caps, data, tensor=False, chunk=1000):
    chunks = [np.frombuffer(data[i:i + chunk], np.uint8).copy() for i in range(0, len(data), chunk)]
    p = pkg.parse_launch(f"appsrc name=src ! {factory} ! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(caps))
    for c in chunks:
        p.by_name("src").push_buffer(pkg.Buffer(torch.from_numpy(c) if tensor else c))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    sink = p.by_name("sink")
    return [s.buffer for s in sink.samples], sink.caps.structure(0).fields


def _pil_bytes(frame, fmt, **params):
    from PIL import Image

    bio = io.BytesIO()
    Image.fromarray(frame).save(bio, fmt, **params)
    return bio.getvalue()


STILLS = [("imagersdec", "image/png", "PNG", {}, "RGB"),
          ("imagersdec", "image/png", "PNG", {}, "RGBA"),
          ("imagersdec", "image/jpeg", "JPEG", {"quality": 90}, "RGB"),
          ("imagersdec", "image/bmp", "BMP", {}, "RGB"),
          ("rswebpdec", "image/webp", "WEBP", {"lossless": True}, "RGB"),
          ("rswebpdec", "image/webp", "WEBP", {"quality": 80}, "RGBA")]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("factory,caps,fmt,params,mode", STILLS,
                         ids=[f"{s[0]}-{s[2]}-{s[4]}" for s in STILLS])
def test_still_decoders_match_jax(factory, caps, fmt, params, mode, payload):
    """The same frames, timestamps and caps as the JAX element; the port's
    frame lies on the selected device."""
    data = _pil_bytes(_frames(1, mode, 40, 24, seed=3)[0], fmt, **params)
    got, gcaps = _decode(tfx, factory, caps, data, payload == "torch")
    ref, rcaps = _decode(fx, factory, caps, data)
    assert len(got) == len(ref) == 1 and gcaps == rcaps
    assert isinstance(got[0].data, torch.Tensor) and got[0].data.device.type == "cpu"
    assert np.array_equal(got[0].data.numpy(), np.asarray(ref[0].data))
    assert (got[0].pts, got[0].duration) == (ref[0].pts, ref[0].duration)


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("loop", [None, 0, 2])
def test_gifdec_matches_jax(loop, payload):
    """The same frames (RGB equal; the JAX decoder's 3-channel frames after
    the first carry alpha 255 here, in the format of the caps), timestamps
    and caps, the file's repeat count played as in the JAX element."""
    from PIL import Image

    frames = [Image.fromarray(f) for f in _frames(4, "RGBA", seed=11)]
    bio = io.BytesIO()
    kw = {} if loop is None else {"loop": loop}
    frames[0].save(bio, "GIF", save_all=True, append_images=frames[1:],
                   duration=[40, 80, 120, 160], **kw)
    got, gcaps = _decode(tfx, "gifdec", "image/gif", bio.getvalue(), payload == "torch")
    ref, rcaps = _decode(fx, "gifdec", "image/gif", bio.getvalue())
    assert len(got) == len(ref) == 4 * (1 + (loop or 0)) and gcaps == rcaps
    assert rcaps["format"] == "RGBA"
    for g, r in zip(got, ref):
        a, b = g.data.numpy(), np.asarray(r.data)
        assert a.shape[-1] == 4 and np.array_equal(a[..., :b.shape[-1]], b)
        if b.shape[-1] == 3:
            assert (a[..., 3] == 255).all()
        assert (g.pts, g.duration) == (r.pts, r.duration)


def _overlay_run(pkg, frames, props, logo, fmt, tensor=False):
    h, w = frames[0].shape[:2]
    p = pkg.parse_launch(f"appsrc name=src ! imagersoverlay location={logo} {props} "
                         f"! appsink name=sink")
    p.by_name("src").set_property("caps", pkg.parse_caps(_caps(fmt, w, h)))
    for f in frames:
        p.by_name("src").push_buffer(pkg.Buffer(torch.from_numpy(f.copy()) if tensor else f))
    p.by_name("src").end_of_stream()
    p.play_until_eos()
    return [s.buffer.data for s in p.by_name("sink").samples]


OVERLAYS = ["offset-x=5 offset-y=3", "offset-x=-7 offset-y=-2 alpha=0.6",
            "offset-x=-40 offset-y=20 alpha=0.35", "offset-x=30 offset-y=-25 alpha=0.8",
            "positioning-mode=pixels-absolute offset-x=-6 offset-y=-4 relative-x=0.25 coef-y=0.1",
            "overlay-width=20 overlay-height=9 relative-y=-0.1 offset-x=-3"]


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("fmt", ["RGBA", "RGB"])
@pytest.mark.parametrize("props", OVERLAYS)
def test_overlay_within_one_lsb_of_jax(tmp_path, props, fmt, payload):
    """Each offset sign (from the edges and absolute, cropped at every
    side), global alpha and scaling: within 1 u8 LSB of the JAX element,
    the port's frames on the selected device."""
    from PIL import Image

    rng = np.random.default_rng(len(props))
    logo = rng.integers(0, 256, (14, 23, 4), dtype=np.uint8)
    logo[:3, :, 3] = 0
    path = tmp_path / "logo.png"
    Image.fromarray(logo, "RGBA").save(path)
    frames = _frames(3, fmt, 48, 32, seed=2)
    got = _overlay_run(tfx, frames, props, path, fmt, payload == "torch")
    ref = _overlay_run(fx, frames, props, path, fmt)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        d = np.abs(g.numpy().astype(int) - np.asarray(r).astype(int))
        assert d.max() <= 1
    assert not np.array_equal(got[0].numpy(), frames[0])


def test_overlay_rejects_a_frame_on_another_device(tmp_path):
    from PIL import Image

    from gst_plugins_rs_tpu_torch.core import Buffer
    from gst_plugins_rs_tpu_torch.elements.image.overlay import ImageOverlay

    path = tmp_path / "logo.png"
    Image.fromarray(np.full((4, 4, 4), 200, np.uint8), "RGBA").save(path)
    ov = ImageOverlay()
    ov.set_property("location", str(path))
    ov.start()
    ov._image = ov._image.to("meta")  # the overlay placed on another device
    with pytest.raises(ValueError, match="overlay on meta"):
        ov.transform(Buffer(torch.zeros((8, 8, 4), dtype=torch.uint8)))


@pytest.mark.parametrize("payload", ["numpy", "torch"])
def test_cdg_matches_jax(payload):
    """chip_smoke.py's seeded CD+G stream (2 s): cdgparse ! cdgdec renders
    the JAX elements' frames with their timestamps."""
    data = chip_smoke.cdg_stream(seconds=2)
    chunks = [np.frombuffer(data[i:i + 4800], np.uint8).copy()
              for i in range(0, len(data), 4800)]
    launch = "appsrc name=src ! cdgparse ! cdgdec ! appsink name=sink"

    def bufs(tensor):
        return [dict(data=torch.from_numpy(c) if tensor else c) for c in chunks]

    ref = run_launch(fx, launch, bufs(False), caps="video/x-cdg")
    got = run_launch(tfx, launch, bufs(payload == "torch"), caps="video/x-cdg")
    assert len(ref[0]) > 400 and got == ref


def test_smoke_image_paths_run_on_the_cpu(tmp_path):
    """chip_smoke.py's stills and GIF paths at a small size: each output
    PNG decodes to the frame that entered rspngenc, every stage's payload is
    a tensor on the selected device, and the GIF comes back frame for
    frame; its CD+G path renders the JAX elements' frame count."""
    grade = chip_smoke.write_grade()
    logo = tmp_path / "logo.png"
    logo.write_bytes(chip_smoke.png_of(tfx, chip_smoke.logo_image(w=40, h=20)))
    pngs = [chip_smoke.png_of(tfx, chip_smoke.still_image(chip_smoke.STILL_SEED + i, 96, 64))
            for i in range(2)]
    outs = chip_smoke.stream_all(chip_smoke.still_pipelines(tfx, grade, logo, pngs))
    for bufs, trace in outs:
        assert len(bufs) == 1
        back = chip_smoke.decode_images(tfx, chip_smoke._bytes(bufs[0]))
        assert torch.equal(back[0], trace.seen["enc:sink"][0].data)
        assert all(isinstance(b.data, torch.Tensor) and b.data.device.type == "cpu"
                   for w in chip_smoke.STILL_WHERE for b in trace.seen[w])
    gif = chip_smoke.gif_of(tfx, chip_smoke.gif_frames(4, w=64, h=36))
    [(gbufs, _)] = chip_smoke.stream_all(chip_smoke.gif_pipeline(tfx, grade, gif))
    back = chip_smoke.decode_images(tfx, chip_smoke._bytes(gbufs[0]), "gifdec", "image/gif")
    assert len(back) == 4 and tuple(back[0].shape) == (36, 64, 4)
    frames = chip_smoke.cdg_run(tfx, chip_smoke.cdg_stream(seconds=1))
    assert len(frames) > 200 and all(tuple(b.data.shape) == (216, 300, 3) for b in frames)


def test_port_runs_captions_without_pil():
    """Importing the port and running cea608overlay through a pipeline
    loads no Pillow: only the image elements import it, when they run."""
    code = (
        "import sys, numpy as np, gst_plugins_rs_tpu_torch as t\n"
        "t.set_device('cpu')\n"
        "from gst_plugins_rs_tpu_torch.ops import cea608\n"
        "p = t.parse_launch('appsrc name=src ! cea608overlay ! appsink name=sink')\n"
        "src = p.by_name('src')\n"
        "src.set_property('caps', t.parse_caps("
        "'video/x-raw,format=RGBA,width=160,height=90,framerate=30/1'))\n"
        "from gst_plugins_rs_tpu_torch.core.video import VideoCaptionMeta\n"
        "pairs = cea608.encode_pop_on(['NO PILLOW'])\n"
        "for i, pair in enumerate(pairs):\n"
        "    b = t.Buffer(np.zeros((90, 160, 4), np.uint8), pts=i * 33_333_333)\n"
        "    b.add_meta(VideoCaptionMeta('cea608-raw', bytes(pair)))\n"
        "    src.push_buffer(b)\n"
        "src.end_of_stream()\n"
        "p.play_until_eos()\n"
        "out = p.by_name('sink').samples[-1].buffer.data\n"
        "assert out.numpy().any(), 'no caption drawn'\n"
        "assert 'PIL' not in sys.modules, 'PIL imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)
