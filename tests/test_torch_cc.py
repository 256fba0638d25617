"""The port's closed-caption family against the JAX package's caption tests.

Each test of tests/test_closedcaption.py, test_cea708.py, test_st2038.py,
test_cc_conformance.py and test_cc_surface.py runs on the port with the
same inputs and the same assertions.  Then the file encoders and the
caption elements against the JAX package on seeded captions, byte for
byte, from numpy and from tensor payloads, and the overlay's bundled glyph
atlas against the JAX package's, which Pillow draws."""
import pathlib

import numpy as np
import pytest
import torch

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.ops import cea608
from torch_parity_helpers import mirror_jax_tests, port_on_cpu, run_launch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = (mirror_jax_tests("test_closedcaption.py", globals())
            + mirror_jax_tests("test_cea708.py", globals())
            + mirror_jax_tests("test_st2038.py", globals())
            + mirror_jax_tests("test_cc_conformance.py", globals())
            + mirror_jax_tests("test_cc_surface.py", globals()))


# ---------------------------------------------------------------------------
# Port against the JAX package on seeded captions
# ---------------------------------------------------------------------------
FRAME = 33_366_666  # 29.97 frames a second
WORDS = ["ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT", "GOLF", "HOTEL"]


def _captions(seed=11, n=3):
    """Seeded pop-on captions as 608 byte pairs, two pairs a frame."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        lines = [" ".join(rng.choice(WORDS, 3)) for _ in range(2)]
        pairs += cea608.encode_pop_on(lines) + [(0x80, 0x80)] * 4
    pairs += [(0x80, 0x80)] * (len(pairs) % 2)
    return [np.asarray(pairs[i:i + 2], np.uint8) for i in range(0, len(pairs), 2)]


def _feed(tensors, seed=11):
    return [dict(data=torch.from_numpy(c) if tensors else c, pts=i * FRAME, duration=FRAME)
            for i, c in enumerate(_captions(seed))]


MCC_PROPS = {"uuid": "0F3C7A1E-5B2D-4C8E-9A71-2D6B3E8F4A10",
             "creation-date": "Sunday, October 18, 2026"}
CC_CASES = {
    "sccenc": ("appsrc name=src ! sccenc ! appsink name=sink", {}),
    "mccenc": ("appsrc name=src ! mccenc name=enc ! appsink name=sink", MCC_PROPS),
    "sccenc ! sccparse ! cea608tott": (
        "appsrc name=src ! sccenc ! sccparse ! cea608tott ! appsink name=sink", {}),
    "mccenc ! mccparse ! cea608tojson": (
        "appsrc name=src ! mccenc name=enc ! mccparse ! cea608tojson ! appsink name=sink",
        MCC_PROPS),
    "cea608tocea708": (
        "appsrc name=src ! cea608tocea708 ! appsink name=sink", {}),
    "ccdetect": ("appsrc name=src ! ccdetect ! appsink name=sink", {}),
}


@pytest.mark.parametrize("payload", ["numpy", "torch"])
@pytest.mark.parametrize("case", sorted(CC_CASES))
def test_caption_output_equals_jax(case, payload):
    launch, props = CC_CASES[case]

    def configure(p):
        for k, v in props.items():
            p.by_name("enc").set_property(k, v)

    caps = "closedcaption/x-cea-608,format=raw,framerate=30000/1001"
    ref = run_launch(fx, launch, _feed(False), caps=caps, configure=configure)
    with port_on_cpu():
        got = run_launch(tfx, launch, _feed(payload == "torch"), caps=caps, configure=configure)
    assert ref[0] and got[0] == ref[0]
    assert got[1] == ref[1]


def test_atlas_equals_jax_build_atlas():
    """The bundled atlas is the JAX package's _build_atlas() bit for bit
    under the installed Pillow, and records the Pillow that drew it."""
    import PIL

    from gst_plugins_rs_tpu.elements.cc.overlay import _build_atlas as jax_atlas
    from gst_plugins_rs_tpu_torch.elements.cc.overlay import _build_atlas
    from gst_plugins_rs_tpu_torch.utils.cea608_atlas import ATLAS_PATH

    got, ref = _build_atlas(), jax_atlas()
    assert got.dtype == ref.dtype == np.float32
    assert np.array_equal(got, ref)
    with np.load(ATLAS_PATH) as f:
        assert str(f["pillow_version"]) == PIL.__version__


def test_port_runs_without_pil():
    """Neither importing the port nor drawing captions imports Pillow."""
    import subprocess
    import sys

    code = ("import sys, numpy as np, gst_plugins_rs_tpu_torch as t\n"
            "t.set_device('cpu')\n"
            "from gst_plugins_rs_tpu_torch.elements.cc.overlay import Cea608Overlay\n"
            "ov = Cea608Overlay(); ov.on_ready_to_paused()\n"
            "import torch; ov._render_mask(('HELLO',), 90, 160, torch.device('cpu'))\n"
            "assert 'PIL' not in sys.modules, 'PIL imported'\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120)


