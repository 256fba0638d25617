"""The port's text elements (regex, textwrap, textaccumulate, jsongstenc,
jsongstparse) against the JAX package's on the same seeded text: the same
strings, PTS, durations and flags, with no tolerance."""
import numpy as np
import pytest

import gst_plugins_rs_tpu as fx
import gst_plugins_rs_tpu_torch as tfx
from torch_parity_helpers import port_on_cpu, run_launch

MS = 1_000_000
TEXT = "text/x-raw,format=utf8"
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "a", "lazy", "dog", "extraordinarily",
         "-", "1234", "hyphenation"]


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


def texts(seed, n=8):
    rng = np.random.default_rng(seed)
    return [dict(data=" ".join(rng.choice(WORDS, rng.integers(1, 12))),
                 pts=i * 700 * MS, duration=int(rng.integers(100, 700)) * MS)
            for i in range(n)]


CASES = {
    "regex": ("regex pattern=o+ replacement=O", TEXT),
    "textwrap": ("textwrap columns=12", TEXT),
    "textwrap-lines": ("textwrap columns=20 lines=2", TEXT),
    "textaccumulate": ("textaccumulate", TEXT),
    "jsongstenc": ("jsongstenc", TEXT),
    "json-roundtrip": ("jsongstenc ! jsongstparse", TEXT),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_text_element_parity(case, seed):
    chain, caps = CASES[case]
    launch = f"appsrc name=src ! {chain} ! appsink name=sink"
    ref = run_launch(fx, launch, texts(seed), caps=caps)
    got = run_launch(tfx, launch, texts(seed), caps=caps)
    assert ref[0]
    assert got == ref


def test_regex_commands_parity():
    cmds = [{"operation": "replace-all", "pattern": "fox", "replacement": "cat"},
            {"operation": "replace-all", "pattern": "\\d", "replacement": "#"}]
    outs = []
    for pkg in (fx, tfx):
        el = pkg.element_factory_make("regex")
        el.set_property("commands", cmds)
        outs.append([el.transform(pkg.Buffer(b["data"])).data for b in texts(3)])
    assert outs[0] == outs[1]
