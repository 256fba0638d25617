"""The port's CLI (`python -m gst_plugins_rs_tpu_torch`, launch.py) and its
registry dump (utils/registry_dump.py) against the JAX package's.

tests/test_cli.py runs on the port with the same inputs and assertions.
Then: `--list-elements` prints a line a factory the port registers, each
equal to the JAX CLI's line for it; `--inspect` prints what the JAX CLI
prints for every such factory; `dump_registry()` equals the JAX package's
dump, and docs/elements.json, on each of them, and it lacks none of the
JAX package's factories.  Where the two packages'
texts differ they do so on purpose, and the tests name each place."""
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import gst_plugins_rs_tpu_torch as tfx
from gst_plugins_rs_tpu.launch import main as jax_main
from gst_plugins_rs_tpu.utils.registry_dump import dump_registry as jax_dump
from gst_plugins_rs_tpu_torch.launch import main
from gst_plugins_rs_tpu_torch.utils.registry_dump import dump_registry
from torch_parity_helpers import mirror_jax_tests, port_on_cpu

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_cli.py", globals())

N_PORTED = 247
# Every factory of the JAX package is ported (ROADMAP A.4).
NOT_PORTED = set()
# Property docs that quote the JAX package's TPU measurements or name its
# device (no TPU figure stands as the port's): the port states its own.
DOC_DIVERGENT = {
    "colorlut": {"precision"},
    "yoloxinference": {"backend-type", "precision", "engine"},
    "burn-yoloxinference": {"backend-type", "precision", "engine"},
}
# loudnormbank's description says "device mesh" for "TPU mesh".
DESCRIPTION_DIVERGENT = {"loudnormbank"}
# rtpvrawpay2's sink template lists its formats as a ValueList, so that an
# upstream element that asks its peer's caps negotiates with it; the JAX
# element's plain list prints as a string.
PADS_DIVERGENT = {"rtpvrawpay2"}
# docs/elements.json predates the JAX package's raptorq properties and pads.
DOCS_STALE = {"raptorqenc", "raptorqdec"}


def _plain(info):
    """An element_info entry as docs/elements.json holds it (JSON types),
    with the implementation's module under the JAX package's name."""
    info = json.loads(json.dumps(info))
    info["python"] = info["python"].replace("gst_plugins_rs_tpu_torch.", "gst_plugins_rs_tpu.", 1)
    return info


def _without_divergences(name, info):
    info = dict(info)
    if name in DOC_DIVERGENT:
        info["properties"] = [{k: v for k, v in p.items()
                               if not (k == "doc" and p["name"] in DOC_DIVERGENT[name])}
                              for p in info["properties"]]
    if name in DESCRIPTION_DIVERGENT:
        info.pop("description")
    if name in PADS_DIVERGENT:
        info.pop("pads")
    return info


@pytest.fixture(scope="module")
def dumps():
    with port_on_cpu():
        port = {k: _plain(v) for k, v in dump_registry().items()}
    return port, json.loads(json.dumps(jax_dump()))


def test_registry_dump_equals_the_jax_packages(dumps):
    """Every factory the port registers dumps as the JAX package's does:
    class, properties (name, type, default, range, choices, mutability,
    doc), signals, pad templates, pad and object properties, the
    implementation's module path; the named divergences differ, and only
    they."""
    port, ref = dumps
    assert len(port) == N_PORTED and set(ref) - set(port) == NOT_PORTED
    for name, info in port.items():
        assert _without_divergences(name, info) == _without_divergences(name, ref[name]), name
    for name in set(DOC_DIVERGENT) | DESCRIPTION_DIVERGENT | PADS_DIVERGENT:
        assert port[name] != ref[name], name


def test_registry_dump_equals_docs_elements_json(dumps):
    """docs/elements.json, the JAX package's published dump: the port's
    entry equals it for every factory the port has, apart from the named
    divergences and the two raptorq entries the file predates (there the
    port equals the JAX package, test above); the file names no other
    factory."""
    port, ref = dumps
    docs = json.loads((ROOT / "docs" / "elements.json").read_text())
    assert set(docs) - set(port) == NOT_PORTED
    for name, info in port.items():
        if name in DOCS_STALE:
            assert docs[name] != ref[name]
            continue
        assert _without_divergences(name, info) == _without_divergences(name, docs[name]), name


def test_registry_dump_main_writes_the_dump(tmp_path, monkeypatch):
    """`python -m gst_plugins_rs_tpu_torch.utils.registry_dump FILE` asks
    for the CPU (introspection needs no card) and writes the dump."""
    from gst_plugins_rs_tpu_torch.utils import registry_dump

    out = tmp_path / "elements.json"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["registry_dump", str(out)])
    tfx.set_device(None)
    registry_dump.main()
    assert tfx.requested_device() == "cpu"
    data = json.loads(out.read_text())
    assert len(data) == N_PORTED and data["hlscmafsink"]["class"] == "Sink/Muxer"


def _lines(fn, argv, capsys):
    assert fn(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_list_elements_lines_equal_the_jax_clis(capsys):
    """--list-elements: one line a ported factory, each the JAX CLI's line
    for that factory (loudnormbank's description aside)."""
    port = _lines(main, ["--list-elements"], capsys)
    ref = {ln.split()[0]: ln for ln in _lines(jax_main, ["--list-elements"], capsys)}
    assert len(port) == N_PORTED
    assert {ln.split()[0] for ln in port} == set(ref) - NOT_PORTED
    for ln in port:
        name = ln.split()[0]
        if name in DESCRIPTION_DIVERGENT:
            assert ln.split()[:2] == ref[name].split()[:2] and ln != ref[name]
            continue
        assert ln == ref[name], name


def _inspect(fn, name, capsys):
    out = _lines(fn, ["--inspect", name], capsys)
    return [ln.replace("gst_plugins_rs_tpu_torch.", "gst_plugins_rs_tpu.", 1)
            if ln.startswith("  Implementation: ") else ln for ln in out]


def test_inspect_prints_what_the_jax_cli_prints(capsys):
    """--inspect <factory> for every ported factory: the JAX CLI's text
    (the implementation's module under the JAX package's name); where a doc
    or the description differs on purpose, every other line is equal."""
    with port_on_cpu():
        names = sorted(dump_registry())
    for name in names:
        port, ref = _inspect(main, name, capsys), _inspect(jax_main, name, capsys)
        if name in set(DOC_DIVERGENT) | DESCRIPTION_DIVERGENT | PADS_DIVERGENT:
            assert len(port) == len(ref) and port[0] == ref[0]
            assert sum(a != b for a, b in zip(port, ref)) <= 3, name
            continue
        assert port == ref, name


def test_pipeline_with_dot_and_tracers(tmp_path, monkeypatch):
    """A pipeline description with --dot and GSTPU_TRACERS: the dot names
    every element and links them; the CLI closes the tracers at the end of
    the run, so memory-tracer (which writes at close) leaves its CSV, with
    the JAX package's rows; the JAX CLI leaves its tracers open, and its
    memory-tracer writes nothing (a fault the port does not keep)."""
    desc = ("audiotestsrc name=src num-buffers=3 samplesperbuffer=480 "
            "! audio/x-raw,format=F32,rate=48000,channels=2 ! identity name=mid "
            "! fakesink name=out")
    rows = {}
    for label, fn in (("port", main), ("jax", jax_main)):
        mem = tmp_path / f"{label}.csv"
        monkeypatch.setenv("GSTPU_TRACERS", f"memory-tracer(file={mem})")
        assert fn([desc, "--dot", str(tmp_path / f"{label}.dot")]) == 0
        dot = (tmp_path / f"{label}.dot").read_text()
        assert all(f'"{n}"' in dot for n in ("src", "mid", "out"))
        assert dot.count('" -> "') == 3
        rows[label] = mem.read_text().splitlines() if mem.exists() else None
    # three buffers of 480 stereo F32 frames into the capsfilter, mid and out
    assert rows["port"][0] == "element,buffers,bytes"
    assert [r.split(",", 1)[1] for r in rows["port"][1:]] == ["3,11520"] * 3
    assert {r.split(",")[0] for r in rows["port"][1:]} >= {"mid", "out"}
    assert rows["jax"] is None


def test_module_entry_point_runs_on_the_card_by_default():
    """`python -m gst_plugins_rs_tpu_torch` runs the pipeline on the card:
    with no CUDA device it fails with the port's error
    instead of running on the CPU; --list-elements needs no card."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-m", "gst_plugins_rs_tpu_torch",
                        "videotestsrc num-buffers=2 ! video/x-raw,format=RGBA,width=64,height=48 "
                        "! hsvfilter ! fakesink"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    r = subprocess.run([sys.executable, "-m", "gst_plugins_rs_tpu_torch", "--list-elements"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and len(r.stdout.splitlines()) == N_PORTED
