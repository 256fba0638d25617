"""Shared helpers of the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): seeded weights that both packages load,
an official-style YOLOX checkpoint, and the CPU setting of the audio tests."""
import contextlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gst_plugins_rs_tpu_torch.models.convert import variables_from_jax, variables_to_numpy
from gst_plugins_rs_tpu_torch.models.yolox import Yolox
from port_test_loader import load_test_module  # noqa: F401  (the tests import it from here)


@contextlib.contextmanager
def port_on_cpu():
    """The port's entry points on the CPU with one intra-op thread, restored
    after.  The audio tests' frames are small: torch's thread pool costs them
    more than it saves, and takes the cores of the other test workers."""
    import gst_plugins_rs_tpu_torch as tfx

    prev, threads = tfx.requested_device(), torch.get_num_threads()
    tfx.set_device("cpu")
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        tfx.set_device(prev)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def rel_err(ref, got, floor=1e-2):
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    return float((np.abs(ref - got) / (np.abs(ref) + floor)).max())


def random_variables(variant, seed=0, num_classes=80):
    """A flax variables tree {"params", "batch_stats"} of numpy arrays for a
    YOLOX variant, filled from a seeded numpy RandomState: conv kernels
    fan-in scaled normals, BN scale ~1, small biases and means, variances in
    [0.5, 1.5)."""
    template = variables_to_numpy(Yolox.from_variant(variant, num_classes).state_dict())
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:3]))
                out[k] = (rng.randn(*v.shape) / np.sqrt(fan_in)).astype(np.float32)
            elif k == "scale":
                out[k] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif k == "var":
                out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            else:  # bias, mean
                out[k] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        return out

    return {"params": fill(template["params"]), "batch_stats": fill(template["batch_stats"])}


def port_state(variables):
    """flax variables -> the port's state_dict, through the weight carrier."""
    return variables_from_jax(to_numpy(variables["params"]),
                              to_numpy(variables["batch_stats"]))


_LIST = re.compile(r"^(m|stems|cls_convs|reg_convs|cls_preds|reg_preds|obj_preds)_(\d+)$")
_OFFICIAL = [
    (re.compile(r"^backbone\.c3_(.+)"), r"backbone.C3_\1"),
    (re.compile(r"^(backbone\.backbone\.dark[2-5])\.conv\.(.+)"), r"\1.0.\2"),
    (re.compile(r"^(backbone\.backbone\.dark[2-4])\.c3\.(.+)"), r"\1.1.\2"),
    (re.compile(r"^(backbone\.backbone\.dark5)\.spp\.(.+)"), r"\1.1.\2"),
    (re.compile(r"^(backbone\.backbone\.dark5)\.c3\.(.+)"), r"\1.2.\2"),
    (re.compile(r"^(head\.(?:cls|reg)_convs\.[0-9]+)\.conv([0-9]+)\.(.+)"), r"\1.\2.\3"),
]


def official_key(port_key: str) -> str:
    """The port's (= flax) module name -> the official YOLOX checkpoint key
    (the inverse of the reference's remapping, yolox.rs:246-277)."""
    parts = []
    for p in port_key.split("."):
        m = _LIST.match(p)
        parts.extend([m.group(1), m.group(2)] if m else [p])
    key = ".".join(parts)
    for pat, rep in _OFFICIAL:
        key = pat.sub(rep, key)
    return key


def official_checkpoint(variables, path):
    """Save `variables` as an official-style .pth: {"model": state_dict}
    with official key names and OIHW kernels.  Returns the path."""
    sd = {official_key(k): v for k, v in port_state(variables).items()}
    torch.save({"model": sd}, path)
    return path


def mirror_jax_tests(jax_test_file, namespace, skip=(), drop=(), subs=()):
    """Run a test file of the JAX package against the port.

    The file is compiled by `load_test_module(..., port=True)`, and its
    tests, fixtures and helpers are put into `namespace` (the calling test
    module's globals), so pytest collects each JAX test under its own name
    in the port's file.  `skip` names tests that are not mirrored, because
    they need a module of a later slice of the port or another port test
    file holds them against the JAX package: a function's or class's name,
    or "Class::method" for a test method (the class is mirrored without
    it); a dict maps each name to the slice or file.  `drop` names modules
    of a later slice whose top-level imports the file's compiled copy leaves
    out (`load_test_module`).  The file's module-level `pytestmark` marks its
    own tests and classes, not the calling module.  `subs` are (pattern,
    replacement) regex pairs applied to the file's source before it is
    compiled (`load_test_module`).  Returns the names of the mirrored
    tests."""
    ns = load_test_module(jax_test_file, port=True, drop=drop, subs=subs)
    methods = {}
    for entry in skip:
        if "::" in entry:
            cls, meth = entry.split("::")
            methods.setdefault(cls, set()).add(meth)
    missing = {n for n in skip if "::" not in n} - set(ns)
    missing |= {f"{c}::{m}" for c, ms in methods.items() for m in ms
                if m not in vars(ns.get(c, object))}
    assert not missing, f"{jax_test_file} has no tests {sorted(missing)}"
    for cls, ms in methods.items():
        old = ns[cls]
        ns[cls] = type(old.__name__, old.__bases__,
                       {k: v for k, v in vars(old).items()
                        if k not in ms and k not in ("__dict__", "__weakref__")})
    # the file's module-level marks (a skipif on a system library) go to
    # its own tests, not to the calling module's other tests
    marks = ns.pop("pytestmark", [])
    marks = marks if isinstance(marks, list) else [marks]
    mirrored = []
    for name, value in ns.items():
        if name.startswith("__") or name in skip:
            continue
        if name.startswith(("test_", "Test")):
            for mark in marks:
                value = mark(value)
        if name.startswith("test_"):
            assert name not in namespace, f"{name} is mirrored twice"
            mirrored.append(name)
        namespace.setdefault(name, value)
    return mirrored


def payload_summary(data):
    """A payload as something both packages' outputs compare by: text as
    is, arrays (numpy or tensors, on any device) as (dtype, shape, bytes)."""
    if data is None or isinstance(data, (str, bytes)):
        return data
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    arr = np.asarray(data)
    return (arr.dtype.str, arr.shape, arr.tobytes())


def buffer_summary(buf):
    """(payload, pts, dts, duration, offset, flags) of a buffer; flags by
    value, since each package has its own BufferFlags class."""
    return (payload_summary(buf.data), buf.pts, buf.dts, buf.duration, buf.offset,
            buf.flags.value)


def message_summary(msg):
    """(type, structure name, fields as text) of a bus message."""
    s = msg.structure
    fields = None if s is None else sorted((k, repr(v)) for k, v in s.fields.items())
    return (msg.type.value, None if s is None else s.name, fields,
            sorted((k, repr(v)) for k, v in msg.fields.items()))


def run_launch(pkg, launch, buffers=(), caps=None, configure=None, src="src", sink="sink"):
    """Run `launch` in one package (the JAX package or the port, passed as
    its module): buffers given as dicts of Buffer arguments (flags by name,
    payloads as the caller made them for that package) go into the appsrc
    named `src` when there is one, then EOS.  Returns the appsink's buffer
    summaries and the bus messages' summaries."""
    p = pkg.parse_launch(launch)
    if configure is not None:
        configure(p)
    try:
        appsrc = p.by_name(src)
    except KeyError:
        appsrc = None
    if appsrc is not None:
        if caps is not None:
            appsrc.set_property("caps", pkg.parse_caps(caps))
        for b in buffers:
            b = dict(b)
            flags = pkg.BufferFlags.NONE
            for name in b.pop("flags", ()):
                flags |= pkg.BufferFlags[name]
            appsrc.push_buffer(pkg.Buffer(b.pop("data"), flags=flags, **b))
        appsrc.end_of_stream()
    p.play_until_eos()
    samples = [buffer_summary(s.buffer) for s in p.by_name(sink).samples]
    return samples, [message_summary(m) for m in p.bus.messages()]
