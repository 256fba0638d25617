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
