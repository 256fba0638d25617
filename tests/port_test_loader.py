"""Loads a test file of the JAX package as a namespace, as it is or
compiled against the PyTorch port.  It imports nothing of JAX, so the card
tests (tests/test_torch_kernels_cuda.py) use it on a machine without JAX,
and tests/torch_parity_helpers.py builds its mirrored tests on it."""
import pathlib
import re


def load_test_module(jax_test_file, port, drop=(), subs=()):
    """The namespace of a test file of the JAX package, compiled as it is
    (port=False) or with every `gst_plugins_rs_tpu` module name replaced by
    `gst_plugins_rs_tpu_torch` (port=True), so that its helpers drive the
    port.  `drop` names modules whose top-level `from <module> import ...`
    lines are left out (modules of a later slice of the port; the tests that
    use those names are not run).  `subs` are (pattern, replacement) regex
    pairs applied to the source first."""
    path = pathlib.Path(__file__).with_name(jax_test_file)
    src = path.read_text()
    for pattern, repl in subs:
        src, n = re.subn(pattern, repl, src)
        assert n, f"{jax_test_file}: no match for {pattern!r}"
    for module in drop:
        src = re.sub(rf"(?m)^from {re.escape(module)} import [^\n]*$", "", src)
    if port:
        src = re.sub(r"\bgst_plugins_rs_tpu\b", "gst_plugins_rs_tpu_torch", src)
    ns = {"__name__": f"{'port' if port else 'jax'}_{path.stem}", "__file__": str(path)}
    exec(compile(src, str(path), "exec"), ns)  # noqa: S102
    return ns
