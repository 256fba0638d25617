"""The port's remaining ts-* elements against tests/test_threadshare_extra.py:
each of its tests runs on the port, with the same inputs and assertions,
the ts-udpsrc cases (shared drain contexts over localhost UDP) among them."""
import pytest

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_threadshare_extra.py", globals())
