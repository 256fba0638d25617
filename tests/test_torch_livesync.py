"""The port's livesync against tests/test_livesync.py: each of its tests runs
on the port, with the same inputs and the same assertions."""
import pytest

import gst_plugins_rs_tpu_torch  # noqa: F401  (registers the elements)
from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_livesync.py", globals(), skip=())
