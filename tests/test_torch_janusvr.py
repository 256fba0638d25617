"""The port's janusvrwebrtcsink and janusvrwebrtcsrc (elements/net/janusvr.py)
against a fake Janus VideoRoom over websockets: tests/test_janusvr.py runs
on the port with the same inputs and assertions."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_janusvr.py", globals())
