"""The port's whipsink and whepsrc (elements/net/webrtchttp.py), thin
wrappers of the WHIP and WHEP clients: tests/test_webrtchttp.py runs on
the port with the same inputs and assertions."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_webrtchttp.py", globals())
