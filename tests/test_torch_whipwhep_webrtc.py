"""The port's WHIP and WHEP clients and servers (elements/net/whipwhep.py):
tests/test_whipwhep_webrtc.py runs on the port with the same inputs and
assertions, media over ICE, DTLS and SRTP on loopback.
tests/test_torch_webrtc_slice.py drives the smoke's WHIP camera in both
packages."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_whipwhep_webrtc.py", globals())
