"""The port's SCTP association and WebRTC data channels (net/sctp.py).

tests/test_sctp.py runs on the port with the same inputs and assertions:
CRC32c vectors, the four-way handshake, DCEP, fragmentation, loss and
reordering.  tests/test_torch_webrtc_stack.py holds the chunks' bytes to
the JAX package's."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_sctp.py", globals())
