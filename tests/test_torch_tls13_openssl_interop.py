"""The port's TLS 1.3 for QUIC (net/tls13.py) against the openssl command
line tool: tests/test_tls13_openssl_interop.py on the port (it skips
without openssl, as the JAX file does)."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_tls13_openssl_interop.py", globals())
