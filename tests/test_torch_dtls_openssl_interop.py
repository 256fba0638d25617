"""The port's DTLS 1.2 (net/dtls.py) against the openssl command line tool,
as client and as server: tests/test_dtls_openssl_interop.py on the port."""
import pytest

from torch_parity_helpers import mirror_jax_tests, port_on_cpu


@pytest.fixture(autouse=True)
def _port_cpu():
    with port_on_cpu():
        yield


MIRRORED = mirror_jax_tests("test_dtls_openssl_interop.py", globals())
