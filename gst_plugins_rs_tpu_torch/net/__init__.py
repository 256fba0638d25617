"""Host-side network and crypto helpers of the port (NaCl crypto_box for
the sodium elements)."""
