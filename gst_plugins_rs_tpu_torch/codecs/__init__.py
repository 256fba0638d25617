"""Host-side codecs of the port (brotli for the compression elements)."""
