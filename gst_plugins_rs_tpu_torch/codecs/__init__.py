"""Host-side codecs of the port: brotli for the compression elements, FLAC
(from the format specification, frames through the repository's native
decoder) and the ctypes shim over libavcodec (avlib)."""
