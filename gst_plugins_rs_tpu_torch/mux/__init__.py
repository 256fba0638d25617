"""ISO Base Media File Format (MP4/fMP4/CMAF) and MPEG-TS muxing.

Parity family: reference mux/isobmff (6 elements: isofmp4mux, cmafmux,
dashmp4mux, onviffmp4mux, isomp4mux, onvifmp4mux;
mux/isobmff/src/isobmff/mod.rs:137-172).  Box serialization is host control
plane (pure bytes): `bmff` writes boxes, `reader` parses them back,
`mpegts` packetizes transport streams.
"""
from . import bmff, reader  # noqa: F401
