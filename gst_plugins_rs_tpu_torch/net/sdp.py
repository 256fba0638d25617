"""Minimal SDP parsing (RFC 4566) for RTSP DESCRIBE responses.

Parity support for rtspsrc2 (reference net/rtsp, which uses the
sdp-types crate): media sections with rtpmap/fmtp/control attributes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SdpMedia:
    media: str  # audio | video | application
    port: int
    proto: str
    payload_type: int
    encoding_name: str = ""
    clock_rate: int = 0
    encoding_params: str = ""
    control: str = ""
    fmtp: Dict[str, str] = field(default_factory=dict)


@dataclass
class Sdp:
    session_name: str = ""
    control: str = ""
    medias: List[SdpMedia] = field(default_factory=list)


def parse_sdp(text: str) -> Sdp:
    sdp = Sdp()
    current: Optional[SdpMedia] = None
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line[:2]:
            continue
        key, value = line[0], line[2:]
        if key == "s":
            sdp.session_name = value
        elif key == "m":
            parts = value.split()
            if len(parts) < 4:
                raise ValueError(f"malformed SDP m-line: {line!r}")
            current = SdpMedia(parts[0], int(parts[1]), parts[2], int(parts[3]))
            sdp.medias.append(current)
        elif key == "a":
            attr, _, aval = value.partition(":")
            if current is None:
                if attr == "control":
                    sdp.control = aval
                continue
            if attr == "rtpmap":
                # "<pt> <encoding>/<rate>[/<params>]"
                _pt, _, enc = aval.partition(" ")
                fields = enc.split("/")
                current.encoding_name = fields[0]
                if len(fields) > 1:
                    current.clock_rate = int(fields[1])
                if len(fields) > 2:
                    current.encoding_params = fields[2]
            elif attr == "control":
                current.control = aval
            elif attr == "fmtp":
                _pt, _, params = aval.partition(" ")
                for kv in params.split(";"):
                    k, _, v = kv.strip().partition("=")
                    if k:
                        current.fmtp[k] = v
    return sdp


__all__ = ["Sdp", "SdpMedia", "parse_sdp"]
