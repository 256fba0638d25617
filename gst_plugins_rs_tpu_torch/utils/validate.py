"""validate: the check-last-frame-qrcode action.

Parity target: utils/validate/src/check_last_frame_qrcode.rs — a
gst-validate action that finds a sink holding the last rendered frame,
decodes the QR code in it (codecs/qr.py), and checks the decoded JSON
against expected fields.  The action API here is a callable registry
(`run_action("check-last-frame-qrcode", pipeline, **params)`), the
framework's analog of validate's action signatures.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

from ..codecs import qr
from ..core.payload import host_array


class ValidateError(AssertionError):
    pass


def _find_sink(pipeline, sink_name: Optional[str] = None,
               factory_name: Optional[str] = None):
    """First sink holding samples, by name / factory / fallback
    (check_last_frame_qrcode.rs find_sink)."""
    for el in pipeline.elements:
        if not hasattr(el, "samples"):
            continue
        if sink_name is not None:
            if el.name == sink_name:
                return el
            continue
        if factory_name is not None:
            if getattr(el, "ELEMENT_NAME", None) == factory_name:
                return el
            continue
        return el
    raise ValidateError("No matching sink found in pipeline")


def _validate_json_fields(decoded: str, expected: Dict) -> None:
    try:
        value = json.loads(decoded)
    except ValueError as e:
        raise ValidateError(f"Failed to parse QR code content as JSON: {e}")
    for key, want in expected.items():
        if key not in value:
            raise ValidateError(f"QR JSON missing field {key!r}")
        if value[key] != want:
            raise ValidateError(
                f"QR JSON field {key!r} = {value[key]!r}, expected {want!r}")


def check_last_frame_qrcode(pipeline, *, expected_fields: Optional[Dict] = None,
                            expected_text: Optional[str] = None,
                            sink_name: Optional[str] = None,
                            factory_name: Optional[str] = None) -> str:
    """Decode the QR in the sink's last frame; raises ValidateError on
    mismatch, returns the decoded text on success."""
    sink = _find_sink(pipeline, sink_name, factory_name)
    if not sink.samples:
        raise ValidateError(f"{sink.name}: no last frame")
    # the last frame only, read back once (a tensor on the card is copied
    # to the host here, at the end of the run, and no buffer before it)
    frame = host_array(sink.samples[-1].buffer.data)
    try:
        decoded = qr.decode(frame)
    except ValueError as e:
        raise ValidateError(f"QR decode failed: {e}")
    if expected_text is not None and decoded != expected_text:
        raise ValidateError(f"QR text {decoded!r} != expected {expected_text!r}")
    if expected_fields is not None:
        _validate_json_fields(decoded, expected_fields)
    return decoded


_ACTIONS: Dict[str, Callable] = {
    "check-last-frame-qrcode": check_last_frame_qrcode,
}


def run_action(name: str, pipeline, **params):
    if name not in _ACTIONS:
        raise KeyError(f"unknown validate action {name!r} "
                       f"(known: {sorted(_ACTIONS)})")
    return _ACTIONS[name](pipeline, **params)
