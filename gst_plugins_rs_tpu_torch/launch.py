"""gst-launch-style CLI: run a textual pipeline description.

The reference's user-facing surface is the same textual language driven
through gst-launch-1.0 (SURVEY.md §1 CLI row); this is that entry point:

    python -m gst_plugins_rs_tpu_torch "audiotestsrc num-buffers=100 ! \\
        audioloudnorm ! fakesink"

Flags: -v prints caps negotiations and bus messages, --dot FILE writes the
pipeline graph (pipeline-snapshot tracer), --list-elements prints the
registry like gst-inspect-1.0, --inspect ELEMENT prints one factory's
pads/caps/properties in full like gst-inspect-1.0 <element>.
"""
from __future__ import annotations

import argparse
import sys
import time


def _fmt_val(v) -> str:
    if isinstance(v, dict):
        if "range" in v:
            return f"[{v['range'][0]}, {v['range'][1]}]"
        if "choices" in v:
            return "{" + ", ".join(str(c) for c in v["choices"]) + "}"
    return str(v)


def _fmt_caps(caps) -> str:
    if isinstance(caps, str):
        return caps
    out = []
    for s in caps:
        fields = ", ".join(f"{k}={_fmt_val(v)}" for k, v in s.items() if k != "name")
        out.append(s["name"] + (f" [{fields}]" if fields else ""))
    return "; ".join(out) or "EMPTY"


def inspect_element(name: str) -> int:
    """gst-inspect-1.0 <element> analog over the same introspection the
    registry dump uses (utils/registry_dump.py), so CLI and docs agree."""
    from .core.registry import list_factories
    from .utils.registry_dump import element_info

    if name not in list_factories():
        print(f"no such element factory {name!r}", file=sys.stderr)
        close = [f for f in list_factories() if name in f]
        if close:
            print("did you mean: " + ", ".join(sorted(close)), file=sys.stderr)
        return 1
    info = element_info(name)
    print(f"Factory: {info['name']}")
    print(f"  Class: {info['class']}")
    print(f"  Description: {info['description']}")
    print(f"  Implementation: {info['python']}")
    print("\nPad templates:")
    for pad in info["pads"]:
        if "error" in pad:
            print(f"  <introspection error: {pad['error']}>")
            continue
        print(f"  {pad['direction'].upper()} template {pad['name']!r} "
              f"({pad['presence']})")
        print(f"    caps: {_fmt_caps(pad['caps'])}")
    props = info["properties"]
    print(f"\nProperties ({len(props)}):")
    for p in props:
        rng = ""
        if "min" in p or "max" in p:
            rng = f" range {p.get('min', '-inf')}..{p.get('max', 'inf')}"
        if "choices" in p:
            rng += " one of " + "/".join(str(c) for c in p["choices"])
        print(f"  {p['name']:24s} {p['type']:8s} default={p['default']!r}"
              f"{rng} (mutable in {p['mutable']})")
        if p.get("doc"):
            print(f"    {p['doc']}")
    signals = info.get("signals") or {}
    if signals:
        print(f"\nSignals ({len(signals)}):")
        for s, kind in sorted(signals.items()):
            print(f"  {s:24s} {kind}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gst_plugins_rs_tpu_torch", description="Run a pipeline description"
    )
    ap.add_argument("pipeline", nargs="*", help="pipeline description (gst-launch grammar)")
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--dot", metavar="FILE", help="write the pipeline graph as graphviz dot")
    ap.add_argument("--list-elements", action="store_true",
                    help="print all element factories (gst-inspect analog)")
    ap.add_argument("--inspect", metavar="ELEMENT",
                    help="print one factory's pads/caps/properties in full "
                         "(gst-inspect-1.0 <element> analog)")
    args = ap.parse_args(argv)

    from .core.registry import factory_class, list_factories

    if args.list_elements:
        for name in list_factories():
            cls = factory_class(name)
            print(f"{name:28s} {cls.ELEMENT_CLASS:32s} {cls.ELEMENT_DESCRIPTION}")
        return 0
    if args.inspect:
        return inspect_element(args.inspect)
    if not args.pipeline:
        ap.error("a pipeline description is required")

    from .core.parse import parse_launch

    desc = " ".join(args.pipeline)
    pipeline = parse_launch(desc)
    if args.dot:
        from .utils.tracers import PipelineSnapshotTracer

        snap = PipelineSnapshotTracer()
        snap.attach(pipeline)
        snap.snapshot(args.dot)
        print(f"wrote {args.dot}", file=sys.stderr)

    t0 = time.perf_counter()
    try:
        pipeline.play_until_eos()
    finally:
        # GSTPU_TRACERS' tracers write their files (memory-tracer and
        # chrome-tracer only here) when closed
        for tracer in pipeline.tracers:
            tracer.close()
    dt = time.perf_counter() - t0
    for msg in pipeline.bus.messages():
        if args.verbose or msg.type.value in ("error", "warning"):
            src = getattr(msg.src, "name", "?")
            print(f"[{msg.type.value}] {src}: {msg.structure!r}", file=sys.stderr)
    if args.verbose:
        print(f"pipeline finished in {dt:.3f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
