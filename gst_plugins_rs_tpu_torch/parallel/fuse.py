"""Element-chain fusion: a run of pure per-buffer transforms as one program.

The port of gst_plugins_rs_tpu/parallel/fuse.py.  Elements opt in by
implementing `pure_kernel()` -> f(payload) -> payload (a function closed over
the element's negotiated caps and current property values; the payload is a
frame tensor or a tuple of planes).  `fuse()` composes them; `fuse_pipeline()`
rewires a live pipeline so a fusable run executes in its head element's
chain function while events and PTS bookkeeping still flow element by
element, and the head pushes the result from the last element's src pad.

The JAX package jits the composition into one XLA program.  The port has no
counterpart of that trace (the hand kernels are ctypes calls, and the fused
output must equal the unfused one bit for bit, which rules out
`torch.compile`'s rewrites), so:

- on the CPU the fused callable runs the kernels eagerly, one after another;
- on CUDA it replays one `torch.cuda.CUDAGraph` per input signature (the
  shapes and dtypes of the payload's planes): at a signature's first buffer
  the kernels run once eagerly on a side stream, on that buffer's own planes
  (that buffer's output, which shares memory with its input at most where
  the unfused chain's would; lazy uploads such as cached resize weights
  happen here), then the run is captured on static copies of the planes
  with `capture_error_mode="thread_local"`, so queues and other branches may
  keep calling CUDA from their own threads meanwhile.  Each later buffer is
  copied into the graph's static input, the graph is replayed, and
  downstream gets a clone of every static output plane: the next replay
  overwrites them, and a sink may still hold the previous frame.  A run that
  fails to capture raises; it never carries on eagerly.  A run whose kernels
  all return their input moves no data: it captures nothing and passes each
  payload on, as the unfused chain does.

Launch accounting: the kernel wrappers count their launches in Python
(`ops.count_launch`), and a replay runs no Python.  The launches that the
capturing thread counts during a capture (the capture itself launches
nothing) are taken back after it and added again on every replay, so the
counters say how often each kernel ran; launches of other threads during
the capture stay as they were counted.  `captures` and `replays` count the
graphs captured and replayed.
"""
from __future__ import annotations

import sys
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .._device import device
from ..core import Buffer, FlowReturn, Pad
from ..core.basetransform import BaseTransform
from ..ops import noting_launches

Counts = Dict[Tuple[str, str], int]

captures = 0
replays = 0


def _planes(data) -> tuple:
    return tuple(data) if isinstance(data, (tuple, list)) else (data,)


def _like(data, planes):
    return tuple(planes) if isinstance(data, (tuple, list)) else planes[0]


def _to_device(data, dev):
    return _like(data, [torch.as_tensor(p, device=dev) for p in _planes(data)])


def _signature(data) -> tuple:
    return tuple((tuple(p.shape), p.dtype) for p in _planes(data))


def _add_launches(counts: Counts, sign: int = 1) -> None:
    for (name, attr), n in counts.items():
        mod = sys.modules[name]
        setattr(mod, attr, getattr(mod, attr) + sign * n)


class _Graph:
    """One captured signature: the graph, its static input planes and output
    payload, and the kernel launches one replay makes."""

    def __init__(self, graph, inputs, output, launches: Counts):
        self.graph, self.inputs, self.output, self.launches = graph, inputs, output, launches


class FusedRun:
    """The composed kernels of a run, called on payloads: eager on the CPU,
    one CUDA graph per input signature on CUDA."""

    def __init__(self, kernels: List[Callable], names: List[str], dev: torch.device):
        self.kernels, self.names, self.device = kernels, names, dev
        # signature -> its graph, or None where the run moves no data
        self.graphs: Dict[tuple, Optional[_Graph]] = {}

    def eager(self, data):
        for k in self.kernels:
            data = k(data)
        return data

    def __call__(self, data):
        global replays
        data = _to_device(data, self.device)
        if self.device.type != "cuda":
            return self.eager(data)
        sig = _signature(data)
        if sig not in self.graphs:
            return self._capture(data, sig)
        g = self.graphs[sig]
        if g is None:
            return data
        for static, p in zip(g.inputs, _planes(data)):
            static.copy_(p)
        g.graph.replay()
        replays += 1
        _add_launches(g.launches)
        return _like(g.output, [p.clone() for p in _planes(g.output)])

    def _capture(self, data, sig):
        """Warm up on a side stream on the buffer's own planes (the returned
        output), then capture the run for this signature on static copies."""
        global captures
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.eager(data)
        cur.wait_stream(side)
        for p in _planes(out):
            p.record_stream(cur)
        if all(any(o is i for i in _planes(data)) for o in _planes(out)):
            self.graphs[sig] = None  # every kernel returned its input
            return out
        inputs = [p.clone(memory_format=torch.contiguous_format) for p in _planes(data)]
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        with noting_launches() as noted:
            try:
                # capture_begin/capture_end by hand rather than torch.cuda.graph:
                # the stream context is left even when capture_end raises
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        static_out = self.eager(_like(data, inputs))
                    finally:
                        graph.capture_end()
            except Exception as e:
                raise RuntimeError(f"fused run {' ! '.join(self.names)}: CUDA graph capture "
                                   f"failed: {e}") from e
            finally:
                captured = dict(Counter(noted))
                _add_launches(captured, -1)  # the capture itself launched nothing
        captures += 1
        self.graphs[sig] = _Graph(graph, inputs, static_out, captured)
        return out


def fuse(elements: List[BaseTransform]) -> FusedRun:
    """Compose the pure kernels of `elements` into one callable on the
    selected device."""
    kernels = []
    for e in elements:
        k = getattr(e, "pure_kernel", None)
        if k is None:
            raise TypeError(f"{e.name} ({e.ELEMENT_NAME}) has no pure_kernel()")
        kernels.append(k())
    return FusedRun(kernels, [e.ELEMENT_NAME for e in elements], device())


def _is_identity(e) -> bool:
    # capsfilter/identity: pure passthrough — may sit INSIDE a run (so
    # caps constraints don't break fusion) but never extend its ends or
    # count toward the 2-element threshold
    return getattr(e, "FUSE_IDENTITY", False)


def fusable_runs(pipeline) -> List[List[BaseTransform]]:
    """Find maximal linked runs with >= 2 fusable non-passthrough
    transforms; interior capsfilter/identity elements are carried along."""
    runs: List[List[BaseTransform]] = []
    seen = set()
    for e in pipeline.elements:
        if id(e) in seen or not hasattr(e, "pure_kernel"):
            continue
        run = [e]
        seen.add(id(e))
        cur = e
        while True:
            peer = cur.srcpad.peer if hasattr(cur, "srcpad") else None
            nxt = peer.element if peer is not None else None
            if nxt is not None and hasattr(nxt, "pure_kernel") and id(nxt) not in seen:
                run.append(nxt)
                seen.add(id(nxt))
                cur = nxt
            else:
                break
        while run and _is_identity(run[0]):
            run.pop(0)
        while run and _is_identity(run[-1]):
            run.pop()
        if sum(1 for x in run if not _is_identity(x)) >= 2:
            runs.append(run)
    return runs


def fuse_pipeline(pipeline) -> int:
    """Rewire every fusable run so the FIRST element executes the whole
    fused program and the rest pass through.  The kernels are built at the
    first buffer, when caps are fixed (elements' pure kernels close over
    negotiated state).  Returns the number of fused runs."""
    runs = fusable_runs(pipeline)
    for run in runs:
        head = run[0]

        def make_head_chain(run=run):
            state: Dict[str, Optional[FusedRun]] = {"fused": None}

            def chain(pad: Pad, buf: Buffer) -> FlowReturn:
                if state["fused"] is None:
                    state["fused"] = fuse(run)
                buf.data = state["fused"](buf.data)
                return run[-1].srcpad.push(buf)

            return chain

        head.sinkpad.chain_function = make_head_chain()
    return len(runs)


__all__ = ["FusedRun", "captures", "fusable_runs", "fuse", "fuse_pipeline", "replays"]
