"""Pipeline: element container + scheduler + bus.

The reference delegates the pipeline graph and threading to the external
GStreamer C core (SURVEY.md §1).  Here the host control plane drives sources
round-robin on one thread — the cooperative "many elements, few threads"
stance of the in-repo threadshare runtime
(generic/threadshare/src/runtime/mod.rs:9-49) — while all hot compute runs as
batched device dispatches.
"""
from __future__ import annotations

from typing import List, Optional

from .basesrc import BaseSrc
from .bus import Bus
from .element import Element, State


class Pipeline:
    def __init__(self, name: str = "pipeline0"):
        self.name = name
        self.bus = Bus()
        self.elements: List[Element] = []
        self.tracers: List = []  # utils.tracers hooks
        self.parent = None
        self.clock = None  # selected on PAUSED->PLAYING; use_clock() overrides
        self._forced_clock = False
        self.base_time = 0
        self._running_offset = 0  # running time accumulated before a pause
        # GSTPU_TRACERS env activation (utils/tracers analog)
        from ..utils.tracers import install_from_env

        install_from_env(self)

    def use_clock(self, clock) -> None:
        """Force a specific clock (e.g. a TestClock); None reverts to auto."""
        self.clock = clock
        self._forced_clock = clock is not None

    def add(self, *elements: Element) -> None:
        for e in elements:
            if e.parent is not None:
                raise ValueError(f"{e.name} already in a pipeline")
            e.parent = self
            self.elements.append(e)

    def by_name(self, name: str) -> Element:
        for e in self.elements:
            if e.name == name:
                return e
        raise KeyError(f"no element {name!r} in {self.name}")

    def add_tracer(self, tracer) -> None:
        self.tracers.append(tracer)

    # -- state ---------------------------------------------------------------
    def set_state(self, target: State) -> None:
        was_playing = any(e.state == State.PLAYING for e in self.elements)
        if target < State.PLAYING and was_playing and self.clock is not None:
            # pausing: bank the running time so resume continues from here
            # instead of restarting at 0 (the C core offsets base_time by
            # the paused duration)
            self._running_offset = self.clock.now() - self.base_time
        if target >= State.PLAYING and self.state_below(State.PLAYING):
            # select + distribute the clock and stamp base_time before any
            # element reaches PLAYING (elements arm timers in
            # on_paused_to_playing) — the C core's clock distribution
            if self.clock is None and not self._forced_clock:
                from .clock import SystemClock

                self.clock = SystemClock.obtain()
            self.base_time = ((self.clock.now() - self._running_offset)
                              if self.clock is not None else 0)
            for e in self.elements:
                e.clock = self.clock
                e.base_time = self.base_time
        if target == State.NULL:
            self._running_offset = 0
        # Sinks first on upward changes (like the C core), sources first on down.
        order = list(reversed(self.elements)) if target > State.NULL else self.elements
        for e in order:
            e.set_state(target)

    def state_below(self, s: State) -> bool:
        return all(e.state < s for e in self.elements) if self.elements else True

    # -- queries ---------------------------------------------------------------
    def query_latency(self):
        """Issue a latency query upstream from every sink; returns the query
        whose min_latency is the pipeline's (max over sinks), as the C
        core's latency distribution does."""
        from .events import Query

        best = None
        for e in self.elements:
            if e.src_pads():  # not a sink
                continue
            sinks = e.sink_pads()
            if not sinks or sinks[0].peer is None:
                continue
            q = Query.new_latency()
            if sinks[0].peer_query(q):
                if best is None or q.result.get("min_latency", 0) > best.result.get("min_latency", 0):
                    best = q
        return best

    # -- seeking / position (gst_element_seek_simple model) -------------------
    def seek(self, position: int, *, rate: float = 1.0, flush: bool = True,
             stop=None) -> bool:
        """Flushing seek to `position` ns: delivered to every seekable
        source (the C core sends seeks to sinks which travel upstream;
        sources are where they land either way)."""
        from .events import Event

        ok = False
        for src in self.sources():
            ok = src.send_event(Event.new_seek(
                position, stop, rate=rate, flush=flush)) or ok
        return ok

    def query_position(self):
        """Stream position in ns from the first source that knows it."""
        from .events import Query

        for src in self.sources():
            q = Query.new_position()
            if src._src_query(src.srcpad, q) and "position" in q.result:
                return q.result["position"]
        return None

    def query_duration(self):
        from .events import Query

        for src in self.sources():
            q = Query.new_duration()
            if src._src_query(src.srcpad, q) and "duration" in q.result:
                return q.result["duration"]
        return None

    # -- scheduling ----------------------------------------------------------
    def sources(self) -> List[BaseSrc]:
        return [e for e in self.elements if isinstance(e, BaseSrc)]

    def run(self, max_iterations: Optional[int] = None) -> None:
        """Drive all sources round-robin until every source hit EOS.

        Sources with a non-empty `context` property are grouped by name
        and each group is driven on its own thread — threadshare's
        Context semantics (same context ⇒ same thread, different
        contexts run in parallel); a group parks `context-wait` ms when
        every source in it reported no data.  Sources without a context
        drive on the calling thread, as before.

        Must be called with the pipeline in PLAYING state."""
        import threading

        groups: dict = {}
        for s in self.sources():
            groups.setdefault(s._props.get("context") or "", []).append(s)
        # self-driving elements (internal worker threads, e.g. fallbacksrc)
        # expose wait_stream_done() instead of the BaseSrc iterate protocol
        selfdriving = [e for e in self.elements
                       if hasattr(e, "wait_stream_done")]
        if not groups and not selfdriving:
            raise RuntimeError(f"{self.name}: no sources to drive")
        main = groups.pop("", [])
        errors: List[BaseException] = []
        threads = []
        for ctx, srcs in groups.items():
            wait_ms = max((s._props.get("context-wait") or 0) for s in srcs) or 5
            t = threading.Thread(
                target=self._drive_group,
                args=(srcs, max_iterations, wait_ms / 1000.0, errors),
                daemon=True, name=f"{self.name}-ctx-{ctx}")
            t.start()
            threads.append(t)
        if main:
            self._drive_group(main, max_iterations, None, errors)
        for t in threads:
            t.join()
        if max_iterations is None:
            for e in selfdriving:
                e.wait_stream_done()
        if errors:
            raise errors[0]

    def _drive_group(self, srcs, max_iterations, idle_wait, errors) -> None:
        from .element import FlowReturn

        active = {id(s): s for s in srcs}
        iters = 0
        try:
            while active:
                all_idle = True
                for key, src in list(active.items()):
                    ret = src.iterate()
                    if ret == FlowReturn.EOS:
                        del active[key]
                    elif ret == FlowReturn.ERROR:
                        raise RuntimeError(f"{src.name}: flow error")
                    if not getattr(src, "_last_was_retry", False):
                        all_idle = False
                iters += 1
                if max_iterations is not None and iters >= max_iterations:
                    break
                if idle_wait and all_idle and active:
                    import time as _time

                    _time.sleep(idle_wait)
        except BaseException as e:
            errors.append(e)
            if idle_wait is None:  # calling thread: raise directly
                raise

    def play_until_eos(self, max_iterations: Optional[int] = None) -> None:
        self.set_state(State.PLAYING)
        try:
            self.run(max_iterations)
        finally:
            self.set_state(State.NULL)


__all__ = ["Pipeline"]
