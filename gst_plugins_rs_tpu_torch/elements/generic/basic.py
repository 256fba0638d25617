"""Basic plumbing elements: capsfilter, identity, queue (threaded decoupling stage)."""
from __future__ import annotations

from typing import Optional

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Element,
    PadDirection,
    Prop,
    TransformMode,
    register,
)


@register
class CapsFilter(BaseTransform):
    """Constrains negotiation to its `caps` property (gst capsfilter)."""

    ELEMENT_NAME = "capsfilter"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Pass data unchanged, limiting formats"
    PROPERTIES = [Prop("caps", Caps.new_any(), type="object", doc="allowed caps")]
    PASSTHROUGH_ON_SAME_CAPS = False
    TRANSFORM_IP_ON_PASSTHROUGH = False
    FUSE_IDENTITY = True

    def transform_caps(self, direction: PadDirection, caps: Caps, filter_: Optional[Caps]) -> Caps:
        out = caps.intersect(self.get_property("caps"))
        if filter_ is not None:
            out = out.intersect(filter_)
        return out

    def transform_ip(self, buf: Buffer) -> Buffer:
        return buf

    def pure_kernel(self):
        """Chain-fusion hook (parallel/fuse.py): capsfilter moves no data, so
        a fused run may span the caps constraints between its transforms."""
        return lambda d: d


@register
class Identity(BaseTransform):
    ELEMENT_NAME = "identity"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Pass data through unchanged"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = True
    FUSE_IDENTITY = True

    def transform_ip(self, buf: Buffer) -> Buffer:
        return buf

    def pure_kernel(self):
        return lambda d: d


@register
class Queue(Element):
    """Decoupling queue with a worker thread: upstream returns as soon as
    the item is enqueued (blocking only when full — backpressure like the
    C core), while a dedicated thread drives everything downstream.

    This is the host-side pipeline-parallelism stage (SURVEY.md §2.3 PP
    row): source/device work upstream of the queue overlaps with the
    downstream chain, the same decoupling the reference gets from the C
    core's one-thread-per-queue model and threadshare's task groups.

    Level/limit/leaky surface matches threadshare ts-queue
    (generic/threadshare/src/queue/imp.rs): max-size-{buffers,bytes,time}
    (0 = that limit unlimited), `leaky` drops instead of blocking
    (upstream = drop arriving buffer, downstream = evict oldest), and the
    read-only current-level-{buffers,bytes,time} report live occupancy.
    Serialized events are never dropped."""

    ELEMENT_NAME = "queue"
    ELEMENT_CLASS = "Generic"
    ELEMENT_DESCRIPTION = "Thread-decoupling buffer queue"
    PROPERTIES = [
        Prop("max-size-buffers", 200, type="uint",
             doc="Maximum number of buffers to queue (0=unlimited)"),
        Prop("max-size-bytes", 1_048_576, type="uint",
             doc="Maximum number of bytes to queue (0=unlimited)"),
        Prop("max-size-time", 1_000_000_000, type="uint64",
             doc="Maximum number of nanoseconds to queue (0=unlimited)"),
        Prop("leaky", "no", type="enum", choices=["no", "upstream", "downstream"],
             doc="Where the queue leaks, if at all"),
        Prop("current-level-buffers", 0, type="uint",
             doc="(read) current number of buffers in the queue"),
        Prop("current-level-bytes", 0, type="uint",
             doc="(read) current amount of data in the queue (bytes)"),
        Prop("current-level-time", 0, type="uint64",
             doc="(read) current amount of data in the queue (ns)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        from ...core import Pad, PadPresence, PadTemplate

        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._items = None  # deque of ("buffer"|"event", payload)
        self._cond = None
        self._level_bytes = 0
        self._level_time = 0
        self._n_buffers = 0
        self._stopping = False
        self._thread = None
        self._ctx = None
        self._ctx_handle = None
        self._downstream_flow = None
        self._error: Optional[BaseException] = None

    # -- sizing helpers ------------------------------------------------------
    @staticmethod
    def _buf_bytes(buf: Buffer) -> int:
        data = getattr(buf, "data", None)
        return int(getattr(data, "nbytes", 0) or 0)

    @staticmethod
    def _buf_time(buf: Buffer) -> int:
        return int(buf.duration or 0) if getattr(buf, "duration", None) else 0

    def _full(self) -> bool:
        mb = self.get_property("max-size-buffers")
        mby = self.get_property("max-size-bytes")
        mt = self.get_property("max-size-time")
        return ((mb and self._n_buffers >= mb)
                or (mby and self._level_bytes >= mby)
                or (mt and self._level_time >= mt))

    def _account(self, kind, payload, sign: int) -> None:
        if kind == "buffer":
            self._n_buffers += sign
            self._level_bytes += sign * self._buf_bytes(payload)
            self._level_time += sign * self._buf_time(payload)

    # -- lifecycle -----------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        import collections
        import threading

        self._items = collections.deque()
        self._cond = threading.Condition()
        self._level_bytes = self._level_time = self._n_buffers = 0
        self._stopping = False
        self._downstream_flow = None
        self._error = None
        ctx_name = self._props.get("context") or ""
        if ctx_name:
            from ...core.taskcontext import TaskContext

            self._ctx = TaskContext.acquire(
                ctx_name, self._props.get("context-wait") or 5)
            self._ctx_handle = self._ctx.add_task(self._service_one)
        else:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name=f"{self.name}-worker")
            self._thread.start()

    def on_paused_to_ready(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if self._ctx is not None:
            # drain what's left on this thread, then detach from the context
            while self._service_one():
                pass
            self._ctx.remove_task(self._ctx_handle)
            self._ctx.release()
            self._ctx = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- servicing -----------------------------------------------------------
    def _service_one(self) -> bool:
        """Pop and push one item; False when idle. Runs on the worker
        thread or a shared TaskContext thread."""
        from ...core import FlowReturn

        with self._cond:
            if not self._items:
                return False
            kind, payload = self._items.popleft()
            self._account(kind, payload, -1)
            self._cond.notify_all()
        try:
            if kind == "buffer":
                ret = self.srcpad.push(payload)
                if ret not in (FlowReturn.OK, FlowReturn.NOT_LINKED):
                    self._downstream_flow = ret
            else:
                self.srcpad.push_event(payload)
        except BaseException as e:  # surface on the feeding thread
            self._error = e
            self._downstream_flow = FlowReturn.ERROR
        return True

    def _worker(self) -> None:
        while True:
            if self._service_one():
                continue
            with self._cond:
                if self._stopping and not self._items:
                    return
                self._cond.wait(0.05)

    # -- upstream side -------------------------------------------------------
    def _enqueue(self, kind, payload) -> None:
        leaky = self.get_property("leaky")
        with self._cond:
            if kind == "buffer" and self._full():
                if leaky == "upstream":
                    return  # drop the arriving buffer
                if leaky == "downstream":
                    while self._full():
                        evicted = False
                        for i, (k, p) in enumerate(self._items):
                            if k == "buffer":
                                del self._items[i]
                                self._account("buffer", p, -1)
                                evicted = True
                                break
                        if not evicted:
                            break
                else:
                    while self._full() and not self._stopping:
                        self._cond.wait(0.05)
            self._items.append((kind, payload))
            self._account(kind, payload, +1)
            self._cond.notify_all()
        if self._ctx is not None:
            self._ctx.wake()

    def _chain(self, pad, buf: Buffer):
        from ...core import FlowReturn

        if self._downstream_flow is not None:
            return self._downstream_flow
        if self._items is None:
            return FlowReturn.FLUSHING
        self._enqueue("buffer", buf)
        return FlowReturn.OK

    def _event(self, pad, event) -> bool:
        from ...core import EventType

        if self._items is None:
            return False
        if event.type == EventType.FLUSH_START:
            # flushing seek: queued data is stale — drop it immediately and
            # forward the flush out-of-band (the C core's flushing contract)
            with self._cond:
                self._items.clear()
                self._level_bytes = self._level_time = self._n_buffers = 0
                self._cond.notify_all()
            return self.srcpad.push_event(event)
        self._enqueue("event", event)
        return True

    def get_property(self, name: str):
        if name == "current-level-buffers":
            return self._n_buffers
        if name == "current-level-bytes":
            return self._level_bytes
        if name == "current-level-time":
            return self._level_time
        return super().get_property(name)

    @property
    def current_level_buffers(self) -> int:
        return self._n_buffers


__all__ = ["CapsFilter", "Identity", "Queue"]
