"""RTP jitterbuffer: seqnum reordering with a latency window.

From-scratch analog of the reference's rtpbin2 jitterbuffer
(net/rtp/src/rtpbin2/jitterbuffer.rs: insert by extended seqnum, forward
in-order packets, flush head past the latency deadline; latency=0 forwards
everything immediately, jitterbuffer.rs:96-143,203-236).

In this synchronous runtime "time" is buffer pts: a held packet's deadline
expires when the newest arrival's pts exceeds head pts + latency.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from .rtp import SeqnumTracker


@dataclass(order=True)
class _Entry:
    ext_seq: int
    item: Any = field(compare=False)
    pts: Optional[int] = field(compare=False, default=None)
    arrival: Optional[int] = field(compare=False, default=None)  # clock ns


class JitterBuffer:
    def __init__(self, latency_ns: int = 0):
        self.latency = latency_ns
        self._tracker = SeqnumTracker()
        self._queue: List[_Entry] = []  # kept sorted by ext_seq
        self._next_seq: Optional[int] = None  # next expected ext seqnum
        self._max_pts: Optional[int] = None
        self.num_late_dropped = 0
        self.num_lost = 0
        self.num_duplicates = 0

    def insert(self, seqnum: int, item: Any, pts: Optional[int] = None,
               arrival: Optional[int] = None) -> List[Any]:
        """Insert a packet, return the packets releasable now (in order).
        `arrival` (clock ns) enables the timer-driven deadline machinery
        (release_expired/next_deadline — the reference jitterbuffer's
        lost-timer model, net/rtp/src/rtpbin2/jitterbuffer.rs)."""
        ext, _gap = self._tracker.update(seqnum)
        if pts is not None:
            self._max_pts = pts if self._max_pts is None else max(self._max_pts, pts)
        if self._next_seq is not None and ext < self._next_seq:
            # too late: already forwarded past it (jitterbuffer.rs "Late")
            self.num_late_dropped += 1
            return self._release()
        if any(e.ext_seq == ext for e in self._queue):
            self.num_duplicates += 1
            return self._release()
        entry = _Entry(ext, item, pts, arrival)
        lo, hi = 0, len(self._queue)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._queue[mid].ext_seq < ext:
                lo = mid + 1
            else:
                hi = mid
        self._queue.insert(lo, entry)
        return self._release()

    def _release(self) -> List[Any]:
        out: List[Any] = []
        while self._queue:
            head = self._queue[0]
            in_order = self._next_seq is None or head.ext_seq == self._next_seq
            expired = (
                self.latency == 0
                or head.pts is None
                or self._max_pts is None
                or self._max_pts - head.pts >= self.latency
            )
            if in_order or expired:
                if self._next_seq is not None and head.ext_seq > self._next_seq:
                    self.num_lost += head.ext_seq - self._next_seq
                out.append(head.item)
                self._next_seq = head.ext_seq + 1
                self._queue.pop(0)
            else:
                break
        return out

    def release_expired(self, now_ns: int) -> List[Any]:
        """Clock-timer path: release heads held past the latency window
        (gap never filled), advancing num_lost like a fired lost-timer."""
        out: List[Any] = []
        while self._queue:
            head = self._queue[0]
            in_order = self._next_seq is None or head.ext_seq == self._next_seq
            overdue = (head.arrival is not None
                       and now_ns - head.arrival >= self.latency)
            if not (in_order or overdue):
                break
            if self._next_seq is not None and head.ext_seq > self._next_seq:
                self.num_lost += head.ext_seq - self._next_seq
            out.append(head.item)
            self._next_seq = head.ext_seq + 1
            self._queue.pop(0)
        return out

    def next_deadline(self) -> Optional[int]:
        """Earliest clock time at which a held head expires, or None."""
        if not self._queue:
            return None
        head = self._queue[0]
        if self._next_seq is not None and head.ext_seq == self._next_seq:
            return None  # in order; releasable immediately via insert path
        if head.arrival is None:
            return None
        return head.arrival + self.latency

    def flush(self) -> List[Any]:
        """EOS: drain everything in seqnum order."""
        out = [e.item for e in self._queue]
        if self._queue:
            if self._next_seq is not None:
                self.num_lost += sum(
                    1 for a, b in zip(self._queue, self._queue[1:])
                    if b.ext_seq != a.ext_seq + 1
                )
            self._next_seq = self._queue[-1].ext_seq + 1
        self._queue.clear()
        return out

    def __len__(self) -> int:
        return len(self._queue)


__all__ = ["JitterBuffer"]
