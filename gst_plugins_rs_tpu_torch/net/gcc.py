"""Google Congestion Control (GCC) bandwidth estimation.

From-scratch implementation of the algorithm behind the reference's
rtpgccbwe element (net/rtp/src/gcc/imp.rs, ~1500 LoC; see
draft-ietf-rmcat-gcc-02): a delay-based controller (arrival-time grouping,
trendline slope estimator, adaptive-threshold overuse detector, AIMD rate
control) combined with a loss-based controller, taking TWCC-style
per-packet feedback (send time, arrival time, size, lost).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

MS = 1_000_000  # ns per ms

BURST_INTERVAL = 5 * MS  # packets sent within 5 ms form one group
TRENDLINE_WINDOW = 20
THRESHOLD_GAIN = 4.0
K_UP = 0.0087
K_DOWN = 0.039
OVERUSE_TIME_TH = 10 * MS
BETA = 0.85  # multiplicative decrease
LOSS_DECREASE_TH = 0.10
LOSS_INCREASE_TH = 0.02


@dataclass
class PacketFeedback:
    seqnum: int
    send_time: int  # ns
    arrival_time: Optional[int]  # ns; None = lost
    size: int  # bytes


@dataclass
class _Group:
    first_send: int
    last_send: int
    arrival: int
    size: int


class TrendlineEstimator:
    """Linear-regression slope over smoothed accumulated delay
    (gcc/imp.rs trendline; draft-ietf-rmcat-gcc-02 §5.3)."""

    def __init__(self) -> None:
        self.history: List[Tuple[float, float]] = []  # (time_ms, smoothed_delay)
        self.acc = 0.0
        self.smoothed = 0.0
        self.first_time: Optional[int] = None

    def update(self, delay_delta_ns: int, arrival_ns: int) -> float:
        if self.first_time is None:
            self.first_time = arrival_ns
        d_ms = delay_delta_ns / MS
        self.acc += d_ms
        self.smoothed = 0.9 * self.smoothed + 0.1 * self.acc
        t = (arrival_ns - self.first_time) / MS
        self.history.append((t, self.smoothed))
        if len(self.history) > TRENDLINE_WINDOW:
            self.history.pop(0)
        if len(self.history) < 2:
            return 0.0
        xs = [h[0] for h in self.history]
        ys = [h[1] for h in self.history]
        mx = sum(xs) / len(xs)
        my = sum(ys) / len(ys)
        num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
        den = sum((x - mx) ** 2 for x in xs)
        return num / den if den else 0.0


class OveruseDetector:
    """Adaptive-threshold overuse detection (§5.4; gamma adapts with
    K_UP/K_DOWN)."""

    def __init__(self) -> None:
        self.threshold = 12.5  # ms
        self.last_update: Optional[int] = None
        self.overusing_since: Optional[int] = None
        self.prev_trend = 0.0

    def detect(self, trend: float, n_groups: int, now_ns: int) -> str:
        modified = min(max(trend * THRESHOLD_GAIN * min(n_groups, 60), -600.0), 600.0)
        state = "normal"
        if modified > self.threshold:
            if self.overusing_since is None:
                self.overusing_since = now_ns
            sustained = now_ns - self.overusing_since >= OVERUSE_TIME_TH
            if sustained and modified >= self.prev_trend:
                state = "overuse"
        elif modified < -self.threshold:
            self.overusing_since = None
            state = "underuse"
        else:
            self.overusing_since = None
        # gamma adaptation
        if self.last_update is not None and abs(modified) < self.threshold + 15.0:
            k = K_DOWN if abs(modified) < self.threshold else K_UP
            dt = min((now_ns - self.last_update) / MS, 100.0)
            self.threshold += k * (abs(modified) - self.threshold) * dt
            self.threshold = min(max(self.threshold, 6.0), 600.0)
        self.last_update = now_ns
        self.prev_trend = modified
        return state


class AimdRateControl:
    """Rate state machine: increase / hold / decrease (§5.5)."""

    def __init__(self, start_bitrate: int, min_bitrate: int, max_bitrate: int):
        self.bitrate = float(start_bitrate)
        self.min = float(min_bitrate)
        self.max = float(max_bitrate)
        self.state = "increase"
        self.last_decrease_rate: Optional[float] = None

    def update(self, overuse_state: str, incoming_bitrate: float, now_ns: int) -> int:
        if overuse_state == "overuse":
            self.state = "decrease"
        elif overuse_state == "underuse":
            self.state = "hold"
        elif self.state != "increase":
            self.state = "increase"

        if self.state == "decrease":
            self.bitrate = max(incoming_bitrate * BETA, self.min)
            self.last_decrease_rate = incoming_bitrate
            self.state = "hold"
        elif self.state == "increase":
            near_convergence = (
                self.last_decrease_rate is not None
                and abs(self.bitrate - self.last_decrease_rate) < 0.5 * self.last_decrease_rate
            )
            if near_convergence:
                self.bitrate += max(1000.0, 0.04 * self.bitrate / 8)  # additive
            else:
                self.bitrate *= 1.08  # multiplicative
        self.bitrate = min(max(self.bitrate, self.min), self.max)
        return int(self.bitrate)


class GoogCC:
    """Combined delay+loss controller consuming per-packet feedback."""

    def __init__(self, *, start_bitrate=1_000_000, min_bitrate=100_000, max_bitrate=50_000_000):
        self.trendline = TrendlineEstimator()
        self.detector = OveruseDetector()
        self.aimd = AimdRateControl(start_bitrate, min_bitrate, max_bitrate)
        self._group: Optional[_Group] = None
        self._prev_group: Optional[_Group] = None
        self._n_groups = 0
        self._recv_window: List[Tuple[int, int]] = []  # (arrival, size)
        self.last_state = "normal"

    # -- helpers --------------------------------------------------------------
    def _incoming_bitrate(self, now_ns: int) -> float:
        window = 500 * MS
        self._recv_window = [(t, s) for t, s in self._recv_window if now_ns - t <= window]
        if not self._recv_window:
            return self.aimd.bitrate
        span = max(now_ns - min(t for t, _ in self._recv_window), MS)
        return sum(s for _, s in self._recv_window) * 8 * 1_000_000_000 / span

    def _close_group(self, now_ns: int) -> None:
        if self._prev_group is not None and self._group is not None:
            send_delta = self._group.last_send - self._prev_group.last_send
            arrival_delta = self._group.arrival - self._prev_group.arrival
            delay_delta = arrival_delta - send_delta
            trend = self.trendline.update(delay_delta, self._group.arrival)
            self._n_groups += 1
            self.last_state = self.detector.detect(trend, self._n_groups, now_ns)
        self._prev_group = self._group
        self._group = None

    # -- public ---------------------------------------------------------------
    def process_feedback(self, packets: List[PacketFeedback]) -> int:
        """Feed one TWCC report's packets; returns the estimated bitrate."""
        arrived = [p for p in packets if p.arrival_time is not None]
        lost = len(packets) - len(arrived)
        now = max((p.arrival_time for p in arrived), default=None)
        for p in sorted(arrived, key=lambda p: p.send_time):
            self._recv_window.append((p.arrival_time, p.size))
            if self._group is None:
                self._group = _Group(p.send_time, p.send_time, p.arrival_time, p.size)
            elif p.send_time - self._group.first_send > BURST_INTERVAL:
                self._close_group(p.arrival_time)
                self._group = _Group(p.send_time, p.send_time, p.arrival_time, p.size)
            else:
                self._group.last_send = p.send_time
                self._group.arrival = max(self._group.arrival, p.arrival_time)
                self._group.size += p.size
        if now is None:
            return int(self.aimd.bitrate)
        estimate = self.aimd.update(self.last_state, self._incoming_bitrate(now), now)
        # loss-based controller (§6)
        if packets:
            loss = lost / len(packets)
            if loss > LOSS_DECREASE_TH:
                estimate = int(estimate * (1 - 0.5 * loss))
            elif loss < LOSS_INCREASE_TH:
                estimate = int(estimate * 1.05)
            estimate = int(min(max(estimate, self.aimd.min), self.aimd.max))
            self.aimd.bitrate = float(estimate)
        return estimate


__all__ = ["GoogCC", "PacketFeedback", "TrendlineEstimator", "OveruseDetector", "AimdRateControl"]
