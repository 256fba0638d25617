"""rtpgccbwe: Google Congestion Control bandwidth estimator element.

Parity target: net/rtp/src/gcc/imp.rs (rtpgccbwe, registered gcc/mod.rs:19):
a passthrough on the RTP stream that consumes TWCC feedback and publishes
`estimated-bitrate`.  Feedback arrives as a custom upstream event named
"rtp-twcc-feedback" carrying [(seqnum, send_ns, arrival_ns|None, size)]
tuples (the reference listens for the equivalent RTCP TWCC event);
`push_feedback()` offers the same entry point programmatically.  Changes
post an `rtpgccbwe-estimate` element message (the notify::estimated-bitrate
analog).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from ...core import (
    BaseTransform,
    Buffer,
    Caps,
    Event,
    Prop,
    TransformMode,
    register,
)
from ...core.caps import Structure
from ...core.events import EventType, Message, MessageType
from ...net.gcc import GoogCC, PacketFeedback

RTP_CAPS = Caps.builder("application/x-rtp")


@register
class RtpGccBwe(BaseTransform):
    ELEMENT_NAME = "rtpgccbwe"
    ELEMENT_CLASS = "Network/Filter/RTP"
    ELEMENT_DESCRIPTION = "Google Congestion Control bandwidth estimator"
    MODE = TransformMode.ALWAYS_IN_PLACE
    PASSTHROUGH_ON_SAME_CAPS = False
    SINK_CAPS = RTP_CAPS
    SRC_CAPS = RTP_CAPS
    PROPERTIES = [
        Prop("min-bitrate", 100_000, type="uint"),
        Prop("max-bitrate", 50_000_000, type="uint"),
        Prop("estimated-bitrate", 1_000_000, type="uint", mutable="playing",
             doc="current estimate; set = starting bitrate"),
        Prop("estimator", "kalman", type="enum",
             choices=["kalman", "linear"],
             doc="delay-gradient estimator; this implementation's "
                 "trendline (linear-regression) estimator serves both "
                 "nicks — kalman is accepted and maps to it"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._cc: Optional[GoogCC] = None
        # consume rtp-twcc-feedback arriving UPSTREAM from a downstream
        # rtpsend (the reference's RTCP TWCC event travels the same way)
        self.srcpad.event_function = self._src_event

    def _src_event(self, pad, event: Event) -> bool:
        if (event.type in (EventType.CUSTOM_DOWNSTREAM, EventType.CUSTOM_UPSTREAM)
                and event.get("name") == "rtp-twcc-feedback"):
            self.push_feedback(event.get("packets"))
            return True  # consumed
        return self.sinkpad.push_event(event)  # forward upstream

    def on_ready_to_paused(self) -> None:
        super().on_ready_to_paused()
        self._cc = GoogCC(
            start_bitrate=self.get_property("estimated-bitrate"),
            min_bitrate=self.get_property("min-bitrate"),
            max_bitrate=self.get_property("max-bitrate"),
        )

    def transform_ip(self, buf: Buffer) -> Buffer:
        return buf  # pure passthrough; estimation is feedback-driven

    def push_feedback(self, packets: List[Tuple[int, int, Optional[int], int]]) -> int:
        """[(seqnum, send_ns, arrival_ns|None, size_bytes)] -> new estimate."""
        assert self._cc is not None, "element must be PAUSED or PLAYING"
        old = self.get_property("estimated-bitrate")
        est = self._cc.process_feedback([PacketFeedback(*p) for p in packets])
        self._props["estimated-bitrate"] = est
        if est != old:
            self.post_message(
                Message(MessageType.ELEMENT,
                        structure=Structure("rtpgccbwe-estimate", bitrate=est))
            )
        return est

    def sink_event(self, event: Event) -> bool:
        if (
            event.type in (EventType.CUSTOM_DOWNSTREAM, EventType.CUSTOM_UPSTREAM)
            and event.get("name") == "rtp-twcc-feedback"
        ):
            self.push_feedback(event.get("packets"))
            return False  # consumed
        return True


__all__ = ["RtpGccBwe"]
