"""webrtcsend / webrtcrecv — low-level signaling-agnostic WebRTC elements.

Parity target: net/webrtcbin2 (webrtcsend, webrtcrecv + WebRTCSession):
elements that do media transport only; the APPLICATION performs the SDP
exchange through the session API instead of a built-in signaller.

Session API here (the WebRTCSession analog):
  send = make("webrtcsend");  offer = send.create_offer()
  recv = make("webrtcrecv");  answer = recv.handle_offer(offer)
  send.handle_answer(answer)
Each side posts a `webrtc-session-status` element message when the
DTLS-SRTP transport connects.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

import numpy as np

from ...core import (
    BaseSink,
    BaseSrc,
    Buffer,
    Caps,
    FlowReturn,
    Message,
    MessageType,
    Prop,
    register,
)
from ...core.payload import host_bytes
from ...core.parse import parse_caps
from ...net.webrtc_peer import PeerConnection

RTP_CAPS = Caps.builder("application/x-rtp")


class WebRTCSession:
    """The GstWebRTCSession analog returned by the `session` property:
    W3C-style description/signaling-state surface over the element's
    PeerConnection (reference rswebrtcbin2 other-types GstWebRTCSession).
    `pc` is the underlying transport session."""

    def __init__(self, owner) -> None:
        self._owner = owner

    @property
    def pc(self) -> Optional[PeerConnection]:
        return self._owner._pc

    def get_property(self, name: str):
        o = self._owner
        if name == "current-local-description":
            return o._sess_current_local
        if name == "current-remote-description":
            return o._sess_current_remote
        if name == "pending-local-description":
            return o._sess_pending_local
        if name == "pending-remote-description":
            return o._sess_pending_remote
        if name == "signaling-state":
            return o._sess_signaling_state
        raise KeyError(f"WebRTCSession: no property {name!r}")

    def __repr__(self):
        return (f"WebRTCSession(state={self._owner._sess_signaling_state!r}, "
                f"pc={self.pc})")


class _SessionMixin:
    """Expose PeerConnection SDP/ICE handles on the element (WebRTCSession)."""

    #: surface of the object the `session` property returns (audited by
    #: ci/prop_parity.py OBJECT_TYPES["GstWebRTCSession"])
    OBJECT_PROPERTIES = {
        "GstWebRTCSession": [
            Prop("current-local-description", None, type="str",
                 doc="(read) latest local SDP that negotiated to stable"),
            Prop("current-remote-description", None, type="str",
                 doc="(read) latest remote SDP that negotiated to stable"),
            Prop("pending-local-description", None, type="str",
                 doc="(read) local SDP still being negotiated"),
            Prop("pending-remote-description", None, type="str",
                 doc="(read) remote SDP still being negotiated"),
            Prop("signaling-state", "stable", type="enum",
                 choices=["stable", "have-local-offer", "have-remote-offer"],
                 doc="(read) W3C RTCSignalingState"),
        ],
    }

    # description/signaling-state tracking (W3C negotiation state machine)
    _sess_current_local: Optional[str] = None
    _sess_current_remote: Optional[str] = None
    _sess_pending_local: Optional[str] = None
    _sess_pending_remote: Optional[str] = None
    _sess_signaling_state: str = "stable"

    def _ensure_pc(self, offerer: bool) -> PeerConnection:
        if self._pc is None:
            pc = PeerConnection(offerer=offerer)
            self._configure_pc(pc)
            pc.start()
            self._pc = pc
            self._watch_connected()
        return self._pc

    def _watch_connected(self) -> None:
        def watch(pc=self._pc):
            if pc.wait_connected(30.0):
                self.post_message(Message(
                    MessageType.ELEMENT, name="webrtc-session-status", status="connected"
                ))

        threading.Thread(target=watch, daemon=True).start()

    def _configure_pc(self, pc: PeerConnection) -> None:  # overridden
        pass

    # -- the session API -------------------------------------------------------
    def create_offer(self, direction: str) -> str:
        offer = self._ensure_pc(offerer=True).create_offer(direction)
        self._sess_pending_local = offer
        self._sess_signaling_state = "have-local-offer"
        return offer

    def handle_answer(self, sdp: str) -> None:
        self._ensure_pc(offerer=True).handle_answer(sdp)
        self._sess_current_local = self._sess_pending_local
        self._sess_pending_local = None
        self._sess_current_remote = sdp
        self._sess_signaling_state = "stable"

    def handle_offer(self, sdp: str, direction: str) -> str:
        self._sess_pending_remote = sdp
        self._sess_signaling_state = "have-remote-offer"
        answer = self._ensure_pc(offerer=False).handle_offer(sdp, direction)
        self._sess_current_remote = sdp
        self._sess_pending_remote = None
        self._sess_current_local = answer
        self._sess_signaling_state = "stable"
        return answer

    def add_remote_ice(self, candidate: str) -> None:
        if self._pc is not None:
            self._pc.add_remote_ice(candidate)

    def local_candidates(self):
        return [c.to_sdp() for c in self._ensure_pc(True).ice.local_candidates()] \
            if self._pc is None else [c.to_sdp() for c in self._pc.ice.local_candidates()]

    def is_connected(self) -> bool:
        return self._pc is not None and self._pc._connected.is_set()

    def _teardown_pc(self) -> None:
        if self._pc is not None:
            self._pc.close()
            self._pc = None


@register
class WebRtcSend(BaseSink, _SessionMixin):
    ELEMENT_NAME = "webrtcsend"
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "Low-level WebRTC sender; the application drives SDP"
    SINK_CAPS = RTP_CAPS
    PROPERTIES = [
        Prop("timeout", 10_000_000_000, type="uint64"),
        Prop("id", "", type="str",
             doc="session id pairing this sender with a webrtcrecv (the "
                 "reference shares one PeerConnection between halves with "
                 "the same id)"),
        Prop("session", None, type="object",
             doc="(read) the underlying PeerConnection session object"),
        Prop("early-data-mode", "none", type="enum",
             choices=["none", "allow"],
             doc="accept media before the session is fully negotiated; "
                 "none drops pre-negotiation buffers"),
    ]

    def get_property(self, name):
        if name == "session":
            return WebRTCSession(self)
        return super().get_property(name)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._pc: Optional[PeerConnection] = None

    def _configure_pc(self, pc: PeerConnection) -> None:
        s = self.caps.structure(0) if self.caps is not None and self.caps.structures else None
        if s is not None:
            pc.set_media(
                s.get("media", "video"), int(s.get("payload", 96)),
                s.get("encoding-name", "VP8"), int(s.get("clock-rate", 90000)),
            )

    def create_offer(self, direction: str = "sendonly") -> str:
        return _SessionMixin.create_offer(self, direction)

    def render(self, buffer: Buffer) -> FlowReturn:
        if self._pc is None:
            return FlowReturn.ERROR
        if not self._pc._connected.is_set():
            timeout = self.get_property("timeout")
            if not self._pc.wait_connected(timeout / 1e9 if timeout else 30.0):
                return FlowReturn.ERROR
        self._pc.send_rtp(host_bytes(buffer.data, np.uint8))
        return FlowReturn.OK

    def on_paused_to_ready(self) -> None:
        self._teardown_pc()


@register
class WebRtcRecv(BaseSrc, _SessionMixin):
    ELEMENT_NAME = "webrtcrecv"
    ELEMENT_CLASS = "Source/Network/WebRTC"
    ELEMENT_DESCRIPTION = "Low-level WebRTC receiver; the application drives SDP"
    SRC_CAPS = RTP_CAPS
    IS_LIVE = True
    PROPERTIES = [
        Prop("timeout", 10_000_000_000, type="uint64"),
        Prop("id", "", type="str",
             doc="session id pairing this receiver with a webrtcsend"),
        Prop("session", None, type="object",
             doc="(read) the underlying PeerConnection session object"),
        Prop("threadshare-context", "", type="str",
             doc="context name (source groups are driven per-context by "
                 "Pipeline.run, the threadshare scheduler analog)"),
        Prop("threadshare-context-wait", 5, type="uint", maximum=1000),
        Prop("threadshare-mode", "none", type="enum",
             choices=["none", "context"],
             doc="none = pipeline round-robin; context = drive on the "
                 "named context group"),
    ]

    def get_property(self, name):
        if name == "session":
            return WebRTCSession(self)
        return super().get_property(name)

    def property_changed(self, name, value) -> None:
        # Pipeline.run groups sources by the `context` key in _props (the
        # threadshare scheduler analog); mirror the threadshare-* naming
        if name in ("threadshare-context", "threadshare-mode"):
            mode = self._props.get("threadshare-mode")
            self._props["context"] = (
                self._props.get("threadshare-context") or ""
            ) if mode == "context" else ""
            self._props.setdefault(
                "context-wait", self._props.get("threadshare-context-wait", 5))

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._pc: Optional[PeerConnection] = None
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._media = ("video", 96, "VP8", 90000)

    def _configure_pc(self, pc: PeerConnection) -> None:
        pc.on_rtp = self._queue.put

    def handle_offer(self, sdp: str, direction: str = "recvonly") -> str:
        answer = _SessionMixin.handle_offer(self, sdp, direction)
        import re
        m = re.search(r"^m=(\w+) \d+ [\w/]+ (\d+)", sdp, re.M)
        rtpmap = re.search(r"^a=rtpmap:(\d+) ([\w\-]+)/(\d+)", sdp, re.M)
        if m and rtpmap:
            self._media = (m.group(1), int(rtpmap.group(1)), rtpmap.group(2), int(rtpmap.group(3)))
        return answer

    def stop(self) -> None:
        self._teardown_pc()
        self._queue.put(None)

    def fixate(self, caps: Caps) -> Caps:
        media, pt, enc, rate = self._media
        return parse_caps(
            f"application/x-rtp,media={media},payload={pt},encoding-name={enc},clock-rate={rate}"
        )

    def create(self):
        timeout = self.get_property("timeout")
        try:
            data = self._queue.get(timeout=(timeout / 1e9) if timeout else None)
        except queue.Empty:
            return None
        if data is None:
            return None
        return Buffer(np.frombuffer(data, np.uint8))
