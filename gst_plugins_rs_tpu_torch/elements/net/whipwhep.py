"""WHIP/WHEP client and server elements over the native WebRTC stack.

Parity targets: net/webrtc's whipclientsink / whipserversrc /
whepclientsrc / whepserversink (the reference builds them as webrtcsink/
webrtcsrc signaller variants around webrtcbin; here they ride
net/webrtc_peer.PeerConnection — ICE RFC 8445 + DTLS 1.2 + SRTP).

Unlike the older whipsink/whepsrc (webrtchttp plugin, plain-RTP media
divergence documented there), these four carry media over real
DTLS-SRTP:

- whipclientsink: POST a sendonly offer to a WHIP endpoint (RFC 9725),
  apply the answer, stream SRTP.
- whipserversrc:  accept WHIP POSTs (media ingest server), answer, and
  emit the received RTP as buffers.
- whepclientsrc:  POST a recvonly offer to a WHEP endpoint, receive SRTP.
- whepserversink: accept WHEP POSTs (playout server) and stream to every
  connected viewer.

Client and server elements interop with each other end-to-end in tests.
"""
from __future__ import annotations

import queue
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.error import HTTPError
from urllib.parse import urlparse
from urllib.request import Request, urlopen

import numpy as np

from ...core import (
    BaseSink,
    BaseSrc,
    Buffer,
    Caps,
    FlowReturn,
    Prop,
    register,
)
from ...core.payload import host_bytes
from ...core.parse import parse_caps
from ...net.webrtc_peer import PeerConnection, WebRtcError
from .webrtc import (
    BASE_WEBRTC_SINK_PROPS,
    BASE_WEBRTC_SRC_PROPS,
    WebRtcSinkBaseMixin,
    WebRtcSrcBaseMixin,
)

RTP_CAPS = Caps.builder("application/x-rtp")


def _caps_media(caps: Optional[Caps]):
    s = caps.structure(0) if caps is not None and caps.structures else None
    get = (lambda k, d: s.get(k, d)) if s is not None else (lambda k, d: d)
    return (
        get("media", "video"),
        int(get("payload", 96)),
        get("encoding-name", "VP8"),
        int(get("clock-rate", 90000)),
    )


def _media_from_sdp(sdp: str):
    m = re.search(r"^m=(\w+) \d+ [\w/]+ (\d+)", sdp, re.M)
    rtpmap = re.search(r"^a=rtpmap:(\d+) ([\w\-]+)/(\d+)", sdp, re.M)
    if m and rtpmap:
        return m.group(1), int(rtpmap.group(1)), rtpmap.group(2), int(rtpmap.group(3))
    return "video", 96, "VP8", 90000


def _http(url: str, method: str, body: Optional[bytes], token: Optional[str]):
    req = Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/sdp")
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    return urlopen(req, timeout=10)


# ---------------------------------------------------------------------------
# client elements


class _WhipWhepClientMixin:
    def _post_offer(self, endpoint: str, token: Optional[str], offer: str):
        resp = _http(endpoint, "POST", offer.encode(), token)
        answer = resp.read().decode()
        location = resp.headers.get("Location")
        if location and not location.startswith("http"):
            base = urlparse(endpoint)
            location = f"{base.scheme}://{base.netloc}{location}"
        return answer, location

    def _delete_resource(self) -> None:
        if getattr(self, "_resource", None):
            try:
                _http(self._resource, "DELETE", None, self.get_property("auth-token"))
            except (HTTPError, OSError):
                pass
            self._resource = None


@register
class WhipClientSink(WebRtcSinkBaseMixin, BaseSink, _WhipWhepClientMixin):
    ELEMENT_NAME = "whipclientsink"
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WHIP client (RFC 9725) streaming over DTLS-SRTP"
    SINK_CAPS = RTP_CAPS
    # GstBaseWebRTCSink surface (the reference's whipclientsink subclasses
    # BaseWebRTCSink); raw-input-only props accepted for surface parity.
    PROPERTIES = BASE_WEBRTC_SINK_PROPS + [
        Prop("whip-endpoint", None, type="str"),
        Prop("auth-token", None, type="str"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._base_init()
        self._pc: Optional[PeerConnection] = None
        self._resource: Optional[str] = None

    def _base_pc_map(self):
        return {"whip": self._pc} if self._pc is not None else {}

    def on_ready_to_paused(self) -> None:
        self._base_on_start()

    def on_caps(self, caps: Caps) -> None:
        if self._pc is not None:
            return
        pc = self._base_prepare_pc(PeerConnection(offerer=True))
        pc.set_media(*_caps_media(caps), extra_attrs=self._base_media_attrs())
        pc.start()
        offer = pc.create_offer("sendonly")
        answer, self._resource = self._post_offer(
            self.get_property("whip-endpoint"), self.get_property("auth-token"), offer
        )
        pc.handle_answer(answer)
        self._pc = pc
        self._base_arm_channels(pc, "whip")

    def render(self, buffer: Buffer) -> FlowReturn:
        if self._pc is None:
            return FlowReturn.ERROR
        if not self._pc._connected.is_set():
            # generous: ICE+DTLS on a loaded host can take a while
            if not self._pc.wait_connected(20.0):
                return FlowReturn.ERROR
        data = host_bytes(buffer.data, np.uint8)
        self._base_record_send(data)
        self._pc.send_rtp(data)
        self._forward_metas(buffer)
        return FlowReturn.OK

    def on_paused_to_ready(self) -> None:
        self._base_on_stop()
        self._delete_resource()
        if self._pc:
            self._pc.close()
            self._pc = None


@register
class WhepClientSrc(WebRtcSrcBaseMixin, BaseSrc, _WhipWhepClientMixin):
    ELEMENT_NAME = "whepclientsrc"
    ELEMENT_CLASS = "Source/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WHEP client receiving over DTLS-SRTP"
    SRC_CAPS = RTP_CAPS
    IS_LIVE = True
    PROPERTIES = BASE_WEBRTC_SRC_PROPS + [
        Prop("whep-endpoint", None, type="str"),
        Prop("auth-token", None, type="str"),
        Prop("timeout", 10_000_000_000, type="uint64"),
        Prop("num-buffers", 0, type="uint", doc="stop after N packets (0 = unbounded)"),
        Prop("caps", "application/x-rtp,media=video,encoding-name=VP8,clock-rate=90000,payload=96",
             type="str", doc="media description offered to the WHEP server"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._src_base_init()
        self._pc: Optional[PeerConnection] = None
        self._resource: Optional[str] = None
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._count = 0

    def start(self) -> None:
        self._count = 0
        pc = PeerConnection(offerer=True)
        pc.set_media(*_caps_media(parse_caps(self.get_property("caps"))))
        pc.on_rtp = self._queue.put
        self._base_accept_channels(pc)
        pc.start()
        offer = pc.create_offer("recvonly")
        answer, self._resource = self._post_offer(
            self.get_property("whep-endpoint"), self.get_property("auth-token"), offer
        )
        pc.handle_answer(answer)
        self._pc = pc

    def stop(self) -> None:
        self._delete_resource()
        if self._pc:
            self._pc.close()
            self._pc = None
        self._queue.put(None)

    def fixate(self, caps: Caps) -> Caps:
        return parse_caps(self.get_property("caps"))

    def create(self):
        maxn = self.get_property("num-buffers")
        if maxn and self._count >= maxn:
            return None
        timeout = self.get_property("timeout")
        try:
            data = self._queue.get(timeout=(timeout / 1e9) if timeout else None)
        except queue.Empty:
            return None
        if data is None:
            return None
        self._count += 1
        return Buffer(np.frombuffer(data, np.uint8))


# ---------------------------------------------------------------------------
# server elements


class _WhipWhepHttpServer:
    """Shared HTTP front end: POST <root> creates a session, DELETE ends it."""

    def __init__(self, element, host: str, port: int, root: str, token: Optional[str]):
        self.element = element
        self.root = root.rstrip("/") or "/"
        self.token = token
        self.sessions: Dict[str, PeerConnection] = {}
        self._lock = threading.RLock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "gstpu-whipwhep/1"

            def log_message(self, *a):  # noqa: N802
                pass

            def _auth_ok(self) -> bool:
                if outer.token is None:
                    return True
                return self.headers.get("Authorization") == f"Bearer {outer.token}"

            def do_POST(self):  # noqa: N802
                if self.path.rstrip("/") != outer.root:
                    self.send_error(404)
                    return
                if not self._auth_ok():
                    self.send_error(401)
                    return
                length = int(self.headers.get("Content-Length", 0))
                offer = self.rfile.read(length).decode()
                try:
                    session_id, answer = outer.element._accept_offer(offer)
                except WebRtcError as e:
                    self.send_error(400, str(e))
                    return
                body = answer.encode()
                self.send_response(201)
                self.send_header("Location", f"{outer.root}/resource/{session_id}")
                self.send_header("Content-Type", "application/sdp")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_DELETE(self):  # noqa: N802
                m = re.match(rf"{re.escape(outer.root)}/resource/([\w\-]+)$", self.path)
                if not m:
                    self.send_error(404)
                    return
                outer.element._end_session(m.group(1))
                self.send_response(200)
                self.end_headers()

            def do_OPTIONS(self):  # noqa: N802
                self.send_response(204)
                self.send_header("Access-Control-Allow-Methods", "POST, DELETE, OPTIONS")
                self.end_headers()

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()


@register
class WhipServerSrc(WebRtcSrcBaseMixin, BaseSrc):
    """WHIP media-ingest server: WHIP clients POST offers, media flows in."""

    ELEMENT_NAME = "whipserversrc"
    ELEMENT_CLASS = "Source/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WHIP server source (accepts WHIP ingests over DTLS-SRTP)"
    SRC_CAPS = RTP_CAPS
    IS_LIVE = True
    PROPERTIES = BASE_WEBRTC_SRC_PROPS + [
        Prop("host-address", "127.0.0.1", type="str"),
        Prop("port", 0, type="uint", doc="0 = ephemeral; read back via bound_port"),
        Prop("auth-token", None, type="str"),
        Prop("timeout", 10_000_000_000, type="uint64"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._src_base_init()
        self._server: Optional[_WhipWhepHttpServer] = None
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._media = ("video", 96, "VP8", 90000)
        self._media_known = threading.Event()

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.port

    def start(self) -> None:
        self._server = _WhipWhepHttpServer(
            self, self.get_property("host-address"), self.get_property("port"),
            "/whip", self.get_property("auth-token"),
        )

    def stop(self) -> None:
        if self._server:
            with self._server._lock:
                sessions = dict(self._server.sessions)
                self._server.sessions.clear()
            for pc in sessions.values():
                pc.close()
            self._server.stop()
            self._server = None
        self._queue.put(None)

    def _accept_offer(self, offer: str):
        pc = PeerConnection(offerer=False)
        pc.on_rtp = self._queue.put
        self._base_accept_channels(pc)
        pc.start()
        answer = pc.handle_offer(offer, "recvonly")
        self._media = _media_from_sdp(offer)
        self._media_known.set()
        session_id = uuid.uuid4().hex
        with self._server._lock:
            self._server.sessions[session_id] = pc
        return session_id, answer

    def _end_session(self, session_id: str) -> None:
        with self._server._lock:
            pc = self._server.sessions.pop(session_id, None)
        if pc:
            # linger: the DELETE races the last media packets — give the
            # receive loop a moment to drain the socket before closing
            threading.Timer(0.5, pc.close).start()

    def fixate(self, caps: Caps) -> Caps:
        # wait briefly for the first ingest so caps reflect its rtpmap
        self._media_known.wait(5.0)
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


@register
class WhepServerSink(WebRtcSinkBaseMixin, BaseSink):
    """WHEP playout server: viewers POST offers, media fans out to all.

    Carries the GstBaseWebRTCSink surface (the reference's whepserversink
    subclasses BaseWebRTCSink); raw-input-only props accepted for parity."""

    ELEMENT_NAME = "whepserversink"
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WHEP server sink (serves WHEP viewers over DTLS-SRTP)"
    SINK_CAPS = RTP_CAPS
    PROPERTIES = BASE_WEBRTC_SINK_PROPS + [
        Prop("host-address", "127.0.0.1", type="str"),
        Prop("port", 0, type="uint"),
        Prop("auth-token", None, type="str"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._base_init()
        self._server: Optional[_WhipWhepHttpServer] = None

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.port

    def _base_pc_map(self):
        if self._server is None:
            return {}
        with self._server._lock:
            return dict(self._server.sessions)

    def on_ready_to_paused(self) -> None:
        self._base_on_start()
        self._server = _WhipWhepHttpServer(
            self, self.get_property("host-address"), self.get_property("port"),
            "/whep", self.get_property("auth-token"),
        )

    def on_paused_to_ready(self) -> None:
        if self._server:
            with self._server._lock:
                sessions = dict(self._server.sessions)
                self._server.sessions.clear()
            for pc in sessions.values():
                pc.close()
            self._server.stop()
            self._server = None
        self._base_on_stop()

    def _accept_offer(self, offer: str):
        pc = self._base_prepare_pc(PeerConnection(offerer=False))
        pc.start()
        answer = pc.handle_offer(offer, "sendonly")
        session_id = uuid.uuid4().hex
        with self._server._lock:
            self._server.sessions[session_id] = pc
        self._base_arm_channels(pc, session_id)
        return session_id, answer

    def _end_session(self, session_id: str) -> None:
        with self._server._lock:
            pc = self._server.sessions.pop(session_id, None)
        self._base_release(session_id)
        if pc:
            pc.close()

    def viewer_count(self) -> int:
        with self._server._lock:
            return sum(1 for pc in self._server.sessions.values() if pc._connected.is_set())

    def render(self, buffer: Buffer) -> FlowReturn:
        data = host_bytes(buffer.data, np.uint8)
        self._base_record_send(data)
        for pc in self._base_pcs():
            pc.send_rtp(data)
        self._forward_metas(buffer)
        return FlowReturn.OK
