"""webrtcsink / webrtcsrc — WebRTC producer and consumer elements.

Parity targets: net/webrtc/src/webrtcsink/imp.rs and webrtcsrc/imp.rs.
The signalling protocol (net/webrtc_signalling.py) matches the reference's
gst-webrtc-signalling-server JSON wire format; the media leg is the
in-repo ICE (RFC 8445) + DTLS 1.2 (RFC 6347) + SRTP (RFC 3711) stack —
real encrypted WebRTC, not plain RTP.

Like the reference, webrtcsink consumes either raw media (video/x-raw
I420 -> internal rav1enc + rtpav1pay2 chain; audio/x-raw -> rtpL16pay2)
or pre-payloaded `application/x-rtp`.  Each consumer session gets its
own PeerConnection; the producer re-sends the one encoded stream to all
connected sessions (the reference shares one encoded stream the same
way).  Divergence (documented): no congestion-control loop on the
encoder (the reference drives encoder bitrate from rtpgccbwe feedback).

webrtcsrc emits `application/x-rtp` buffers with media/encoding-name/
clock-rate/payload taken from the producer's SDP offer.

The port reads a payload back to the host once, where it becomes packets:
in the payloader of webrtcsink's internal chain for raw media (a CUDA
frame or audio buffer), or in `_send_rtp_buffer` for pre-payloaded input.
Received packets stay on the host; a depayloader or decoder downstream
puts the media on the device.  Divergence: webrtcsrc ends its stream on
endSession after the packets already received (`PeerConnection.drain`).
"""
from __future__ import annotations

import json
import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional

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
from ...net.webrtc_peer import PeerConnection, WebRtcError
from ...net.webrtc_signalling import (
    SignallingClient,
    msg_end_session,
    msg_peer_sdp,
)

RTP_CAPS = Caps.builder("application/x-rtp")

#: GstBaseWebRTCSink property surface (reference rswebrtc other-types;
#: net/webrtc/src/webrtcsink/imp.rs ParamSpec block around :5547-5560).
#: Shared by webrtcsink and the signaller variants (janusvr / awskvs /
#: ueps / whipclient / whepserver).
BASE_WEBRTC_SINK_PROPS = [
    Prop("video-caps", None, type="object", mutable="ready",
         doc="priority-ordered caps governing proposed video codecs; the "
             "in-repo encode chain produces video/x-av1, so a list "
             "excluding it fails negotiation for raw video input"),
    Prop("audio-caps", None, type="object", mutable="ready",
         doc="priority-ordered caps governing proposed audio codecs "
             "(in-repo raw-audio chain pays L16)"),
    Prop("congestion-control", "homegrown", type="enum",
         choices=["disabled", "homegrown", "gcc"], mutable="ready",
         doc="loss-driven controller; 'gcc' negotiates TWCC-based GCC "
             "where the consumer echoes transport feedback and otherwise "
             "behaves as homegrown (reference defaults gcc)"),
    Prop("min-bitrate", 1000, type="uint", doc="bps"),
    Prop("max-bitrate", 8_192_000, type="uint", doc="bps"),
    Prop("start-bitrate", 2_048_000, type="uint", doc="bps"),
    Prop("do-fec", True, type="bool", mutable="ready",
         doc="accepted for surface parity; ULPFEC/RED negotiation is not "
             "implemented (documented divergence — in-repo FEC is "
             "raptorq, a different wire format)"),
    Prop("do-retransmission", True, type="bool", mutable="ready",
         doc="honor RTCP NACK by resending from the send history"),
    Prop("rtx-percentage", -1, type="int", minimum=-1, maximum=100,
         doc="retransmission bandwidth cap as %% of media bandwidth over "
             "a 1 s window (-1 = unlimited)"),
    Prop("do-clock-signalling", False, type="bool", mutable="ready",
         doc="add a=ts-refclk:local / a=mediaclk:sender clock signalling "
             "to offered media sections (RFC 7273)"),
    Prop("enable-control-data-channel", False, type="bool", mutable="ready",
         doc="open a 'control' WebRTC data channel per session for "
             "arbitrary events and forwarded metas"),
    Prop("enable-data-channel-navigation", False, type="bool",
         mutable="ready",
         doc="open an 'input' data channel; received navigation JSON "
             "becomes upstream GstNavigation events on the video pad"),
    Prop("enable-mitigation-modes", "downsampled+downscaled", type="enum",
         choices=["none", "downscaled", "downsampled",
                  "downsampled+downscaled"], mutable="playing",
         doc="congestion mitigation flags; this encoder chain mitigates "
             "through bitrate, so the flags gate whether the cc loop may "
             "request resolution/framerate hints (advisory)"),
    Prop("forward-metas", "", type="str", mutable="playing",
         doc="comma-separated buffer meta api names serialized over the "
             "control data channel with each rendered buffer"),
    Prop("ice-transport-policy", "all", type="enum", choices=["all", "relay"],
         mutable="ready",
         doc="'relay' requires TURN, which this stack does not implement "
             "— selecting it raises at READY->PAUSED (documented)"),
    Prop("meta", None, type="object",
         doc="JSON metadata advertised with the producer"),
    Prop("signaller", None, type="object",
         doc="read-only: the signalling client object in use"),
    Prop("stats", None, type="object",
         doc="read-only: application/x-webrtcsink-stats per-session dict"),
    Prop("stun-server", None, type="str",
         doc="accepted for API parity; host candidates only"),
    Prop("turn-servers", None, type="object", mutable="ready",
         doc="accepted for API parity (turn(s)://user:pass@host:port "
             "list); this stack offers host candidates only"),
    Prop("run-web-server", False, type="bool", mutable="ready",
         doc="serve web-server-directory over HTTP(S) while PAUSED+"),
    Prop("web-server-cert", None, type="str",
         doc="TLS certificate path for the web server"),
    Prop("web-server-directory", "gstwebrtc-api/dist", type="str",
         doc="directory the web server serves"),
    Prop("web-server-host-addr", "http://127.0.0.1:8080/", type="str",
         doc="address the web server listens on"),
    Prop("web-server-key", None, type="str",
         doc="TLS private key path for the web server"),
    Prop("web-server-path", None, type="str",
         doc="root path prefix the server strips before file lookup"),
]

#: GstBaseWebRTCSrc property surface (reference rswebrtc other-types)
BASE_WEBRTC_SRC_PROPS = [
    Prop("video-codecs", None, type="object", mutable="ready",
         doc="list of acceptable video codec names for negotiation "
             "(None = accept any)"),
    Prop("audio-codecs", None, type="object", mutable="ready",
         doc="list of acceptable audio codec names for negotiation"),
    Prop("do-retransmission", True, type="bool", mutable="ready",
         doc="send RTCP NACK for sequence gaps in received media"),
    Prop("enable-control-data-channel", False, type="bool", mutable="ready",
         doc="accept the producer's 'control' data channel"),
    Prop("enable-data-channel-navigation", False, type="bool",
         mutable="ready",
         doc="serialize upstream GstNavigation events over the "
             "producer's 'input' data channel"),
    Prop("meta", None, type="object"),
    Prop("signaller", None, type="object",
         doc="read-only: the signalling client object in use"),
    Prop("stun-server", None, type="str",
         doc="accepted for API parity; host candidates only"),
    Prop("turn-servers", None, type="object", mutable="ready",
         doc="accepted for API parity; host candidates only"),
]


class _WebServer:
    """Tiny embedded web server (GstBaseWebRTCSink run-web-server /
    web-server-* properties): serves a directory over HTTP(S)."""

    def __init__(self, host_addr: str, directory: str,
                 cert: Optional[str] = None, key: Optional[str] = None,
                 root_path: Optional[str] = None):
        import http.server
        from urllib.parse import urlparse

        u = urlparse(host_addr)
        host = u.hostname or "127.0.0.1"
        port = u.port or (443 if u.scheme == "https" else 8080)
        prefix = (root_path or "").strip("/")

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=directory, **kw)

            def translate_path(self, path):
                if prefix and path.lstrip("/").startswith(prefix):
                    path = "/" + path.lstrip("/")[len(prefix):].lstrip("/")
                return super().translate_path(path)

            def log_message(self, *a):  # quiet
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        if cert:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            self.httpd.socket = ctx.wrap_socket(self.httpd.socket,
                                                server_side=True)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(1.0)


def _caps_media(caps: Optional[Caps]):
    """(media, pt, encoding-name, clock-rate) from x-rtp caps, with defaults."""
    s = caps.structure(0) if caps is not None and caps.structures else None
    get = (lambda k, d: s.get(k, d)) if s is not None else (lambda k, d: d)
    return (
        get("media", "video"),
        int(get("payload", 96)),
        get("encoding-name", "VP8"),
        int(get("clock-rate", 90000)),
    )


class WebRtcSinkBaseMixin:
    """GstBaseWebRTCSink shared behavior (reference webrtcsink/imp.rs — the
    signaller variants janusvr/awskvs/ueps/whipclient/whepserver all subclass
    the same base there and inherit its full surface).

    Subclasses call `_base_init()` from __init__, `_base_on_start()` /
    `_base_on_stop()` around READY<->PAUSED, `_base_prepare_pc(pc)` on every
    new PeerConnection before the SDP exchange, `_base_arm_channels(pc, key)`
    after it, and `_base_record_send(data)` on the send path.  They provide
    `_base_pc_map()` returning {session-key: PeerConnection}.
    """

    def _base_init(self) -> None:
        self._base_lock = threading.RLock()
        self._web_server = None
        # do-retransmission send history: seq -> rtp bytes
        self._send_history: "OrderedDict[int, bytes]" = OrderedDict()
        self._rtx_sent_window: List[tuple] = []  # (time, bytes)
        self._media_sent_window: List[tuple] = []  # (time, bytes)
        self._cc_encoder = None
        self._cc_bitrate = 0
        self._cc_last_update = 0.0
        self._base_channels: Dict[object, dict] = {}  # key -> {label: ch}

    # -- subclass surface -----------------------------------------------------
    def _base_pc_map(self) -> Dict[object, PeerConnection]:
        raise NotImplementedError

    def _base_pcs(self) -> List[PeerConnection]:
        return list(self._base_pc_map().values())

    def _video_sink_pads(self):
        return [self.sinkpad]

    def _control_pads(self):
        return [self.sinkpad]

    # -- property surface -----------------------------------------------------
    def get_property(self, name: str):
        if name == "stats":
            # reference: application/x-webrtcsink-stats, one entry per session
            return {
                str(key): {
                    "consumer-stats": dict(pc._rx_stats),
                    "bitrate": self._cc_bitrate,
                    "connected": pc._connected.is_set(),
                }
                for key, pc in self._base_pc_map().items()
            }
        return super().get_property(name)

    # -- lifecycle ------------------------------------------------------------
    def _base_on_start(self) -> None:
        if self.get_property("ice-transport-policy") == "relay":
            raise RuntimeError(
                f"{self.name}: ice-transport-policy=relay requires TURN "
                "relaying, which this stack does not implement")
        if self.get_property("run-web-server"):
            self._web_server = _WebServer(
                self.get_property("web-server-host-addr"),
                self.get_property("web-server-directory"),
                cert=self.get_property("web-server-cert"),
                key=self.get_property("web-server-key"),
                root_path=self.get_property("web-server-path"))

    def _base_on_stop(self) -> None:
        with self._base_lock:
            self._base_channels.clear()
        if self._web_server is not None:
            self._web_server.stop()
            self._web_server = None

    def _base_media_attrs(self) -> Optional[List[str]]:
        """RFC 7273 media-clock attrs when do-clock-signalling is set."""
        if self.get_property("do-clock-signalling"):
            return ["a=ts-refclk:local", "a=mediaclk:sender"]
        return None

    def _base_prepare_pc(self, pc: PeerConnection) -> PeerConnection:
        """Wire loss-report/NACK handling and (for offerers) the data-channel
        m=application section before the SDP exchange."""
        pc.on_rtcp = self._on_rtcp
        if pc.offerer and (self.get_property("enable-control-data-channel")
                           or self.get_property(
                               "enable-data-channel-navigation")):
            pc.enable_data_channel = True
        return pc

    def _base_arm_channels(self, pc: PeerConnection, key) -> None:
        """Create the 'input'/'control' channels once the peer connects
        (webrtcsink/imp.rs:1820-1916 — the producer CREATES both)."""
        want_nav = self.get_property("enable-data-channel-navigation")
        want_ctrl = self.get_property("enable-control-data-channel")
        if not (want_nav or want_ctrl) or not pc.enable_data_channel:
            return
        threading.Thread(
            target=self._base_setup_channels,
            args=(pc, key, want_nav, want_ctrl), daemon=True).start()

    def _base_setup_channels(self, pc: PeerConnection, key,
                             want_nav: bool, want_ctrl: bool) -> None:
        try:
            if not pc.wait_connected(15.0):
                return
            chans = {}
            if want_nav:
                ch = pc.create_data_channel("input")
                ch.on_message = lambda data, _bin: \
                    self._create_navigation_event(data)
                chans["input"] = ch
            if want_ctrl:
                ch = pc.create_data_channel("control")
                ch.on_message = lambda data, _bin: \
                    self._handle_control_message(chans.get("control"), data)
                chans["control"] = ch
            with self._base_lock:
                self._base_channels[key] = chans
        except (WebRtcError, RuntimeError):
            pass

    def _base_release(self, key) -> None:
        with self._base_lock:
            self._base_channels.pop(key, None)

    # -- loss-driven congestion control (homegrown_cc analog) -----------------
    def _on_rtcp(self, data: bytes) -> None:
        from ...net import rtcp as _rtcp

        try:
            pkts = _rtcp.parse_compound(data)
        except Exception:
            return
        for pkt in pkts:
            if isinstance(pkt, _rtcp.GenericNack):
                self._handle_nack(pkt.seqs)
            elif isinstance(pkt, _rtcp.ReceiverReport) and pkt.reports:
                if self.get_property("congestion-control") != "disabled":
                    self._cc_update(max(rb.fraction_lost for rb in pkt.reports))

    # -- NACK retransmission (do-retransmission / rtx-percentage) -------------
    def _handle_nack(self, seqs) -> None:
        if not self.get_property("do-retransmission"):
            return
        pct = self.get_property("rtx-percentage")
        now = time.monotonic()
        sessions = self._base_pcs()
        with self._base_lock:
            for seq in seqs:
                pkt = self._send_history.get(seq & 0xFFFF)
                if pkt is None:
                    continue
                if pct >= 0:
                    # cap rtx bandwidth at pct% of media bandwidth over 1 s
                    cutoff = now - 1.0
                    self._rtx_sent_window = [
                        e for e in self._rtx_sent_window if e[0] > cutoff]
                    self._media_sent_window = [
                        e for e in self._media_sent_window if e[0] > cutoff]
                    media = sum(n for _, n in self._media_sent_window)
                    rtx = sum(n for _, n in self._rtx_sent_window)
                    if rtx + len(pkt) > media * pct / 100.0:
                        continue
                self._rtx_sent_window.append((now, len(pkt)))
                for pc in sessions:
                    pc.send_rtp(pkt)

    def _cc_update(self, fraction_lost: int) -> None:
        now = time.monotonic()
        if now - self._cc_last_update < 0.5:  # rate-limit reconfigs
            return
        self._cc_last_update = now
        if not self._cc_bitrate:
            self._cc_bitrate = self.get_property("start-bitrate")
        loss = fraction_lost / 256.0
        if loss > 0.10:
            # multiplicative decrease proportional to loss (homegrown_cc)
            self._cc_bitrate = int(self._cc_bitrate * (1.0 - 0.5 * loss))
        elif loss < 0.02:
            self._cc_bitrate = int(self._cc_bitrate * 1.05)
        self._cc_bitrate = max(self.get_property("min-bitrate"),
                               min(self.get_property("max-bitrate"),
                                   self._cc_bitrate))
        enc = self._cc_encoder
        if enc is not None and enc.get_property("bitrate") != self._cc_bitrate:
            enc.set_property("bitrate", self._cc_bitrate)
        from ...core.caps import Structure

        self.post_message(Message(
            MessageType.ELEMENT,
            structure=Structure("webrtcsink-congestion",
                                bitrate=self._cc_bitrate,
                                fraction_lost=fraction_lost)))

    # -- send-path bookkeeping ------------------------------------------------
    def _base_record_send(self, data: bytes) -> None:
        if len(data) >= 12 and self.get_property("do-retransmission"):
            with self._base_lock:
                seq = int.from_bytes(data[2:4], "big")
                self._send_history[seq] = data
                while len(self._send_history) > 512:
                    self._send_history.popitem(last=False)
                self._media_sent_window.append((time.monotonic(), len(data)))
                if len(self._media_sent_window) > 4096:
                    del self._media_sent_window[:2048]

    def _forward_metas(self, buffer: Buffer) -> None:
        """GstBaseWebRTCSink forward-metas: serialize listed buffer metas
        over each session's control data channel."""
        wanted = self.get_property("forward-metas")
        if not wanted or not buffer.metas:
            return
        names = {n.strip() for n in wanted.split(",") if n.strip()}
        metas = [m for m in buffer.metas if type(m).__name__ in names]
        if not metas:
            return
        payload = json.dumps({
            "type": "metas",
            "ts": buffer.pts,
            "metas": [{"api": type(m).__name__,
                       "fields": {k: v for k, v in vars(m).items()
                                  if isinstance(v, (int, float, str, bool,
                                                    type(None)))}}
                      for m in metas],
        })
        with self._base_lock:
            chans = [d.get("control") for d in self._base_channels.values()]
        for ch in chans:
            if ch is not None and ch.ready.is_set():
                try:
                    ch.send(payload)
                except Exception:
                    pass

    # -- data-channel event handling ------------------------------------------
    def _create_navigation_event(self, data: bytes) -> bool:
        """Navigation JSON from the 'input' channel -> upstream
        GstNavigation event on the video sink pad(s)
        (webrtcsink/imp.rs:433-473 create_navigation_event)."""
        from ...core.caps import Structure
        from ...core.events import Event

        try:
            msg = json.loads(data)
        except (ValueError, UnicodeDecodeError):
            return False
        fields = {k: v for k, v in msg.items() if k != "mid"}
        ev = Event.new_navigation(Structure("navigation", **fields))
        ok = False
        for pad in self._video_sink_pads():
            ok = pad.push_event(ev) or ok
        return ok

    def _handle_control_message(self, channel, data: bytes) -> None:
        """ControlRequestMessage {id, mid, request} -> upstream event;
        reply ControlResponseMessage {id, error}
        (webrtcsink/imp.rs:475-543 handle_control_event)."""
        from ...core.caps import Structure
        from ...core.events import Event, EventType

        error = None
        msg_id = None
        try:
            msg = json.loads(data)
            msg_id = msg.get("id")
            req = msg.get("request")
            if isinstance(req, str):
                req = json.loads(req)
            rtype = req.get("type")
            if rtype == "navigationEvent":
                ev = Event.new_navigation(
                    Structure("navigation", **req.get("event", {})))
            elif rtype == "customUpstreamEvent":
                ev = Event(EventType.CUSTOM_UPSTREAM,
                           structure=Structure(req.get("structureName", ""),
                                               **(req.get("structure") or {})))
            else:
                raise ValueError(f"unknown control request {rtype!r}")
            ok = False
            for pad in self._control_pads():
                ok = pad.push_event(ev) or ok
            if not ok:
                error = "No sink pad could handle the request"
        except (ValueError, KeyError, AttributeError, TypeError) as e:
            error = f"Failed to handle control event: {e}"
        if channel is not None:
            try:
                channel.send(json.dumps({"id": msg_id, "error": error}))
            except Exception:
                pass


class WebRtcSrcBaseMixin:
    """GstBaseWebRTCSrc shared behavior: accept producer-created data
    channels and serialize navigation / custom upstream events over them
    (webrtcsrc/imp.rs:418-471)."""

    def _src_base_init(self) -> None:
        self._channels: Dict[str, object] = {}
        self._control_msg_id = 0

    def _base_accept_channels(self, pc: PeerConnection) -> None:
        pc.on_data_channel = self._on_data_channel
        if pc.offerer and (self.get_property("enable-control-data-channel")
                           or self.get_property(
                               "enable-data-channel-navigation")):
            # consumer-offered sessions must carry the m=application section
            # themselves for the producer to open channels on it
            pc.enable_data_channel = True

    def _on_data_channel(self, channel) -> None:
        label = getattr(channel, "label", "")
        if label == "input" and \
                self.get_property("enable-data-channel-navigation"):
            self._channels["input"] = channel
        elif label == "control" and \
                self.get_property("enable-control-data-channel"):
            self._channels["control"] = channel

    def _src_event(self, pad, event) -> bool:
        from ...core.events import EventType

        if event.type == EventType.NAVIGATION:
            ch = self._channels.get("input")
            if ch is not None and ch.ready.is_set():
                st = event.get("structure")
                payload = dict(st.fields) if st is not None else {}
                payload["mid"] = None
                try:
                    ch.send(json.dumps(payload))
                    return True
                except Exception:
                    return False
            return False
        if event.type == EventType.CUSTOM_UPSTREAM:
            ch = self._channels.get("control")
            if ch is not None and ch.ready.is_set():
                st = event.get("structure")
                self._control_msg_id += 1
                try:
                    ch.send(json.dumps({
                        "id": self._control_msg_id,
                        "mid": None,
                        "request": {
                            "type": "customUpstreamEvent",
                            "structureName": st.name if st else "",
                            "structure": dict(st.fields) if st else {},
                        },
                    }))
                    return True
                except Exception:
                    return False
            return False
        return super()._src_event(pad, event)


@register
class WebRtcSink(WebRtcSinkBaseMixin, BaseSink):
    ELEMENT_NAME = "webrtcsink"
    EXTRA_PAD_TEMPLATES = [
        ('video_%u', 'sink', 'request', 'video/x-raw'),
        ('audio_%u', 'sink', 'request', 'audio/x-raw'),
    ]
    # GstWebRTCSinkPad (reference webrtcsink/imp.rs WebRTCSinkPad msid
    # ParamSpec): the msid advertised in the pad's m-section (a=msid)
    PAD_PROPERTIES = {
        "video": [Prop("msid", None, type="str", mutable="ready",
                       doc="a=msid value for this stream's media section")],
        "audio": [Prop("msid", None, type="str", mutable="ready",
                       doc="a=msid value for this stream's media section")],
    }
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WebRTC producer with gst-webrtc signalling (ICE+DTLS-SRTP)"
    from ...core.caps import Structure as _S
    SINK_CAPS = Caps([
        _S("application/x-rtp"),
        _S("video/x-raw", format="I420"),
        _S("audio/x-raw"),
    ])
    PROPERTIES = BASE_WEBRTC_SINK_PROPS + [
        Prop("signaller-uri", "ws://127.0.0.1:8443", type="str"),
        # embedded signalling server (webrtcsink/imp.rs run-signalling-server)
        Prop("run-signalling-server", False, type="bool",
             doc="start the in-repo gst-webrtc signalling relay and "
                 "connect to it instead of signaller-uri"),
        Prop("signalling-server-host", "0.0.0.0", type="str"),
        Prop("signalling-server-port", 8443, type="uint", maximum=65535),
        Prop("signalling-server-cert", None, type="str",
             doc="TLS cert for the embedded server (accepted; the in-repo "
                 "relay serves plain ws — wss termination is external)"),
        Prop("signalling-server-cert-password", None, type="str",
             doc="accepted with signalling-server-cert"),
        Prop("signalling-server-key", None, type="str",
             doc="accepted with signalling-server-cert"),
        Prop("signalling-server-headers", None, type="object",
             doc="extra headers the embedded server replies with "
                 "(accepted; the relay speaks the JSON protocol only)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._base_init()
        self._client: Optional[SignallingClient] = None
        self._own_server = None
        self._sessions: Dict[str, PeerConnection] = {}
        self._lock = threading.RLock()
        self._chain_elements = []
        self._chain_head = None
        self._rtp_media = None  # (media, pt, encoding, rate) for offers
        self._extra_pads = []  # request pads -> extra BUNDLE sections

    def _base_pc_map(self) -> Dict[object, PeerConnection]:
        with self._lock:
            return dict(self._sessions)

    # -- internal encode chain for raw media (webrtcsink/imp.rs encoder role)
    def on_caps(self, caps: Caps) -> None:
        s = caps.structure(0)
        if s.name == "application/x-rtp":
            self._rtp_media = (
                s.get("media", "video"), int(s.get("payload", 96)),
                s.get("encoding-name", "VP8"), int(s.get("clock-rate", 90000)),
            )
            return
        from ...core.registry import element_factory_make
        from ...core.element import Pad, PadDirection, PadPresence, PadTemplate, State
        from ...core.events import Event, Segment

        # video-caps / audio-caps: priority-ordered codec gating
        # (GstBaseWebRTCSink video-caps/audio-caps ParamSpecs)
        allowed = self.get_property(
            "video-caps" if s.name == "video/x-raw" else "audio-caps")
        if allowed is not None:
            produced = "video/x-av1" if s.name == "video/x-raw" else "audio/x-raw"
            names = [c if isinstance(c, str) else c.structure(0).name
                     for c in (allowed if isinstance(allowed, (list, tuple))
                               else [allowed])]
            if produced not in names:
                raise RuntimeError(
                    f"{self.name}: {s.name} input but {produced} not in "
                    f"{'video' if 'video' in s.name else 'audio'}-caps {names}")
        if s.name == "video/x-raw":
            enc = element_factory_make("rav1enc", f"{self.name}-enc")
            enc.set_property("low-latency", True)
            enc.set_property("speed-preset", 10)
            if self.get_property("congestion-control") != "disabled":
                enc.set_property("bitrate", self.get_property("start-bitrate"))
                self._cc_encoder = enc
            pay = element_factory_make("rtpav1pay2", f"{self.name}-pay")
            chain = [enc, pay]
            self._rtp_media = ("video", 96, "AV1", 90000)
        else:
            pay = element_factory_make("rtpL16pay2", f"{self.name}-pay")
            chain = [pay]
            self._rtp_media = ("audio", 96, "L16", int(s.get("rate", 48000)))
        for k in ("ssrc", "seqnum-offset", "timestamp-offset"):
            try:
                pay.set_property(k, 0 if k != "ssrc" else 1)
            except Exception:
                pass
        for a, b in zip(chain, chain[1:]):
            a.link(b)
        terminal = Pad(f"{self.name}-rtp-out", PadDirection.SINK,
                       PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS,
                                   Caps.new_any()))
        terminal.element = self
        terminal.chain_function = lambda pad, buf: self._send_rtp_buffer(buf)
        terminal.event_function = lambda pad, ev: True
        tail_src = chain[-1].src_pads()[0]
        tail_src.peer = terminal
        terminal.peer = tail_src
        for e in chain:
            e.set_state(State.PLAYING)
        head = chain[0].sink_pads()[0]
        head.send_event(Event.new_stream_start(f"{self.name}-raw"))
        head.send_event(Event.new_caps(caps))
        head.send_event(Event.new_segment(Segment()))
        self._chain_elements = chain
        self._chain_head = head

    def _send_rtp_buffer(self, buffer: Buffer) -> FlowReturn:
        data = host_bytes(buffer.data, np.uint8)
        self._base_record_send(data)
        for pc in self._base_pcs():
            pc.send_rtp(data)
        self._forward_metas(buffer)
        return FlowReturn.OK

    # -- extra media sections (request pads, webrtcsink video_%u/audio_%u) ----
    def request_sink_pad(self, kind: str = "video") -> "Pad":
        """Adds another application/x-rtp stream as its own BUNDLEd m-line;
        the pad's caps become the section's rtpmap."""
        from ...core.element import Pad, PadDirection, PadPresence, PadTemplate

        idx = len(self._extra_pads)
        pad = Pad(f"{kind}_{idx}", PadDirection.SINK,
                  PadTemplate(f"{kind}_%u", PadDirection.SINK, PadPresence.REQUEST,
                              RTP_CAPS))
        self.add_pad(pad)
        entry = {"pad": pad, "media": None}
        self._extra_pads.append(entry)

        def on_event(p, ev, entry=entry):
            from ...core.events import EventType

            if ev.type == EventType.CAPS:
                st = ev.get("caps").structure(0)
                entry["media"] = (
                    st.get("media", kind), int(st.get("payload", 97 + idx)),
                    st.get("encoding-name", "VP8"), int(st.get("clock-rate", 90000)),
                )
            return True

        pad.chain_function = lambda p, buf: self._send_rtp_buffer(buf)
        pad.event_function = on_event
        return pad

    # -- signalling ------------------------------------------------------------
    def on_ready_to_paused(self) -> None:
        self._base_on_start()
        uri = self.get_property("signaller-uri")
        if self.get_property("run-signalling-server"):
            from ...net.webrtc_signalling import SignallingServer

            self._own_server = SignallingServer(
                self.get_property("signalling-server-host"),
                self.get_property("signalling-server-port"))
            uri = f"ws://127.0.0.1:{self._own_server.port}"
            self._props["signaller-uri"] = uri
        self._client = SignallingClient(uri, self._on_signal)
        self._client.wait_welcome()
        self._client.send({
            "type": "setPeerStatus",
            "roles": ["producer"],
            "meta": self.get_property("meta"),
        })

    def on_paused_to_ready(self) -> None:
        with self._lock:
            sessions, self._sessions = dict(self._sessions), {}
        for sid, pc in sessions.items():
            if self._client:
                try:
                    self._client.send(msg_end_session(sid))
                except Exception:
                    pass
            pc.close()
        if self._client:
            self._client.close()
            self._client = None
        if self._own_server is not None:
            self._own_server.stop()
            self._own_server = None
        self._base_on_stop()

    def _on_signal(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "startSession":
            self._start_session(msg["sessionId"])
        elif t == "peer":
            sid = msg.get("sessionId")
            with self._lock:
                pc = self._sessions.get(sid)
            if pc is None:
                return
            sdp = msg.get("sdp")
            if sdp and sdp.get("type") == "answer":
                try:
                    pc.handle_answer(sdp["sdp"])
                except WebRtcError as e:
                    self.post_message(Message(MessageType.WARNING, text=str(e)))
            ice = msg.get("ice")
            if ice:
                pc.add_remote_ice(ice["candidate"])
        elif t == "endSession":
            self._end_session(msg.get("sessionId"))

    def _start_session(self, session_id: str) -> None:
        # caps may still be propagating when the first consumer asks for a
        # session — wait briefly so the offer advertises the real media
        deadline = time.monotonic() + 2.0
        while self._rtp_media is None and self.caps is None \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        pc = self._base_prepare_pc(PeerConnection(offerer=True))
        media, pt, enc, rate = self._rtp_media or _caps_media(self.caps)
        pc.set_media(media, pt, enc, rate, self._base_media_attrs())
        for entry in self._extra_pads:
            if entry["media"] is not None:
                attrs = []
                # GstWebRTCSinkPad msid -> a=msid on the pad's m-section
                msid = entry["pad"].get_property("msid") \
                    if "msid" in entry["pad"]._props else None
                if msid:
                    attrs.append(f"a=msid:{msid}")
                pc.add_media(*entry["media"], extra_attrs=attrs or None)
        with self._lock:
            self._sessions[session_id] = pc
        pc.start()
        offer = pc.create_offer("sendonly")
        self._client.send(msg_peer_sdp(session_id, "offer", offer))
        self._base_arm_channels(pc, session_id)
        self.post_message(Message(
            MessageType.ELEMENT, name="webrtcsink-session-started", session_id=session_id
        ))

    def _video_sink_pads(self):
        pads = []
        if self.caps is not None and \
                self.caps.structure(0).name.startswith("video"):
            pads.append(self.sinkpad)
        elif self._rtp_media is not None and self._rtp_media[0] == "video":
            pads.append(self.sinkpad)
        for entry in self._extra_pads:
            if entry["pad"].name.startswith("video_"):
                pads.append(entry["pad"])
        return pads or [self.sinkpad]

    def _control_pads(self):
        return [self.sinkpad] + [e["pad"] for e in self._extra_pads]

    def _end_session(self, session_id: Optional[str]) -> None:
        with self._lock:
            pc = self._sessions.pop(session_id, None)
        self._base_release(session_id)
        if pc:
            pc.close()

    # -- media -------------------------------------------------------------------
    def render(self, buffer: Buffer) -> FlowReturn:
        if self._chain_head is not None:
            return self._chain_head.chain(buffer)
        return self._send_rtp_buffer(buffer)

    def on_event(self, event) -> None:
        from ...core.events import EventType

        # EOS must reach the internal encoder so it drains its lookahead
        if event.type == EventType.EOS and self._chain_head is not None:
            self._chain_head.send_event(event)

    def connected_sessions(self) -> List[str]:
        with self._lock:
            return [sid for sid, pc in self._sessions.items() if pc._connected.is_set()]

    def wait_any_connected(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.connected_sessions():
                return True
            time.sleep(0.02)
        return False


@register
class WebRtcSrc(WebRtcSrcBaseMixin, BaseSrc):
    ELEMENT_NAME = "webrtcsrc"
    EXTRA_PAD_TEMPLATES = [
        ('stream_%u', 'src', 'sometimes', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Source/Network/WebRTC"
    ELEMENT_DESCRIPTION = "WebRTC consumer with gst-webrtc signalling (ICE+DTLS-SRTP)"
    SRC_CAPS = RTP_CAPS
    IS_LIVE = True
    PROPERTIES = BASE_WEBRTC_SRC_PROPS + [
        Prop("signaller-uri", "ws://127.0.0.1:8443", type="str"),
        Prop("producer-peer-id", None, type="str",
             doc="producer to connect to; None = first producer to appear "
                 "(requires connect-to-first-producer)"),
        Prop("connect-to-first-producer", True, type="bool",
             doc="with no producer-peer-id, connect to the first producer "
                 "that appears (reference defaults false and errors; this "
                 "framework defaults true — documented divergence)"),
        Prop("timeout", 10_000_000_000, type="uint64",
             doc="ns to wait for media before giving up (0 = forever)"),
        Prop("output", "rtp", type="enum", choices=["rtp", "raw"],
             doc="raw: depayload + decode the primary section internally "
                 "(AV1 via rtpav1depay2 + dav1ddec, L16 via rtpL16depay2) — "
                 "the reference webrtcsrc's decoded-output role"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._client: Optional[SignallingClient] = None
        self._pc: Optional[PeerConnection] = None
        self._session_id: Optional[str] = None
        # items: (media_index, packet) or None for EOS
        self._rtp_queue: "queue.Queue" = queue.Queue()
        self._media = ("video", 96, "VP8", 90000)
        self._producer_evt = threading.Event()
        self._producer_id: Optional[str] = None
        self._extra_pads = {}  # media index -> sometimes Pad
        # producer-created data channels by label (GstBaseWebRTCSrc
        # enable-data-channel-navigation / enable-control-data-channel)
        self._src_base_init()

    def start(self) -> None:
        self._client = SignallingClient(self.get_property("signaller-uri"), self._on_signal)
        self._client.wait_welcome()
        self._client.send({
            "type": "setPeerStatus",
            "roles": ["consumer", "listener"],
            "meta": self.get_property("meta"),
        })
        wanted = self.get_property("producer-peer-id")
        if wanted:
            self._producer_id = wanted
            self._producer_evt.set()
        elif not self.get_property("connect-to-first-producer"):
            raise RuntimeError(
                "webrtcsrc: no producer-peer-id set and "
                "connect-to-first-producer is false")
        else:
            # poll the producer list until one appears (the reference's
            # webrtcsrc listens for peerStatusChanged the same way; the list
            # re-request covers producers that registered concurrently)
            deadline = time.monotonic() + 10.0
            while not self._producer_evt.is_set() and time.monotonic() < deadline:
                self._client.send({"type": "list"})
                self._producer_evt.wait(0.5)
        if not self._producer_evt.wait(10.0):
            raise RuntimeError("webrtcsrc: no producer available")
        self._client.send({
            "type": "startSession", "peerId": self._producer_id, "offer": None,
        })
        # wait for the producer's offer so caps (media/pt/encoding) are known
        # before the source negotiates downstream
        deadline = time.monotonic() + 10.0
        while self._pc is None and time.monotonic() < deadline:
            time.sleep(0.02)
        if self._pc is None:
            raise RuntimeError("webrtcsrc: producer sent no offer")

    def stop(self) -> None:
        if self._client and self._session_id:
            try:
                self._client.send(msg_end_session(self._session_id))
            except Exception:
                pass
        if self._pc:
            self._pc.close()
            self._pc = None
        if self._client:
            self._client.close()
            self._client = None
        self._rtp_queue.put(None)

    def _on_signal(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "list":
            producers = msg.get("producers", [])
            if producers and not self._producer_evt.is_set():
                self._producer_id = producers[0]["id"]
                self._producer_evt.set()
        elif t == "peerStatusChanged":
            if "producer" in msg.get("roles", []) and not self._producer_evt.is_set():
                self._producer_id = msg.get("peerId")
                self._producer_evt.set()
        elif t == "sessionStarted":
            self._session_id = msg["sessionId"]
        elif t == "peer":
            sdp = msg.get("sdp")
            if sdp and sdp.get("type") == "offer":
                self._on_offer(msg["sessionId"], sdp["sdp"])
            ice = msg.get("ice")
            if ice and self._pc:
                self._pc.add_remote_ice(ice["candidate"])
        elif t == "endSession":
            # the producer sent its media before this message: end the
            # stream after what is already in the socket (the JAX package
            # ends at once, and a loaded receive loop then loses the tail)
            pc = self._pc
            if pc is not None:
                pc.drain()
            self._rtp_queue.put(None)

    def _on_offer(self, session_id: str, offer: str) -> None:
        self._session_id = session_id
        pc = PeerConnection(offerer=False)
        pc.on_rtp_media = lambda idx, pkt: self._rtp_queue.put((idx, pkt))
        self._base_accept_channels(pc)
        pc.start()
        answer = pc.handle_offer(offer, "recvonly")
        # media description for our caps
        import re
        m = re.search(r"^m=(\w+) \d+ [\w/]+ (\d+)", offer, re.M)
        rtpmap = re.search(r"^a=rtpmap:(\d+) ([\w\-]+)/(\d+)", offer, re.M)
        if m and rtpmap:
            self._media = (m.group(1), int(rtpmap.group(1)), rtpmap.group(2), int(rtpmap.group(3)))
            # video-codecs / audio-codecs: negotiation gating
            # (GstBaseWebRTCSrc video-codecs/audio-codecs ParamSpecs)
            allowed = self.get_property(
                "video-codecs" if m.group(1) == "video" else "audio-codecs")
            if allowed is not None and rtpmap.group(2).upper() not in \
                    [str(c).upper() for c in allowed]:
                self.post_message(Message(
                    MessageType.ERROR,
                    text=f"{self.name}: producer offers "
                         f"{rtpmap.group(2)} but "
                         f"{'video' if m.group(1) == 'video' else 'audio'}"
                         f"-codecs only allows {list(allowed)}"))
                pc.close()
                self._rtp_queue.put(None)
                return
        # publish LAST: start() unblocks on _pc and reads _media for caps
        self._pc = pc
        self._client.send(msg_peer_sdp(session_id, "answer", answer))

    def fixate(self, caps: Caps) -> Caps:
        from ...core.parse import parse_caps

        media, pt, enc, rate = self._media
        if self.get_property("output") == "raw":
            if enc == "AV1":
                return Caps.builder("video/x-raw", format="I420")
            if enc == "L16":
                from ...core.caps import Structure
                return Caps([Structure("audio/x-raw", format="S16", rate=rate,
                                       channels=1, layout="interleaved")])
        return parse_caps(
            f"application/x-rtp,media={media},payload={pt},"
            f"encoding-name={enc},clock-rate={rate}"
        )

    def _build_decode_chain(self):
        """rtp -> depay -> decoder feeding the static src pad (raw mode)."""
        from ...core.element import Pad, PadDirection, PadPresence, PadTemplate, State
        from ...core.events import Event, Segment
        from ...core.parse import parse_caps
        from ...core.registry import element_factory_make

        media, pt, enc, rate = self._media
        if enc == "AV1":
            chain = [element_factory_make("rtpav1depay2", f"{self.name}-depay"),
                     element_factory_make("dav1ddec", f"{self.name}-dec")]
        elif enc == "L16":
            chain = [element_factory_make("rtpL16depay2", f"{self.name}-depay")]
        else:
            raise RuntimeError(f"{self.name}: no decoder wired for {enc}")
        for a, b in zip(chain, chain[1:]):
            a.link(b)
        terminal = Pad(f"{self.name}-raw-out", PadDirection.SINK,
                       PadTemplate("inner", PadDirection.SINK, PadPresence.ALWAYS,
                                   Caps.new_any()))
        terminal.element = self

        def forward(pad, buf):
            return self.srcpad.push(buf)

        def forward_event(pad, ev):
            from ...core.events import EventType

            # the decoder's caps describe the decoded frames downstream
            if ev.type == EventType.CAPS:
                self.srcpad.current_caps = ev.get("caps")
            if ev.type in (EventType.CAPS, EventType.EOS):
                return self.srcpad.push_event(ev)
            return True

        terminal.chain_function = forward
        terminal.event_function = forward_event
        tail = chain[-1].src_pads()[0]
        tail.peer = terminal
        terminal.peer = tail
        for e in chain:
            e.set_state(State.PLAYING)
        head = chain[0].sink_pads()[0]
        head.send_event(Event.new_stream_start(f"{self.name}-raw"))
        head.send_event(Event.new_caps(parse_caps(
            f"application/x-rtp,media={media},payload={pt},"
            f"encoding-name={enc},clock-rate={rate}")))
        head.send_event(Event.new_segment(Segment()))
        self._decode_chain = chain
        self._decode_head = head

    def create(self):
        timeout = self.get_property("timeout")
        try:
            item = self._rtp_queue.get(timeout=(timeout / 1e9) if timeout else None)
        except queue.Empty:
            return None
        if item is None:
            if getattr(self, "_decode_head", None) is not None:
                from ...core.events import Event

                # drain the decoder before the source's own EOS
                self._decode_head.send_event(Event.new_eos())
            return None
        idx, data = item
        if idx == 0:
            if self.get_property("output") == "raw":
                if getattr(self, "_decode_head", None) is None:
                    self._build_decode_chain()
                self._decode_head.chain(Buffer(np.frombuffer(data, np.uint8)))
                return BaseSrc.RETRY
            return Buffer(np.frombuffer(data, np.uint8))
        # extra BUNDLE sections flow on sometimes pads stream_%u
        pad = self._pad_for_section(idx)
        if pad.peer is not None:
            pad.push(Buffer(np.frombuffer(data, np.uint8)))
        return BaseSrc.RETRY

    def _pad_for_section(self, idx: int):
        from ...core.element import Pad, PadDirection, PadPresence, PadTemplate
        from ...core.events import Event, Segment
        from ...core.parse import parse_caps

        if idx not in self._extra_pads:
            pad = Pad(f"stream_{idx}", PadDirection.SRC,
                      PadTemplate("stream_%u", PadDirection.SRC,
                                  PadPresence.SOMETIMES, RTP_CAPS))
            self.add_pad(pad)
            self._extra_pads[idx] = pad
            if self.on_new_pad:
                self.on_new_pad(pad)
            m = self._pc.medias[idx] if self._pc and idx < len(self._pc.medias) else None
            caps = parse_caps(
                f"application/x-rtp,media={m['media']},payload={m['pt']},"
                f"encoding-name={m['encoding']},clock-rate={m['rate']}"
            ) if m else RTP_CAPS
            pad.push_event(Event.new_stream_start(f"{self.name}-stream-{idx}"))
            pad.push_event(Event.new_caps(caps))
            pad.push_event(Event.new_segment(Segment()))
        return self._extra_pads[idx]

    on_new_pad = None
