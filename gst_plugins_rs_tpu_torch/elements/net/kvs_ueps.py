"""awskvswebrtcsink and uepswebrtcsink — cloud-signaller WebRTC producers.

Parity targets: net/webrtc/src/aws_kvs_signaller/imp.rs and
ue_ps_signaller/{imp.rs,protocol.rs}.

awskvswebrtcsink — Amazon Kinesis Video Streams WebRTC *master*:
  WebSocket messages `{"messageType": SDP_OFFER|SDP_ANSWER|ICE_CANDIDATE,
  "messagePayload": base64(json), "senderClientId"/"recipientClientId"}`
  (imp.rs:95-151,543,578).  Viewers send SDP_OFFERs; the master answers
  each and streams over DTLS-SRTP.  The production wss:// URL is a SigV4
  presigned endpoint (net/sigv4.py presign_url, imp.rs:378-379); the
  `address` property connects directly (the reference defaults to
  ws://127.0.0.1:8443 the same way), since channel discovery via the AWS
  API needs egress.

uepswebrtcsink — Unreal Engine Pixel Streaming streamer:
  connect -> `identify` -> `endpointId {id}` -> `endpointIdConfirm`;
  on `playerConnected {playerId}` send `offer {sdp, playerId}`, apply
  `answer`, exchange `iceCandidate` (protocol.rs Message enum).
"""
from __future__ import annotations

import base64
import json
import threading
from typing import Dict, Optional

import numpy as np

from websockets.sync.client import connect as ws_connect

from ...core import BaseSink, Buffer, Caps, FlowReturn, Prop, register
from ...core.payload import host_bytes
from ...net.webrtc_peer import PeerConnection, WebRtcError
from ...net import sigv4
from .webrtc import BASE_WEBRTC_SINK_PROPS, WebRtcSinkBaseMixin

RTP_CAPS = Caps.builder("application/x-rtp")


def _pc_for_caps(caps: Optional[Caps], extra_attrs=None) -> PeerConnection:
    pc = PeerConnection(offerer=True)
    s = caps.structure(0) if caps is not None and caps.structures else None
    if s is not None:
        pc.set_media(
            s.get("media", "video"), int(s.get("payload", 96)),
            s.get("encoding-name", "VP8"), int(s.get("clock-rate", 90000)),
            extra_attrs,
        )
    return pc


class _FanoutSinkBase(WebRtcSinkBaseMixin, BaseSink):
    """Shared session bookkeeping: one PeerConnection per remote viewer,
    with the GstBaseWebRTCSink surface (the reference's signaller variants
    subclass BaseWebRTCSink; raw-input-only props like video-caps are
    accepted for surface parity — these elements take pre-payloaded x-rtp)."""

    SINK_CAPS = RTP_CAPS

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._base_init()
        self._sessions: Dict[str, PeerConnection] = {}
        self._lock = threading.RLock()

    def _base_pc_map(self):
        with self._lock:
            return dict(self._sessions)

    def _close_sessions(self) -> None:
        with self._lock:
            sessions, self._sessions = dict(self._sessions), {}
        for key, pc in sessions.items():
            self._base_release(key)
            pc.close()

    def render(self, buffer: Buffer) -> FlowReturn:
        data = host_bytes(buffer.data, np.uint8)
        self._base_record_send(data)
        for pc in self._base_pcs():
            pc.send_rtp(data)
        self._forward_metas(buffer)
        return FlowReturn.OK

    def connected_count(self) -> int:
        with self._lock:
            return sum(1 for pc in self._sessions.values() if pc._connected.is_set())


@register
class AwsKvsWebRtcSink(_FanoutSinkBase):
    ELEMENT_NAME = "awskvswebrtcsink"
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "KVS WebRTC master streaming to viewers over DTLS-SRTP"
    PROPERTIES = BASE_WEBRTC_SINK_PROPS + [
        Prop("address", "ws://127.0.0.1:8443", type="str",
             doc="signaling endpoint; presigned wss URL in production"),
        Prop("channel-name", None, type="str"),
        Prop("access-key", None, type="str"),
        Prop("secret-access-key", None, type="str"),
        Prop("session-token", None, type="str"),
        Prop("region", "us-east-1", type="str"),
        Prop("ping-timeout", 30, type="int"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ws = None
        self._thread: Optional[threading.Thread] = None

    def _connect_url(self) -> str:
        address = self.get_property("address")
        access = self.get_property("access-key")
        secret = self.get_property("secret-access-key")
        if access and secret and address.startswith("wss"):
            # production form: SigV4-presigned GetMedia endpoint
            params = {}
            if self.get_property("channel-name"):
                params["X-Amz-ChannelARN"] = self.get_property("channel-name")
            return sigv4.presign_url(
                "GET", address, self.get_property("region"), "kinesisvideo",
                access, secret, session_token=self.get_property("session-token"),
                extra_params=params,
            )
        return address

    def on_ready_to_paused(self) -> None:
        self._base_on_start()
        self._ws = ws_connect(self._connect_url(), open_timeout=10)
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def on_paused_to_ready(self) -> None:
        self._close_sessions()
        self._base_on_stop()
        if self._ws is not None:
            try:
                self._ws.close()
            except Exception:
                pass
            self._ws = None

    def _send_msg(self, message_type: str, payload: dict, recipient: str) -> None:
        self._ws.send(json.dumps({
            "action": message_type,
            "messageType": message_type,
            "messagePayload": base64.b64encode(json.dumps(payload).encode()).decode(),
            "recipientClientId": recipient,
        }))

    def _recv_loop(self) -> None:
        try:
            for raw in self._ws:
                try:
                    msg = json.loads(raw)
                    payload = json.loads(base64.b64decode(msg["messagePayload"]))
                except (ValueError, KeyError):
                    continue
                sender = msg.get("senderClientId", "")
                mtype = msg.get("messageType")
                if mtype == "SDP_OFFER":
                    self._on_offer(sender, payload.get("sdp", ""))
                elif mtype == "ICE_CANDIDATE":
                    with self._lock:
                        pc = self._sessions.get(sender)
                    if pc is not None:
                        pc.add_remote_ice(payload.get("candidate", ""))
        except Exception:
            pass

    def _on_offer(self, client_id: str, sdp: str) -> None:
        pc = self._base_prepare_pc(PeerConnection(offerer=False))
        pc.start()
        try:
            answer = pc.handle_offer(sdp, "sendonly")
        except WebRtcError:
            pc.close()
            return
        with self._lock:
            self._sessions[client_id] = pc
        self._base_arm_channels(pc, client_id)
        self._send_msg("SDP_ANSWER", {"type": "answer", "sdp": answer}, client_id)


@register
class UePsWebRtcSink(_FanoutSinkBase):
    ELEMENT_NAME = "uepswebrtcsink"
    ELEMENT_CLASS = "Sink/Network/WebRTC"
    ELEMENT_DESCRIPTION = "Unreal Pixel Streaming streamer over DTLS-SRTP"
    PROPERTIES = BASE_WEBRTC_SINK_PROPS + [
        Prop("signaller-uri", "ws://127.0.0.1:8888", type="str"),
        Prop("streamer-id", "gstpu-streamer", type="str"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ws = None
        self._thread: Optional[threading.Thread] = None
        self.confirmed_id: Optional[str] = None
        self._id_confirmed = threading.Event()

    def on_ready_to_paused(self) -> None:
        self._base_on_start()
        self._ws = ws_connect(self.get_property("signaller-uri"), open_timeout=10)
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        self._thread.start()

    def on_paused_to_ready(self) -> None:
        self._close_sessions()
        self._base_on_stop()
        if self._ws is not None:
            try:
                self._ws.send(json.dumps({"type": "stopStreaming"}))
                self._ws.close()
            except Exception:
                pass
            self._ws = None

    def _recv_loop(self) -> None:
        try:
            for raw in self._ws:
                try:
                    msg = json.loads(raw)
                except ValueError:
                    continue
                t = msg.get("type")
                if t == "identify":
                    self._ws.send(json.dumps({
                        "type": "endpointId",
                        "id": self.get_property("streamer-id"),
                        "protocolVersion": "1.1",
                    }))
                elif t == "endpointIdConfirm":
                    self.confirmed_id = msg.get("committedId", self.get_property("streamer-id"))
                    self._id_confirmed.set()
                    self._ws.send(json.dumps({"type": "startStreaming"}))
                elif t == "playerConnected":
                    self._on_player(str(msg.get("playerId")))
                elif t == "playerDisconnected":
                    pid = str(msg.get("playerId"))
                    with self._lock:
                        pc = self._sessions.pop(pid, None)
                    self._base_release(pid)
                    if pc:
                        pc.close()
                elif t == "answer":
                    pid = str(msg.get("playerId"))
                    with self._lock:
                        pc = self._sessions.get(pid)
                    if pc is not None:
                        try:
                            pc.handle_answer(msg.get("sdp", ""))
                        except WebRtcError:
                            pass
                elif t == "iceCandidate":
                    pid = str(msg.get("playerId"))
                    cand = msg.get("candidate") or {}
                    with self._lock:
                        pc = self._sessions.get(pid)
                    if pc is not None:
                        pc.add_remote_ice(cand.get("candidate", ""))
                elif t == "ping":
                    self._ws.send(json.dumps({"type": "pong", "time": msg.get("time")}))
        except Exception:
            pass

    def _on_player(self, player_id: str) -> None:
        pc = self._base_prepare_pc(
            _pc_for_caps(self.caps, self._base_media_attrs()))
        pc.start()
        with self._lock:
            self._sessions[player_id] = pc
        offer = pc.create_offer("sendonly")
        self._ws.send(json.dumps({"type": "offer", "sdp": offer, "playerId": player_id}))
        self._base_arm_channels(pc, player_id)
