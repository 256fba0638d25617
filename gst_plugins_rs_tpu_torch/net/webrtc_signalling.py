"""gst-webrtc signalling protocol + server + client.

Parity target: net/webrtc/protocol/src/lib.rs (message schema — serde
camelCase with internal "type" tags) and net/webrtc/signalling (the
WebSocket relay server run as `gst-webrtc-signalling-server`).  The JSON
wire format matches the reference exactly, so this server interops with
reference webrtcsink/webrtcsrc clients and vice versa:

  server→peer: welcome, peerStatusChanged, startSession, sessionStarted,
               endSession, peer, list, listConsumers, error
  peer→server: setPeerStatus, startSession, endSession, peer, list,
               listConsumers

Transport is RFC 6455 WebSocket via the `websockets` package (threaded
sync API — the reference uses tokio/async-tungstenite; the relay logic
is identical).
"""
from __future__ import annotations

import json
import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from websockets.sync.client import connect as ws_connect
from websockets.sync.server import serve as ws_serve


# ---------------------------------------------------------------------------
# message constructors (reference protocol/src/lib.rs:17-193)


def msg_welcome(peer_id: str) -> dict:
    return {"type": "welcome", "peerId": peer_id}


def msg_peer_status(roles: List[str], meta=None, peer_id: Optional[str] = None) -> dict:
    m = {"type": "peerStatusChanged", "roles": roles, "meta": meta}
    if peer_id is not None:
        m["peerId"] = peer_id
    return m


def msg_start_session(peer_id: str, session_id: str, offer: Optional[str] = None) -> dict:
    return {"type": "startSession", "peerId": peer_id, "sessionId": session_id, "offer": offer}


def msg_session_started(peer_id: str, session_id: str) -> dict:
    return {"type": "sessionStarted", "peerId": peer_id, "sessionId": session_id}


def msg_end_session(session_id: str) -> dict:
    return {"type": "endSession", "sessionId": session_id}


def msg_peer_sdp(session_id: str, kind: str, sdp: str) -> dict:
    return {"type": "peer", "sessionId": session_id, "sdp": {"type": kind, "sdp": sdp}}


def msg_peer_ice(session_id: str, candidate: str, mline_index: int) -> dict:
    return {
        "type": "peer",
        "sessionId": session_id,
        "ice": {"candidate": candidate, "sdpMLineIndex": mline_index},
    }


def msg_error(details: str) -> dict:
    return {"type": "error", "details": details}


# ---------------------------------------------------------------------------
# server


@dataclass
class _Peer:
    ws: object
    peer_id: str
    roles: List[str] = field(default_factory=list)
    meta: Optional[dict] = None


@dataclass
class _Session:
    session_id: str
    producer_id: str
    consumer_id: str


class SignallingServer:
    """The gst-webrtc-signalling-server relay (reference signalling/src/server)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._peers: Dict[str, _Peer] = {}
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.RLock()
        self._server = ws_serve(self._handle, host, port)
        self.port = self._server.socket.getsockname()[1]
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def uri(self) -> str:
        return f"ws://127.0.0.1:{self.port}"

    def stop(self) -> None:
        self._server.shutdown()

    # -- per-connection ------------------------------------------------------
    def _send(self, peer: _Peer, msg: dict) -> None:
        try:
            peer.ws.send(json.dumps(msg))
        except Exception:
            pass

    def _handle(self, ws) -> None:
        peer = _Peer(ws=ws, peer_id=str(uuid.uuid4()))
        with self._lock:
            self._peers[peer.peer_id] = peer
        self._send(peer, msg_welcome(peer.peer_id))
        try:
            for raw in ws:
                try:
                    msg = json.loads(raw)
                except ValueError:
                    self._send(peer, msg_error("invalid json"))
                    continue
                self._dispatch(peer, msg)
        except Exception:
            pass
        finally:
            self._remove_peer(peer)

    def _remove_peer(self, peer: _Peer) -> None:
        with self._lock:
            self._peers.pop(peer.peer_id, None)
            ended = [s for s in self._sessions.values()
                     if peer.peer_id in (s.producer_id, s.consumer_id)]
            for s in ended:
                del self._sessions[s.session_id]
            listeners = [p for p in self._peers.values() if "listener" in p.roles]
        for s in ended:
            other_id = s.consumer_id if s.producer_id == peer.peer_id else s.producer_id
            other = self._peers.get(other_id)
            if other:
                self._send(other, msg_end_session(s.session_id))
        if peer.roles:
            gone = msg_peer_status([], None, peer.peer_id)
            for lp in listeners:
                self._send(lp, gone)

    def _dispatch(self, peer: _Peer, msg: dict) -> None:
        t = msg.get("type")
        if t == "setPeerStatus":
            with self._lock:
                peer.roles = [r.lower() for r in msg.get("roles", [])]
                peer.meta = msg.get("meta")
                listeners = [p for p in self._peers.values() if "listener" in p.roles]
            status = msg_peer_status(peer.roles, peer.meta, peer.peer_id)
            self._send(peer, status)
            for lp in listeners:
                if lp.peer_id != peer.peer_id:
                    self._send(lp, status)
        elif t == "list":
            with self._lock:
                producers = [
                    {"id": p.peer_id, "meta": p.meta}
                    for p in self._peers.values() if "producer" in p.roles
                ]
            self._send(peer, {"type": "list", "producers": producers})
        elif t == "listConsumers":
            with self._lock:
                consumers = [
                    {"id": p.peer_id, "meta": p.meta}
                    for p in self._peers.values() if "consumer" in p.roles
                ]
            self._send(peer, {"type": "listConsumers", "consumers": consumers})
        elif t == "startSession":
            other_id = msg.get("peerId")
            with self._lock:
                other = self._peers.get(other_id)
            if other is None:
                self._send(peer, msg_error(f"no such peer {other_id!r}"))
                return
            session_id = str(uuid.uuid4())
            offer = msg.get("offer")
            # requester is the consumer unless it registered as producer
            if "producer" in peer.roles and "producer" not in other.roles:
                producer, consumer = peer, other
            else:
                producer, consumer = other, peer
            with self._lock:
                self._sessions[session_id] = _Session(session_id, producer.peer_id, consumer.peer_id)
            self._send(producer, msg_start_session(consumer.peer_id, session_id, offer))
            self._send(consumer, msg_session_started(producer.peer_id, session_id))
        elif t == "peer":
            session_id = msg.get("sessionId")
            with self._lock:
                sess = self._sessions.get(session_id)
                if sess is None:
                    self._send(peer, msg_error(f"no such session {session_id!r}"))
                    return
                other_id = (
                    sess.consumer_id if sess.producer_id == peer.peer_id else sess.producer_id
                )
                other = self._peers.get(other_id)
            if other:
                self._send(other, msg)
        elif t == "endSession":
            session_id = msg.get("sessionId")
            with self._lock:
                sess = self._sessions.pop(session_id, None)
                other = None
                if sess:
                    other_id = (
                        sess.consumer_id if sess.producer_id == peer.peer_id else sess.producer_id
                    )
                    other = self._peers.get(other_id)
            if other:
                self._send(other, msg_end_session(session_id))
        elif t in ("setProtocolVersion", "newPeer"):
            pass
        else:
            self._send(peer, msg_error(f"unknown message type {t!r}"))


# ---------------------------------------------------------------------------
# client


class SignallingClient:
    """Threaded client; messages dispatched to `on_message(dict)`."""

    def __init__(self, uri: str, on_message: Callable[[dict], None]):
        self.ws = ws_connect(uri, open_timeout=5)
        self.peer_id: Optional[str] = None
        self.on_message = on_message
        self._welcome = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for raw in self.ws:
                msg = json.loads(raw)
                if msg.get("type") == "welcome":
                    self.peer_id = msg["peerId"]
                    self._welcome.set()
                try:
                    self.on_message(msg)
                except Exception:  # a bad handler must not kill the receive loop
                    import traceback

                    traceback.print_exc()
        except Exception:
            pass

    def wait_welcome(self, timeout: float = 5.0) -> str:
        if not self._welcome.wait(timeout):
            raise TimeoutError("no welcome from signalling server")
        return self.peer_id  # type: ignore[return-value]

    def send(self, msg: dict) -> None:
        self.ws.send(json.dumps(msg))

    def close(self) -> None:
        try:
            self.ws.close()
        except Exception:
            pass
        self._thread.join(1.0)
