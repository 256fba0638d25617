"""ICE agent (RFC 8445, host candidates) over the native STUN codec.

Parity target: the reference's webrtcsink/webrtcsrc get ICE from webrtcbin
(libnice / webrtc-ice); here the agent is in-repo.  Scope: UDP host
candidates, full + ICE-lite style responders, aggressive nomination
(USE-CANDIDATE on every check, like libnice's default for controlling
agents), role from signaling (offerer controls).  Server-reflexive /
TURN gathering is out of scope in this egress-less environment.

Demux on the shared socket follows RFC 5764 §5.1.2: STUN (first byte < 64
+ magic cookie), DTLS (20..63), RTP/RTCP (128..191).
"""
from __future__ import annotations

import secrets
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .stun import (
    BINDING_ERROR,
    BINDING_REQUEST,
    BINDING_SUCCESS,
    ATTR_ICE_CONTROLLED,
    ATTR_ICE_CONTROLLING,
    ATTR_USE_CANDIDATE,
    StunMessage,
    is_stun,
)


def candidate_priority(type_pref: int, local_pref: int, component: int) -> int:
    """RFC 8445 §5.1.2.1."""
    return (type_pref << 24) | (local_pref << 8) | (256 - component)


@dataclass
class Candidate:
    foundation: str
    component: int
    transport: str
    priority: int
    host: str
    port: int
    typ: str = "host"

    def to_sdp(self) -> str:
        return (
            f"candidate:{self.foundation} {self.component} {self.transport} "
            f"{self.priority} {self.host} {self.port} typ {self.typ}"
        )

    @classmethod
    def from_sdp(cls, line: str) -> "Candidate":
        if line.startswith("a="):
            line = line[2:]
        if line.startswith("candidate:"):
            line = line[len("candidate:"):]
        parts = line.split()
        return cls(
            foundation=parts[0],
            component=int(parts[1]),
            transport=parts[2],
            priority=int(parts[3]),
            host=parts[4],
            port=int(parts[5]),
            typ=parts[7] if len(parts) > 7 else "host",
        )


class IceAgent:
    """One component (RTP with rtcp-mux), one UDP socket."""

    def __init__(self, controlling: bool, bind_host: str = "127.0.0.1"):
        self.controlling = controlling
        self.local_ufrag = secrets.token_urlsafe(4)
        self.local_pwd = secrets.token_urlsafe(18)
        self.remote_ufrag: Optional[str] = None
        self.remote_pwd: Optional[str] = None
        self.remote_candidates: List[Candidate] = []
        self.tiebreaker = struct.pack("!Q", secrets.randbits(64))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((bind_host, 0))
        self.local_candidate = Candidate(
            foundation="1",
            component=1,
            transport="udp",
            priority=candidate_priority(126, 65535, 1),
            host=bind_host,
            port=self.sock.getsockname()[1],
        )
        self.selected: Optional[Tuple[str, int]] = None
        self._selected_evt = threading.Event()
        self._pending: Dict[bytes, Tuple[str, int]] = {}
        self._lock = threading.Lock()

    # -- signaling-side API --------------------------------------------------
    def local_candidates(self) -> List[Candidate]:
        return [self.local_candidate]

    def set_remote_credentials(self, ufrag: str, pwd: str) -> None:
        self.remote_ufrag, self.remote_pwd = ufrag, pwd

    def add_remote_candidate(self, cand: Candidate) -> None:
        with self._lock:
            self.remote_candidates.append(cand)

    # -- checks ----------------------------------------------------------------
    def send_checks(self) -> None:
        """Fire one binding request per remote candidate (aggressive nomination)."""
        if self.remote_pwd is None:
            return
        with self._lock:
            cands = list(self.remote_candidates)
        for cand in cands:
            req = StunMessage(BINDING_REQUEST)
            req.add_username(f"{self.remote_ufrag}:{self.local_ufrag}")
            req.add_priority(candidate_priority(110, 65535, 1))  # prflx preference
            role = ATTR_ICE_CONTROLLING if self.controlling else ATTR_ICE_CONTROLLED
            req.add(role, self.tiebreaker)
            if self.controlling:
                req.add(ATTR_USE_CANDIDATE, b"")
            with self._lock:
                self._pending[req.transaction_id] = (cand.host, cand.port)
            self.sock.sendto(
                req.encode(integrity_key=self.remote_pwd.encode()),
                (cand.host, cand.port),
            )

    def handle_stun(self, data: bytes, addr: Tuple[str, int]) -> None:
        msg = StunMessage.decode(data)
        if msg.msg_type == BINDING_REQUEST:
            if not msg.verify_integrity(data, self.local_pwd.encode()):
                err = StunMessage(BINDING_ERROR, msg.transaction_id).add_error(401, "Unauthorized")
                self.sock.sendto(err.encode(), addr)
                return
            resp = StunMessage(BINDING_SUCCESS, msg.transaction_id)
            resp.add_xor_mapped_address(*addr)
            self.sock.sendto(resp.encode(integrity_key=self.local_pwd.encode()), addr)
            nominate = msg.get(ATTR_USE_CANDIDATE) is not None
            if nominate or not self.controlling:
                self._select(addr)
            if not self.controlling:
                # Triggered check back (RFC 8445 §7.3.1.4) so both sides validate.
                self.send_checks()
        elif msg.msg_type == BINDING_SUCCESS:
            with self._lock:
                dest = self._pending.pop(msg.transaction_id, None)
            if dest is not None:
                self._select(dest)

    def _select(self, addr: Tuple[str, int]) -> None:
        if self.selected is None:
            self.selected = addr
        self._selected_evt.set()

    def wait_connected(self, timeout: float = 5.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._selected_evt.wait(0.05):
                return True
            self.send_checks()
        return self._selected_evt.is_set()

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def demux_packet(data: bytes) -> str:
    """RFC 5764 §5.1.2 first-byte demux: 'stun' | 'dtls' | 'rtp' | 'unknown'."""
    if not data:
        return "unknown"
    b = data[0]
    if is_stun(data):
        return "stun"
    if 20 <= b <= 63:
        return "dtls"
    if 128 <= b <= 191:
        return "rtp"
    return "unknown"
