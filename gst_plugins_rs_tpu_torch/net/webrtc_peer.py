"""WebRTC peer connection: ICE + DTLS-SRTP + SDP offer/answer over one socket.

Parity target: the role webrtcbin plays under the reference's
webrtcsink/webrtcsrc (net/webrtc/src/webrtcsink/imp.rs builds on
webrtcbin for ICE/DTLS/SRTP + SDP).  Here the whole stack is in-repo:
net/ice.py (RFC 8445), net/dtls.py (RFC 6347 + RFC 5764 use_srtp),
net/srtp.py (RFC 3711).

Negotiation shape (what webrtcbin emits for a single bundled stream):
UDP/TLS/RTP/SAVPF with rtcp-mux, a=setup:actpass in the offer and
a=setup:active in the answer — so the answerer runs the DTLS client.
Certificate fingerprints from the SDP are checked against the DTLS
peer certificate (a mismatch kills the connection).

Two divergences from the JAX package's copy, both about media that races
the connection's edges: SRTP arriving before the session keys are
installed is held and replayed under one lock, so no packet is appended
to a list that was already replayed and the replay keeps arrival order;
and `drain()` lets a receiver end a stream after the datagrams already in
the socket, not before them (webrtcsrc calls it on endSession).
"""
from __future__ import annotations

import re
import secrets
import select
import socket
import threading
import time
from typing import Callable, List, Optional

from .dtls import DtlsConnection, certificate_fingerprint, generate_certificate
from .ice import Candidate, IceAgent, demux_packet
from .rtcp import ReceiverReport, ReportBlock, Sdes
from .srtp import SrtpError, sessions_from_dtls


class WebRtcError(Exception):
    pass


def parse_sdp_medias(sdp: str) -> List[dict]:
    """All m-lines with their first rtpmap: [{media, pt, encoding, rate, attrs}]."""
    out: List[dict] = []
    for m in re.finditer(r"^m=(\w+) \d+ [\w/]+ (\d+)[^\n]*\n(.*?)(?=^m=|\Z)",
                         sdp.replace("\r\n", "\n"), re.M | re.S):
        media, pt, body = m.group(1), int(m.group(2)), m.group(3)
        rtpmap = re.search(rf"^a=rtpmap:{pt} ([\w\-]+)/(\d+)", body, re.M)
        enc, rate = (rtpmap.group(1), int(rtpmap.group(2))) if rtpmap else ("VP8", 90000)
        out.append({"media": media, "pt": pt, "encoding": enc, "rate": rate, "attrs": []})
    return out


def _sdp_attr(sdp: str, name: str) -> Optional[str]:
    m = re.search(rf"^a={re.escape(name)}:(.*?)\r?$", sdp, re.M)
    return m.group(1).strip() if m else None


class PeerConnection:
    """One bundled media stream (rtcp-mux) between two peers."""

    def __init__(self, offerer: bool, bind_host: str = "127.0.0.1"):
        self.offerer = offerer
        self.ice = IceAgent(controlling=offerer, bind_host=bind_host)
        self.cert_der, self.cert_key = generate_certificate()
        self.fingerprint = certificate_fingerprint(self.cert_der)
        self.remote_fingerprint: Optional[str] = None
        self.dtls: Optional[DtlsConnection] = None
        self.srtp_tx = None
        self.srtp_rx = None
        self._early_rtp: List[bytes] = []  # media racing SRTP installation
        # held by the receive loop deciding to hold a packet and by the
        # installation of the SRTP sessions with the replay of held packets
        self._srtp_lock = threading.Lock()
        self._drains: List[threading.Event] = []  # drain() requests
        self._drain_lock = threading.Lock()
        self.on_rtp: Optional[Callable[[bytes], None]] = None
        #: multi-section receivers: (media_index, packet)
        self.on_rtp_media: Optional[Callable[[int, bytes], None]] = None
        self.on_rtcp: Optional[Callable[[bytes], None]] = None
        self._connected = threading.Event()
        self._failed: Optional[str] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        #: BUNDLEd media sections: {media, pt, encoding, rate, attrs}
        self.medias: List[dict] = [
            {"media": "video", "pt": 96, "encoding": "VP8", "rate": 90000, "attrs": []}
        ]
        self.session_id = secrets.token_hex(8)
        # receiver statistics per remote SSRC for RTCP receiver reports
        self.local_ssrc = secrets.randbits(32)
        self._rx_stats: dict = {}  # ssrc -> {"count", "highest_seq", "cycles"}
        self.rtcp_interval = 2.0  # seconds; RFC 3550 reduced-size default
        # WebRTC data channels (net/sctp.py; RFC 8831/8832 over RFC 8261):
        # enabled adds an m=application webrtc-datachannel BUNDLE section
        self.enable_data_channel = False
        self.sctp = None
        self.on_data_channel: Optional[Callable[[object], None]] = None
        # host clocks (time.perf_counter) of start(), of ICE's selected pair
        # and of the DTLS handshake's end: the connection's set-up times
        self.t_start: Optional[float] = None
        self.t_ice: Optional[float] = None
        self.t_dtls: Optional[float] = None

    # -- SDP -----------------------------------------------------------------

    def set_media(self, media: str, pt: int, encoding: str, clock_rate: int,
                  extra_attrs: Optional[List[str]] = None) -> None:
        """Single-section sessions (clears any previous sections)."""
        self.medias = []
        self.add_media(media, pt, encoding, clock_rate, extra_attrs)

    def add_media(self, media: str, pt: int, encoding: str, clock_rate: int,
                  extra_attrs: Optional[List[str]] = None) -> int:
        """Appends a BUNDLEd m-line; returns its media index (= mid)."""
        self.medias.append({
            "media": media, "pt": pt, "encoding": encoding, "rate": clock_rate,
            "attrs": list(extra_attrs or []),
        })
        return len(self.medias) - 1

    def _pt_to_index(self, pt: int) -> int:
        for i, m in enumerate(self.medias):
            if m["pt"] == pt:
                return i
        return 0

    def _sdp(self, setup: str, direction: str) -> str:
        n_mids = len(self.medias) + (1 if self.enable_data_channel else 0)
        mids = " ".join(str(i) for i in range(n_mids))
        lines = [
            "v=0",
            f"o=- {int(self.session_id[:8], 16)} 0 IN IP4 0.0.0.0",
            "s=-",
            "t=0 0",
            f"a=group:BUNDLE {mids}",
        ]
        for i, m in enumerate(self.medias):
            lines += [
                f"m={m['media']} 9 UDP/TLS/RTP/SAVPF {m['pt']}",
                "c=IN IP4 0.0.0.0",
                f"a=mid:{i}",
                f"a={direction}",
                f"a=ice-ufrag:{self.ice.local_ufrag}",
                f"a=ice-pwd:{self.ice.local_pwd}",
                f"a=fingerprint:sha-256 {self.fingerprint}",
                f"a=setup:{setup}",
                "a=rtcp-mux",
                f"a=rtpmap:{m['pt']} {m['encoding']}/{m['rate']}",
                *m["attrs"],
                *[f"a={c.to_sdp()}" for c in self.ice.local_candidates()],
            ]
        if self.enable_data_channel:
            # RFC 8841 SDP for SCTP-over-DTLS data channels
            from .sctp import SCTP_PORT

            lines += [
                "m=application 9 UDP/DTLS/SCTP webrtc-datachannel",
                "c=IN IP4 0.0.0.0",
                f"a=mid:{len(self.medias)}",
                f"a=sctp-port:{SCTP_PORT}",
                "a=max-message-size:262144",
                f"a=ice-ufrag:{self.ice.local_ufrag}",
                f"a=ice-pwd:{self.ice.local_pwd}",
                f"a=fingerprint:sha-256 {self.fingerprint}",
                f"a=setup:{setup}",
            ]
        lines.append("")
        return "\r\n".join(lines)

    def create_offer(self, direction: str = "sendonly") -> str:
        return self._sdp("actpass", direction)

    def _parse_remote(self, sdp: str) -> None:
        ufrag = _sdp_attr(sdp, "ice-ufrag")
        pwd = _sdp_attr(sdp, "ice-pwd")
        if not ufrag or not pwd:
            raise WebRtcError("remote SDP missing ICE credentials")
        self.ice.set_remote_credentials(ufrag, pwd)
        fp = _sdp_attr(sdp, "fingerprint")
        if fp:
            algo, _, value = fp.partition(" ")
            if algo.lower() != "sha-256":
                raise WebRtcError(f"unsupported fingerprint hash {algo}")
            self.remote_fingerprint = value.strip().upper()
        for m in re.finditer(r"^a=(candidate:.*?)\r?$", sdp, re.M):
            self.ice.add_remote_candidate(Candidate.from_sdp(m.group(1)))

    def handle_offer(self, sdp: str, direction: str = "recvonly") -> str:
        """Answerer path: returns the answer SDP; we become the DTLS client."""
        self._parse_remote(sdp)
        parsed = parse_sdp_medias(sdp)
        if parsed:
            self.medias = parsed
        if "webrtc-datachannel" in sdp:
            self.enable_data_channel = True
        self._setup_dtls(is_client=True)
        return self._sdp("active", direction)

    def handle_answer(self, sdp: str) -> None:
        """Offerer path: answer chose active, so we are the DTLS server."""
        self._parse_remote(sdp)
        setup = (_sdp_attr(sdp, "setup") or "active").lower()
        self._setup_dtls(is_client=(setup == "passive"))

    def add_remote_ice(self, candidate_line: str) -> None:
        """Trickled candidate (signalling 'peer'/'ice' message)."""
        try:
            self.ice.add_remote_candidate(Candidate.from_sdp(candidate_line))
        except (ValueError, IndexError):
            pass

    # -- connection establishment ------------------------------------------------

    def _setup_dtls(self, is_client: bool) -> None:
        self.dtls = DtlsConnection(
            is_client, self._dtls_send, certificate=(self.cert_der, self.cert_key)
        )

    def _dtls_send(self, datagram: bytes) -> None:
        dest = self.ice.selected
        if dest is not None:
            try:
                self.ice.sock.sendto(datagram, dest)
            except OSError:
                pass

    def start(self) -> None:
        self.t_start = time.perf_counter()
        for target in (self._recv_loop, self._connect_loop, self._rtcp_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def _recv_loop(self) -> None:
        self.ice.sock.settimeout(0.1)
        while not self._stop.is_set():
            if self._drains and not select.select([self.ice.sock], [], [], 0)[0]:
                with self._drain_lock:
                    drains, self._drains = self._drains, []
                for done in drains:
                    done.set()
            try:
                data, addr = self.ice.sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                return
            kind = demux_packet(data)
            if kind == "stun":
                try:
                    self.ice.handle_stun(data, addr)
                except (ValueError, KeyError):
                    pass
            elif kind == "dtls" and self.dtls is not None:
                self.dtls.handle_packet(data)
            elif kind == "rtp":
                with self._srtp_lock:
                    held = self.srtp_rx is None
                    if held and len(self._early_rtp) < 256:
                        # peer's SRTP can start before our session objects
                        # are installed (the gap between handshake-done and
                        # _connect_loop's wake-up) — hold, replay on install
                        self._early_rtp.append(data)
                if not held:
                    self._handle_srtp(data)

    def drain(self, timeout: float = 2.0) -> bool:
        """Wait until the receive loop has handled every datagram that was
        in the socket when this was called (on loopback, everything the
        peer sent before its last signalling message).  False when the loop
        did not get there within `timeout` (it stopped, or is behind)."""
        done = threading.Event()
        with self._drain_lock:
            self._drains.append(done)
        return done.wait(timeout)

    def _handle_srtp(self, data: bytes) -> None:
        is_rtcp = len(data) > 1 and 192 <= data[1] <= 223
        try:
            if is_rtcp:
                plain = self.srtp_rx.unprotect_rtcp(data)
                if self.on_rtcp:
                    self.on_rtcp(plain)
            else:
                plain = self.srtp_rx.unprotect(data)
                self._track_rx(plain)
                if self.on_rtp_media is not None:
                    self.on_rtp_media(self._pt_to_index(plain[1] & 0x7F), plain)
                if self.on_rtp:
                    self.on_rtp(plain)
        except SrtpError:
            pass

    def _track_rx(self, rtp: bytes) -> None:
        import struct as _struct

        if len(rtp) < 12:
            return
        seq = _struct.unpack("!H", rtp[2:4])[0]
        ssrc = _struct.unpack("!I", rtp[8:12])[0]
        st = self._rx_stats.setdefault(ssrc, {"count": 0, "highest_seq": seq,
                                              "cycles": 0})
        st["count"] += 1
        if seq < st["highest_seq"] and st["highest_seq"] - seq > 0x8000:
            st["cycles"] += 1
        if seq > st["highest_seq"] or st["cycles"]:
            st["highest_seq"] = max(seq, st["highest_seq"]) \
                if not (seq < st["highest_seq"] and st["highest_seq"] - seq > 0x8000) else seq

    def _rtcp_loop(self) -> None:
        """Periodic compound RR+SDES over SRTCP (RFC 3550 §6)."""
        while not self._stop.wait(self.rtcp_interval):
            if not self._connected.is_set():
                continue
            reports = []
            for ssrc, st in list(self._rx_stats.items()):
                ext = (st["cycles"] << 16) | st["highest_seq"]
                expected = ext + 1
                lost = max(0, expected - st["count"])
                reports.append(ReportBlock(
                    ssrc=ssrc, fraction_lost=0,
                    cumulative_lost=min(lost, 0x7FFFFF),
                    ext_highest_seq=ext, jitter=0, lsr=0, dlsr=0))
            compound = ReceiverReport(self.local_ssrc, reports).to_bytes() \
                + Sdes(self.local_ssrc, f"gstpu-{self.session_id[:8]}").to_bytes()
            self.send_rtcp(compound)

    def _connect_loop(self) -> None:
        if not self.ice.wait_connected(10.0):
            self._failed = "ICE timed out"
            return
        self.t_ice = time.perf_counter()
        if self.dtls is None:
            # answer not applied yet; wait for it
            deadline = time.monotonic() + 10.0
            while self.dtls is None and time.monotonic() < deadline:
                if self._stop.wait(0.02):
                    return
            if self.dtls is None:
                self._failed = "no DTLS role established"
                return
        if self.dtls.is_client:
            self.dtls.start_handshake()
        try:
            ok = self.dtls.wait_handshake(10.0)
        except Exception as e:
            self._failed = f"DTLS failed: {e}"
            return
        if not ok:
            self._failed = "DTLS handshake timed out"
            return
        self.t_dtls = time.perf_counter()
        if self.remote_fingerprint is not None:
            actual = certificate_fingerprint(self.dtls.peer_cert_der or b"")
            if actual != self.remote_fingerprint:
                self._failed = "peer certificate fingerprint mismatch"
                return
        with self._srtp_lock:
            self.srtp_tx, self.srtp_rx = sessions_from_dtls(self.dtls)
            early, self._early_rtp = self._early_rtp, []
            for data in early:
                self._handle_srtp(data)
        if self.enable_data_channel:
            from .sctp import SctpAssociation

            self.sctp = SctpAssociation(self.dtls.send,
                                        client=self.dtls.is_client)
            self.sctp.on_channel = self._on_sctp_channel
            self.dtls.on_data = self.sctp.feed
            if self.dtls.is_client:
                self.sctp.connect()
            t = threading.Thread(target=self._sctp_tick_loop, daemon=True)
            t.start()
            self._threads.append(t)
        self._connected.set()

    def _on_sctp_channel(self, channel) -> None:
        if self.on_data_channel is not None:
            self.on_data_channel(channel)

    def _sctp_tick_loop(self) -> None:
        while not self._stop.wait(0.1):
            if self.sctp is None or self.sctp.closed.is_set():
                return
            self.sctp.tick()

    def create_data_channel(self, label: str, protocol: str = "",
                            timeout: float = 10.0):
        """Open a data channel; blocks until the association is up."""
        if self.sctp is None:
            deadline = time.monotonic() + timeout
            while self.sctp is None and time.monotonic() < deadline:
                if self._stop.wait(0.02):
                    raise WebRtcError("connection stopped")
            if self.sctp is None:
                raise WebRtcError("no SCTP association (data channel not "
                                  "negotiated?)")
        if not self.sctp.established.wait(timeout):
            raise WebRtcError("SCTP association timed out")
        return self.sctp.open_channel(label, protocol)

    def wait_connected(self, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._connected.wait(0.05):
                return True
            if self._failed:
                raise WebRtcError(self._failed)
        return self._connected.is_set()

    # -- media ----------------------------------------------------------------

    def send_rtp(self, packet: bytes) -> None:
        if not self._connected.is_set():
            return
        dest = self.ice.selected
        if dest is None:
            return
        try:
            self.ice.sock.sendto(self.srtp_tx.protect(packet), dest)
        except OSError:
            pass

    def send_rtcp(self, packet: bytes) -> None:
        if not self._connected.is_set():
            return
        dest = self.ice.selected
        if dest is None:
            return
        try:
            self.ice.sock.sendto(self.srtp_tx.protect_rtcp(packet), dest)
        except OSError:
            pass

    def close(self) -> None:
        self._stop.set()
        if self.sctp is not None:
            try:
                self.sctp.shutdown()
            except Exception:
                pass
        if self.dtls is not None:
            self.dtls.close()
        for t in self._threads:
            t.join(0.5)
        self.ice.close()
