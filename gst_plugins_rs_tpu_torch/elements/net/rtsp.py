"""rtspsrc2: RTSP client source (RFC 2326/7826 subset).

Parity target: net/rtsp (rtspsrc2, 6246 LoC).  Implements the client state
machine OPTIONS -> DESCRIBE (SDP) -> SETUP -> PLAY -> TEARDOWN with:

- RTP over UDP (per-media receive sockets) or interleaved TCP
  (`protocols=tcp`: Transport RTP/AVP/TCP;interleaved=n-n+1, '$'-framed
  records on the control connection, RFC 2326 §10.12)
- basic and digest authentication (RFC 7616 MD5 + qop=auth subset) via
  `user-id` / `user-pw`, retried on 401 like the reference

The first media stream flows on the static src pad; additional streams
appear as sometimes pads `stream_%u` (reference pad naming), all with
application/x-rtp caps built from the SDP rtpmap.
"""
from __future__ import annotations

import hashlib
import re
import secrets
import socket
import struct
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from ...core import (
    BaseSrc,
    Buffer,
    Caps,
    Event,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.caps import Structure
from ...core.events import Segment
from ...net.sdp import Sdp, parse_sdp

RTP_CAPS = Caps.builder("application/x-rtp")


def _digest_response(user: str, pw: str, realm: str, nonce: str, method: str,
                     uri: str, qop: Optional[str], cnonce: str, nc: str) -> str:
    ha1 = hashlib.md5(f"{user}:{realm}:{pw}".encode()).hexdigest()
    ha2 = hashlib.md5(f"{method}:{uri}".encode()).hexdigest()
    if qop:
        return hashlib.md5(f"{ha1}:{nonce}:{nc}:{cnonce}:{qop}:{ha2}".encode()).hexdigest()
    return hashlib.md5(f"{ha1}:{nonce}:{ha2}".encode()).hexdigest()


def _parse_www_auth(value: str) -> Tuple[str, Dict[str, str]]:
    scheme, _, rest = value.partition(" ")
    params = {}
    for m in re.finditer(r'(\w+)=(?:"([^"]*)"|([^\s,]+))', rest):
        params[m.group(1).lower()] = m.group(2) if m.group(2) is not None else m.group(3)
    return scheme.lower(), params


class _Stream:
    def __init__(self, index: int, media, sock: Optional[socket.socket],
                 channel: Optional[int] = None):
        self.index = index
        self.media = media
        self.sock = sock
        self.channel = channel  # interleaved TCP channel (RTP)
        self.pad: Optional[Pad] = None
        self.started = False

    def caps(self) -> Caps:
        m = self.media
        fields = {"media": m.media, "payload": m.payload_type}
        if m.encoding_name:
            fields["encoding-name"] = m.encoding_name
        if m.clock_rate:
            fields["clock-rate"] = m.clock_rate
        if m.encoding_params:
            fields["encoding-params"] = m.encoding_params
        return Caps([Structure("application/x-rtp", **fields)])


@register
class RtspSrc2(BaseSrc):
    ELEMENT_NAME = "rtspsrc2"
    EXTRA_PAD_TEMPLATES = [
        ('stream_%u', 'src', 'sometimes', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Source/Network"
    ELEMENT_DESCRIPTION = "RTSP client source (RTP over UDP or interleaved TCP)"
    SIGNALS = {
        "get-parameter": "get_parameter",
        "get-parameters": "get_parameters",
        "set-parameter": "set_parameter",
        "tls-client-auth": None,  # request: app supplies a client cert
    }
    IS_LIVE = True
    SRC_CAPS = RTP_CAPS
    PROPERTIES = [
        Prop("location", None, type="str", doc="rtsp:// URL"),
        Prop("timeout", 2_000_000_000, type="uint64", doc="ns without data -> EOS"),
        Prop("num-buffers", 0, type="uint", doc="stop after N RTP packets (0 = unbounded)"),
        Prop("protocols", "udp", type="enum", choices=["udp", "tcp"],
             doc="lower transport (tcp = interleaved on the control connection)"),
        Prop("user-id", None, type="str"),
        Prop("user-pw", None, type="str"),
        Prop("latency", 2_000, type="uint",
             doc="ms of jitterbuffer latency reported downstream"),
        Prop("port-start", 0, type="uint", maximum=65535,
             doc="first local UDP port to try for RTP (0 = ephemeral)"),
        Prop("receive-mtu", 65536, type="uint", minimum=1500,
             doc="receive buffer allocation per RTP datagram"),
        Prop("do-rtsp-keep-alive", True, type="bool",
             doc="send periodic keep-alive requests on the control "
                 "connection while playing"),
        Prop("extra-http-request-headers", None, type="object",
             doc="extra headers on every RTSP request (mapping)"),
        Prop("certificate-file", None, type="str",
             doc="client TLS certificate for rtsps:// (accepted; this "
                 "client speaks plain rtsp:// — TLS termination external)"),
        Prop("private-key-file", None, type="str",
             doc="accepted with certificate-file"),
        Prop("tls-validation-flags", "validate-all", type="enum",
             choices=["validate-all", "none"],
             doc="accepted with rtsps:// (see certificate-file)"),
    ]

    def latency_additional_ns(self) -> int:
        return self.get_property("latency") * 1_000_000

    # -- GET_PARAMETER / SET_PARAMETER actions (rtspsrc2/imp.rs signals) ----
    def get_parameter(self, parameter: str, content_type: str = "text/parameters") -> str:
        """`get-parameter` action: one RTSP GET_PARAMETER round trip."""
        return self.get_parameters([parameter], content_type)

    def get_parameters(self, parameters, content_type: str = "text/parameters") -> str:
        body = "\r\n".join(parameters).encode() if parameters else b""
        headers, resp = self._request_with_body(
            "GET_PARAMETER", self.get_property("location"),
            body, content_type)
        return resp.decode(errors="replace")

    def set_parameter(self, name: str, value: str,
                      content_type: str = "text/parameters") -> bool:
        body = f"{name}: {value}".encode()
        self._request_with_body("SET_PARAMETER", self.get_property("location"),
                                body, content_type)
        return True

    def _request_with_body(self, method: str, url: str, body: bytes,
                           content_type: str):
        extra = {"Content-Type": content_type,
                 "Content-Length": str(len(body))}
        # reuse the header path, then append the body on the wire
        self._cseq += 1
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self._cseq}"]
        if self._session:
            lines.append(f"Session: {self._session}")
        auth = self._authorization(method, url)
        if auth:
            lines.append(f"Authorization: {auth}")
        for k, v in extra.items():
            lines.append(f"{k}: {v}")
        self._conn.sendall(("\r\n".join(lines) + "\r\n\r\n").encode() + body)
        status_line, headers, resp = self._read_response(method)
        if status_line.split()[1] != "200":
            raise RuntimeError(f"{self.name}: {method} failed: {status_line}")
        return headers, resp

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._conn: Optional[socket.socket] = None
        self._cseq = 0
        self._session = ""
        self._streams: List[_Stream] = []
        self._count = 0
        self.sdp: Optional[Sdp] = None
        self._auth_header: Optional[Tuple[str, Dict[str, str]]] = None  # (scheme, params)
        self._nc = 0
        self._tcp_buf = bytearray()

    # -- auth ------------------------------------------------------------------
    def _authorization(self, method: str, url: str) -> Optional[str]:
        user = self.get_property("user-id")
        pw = self.get_property("user-pw")
        if user is None or self._auth_header is None:
            return None
        scheme, params = self._auth_header
        if scheme == "basic":
            import base64

            return "Basic " + base64.b64encode(f"{user}:{pw or ''}".encode()).decode()
        if scheme == "digest":
            realm = params.get("realm", "")
            nonce = params.get("nonce", "")
            qop = "auth" if "auth" in (params.get("qop") or "") else None
            self._nc += 1
            nc = f"{self._nc:08x}"
            cnonce = secrets.token_hex(8)
            resp = _digest_response(user, pw or "", realm, nonce, method, url,
                                    qop, cnonce, nc)
            out = (f'Digest username="{user}", realm="{realm}", nonce="{nonce}", '
                   f'uri="{url}", response="{resp}"')
            if qop:
                out += f', qop={qop}, nc={nc}, cnonce="{cnonce}"'
            if "opaque" in params:
                out += f', opaque="{params["opaque"]}"'
            return out
        return None

    # -- RTSP protocol -----------------------------------------------------------
    def _read_response(self, method: str) -> Tuple[str, Dict[str, str], bytes]:
        """Reads one RTSP response, buffering any interleaved '$' records."""
        while True:
            # strip leading interleaved frames that arrive before the reply
            while self._tcp_buf[:1] == b"$":
                if len(self._tcp_buf) < 4:
                    break
                ch, length = self._tcp_buf[1], struct.unpack("!H", self._tcp_buf[2:4])[0]
                if len(self._tcp_buf) < 4 + length:
                    break
                self._deliver_interleaved(ch, bytes(self._tcp_buf[4:4 + length]))
                del self._tcp_buf[:4 + length]
            if b"\r\n\r\n" in self._tcp_buf:
                break
            chunk = self._conn.recv(4096)
            if not chunk:
                raise RuntimeError(f"{self.name}: server closed during {method}")
            self._tcp_buf += chunk
        head, _, rest = bytes(self._tcp_buf).partition(b"\r\n\r\n")
        head_lines = head.decode(errors="replace").split("\r\n")
        headers: Dict[str, str] = {}
        for hl in head_lines[1:]:
            k, _, v = hl.partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        while len(rest) < length:
            chunk = self._conn.recv(4096)
            if not chunk:
                break
            rest += chunk
        body, leftover = rest[:length], rest[length:]
        self._tcp_buf = bytearray(leftover)
        return head_lines[0], headers, body

    def _request(self, method: str, url: str,
                 extra: Optional[Dict[str, str]] = None,
                 _retried: bool = False) -> Tuple[Dict[str, str], bytes]:
        extra = extra or {}
        self._cseq += 1
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self._cseq}"]
        if self._session:
            lines.append(f"Session: {self._session}")
        auth = self._authorization(method, url)
        if auth:
            lines.append(f"Authorization: {auth}")
        for k, v in extra.items():
            lines.append(f"{k}: {v}")
        custom = self.get_property("extra-http-request-headers")
        if custom:
            items = custom.items() if hasattr(custom, "items") else custom
            for k, v in items:
                lines.append(f"{k}: {v}")
        self._conn.sendall(("\r\n".join(lines) + "\r\n\r\n").encode())
        status_line, headers, body = self._read_response(method)
        status = status_line.split()
        if status[1] == "401" and not _retried and self.get_property("user-id"):
            www = headers.get("www-authenticate")
            if www:
                self._auth_header = _parse_www_auth(www)
                return self._request(method, url, extra, _retried=True)
        if status[1] != "200":
            raise RuntimeError(f"{self.name}: {method} failed: {status_line}")
        return headers, body

    def start(self) -> None:
        loc = self.get_property("location")
        if not loc:
            raise RuntimeError(f"{self.name}: no location set")
        url = urlparse(loc)
        self._conn = socket.create_connection((url.hostname, url.port or 554), timeout=5)
        self._cseq = 0
        self._session = ""
        self._count = 0
        self._tcp_buf = bytearray()
        use_tcp = self.get_property("protocols") == "tcp"
        self._request("OPTIONS", loc)
        headers, body = self._request("DESCRIBE", loc, {"Accept": "application/sdp"})
        self.sdp = parse_sdp(body.decode(errors="replace"))
        if not self.sdp.medias:
            raise RuntimeError(f"{self.name}: no media in SDP")
        base = headers.get("content-base", loc).rstrip("/")
        self._streams = []
        for i, media in enumerate(self.sdp.medias):
            control = media.control or str(i)
            setup_url = control if control.startswith("rtsp://") else f"{base}/{control}"
            if use_tcp:
                ch = 2 * i
                headers, _ = self._request(
                    "SETUP", setup_url,
                    {"Transport": f"RTP/AVP/TCP;unicast;interleaved={ch}-{ch + 1}"},
                )
                self._streams.append(_Stream(i, media, None, channel=ch))
            else:
                sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                start_port = self.get_property("port-start")
                if start_port:
                    # walk even ports from port-start until one binds
                    for cand in range(start_port + 2 * i, 65534, 2):
                        try:
                            sock.bind(("0.0.0.0", cand))
                            break
                        except OSError:
                            continue
                    else:
                        sock.bind(("0.0.0.0", 0))
                else:
                    sock.bind(("0.0.0.0", 0))
                port = sock.getsockname()[1]
                headers, _ = self._request(
                    "SETUP", setup_url,
                    {"Transport": f"RTP/AVP;unicast;client_port={port}-{port + 1}"},
                )
                self._streams.append(_Stream(i, media, sock))
            self._session = headers.get("session", self._session).split(";")[0]
        self._request("PLAY", loc, {"Range": "npt=0-"})
        timeout = self.get_property("timeout") / 1e9
        for st in self._streams:
            if st.sock is not None:
                st.sock.settimeout(timeout)
        if use_tcp:
            self._conn.settimeout(timeout)

    def stop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.settimeout(2.0)
                self._request("TEARDOWN", self.get_property("location"))
            except Exception:
                pass
            self._conn.close()
            self._conn = None
        for st in self._streams:
            if st.sock is not None:
                st.sock.close()
        self._streams = []

    # -- pads/negotiation ---------------------------------------------------------
    def _pad_for(self, st: _Stream) -> Pad:
        if st.pad is None:
            if st.index == 0:
                st.pad = self.srcpad
            else:
                st.pad = Pad(f"stream_{st.index}", PadDirection.SRC,
                             PadTemplate("stream_%u", PadDirection.SRC,
                                         PadPresence.SOMETIMES, RTP_CAPS))
                self.add_pad(st.pad)
        if not st.started and st.pad.peer is not None:
            st.started = True
            st.pad.push_event(Event.new_stream_start(f"{self.name}-stream{st.index}"))
            st.pad.push_event(Event.new_caps(st.caps()))
            st.pad.push_event(Event.new_segment(Segment()))
        return st.pad

    def negotiate(self) -> Caps:
        return self._streams[0].caps() if self._streams else super().negotiate()

    def _deliver_interleaved(self, channel: int, data: bytes) -> None:
        for st in self._streams:
            if st.channel == channel:
                pad = self._pad_for(st)
                self._count += 1
                if pad.peer is not None:
                    pad.push(Buffer(np.frombuffer(data, np.uint8)))
                return
        # channel+1 = RTCP: ignored (rtprecv handles RTCP in udp pipelines)

    def _iterate_tcp(self):
        from ...core.element import FlowReturn

        # parse any complete frames already buffered
        progressed = False
        while True:
            if self._tcp_buf[:1] == b"$" and len(self._tcp_buf) >= 4:
                length = struct.unpack("!H", self._tcp_buf[2:4])[0]
                if len(self._tcp_buf) < 4 + length:
                    pass
                else:
                    ch = self._tcp_buf[1]
                    payload = bytes(self._tcp_buf[4:4 + length])
                    del self._tcp_buf[:4 + length]
                    self._deliver_interleaved(ch, payload)
                    progressed = True
                    continue
            try:
                chunk = self._conn.recv(65536)
            except socket.timeout:
                chunk = b""
            except OSError:
                chunk = b""
            if not chunk:
                break
            self._tcp_buf += chunk
        if not progressed:
            return self._finish()
        return FlowReturn.OK

    def iterate(self):
        from ...core.element import FlowReturn

        if self._eos_sent:
            return FlowReturn.EOS
        maxn = self.get_property("num-buffers")
        if maxn and self._count >= maxn:
            return self._finish()
        if self.get_property("protocols") == "tcp":
            return self._iterate_tcp()
        # keep-alive: a periodic OPTIONS with the session keeps NAT/session
        # state fresh while media flows over UDP (rtspsrc2 keep-alive)
        if self.get_property("do-rtsp-keep-alive"):
            import time as _t

            now = _t.monotonic()
            if now - getattr(self, "_last_keepalive", 0.0) > 25.0:
                self._last_keepalive = now
                try:
                    self._request("OPTIONS", self.get_property("location"))
                except Exception:
                    pass  # a failed keep-alive must not kill media flow
        wait_s = self.get_property("timeout") / 1e9
        progressed = False
        for st in self._streams:
            try:
                # block (up to the timeout) for the first stream, then just
                # drain whatever else is queued without waiting
                st.sock.settimeout(0.0 if progressed else wait_s)
                data, _ = st.sock.recvfrom(self.get_property("receive-mtu"))
            except (socket.timeout, BlockingIOError):
                continue
            pad = self._pad_for(st)
            self._count += 1
            if pad.peer is not None:
                pad.push(Buffer(np.frombuffer(data, np.uint8)))
            progressed = True
        if not progressed:
            return self._finish()
        return FlowReturn.OK

    def _finish(self):
        from ...core.element import FlowReturn

        self._eos_sent = True
        for st in self._streams:
            if st.pad is not None and st.pad.peer is not None:
                st.pad.push_event(Event.new_eos())
        return FlowReturn.EOS


__all__ = ["RtspSrc2"]
