"""HTTP elements: reqwesthttpsrc and icecastsink.

Parity targets: net/reqwest (reqwesthttpsrc, reqwesthttpsrc/imp.rs:167 —
HTTP(S) source with ranges/redirects/auth) and net/icecast (icecastsink,
icecastsink/imp.rs:98 — streams audio to an Icecast server via HTTP PUT
with ice-* headers and basic auth).

reqwest maps to urllib here (stdlib; the tests run against a loopback
http.server).  icecastsink speaks the
Icecast 2.4 HTTP PUT protocol over a raw socket with `100-continue`
handling.
"""
from __future__ import annotations

import base64
import socket
from typing import Optional
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


@register
class ReqwestHttpSrc(BaseSrc):
    ELEMENT_NAME = "reqwesthttpsrc"
    ELEMENT_CLASS = "Source/Network/HTTP"
    ELEMENT_DESCRIPTION = "HTTP(S) source"
    SEEK_FORMAT = "bytes"
    PROPERTIES = [
        Prop("location", None, type="str"),
        Prop("user-agent", "gst_plugins_rs_tpu/reqwesthttpsrc", type="str"),
        Prop("timeout", 15, type="uint", doc="seconds, 0 = none"),
        Prop("blocksize", 65536, type="uint", minimum=1),
        Prop("user-id", None, type="str"),
        Prop("user-pw", None, type="str"),
        Prop("extra-headers", None, type="object",
             doc="mapping of extra request headers"),
        Prop("cookies", None, type="object",
             doc="list of Cookie header values to send"),
        Prop("compress", False, type="bool",
             doc="request gzip transfer-compression (Accept-Encoding)"),
        Prop("keep-alive", True, type="bool",
             doc="send Connection: keep-alive (false = close)"),
        Prop("proxy", None, type="str",
             doc="HTTP proxy URI; a bare host:port gets an http:// scheme "
                 "(souphttpsrc compatibility, reqwesthttpsrc.rs test_proxy_prop)"),
        Prop("proxy-id", None, type="str", doc="proxy user id"),
        Prop("proxy-pw", None, type="str", doc="proxy password"),
        Prop("iradio-mode", False, type="bool",
             doc="send Icy-MetaData:1 and surface icy-* headers as tags"),
        Prop("is-live", False, type="bool"),
    ]

    #: icy-* headers collected when iradio-mode is set
    iradio_info: dict

    def set_property(self, name: str, value) -> None:
        if name == "proxy" and value and "://" not in str(value):
            # souphttpsrc compatibility: bare host:port means http://
            value = f"http://{value}"
        super().set_property(name, value)

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._resp = None
        self.content_type: Optional[str] = None
        self._seekable: Optional[bool] = None  # unknown until first response
        self._offset = 0  # byte position of the next create()
        self._stop: Optional[int] = None
        self._size: Optional[int] = None

    # -- seeking (reqwesthttpsrc/imp.rs Range-request seeks;
    #    tests/reqwesthttpsrc.rs test_seek_after_ready/_after_buffer_received/
    #    _with_stop_position) ---------------------------------------------------
    def is_seekable(self) -> bool:
        # optimistic before the first response (a seek in READY is accepted
        # and validated at connect time, like the reference)
        return self._seekable is not False

    def do_seek(self, segment) -> bool:
        if self._seekable is False:
            return False
        prev_offset, prev_stop = self._offset, self._stop
        self._offset = int(segment.start)
        self._stop = None if segment.stop is None else int(segment.stop)
        if self._resp is not None:  # mid-stream seek: reconnect with Range
            self._resp.close()
            self._resp = None
            try:
                self._connect()
            except Exception:
                # the server ignored the Range header (non-206) or the
                # reconnect failed: the seek FAILS but the element must
                # stay consistent — handle_seek still has to send
                # FLUSH_STOP, and the next create() needs a live response.
                self._seekable = False
                self._offset, self._stop = prev_offset, prev_stop
                try:
                    self._connect()  # unranged resume from prev_offset=0 case
                except Exception:
                    self._resp = None  # create() will surface the error
                return False
        return True

    def duration_ns(self) -> Optional[int]:
        # bytes-format source: "duration" is the total size in bytes
        return self._size

    def position_ns(self) -> Optional[int]:
        return self._offset

    def start(self) -> None:
        self._connect()

    def _connect(self) -> None:
        loc = self.get_property("location")
        if not loc:
            raise RuntimeError(f"{self.name}: no location set")
        req = Request(loc, headers={"User-Agent": self.get_property("user-agent")})
        uid, pw = self.get_property("user-id"), self.get_property("user-pw")
        if uid is not None:
            cred = base64.b64encode(f"{uid}:{pw or ''}".encode()).decode()
            req.add_header("Authorization", f"Basic {cred}")
        extra = self.get_property("extra-headers")
        if extra:
            items = extra.items() if hasattr(extra, "items") else extra
            for k, v in items:
                req.add_header(str(k), str(v))
        cookies = self.get_property("cookies")
        if cookies:
            req.add_header("Cookie", "; ".join(
                [cookies] if isinstance(cookies, str) else [str(c) for c in cookies]))
        if self.get_property("compress"):
            req.add_header("Accept-Encoding", "gzip")
        if not self.get_property("keep-alive"):
            req.add_header("Connection", "close")
        if self.get_property("iradio-mode"):
            req.add_header("Icy-MetaData", "1")
        if self._offset or self._stop is not None:
            end = "" if self._stop is None else str(self._stop - 1)
            req.add_header("Range", f"bytes={self._offset}-{end}")
        timeout = self.get_property("timeout") or None
        proxy = self.get_property("proxy")
        if proxy:
            import urllib.request as _ur

            handlers = [_ur.ProxyHandler({"http": proxy, "https": proxy})]
            pid = self.get_property("proxy-id")
            if pid:
                pmgr = _ur.HTTPPasswordMgrWithDefaultRealm()
                pmgr.add_password(None, proxy, pid,
                                  self.get_property("proxy-pw") or "")
                handlers.append(_ur.ProxyBasicAuthHandler(pmgr))
            self._resp = _ur.build_opener(*handlers).open(req, timeout=timeout)
        else:
            self._resp = urlopen(req, timeout=timeout)
        self.content_type = self._resp.headers.get("Content-Type")
        status = getattr(self._resp, "status", 200)
        accept_ranges = (self._resp.headers.get("Accept-Ranges") or "").lower()
        self._seekable = status == 206 or "bytes" in accept_ranges
        if (self._offset or self._stop is not None) and status != 206:
            self._resp.close()
            self._resp = None
            raise RuntimeError(
                f"{self.name}: seek to {self._offset} requested but the "
                "server does not support Range requests")
        clen = self._resp.headers.get("Content-Length")
        if clen is not None:
            self._size = self._offset + int(clen)
        crange = self._resp.headers.get("Content-Range")
        if crange and "/" in crange and crange.rsplit("/", 1)[1].isdigit():
            self._size = int(crange.rsplit("/", 1)[1])
        if self._resp.headers.get("Content-Encoding") == "gzip":
            import gzip as _gz

            self._resp = _gz.GzipFile(fileobj=self._resp)
        self.iradio_info = {k.lower(): v for k, v in
                            getattr(self._resp, "headers", {}).items()
                            if k.lower().startswith("icy-")} \
            if self.get_property("iradio-mode") else {}

    def stop(self) -> None:
        if self._resp is not None:
            self._resp.close()
            self._resp = None
        self._offset = 0
        self._stop = None
        self._seekable = None

    def fixate(self, caps: Caps) -> Caps:
        if not caps.is_any():
            return caps.fixate()
        ct_full = self.content_type or "application/octet-stream"
        ct = ct_full.split(";")[0].strip()
        if ct.lower() == "audio/l16":
            # raw network-order PCM (RFC 2586): surface rate/channels like
            # souphttpsrc (reqwesthttpsrc.rs test_audio_l16)
            params = dict(
                p.strip().partition("=")[::2]
                for p in ct_full.split(";")[1:] if "=" in p)
            return Caps.builder(
                "audio/x-unaligned-raw", format="S16BE",
                rate=int(params.get("rate", 44100)),
                channels=int(params.get("channels", 2)),
                layout="interleaved")
        if self.get_property("iradio-mode") and getattr(self, "iradio_info", None) \
                and self.iradio_info.get("icy-metaint"):
            # interleaved ICY metadata stream (test_iradio_mode)
            return Caps.builder(
                "application/x-icy",
                **{"metadata-interval": int(self.iradio_info["icy-metaint"])})
        return Caps.builder(ct if "/" in ct else "application/octet-stream")

    def create(self) -> Optional[Buffer]:
        if self._resp is None:
            raise RuntimeError(
                f"{self.name}: no live HTTP response (reconnect failed)")
        want = self.get_property("blocksize")
        if self._stop is not None:
            want = min(want, self._stop - self._offset)
            if want <= 0:
                return None
        data = self._resp.read(want)
        if not data:
            return None
        buf = Buffer(np.frombuffer(data, np.uint8),
                     offset=self._offset, offset_end=self._offset + len(data))
        self._offset += len(data)
        return buf


@register
class IcecastSink(BaseSink):
    ELEMENT_NAME = "icecastsink"
    ELEMENT_CLASS = "Sink/Network"
    ELEMENT_DESCRIPTION = "Streams to an Icecast server (HTTP PUT)"
    PROPERTIES = [
        Prop("host", "127.0.0.1", type="str"),
        Prop("port", 8000, type="uint", minimum=1, maximum=65535),
        Prop("mount", "/stream", type="str"),
        Prop("username", "source", type="str"),
        Prop("password", "hackme", type="str"),
        Prop("stream-name", "", type="str"),
        Prop("genre", "", type="str"),
        Prop("description", "", type="str"),
        Prop("public", False, type="bool"),
        Prop("content-type", "application/ogg", type="str"),
        Prop("location", None, type="str",
             doc="http://host:port/mount shorthand (overrides host/port/"
                 "mount when set)"),
        Prop("timeout", 5, type="uint", doc="connect timeout in seconds"),
        Prop("auto-reconnect", True, type="bool",
             doc="re-establish the PUT session when the server drops it"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sock: Optional[socket.socket] = None

    def _apply_location(self) -> None:
        loc = self.get_property("location")
        if not loc:
            return
        from urllib.parse import urlsplit

        u = urlsplit(loc)
        if u.hostname:
            self._props["host"] = u.hostname
        if u.port:
            self._props["port"] = u.port
        if u.path:
            self._props["mount"] = u.path

    def _connect(self) -> None:
        self._sock = socket.create_connection(
            (self.get_property("host"), self.get_property("port")),
            timeout=self.get_property("timeout") or 5,
        )
        mount = self.get_property("mount")
        if not mount.startswith("/"):
            mount = "/" + mount
        cred = base64.b64encode(
            f"{self.get_property('username')}:{self.get_property('password')}".encode()
        ).decode()
        headers = [
            f"PUT {mount} HTTP/1.1",
            f"Host: {self.get_property('host')}:{self.get_property('port')}",
            f"Authorization: Basic {cred}",
            f"Content-Type: {self.get_property('content-type')}",
            "Expect: 100-continue",
            f"Ice-Public: {1 if self.get_property('public') else 0}",
        ]
        for prop, hdr in (("stream-name", "Ice-Name"), ("genre", "Ice-Genre"),
                          ("description", "Ice-Description")):
            v = self.get_property(prop)
            if v:
                headers.append(f"{hdr}: {v}")
        self._sock.sendall(("\r\n".join(headers) + "\r\n\r\n").encode())
        reply = self._sock.recv(4096).decode(errors="replace")
        if "100" not in reply.split("\r\n")[0] and "200" not in reply.split("\r\n")[0]:
            raise RuntimeError(f"{self.name}: icecast rejected the stream: {reply.splitlines()[:1]}")

    def on_paused_to_ready(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def on_ready_to_paused(self) -> None:
        self._apply_location()
        self._connect()

    def render(self, buffer: Buffer) -> FlowReturn:
        d = buffer.data
        data = d.encode() if isinstance(d, str) else host_bytes(d, np.uint8)
        try:
            self._sock.sendall(data)
        except OSError:
            if not self.get_property("auto-reconnect"):
                raise
            self._connect()  # one reconnect attempt, then resend
            self._sock.sendall(data)
        return FlowReturn.OK


__all__ = ["ReqwestHttpSrc", "IcecastSink"]
