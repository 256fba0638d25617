"""quinn QUIC elements: quinnquicsink/src, quinnquicmux/demux,
quinnroqmux/demux.

Parity target: net/quinn (the reference rides the Rust quinn stack; the
transport here is the in-repo QUIC v1 — net/quic.py + net/tls13.py).

The port: a payload becomes QUIC stream data or a datagram through one
read-back (`core/payload.host_bytes`) in quinnquicsink, quinnroqmux and
quinnwtsink; the sources and quinnroqdemux emit host arrays, as in the
JAX package, and the element after them uploads.  `stats` also carries
the connection's packets sent, the packets declared lost and the PTO
resends (net/quic.py counts them; the JAX elements' stats do not).

Topology matches the reference:

  quinnquicmux (stream_%u + datagram request pads) tags buffers with
  QuinnQuicMeta{stream_id | datagram} -> quinnquicsink (QUIC client)
  routes each tagged buffer onto its QUIC stream or as a datagram.
  quinnquicsrc (QUIC server) emits received data tagged the same way ->
  quinnquicdemux fans out to stream_%u / datagram sometimes pads.

RTP-over-QUIC (RoQ, draft-ietf-avtcore-rtp-over-quic) framing:
  streams:   flow-id varint once, then each packet varint-length-prefixed
  datagrams: flow-id varint + one RTP packet per datagram
"""
from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ...core import (
    BaseSink,
    BaseSrc,
    Buffer,
    Caps,
    Element,
    FlowReturn,
    Meta,
    Pad,
    PadDirection,
    PadPresence,
    PadTemplate,
    Prop,
    register,
)
from ...core.caps import Structure
from ...core.parse import parse_caps
from ...core.payload import host_bytes
from ...net.quic import QuicConnection, decode_varint, encode_varint

RTP_CAPS = Caps.builder("application/x-rtp")


class QuinnQuicMeta(Meta):
    """Routing tag: which QUIC stream a buffer belongs to (or datagram).
    `priority` carries the mux pad's send priority to the sink."""

    api = "quinn-quic"

    def __init__(self, stream_id: Optional[int] = None, datagram: bool = False,
                 priority: int = 0):
        self.stream_id = stream_id
        self.datagram = datagram
        self.priority = priority


class _UdpQuicEndpoint:
    """One UDP socket + receive thread driving a QuicConnection."""

    def __init__(self, conn_factory, bind: Tuple[str, int],
                 peer: Optional[Tuple[str, int]] = None,
                 keepalive_ns: int = 0,
                 rcvbuf: int = 0, sndbuf: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if rcvbuf:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, int(rcvbuf))
        if sndbuf:
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, int(sndbuf))
        self.keepalive_ns = keepalive_ns
        self._last_ping = time.monotonic()
        self.sock.bind(bind)
        self.peer = peer
        self.conn: Optional[QuicConnection] = None
        self._conn_factory = conn_factory
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop, daemon=True)
        if peer is not None:
            self.conn = conn_factory(lambda d: self._send(d, peer))
            # address-aware path: enables RFC 9000 §9 connection migration
            self.conn.sendto_cb = self._send
            self.conn.peer_addr = peer
        self._thread.start()

    def _send(self, datagram: bytes, addr: Tuple[str, int]) -> None:
        try:
            self.sock.sendto(datagram, addr)
        except OSError:
            pass

    def _recv_loop(self) -> None:
        self.sock.settimeout(0.1)
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                if self.conn is not None:
                    self.conn.tick()
                    if self.keepalive_ns and (
                            time.monotonic() - self._last_ping
                            > self.keepalive_ns / 1e9):
                        self._last_ping = time.monotonic()
                        self.conn.ping()
                continue
            except OSError:
                return
            if self.conn is None:  # server: first datagram creates the connection
                self.peer = addr
                self.conn = self._conn_factory(lambda d: self._send(d, addr))
                self.conn.sendto_cb = self._send
            self.conn.handle_datagram(data, addr)

    @property
    def bound_port(self) -> int:
        return self.sock.getsockname()[1]

    def close(self) -> None:
        self._stop.set()
        if self.conn is not None:
            self.conn.close()
        self._thread.join(0.5)
        try:
            self.sock.close()
        except OSError:
            pass


def _load_pem_pins(path: str):
    """All certificates in a PEM bundle as a DER pin set."""
    from cryptography import x509
    from cryptography.hazmat.primitives import serialization

    pins = set()
    blob = open(path, "rb").read()
    marker = b"-----BEGIN CERTIFICATE-----"
    for part in blob.split(marker)[1:]:
        pem = marker + part.split(b"-----END CERTIFICATE-----")[0]             + b"-----END CERTIFICATE-----\n"
        der = x509.load_pem_x509_certificate(pem).public_bytes(
            serialization.Encoding.DER)
        pins.add(der)
    return pins


def _pinned_verify_peer(element):
    """Client-side peer-cert policy from secure-connection/certificate-file.

    Mirrors the reference quinn elements' secure-connection handling
    (net/quinn/src/utils.rs): with secure-connection=false any peer is
    accepted; with a certificate-file the peer must present exactly that
    certificate (pinning — the in-repo TLS does no webpki chain walk).
    """
    if not element.get_property("secure-connection"):
        return None
    db = element.get_property("certificate-database-file")
    if db:
        pins = _load_pem_pins(db)
        return lambda der: der in pins
    path = element.get_property("certificate-file")
    if not path:
        import warnings
        warnings.warn(
            f"{element.name}: secure-connection without certificate-file "
            "accepts any self-signed peer certificate (no CA roots in-repo); "
            "set certificate-file to pin the server certificate")
        return None
    with open(path, "rb") as f:
        data = f.read()
    if data.lstrip().startswith(b"-----BEGIN"):
        from cryptography import x509
        from cryptography.hazmat.primitives import serialization
        data = x509.load_pem_x509_certificate(data).public_bytes(
            serialization.Encoding.DER)
    expected = data
    return lambda der: der == expected


_QUIC_PROPS = [
    Prop("address", "127.0.0.1", type="str"),
    Prop("port", 4433, type="uint"),
    Prop("bind-address", "0.0.0.0", type="str"),
    Prop("bind-port", 0, type="uint"),
    # reference-compatible aliases (net/quinn names them per role)
    Prop("server-address", "127.0.0.1", type="str",
         doc="alias of address (kept in sync)"),
    Prop("server-port", 4433, type="uint", doc="alias of port"),
    Prop("client-address", "0.0.0.0", type="str", doc="alias of bind-address"),
    Prop("client-port", 0, type="uint", doc="alias of bind-port"),
    Prop("server-name", "", type="str",
         doc="TLS SNI (defaults to address when empty)"),
    Prop("role", "", type="str",
         doc="client|server (empty = the element's natural role)"),
    Prop("alpn-protocols", "gst-quinn", type="str", doc="comma separated"),
    Prop("keep-alive-interval", 0, type="uint64",
         doc="ns between PING frames on an idle connection (0 = off)"),
    Prop("secure-connection", True, type="bool"),
    Prop("certificate-file", None, type="str"),
    Prop("private-key-file", None, type="str"),
    Prop("certificate-database-file", None, type="str",
         doc="file of PEM certificates; the peer must present one of them "
             "(pin set — the in-repo TLS does no webpki chain walk)"),
    Prop("timeout", 5, type="uint", doc="connect timeout (s)"),
    Prop("initial-mtu", 1200, type="uint", minimum=1200),
    Prop("min-mtu", 1200, type="uint", minimum=1200),
    Prop("upper-bound-mtu", 1452, type="uint", minimum=1200, maximum=65527),
    Prop("max-udp-payload-size", 65527, type="uint", minimum=1200),
    Prop("datagram-receive-buffer-size", 1_250_000, type="uint64",
         doc="SO_RCVBUF on the UDP socket"),
    Prop("datagram-send-buffer-size", 1_048_576, type="uint64",
         doc="SO_SNDBUF on the UDP socket"),
    Prop("max-concurrent-uni-streams", 32, type="uint64",
         doc="initial_max_streams_uni transport parameter"),
    Prop("send-window", 0, type="uint64",
         doc="cap on the congestion window in bytes (0 = transport default)"),
    Prop("stats", None, type="object",
         doc="(read) live connection statistics structure"),
]

_ALIASES = {"server-address": "address", "server-port": "port",
            "client-address": "bind-address", "client-port": "bind-port"}


class _QuicPropsMixin:
    """Alias syncing + shared ctor kwargs + live stats for quinn elements."""

    def property_changed(self, name, value) -> None:
        if name in _ALIASES:
            self._props[_ALIASES[name]] = value
        else:
            for alias, real in _ALIASES.items():
                if real == name:
                    self._props[alias] = value

    def _conn_kwargs(self) -> dict:
        sw = self.get_property("send-window")
        return {
            "alpn": self.get_property("alpn-protocols").split(","),
            "max_streams_uni": int(self.get_property("max-concurrent-uni-streams")),
            "send_window": int(sw) if sw else None,
        }

    def _configure_conn(self, conn) -> None:
        mtu = max(self.get_property("min-mtu"),
                  min(self.get_property("initial-mtu"),
                      self.get_property("upper-bound-mtu"),
                      self.get_property("max-udp-payload-size")))
        conn.MTU = int(mtu)

    def get_property(self, name: str):
        if name == "stats":
            conn = self._ep.conn if getattr(self, "_ep", None) else None
            if conn is None:
                return Structure("stats")
            return Structure(
                "stats",
                **{"cwnd": int(conn._cwnd),
                   "bytes-in-flight": int(conn._in_flight),
                   "srtt-ms": (conn._srtt or 0.0) * 1000.0,
                   "pto-ms": conn._pto * 1000.0,
                   "closed": conn.closed.is_set(),
                   "packets-sent": conn.packets_sent,
                   "packets-lost": conn.packets_lost,
                   "pto-resends": conn.pto_resends})
        return super().get_property(name)


@register
class QuinnQuicSink(_QuicPropsMixin, BaseSink):
    """QUIC client sink: each buffer goes onto a QUIC stream (default one
    unidirectional stream) or as a datagram when tagged by quinnquicmux."""

    ELEMENT_NAME = "quinnquicsink"
    ELEMENT_CLASS = "Sink/Network/QUIC"
    ELEMENT_DESCRIPTION = "Send data over the network via QUIC"
    PROPERTIES = _QUIC_PROPS + [
        Prop("drop-buffer-for-datagram", False, type="bool"),
        Prop("use-datagram", False, type="bool",
             doc="send untagged buffers as QUIC datagrams instead of a stream"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ep: Optional[_UdpQuicEndpoint] = None
        self._streams: Dict[int, int] = {}  # tag -> quic stream id
        self._default_stream: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        kwargs = self._conn_kwargs()
        sni = self.get_property("server-name") or self.get_property("address")

        def factory(send):
            conn = QuicConnection(True, send, server_name=sni,
                                  verify_peer=_pinned_verify_peer(self),
                                  **kwargs)
            self._configure_conn(conn)
            return conn

        self._ep = _UdpQuicEndpoint(
            factory,
            (self.get_property("bind-address"), self.get_property("bind-port")),
            (self.get_property("address"), self.get_property("port")),
            keepalive_ns=self.get_property("keep-alive-interval"),
            rcvbuf=self.get_property("datagram-receive-buffer-size"),
            sndbuf=self.get_property("datagram-send-buffer-size"),
        )
        self._ep.conn.connect()
        if not self._ep.conn.wait_handshake(self.get_property("timeout")):
            raise RuntimeError(f"{self.name}: QUIC handshake timed out")
        self._streams = {}
        self._default_stream = None

    def on_paused_to_ready(self) -> None:
        if self._ep is not None:
            # flush FINs on our streams, then drain: queued/cwnd-held
            # stream data must be sent and acked before the endpoint
            # closes, or a teardown right after EOS loses the tail
            # (quinn's SendStream::finish contract)
            conn = self._ep.conn
            if conn is not None:
                for sid in self._streams.values():
                    conn.send_stream(sid, b"", fin=True)
                if self._default_stream is not None:
                    conn.send_stream(self._default_stream, b"", fin=True)
                conn.drain(float(self.get_property("timeout")))
            self._ep.close()
            self._ep = None

    def render(self, buffer: Buffer) -> FlowReturn:
        conn = self._ep.conn
        data = host_bytes(buffer.data, np.uint8)
        meta = next(iter(buffer.iter_meta(QuinnQuicMeta)), None) \
            if hasattr(buffer, "iter_meta") else None
        if meta is None and self.get_property("use-datagram"):
            conn.send_datagram(data)
            return FlowReturn.OK
        if meta is not None and meta.datagram:
            if conn.peer_max_datagram and len(data) + 8 > conn.peer_max_datagram \
                    and self.get_property("drop-buffer-for-datagram"):
                return FlowReturn.OK
            conn.send_datagram(data)
            return FlowReturn.OK
        tag = meta.stream_id if meta is not None else None
        if tag is None:
            if self._default_stream is None:
                self._default_stream = conn.open_uni_stream()
            sid = self._default_stream
        else:
            if tag not in self._streams:
                self._streams[tag] = conn.open_uni_stream()
            sid = self._streams[tag]
        conn.send_stream(sid, data)
        return FlowReturn.OK


@register
class QuinnQuicSrc(_QuicPropsMixin, BaseSrc):
    """QUIC server source: emits stream data / datagrams as buffers tagged
    with QuinnQuicMeta for quinnquicdemux."""

    ELEMENT_NAME = "quinnquicsrc"
    ELEMENT_CLASS = "Source/Network/QUIC"
    ELEMENT_DESCRIPTION = "Receive data over the network via QUIC"
    IS_LIVE = True
    PROPERTIES = _QUIC_PROPS + [
        Prop("caps", None, type="object"),
        Prop("idle-timeout", 2_000_000_000, type="uint64",
             doc="ns without data before EOS (0 = forever)"),
        Prop("is-live", True, type="bool"),
        Prop("receive-window", 0, type="uint64",
             doc="initial_max_data we advertise (0 = default 1 GiB)"),
        Prop("stream-receive-window", 0, type="uint64",
             doc="per-stream flow-control window we advertise "
                 "(initial_max_stream_data; 0 = default 256 MiB)"),
        Prop("use-datagram", False, type="bool",
             doc="accepted for parity; datagrams are always surfaced, "
                 "tagged datagram=true in QuinnQuicMeta"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ep: Optional[_UdpQuicEndpoint] = None
        self._queue: "queue.Queue[Optional[Tuple[Optional[int], bytes, bool]]]" = queue.Queue()

    @property
    def bound_port(self) -> int:
        assert self._ep is not None
        return self._ep.bound_port

    def start(self) -> None:
        kwargs = self._conn_kwargs()
        rw = self.get_property("receive-window")
        if rw:
            kwargs["max_data"] = int(rw)
        srw = self.get_property("stream-receive-window")
        if srw:
            kwargs["max_stream_data"] = int(srw)

        def factory(send):
            conn = QuicConnection(False, send, **kwargs)
            self._configure_conn(conn)
            conn.on_stream_data = lambda sid, data, fin: \
                self._queue.put((sid, data, fin))
            conn.on_datagram = lambda data: self._queue.put((None, data, False))
            return conn

        self._ep = _UdpQuicEndpoint(
            factory,
            (self.get_property("bind-address") if self.get_property("bind-port")
             else self.get_property("address"),
             self.get_property("bind-port") or self.get_property("port")),
            keepalive_ns=self.get_property("keep-alive-interval"),
            rcvbuf=self.get_property("datagram-receive-buffer-size"),
            sndbuf=self.get_property("datagram-send-buffer-size"),
        )

    def stop(self) -> None:
        if self._ep is not None:
            self._ep.close()
            self._ep = None
        self._queue.put(None)

    def fixate(self, caps: Caps) -> Caps:
        prop = self.get_property("caps")
        if prop is not None:
            return parse_caps(prop) if isinstance(prop, str) else prop
        return Caps.builder("application/octet-stream")

    def create(self):
        timeout = self.get_property("idle-timeout")
        try:
            item = self._queue.get(timeout=(timeout / 1e9) if timeout else None)
        except queue.Empty:
            return None
        if item is None:
            return None
        sid, data, fin = item
        if not data and fin:
            return BaseSrc.RETRY
        buf = Buffer(np.frombuffer(data, np.uint8))
        buf.add_meta(QuinnQuicMeta(stream_id=sid, datagram=(sid is None)))
        return buf


# ---------------------------------------------------------------------------
# mux / demux


@register
class QuinnQuicMux(Element):
    """Tags each input pad's buffers with a stream id (or datagram)."""

    ELEMENT_NAME = "quinnquicmux"
    EXTRA_PAD_TEMPLATES = [
        ('stream_%u', 'sink', 'request', 'ANY'),
        ('datagram', 'sink', 'request', 'ANY'),
    ]
    ELEMENT_CLASS = "Muxer/Network/QUIC"
    ELEMENT_DESCRIPTION = "Multiplexes multiple streams and datagram for QUIC"
    # QuinnQuicMuxPad surface (reference quinn other-types): per-stream
    # send priority, forwarded to the sink's stream scheduler via the meta
    PAD_PROPERTIES = {
        "stream": [
            Prop("priority", 0, type="int", minimum=-(2**31), maximum=2**31 - 1,
                 mutable="playing",
                 doc="relative send priority of this stream (higher first)"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self._count = 0
        self._caps_sent = False

    def request_sink_pad(self, name: Optional[str] = None) -> Pad:
        if name == "datagram":
            tag = None
        else:
            tag = self._count
            self._count += 1
        pad_name = name or f"stream_{tag}"
        pad = self.add_pad(
            Pad(pad_name, PadDirection.SINK,
                PadTemplate("stream_%u", PadDirection.SINK, PadPresence.REQUEST,
                            Caps.new_any()))
        )
        pad.chain_function = lambda p, buf, _tag=tag, _dg=(name == "datagram"): \
            self._chain(p, buf, _tag, _dg)
        pad.event_function = self._event
        return pad

    def request_datagram_pad(self) -> Pad:
        return self.request_sink_pad("datagram")

    def _chain(self, pad: Pad, buf: Buffer, tag: Optional[int],
               datagram: bool) -> FlowReturn:
        prio = pad._props.get("priority", 0)
        buf.add_meta(QuinnQuicMeta(stream_id=tag, datagram=datagram,
                                   priority=prio))
        return self.srcpad.push(buf)

    def _event(self, pad: Pad, event) -> bool:
        from ...core.events import EventType

        if event.type == EventType.CAPS:
            if self._caps_sent:
                return True
            self._caps_sent = True
            from ...core.events import Event
            return self.srcpad.push_event(
                Event.new_caps(Caps.builder("application/quic+mux")))
        if event.type == EventType.EOS:
            # only forward the last EOS
            open_pads = [p for p in self.sink_pads()]
            return self.srcpad.push_event(event)
        return self.srcpad.push_event(event)


@register
class QuinnQuicDemux(Element):
    """Fans tagged buffers out to stream_%u / datagram sometimes pads."""

    ELEMENT_NAME = "quinnquicdemux"
    EXTRA_PAD_TEMPLATES = [
        ('stream_%u', 'src', 'sometimes', 'ANY'),
        ('datagram', 'src', 'sometimes', 'ANY'),
    ]
    ELEMENT_CLASS = "Demuxer/Network/QUIC"
    ELEMENT_DESCRIPTION = "Demultiplexes multiple streams and datagram for QUIC"

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._pads: Dict[object, Pad] = {}

    def _pad_for(self, key) -> Pad:
        if key not in self._pads:
            name = "datagram" if key == "datagram" else f"stream_{key}"
            pad = self.add_pad(
                Pad(name, PadDirection.SRC,
                    PadTemplate("stream_%u", PadDirection.SRC, PadPresence.SOMETIMES,
                                Caps.new_any()))
            )
            self._pads[key] = pad
            if hasattr(self, "on_new_pad") and self.on_new_pad:
                self.on_new_pad(pad)
            from ...core.events import Event, Segment
            pad.push_event(Event.new_stream_start(f"{self.name}-{name}"))
            pad.push_event(Event.new_caps(Caps.builder("application/octet-stream")))
            pad.push_event(Event.new_segment(Segment()))
        return self._pads[key]

    on_new_pad = None

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        meta = next(iter(buf.iter_meta(QuinnQuicMeta)), None)
        if meta is None:
            key = 0
        elif meta.datagram:
            key = "datagram"
        else:
            key = meta.stream_id if meta.stream_id is not None else 0
        return self._pad_for(key).push(buf)

    def _event(self, pad: Pad, event) -> bool:
        from ...core.events import EventType

        if event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT):
            return True  # pads get their own
        ok = True
        for p in self._pads.values():
            ok = p.push_event(event) and ok
        return ok


# ---------------------------------------------------------------------------
# RoQ: RTP over QUIC


@register
class QuinnRoqMux(Element):
    """RTP over QUIC framing (draft-ietf-avtcore-rtp-over-quic).

    stream_%u pads -> stream mode (flow-id varint once, then varint
    length-prefixed packets); datagram_%u pads -> datagram mode (flow-id
    varint + packet per datagram).  Pair with quinnquicsink.
    """

    ELEMENT_NAME = "quinnroqmux"
    EXTRA_PAD_TEMPLATES = [
        ('stream_%u', 'sink', 'request', 'application/x-rtp'),
        ('datagram_%u', 'sink', 'request', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Muxer/Network/QUIC/RTP"
    ELEMENT_DESCRIPTION = "Multiplexes RTP streams over QUIC"
    # QuinnRoqMuxPad surface (reference quinn other-types): the RoQ flow id
    # is a pad property (settable before data flows) plus a send priority
    PAD_PROPERTIES = {
        "stream": [
            Prop("flow-id", 0, type="uint64", mutable="ready",
                 doc="RoQ flow identifier this pad's RTP rides on"),
            Prop("priority", 0, type="int", minimum=-(2**31), maximum=2**31 - 1,
                 mutable="playing",
                 doc="relative send priority of this flow's QUIC stream"),
        ],
        "datagram": [
            Prop("flow-id", 0, type="uint64", mutable="ready",
                 doc="RoQ flow identifier this pad's RTP rides on"),
            Prop("priority", 0, type="int", minimum=-(2**31), maximum=2**31 - 1,
                 mutable="playing",
                 doc="relative send priority (datagrams are unqueued; "
                     "advisory)"),
        ],
    }

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.srcpad = self.add_pad(
            Pad("src", PadDirection.SRC,
                PadTemplate("src", PadDirection.SRC, PadPresence.ALWAYS, Caps.new_any()))
        )
        self._started: Dict[int, bool] = {}
        self._caps_sent = False

    def request_stream_pad(self, flow_id: int) -> Pad:
        return self._make_pad(flow_id, datagram=False)

    def request_datagram_pad(self, flow_id: int) -> Pad:
        return self._make_pad(flow_id, datagram=True)

    def request_sink_pad(self) -> Pad:
        return self._make_pad(len(self._started), datagram=False)

    def _make_pad(self, flow_id: int, datagram: bool) -> Pad:
        kind = "datagram" if datagram else "stream"
        pad = self.add_pad(
            Pad(f"{kind}_{flow_id}", PadDirection.SINK,
                PadTemplate(f"{kind}_%u", PadDirection.SINK, PadPresence.REQUEST,
                            RTP_CAPS))
        )
        self._started[flow_id] = False
        pad._props["flow-id"] = flow_id  # default from the pad name
        pad.chain_function = lambda p, buf, dg=datagram: \
            self._chain(buf, int(p._props.get("flow-id", 0)), dg)
        pad.event_function = self._event
        return pad

    def pad_property_changed(self, pad: Pad, name: str, value) -> None:
        if name == "flow-id":
            self._started.setdefault(int(value), False)

    def _chain(self, buf: Buffer, flow_id: int, datagram: bool) -> FlowReturn:
        pkt = host_bytes(buf.data, np.uint8)
        if datagram:
            out = Buffer(np.frombuffer(encode_varint(flow_id) + pkt, np.uint8),
                         pts=buf.pts, duration=buf.duration)
            out.add_meta(QuinnQuicMeta(datagram=True))
        else:
            payload = b""
            if not self._started[flow_id]:
                self._started[flow_id] = True
                payload += encode_varint(flow_id)
            payload += encode_varint(len(pkt)) + pkt
            out = Buffer(np.frombuffer(payload, np.uint8),
                         pts=buf.pts, duration=buf.duration)
            out.add_meta(QuinnQuicMeta(stream_id=flow_id))
        return self.srcpad.push(out)

    def _event(self, pad: Pad, event) -> bool:
        from ...core.events import Event, EventType

        if event.type == EventType.CAPS:
            if self._caps_sent:
                return True
            self._caps_sent = True
            return self.srcpad.push_event(
                Event.new_caps(Caps.builder("application/quic+roq")))
        return self.srcpad.push_event(event)


@register
class QuinnRoqDemux(Element):
    """Reverses quinnroqmux framing into per-flow application/x-rtp pads."""

    ELEMENT_NAME = "quinnroqdemux"
    EXTRA_PAD_TEMPLATES = [
        ('src_%u', 'src', 'sometimes', 'application/x-rtp'),
    ]
    ELEMENT_CLASS = "Demuxer/Network/QUIC/RTP"
    ELEMENT_DESCRIPTION = "Demultiplexes RTP streams over QUIC"
    SIGNALS = {
        # request: the app answers with the caps for a flow-id (the
        # reference's request-flow-id-map); None falls back to rtp-caps
        "request-flow-id-map": None,
    }
    PROPERTIES = [
        Prop("rtp-caps", "application/x-rtp", type="str",
             doc="caps advertised on the demuxed flows"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self.sinkpad = self.add_pad(
            Pad("sink", PadDirection.SINK,
                PadTemplate("sink", PadDirection.SINK, PadPresence.ALWAYS, Caps.new_any()))
        )
        self.sinkpad.chain_function = self._chain
        self.sinkpad.event_function = self._event
        self._pads: Dict[int, Pad] = {}
        # per QUIC-stream parse state: (flow_id or None, partial buffer)
        self._stream_state: Dict[object, Tuple[Optional[int], bytearray]] = {}

    def _pad_for(self, flow_id: int) -> Pad:
        if flow_id not in self._pads:
            pad = self.add_pad(
                Pad(f"src_{flow_id}", PadDirection.SRC,
                    PadTemplate("src_%u", PadDirection.SRC, PadPresence.SOMETIMES,
                                RTP_CAPS))
            )
            self._pads[flow_id] = pad
            from ...core.events import Event, Segment
            pad.push_event(Event.new_stream_start(f"{self.name}-flow-{flow_id}"))
            mapped = self.emit("request-flow-id-map", flow_id)
            caps = mapped if mapped is not None else \
                parse_caps(self.get_property("rtp-caps"))
            if isinstance(caps, str):
                caps = parse_caps(caps)
            pad.push_event(Event.new_caps(caps))
            pad.push_event(Event.new_segment(Segment()))
        return self._pads[flow_id]

    def _chain(self, pad: Pad, buf: Buffer) -> FlowReturn:
        data = host_bytes(buf.data, np.uint8)
        meta = next(iter(buf.iter_meta(QuinnQuicMeta)), None)
        if meta is not None and meta.datagram:
            flow_id, off = decode_varint(data, 0)
            out = Buffer(np.frombuffer(data[off:], np.uint8), pts=buf.pts)
            return self._pad_for(flow_id).push(out)
        key = meta.stream_id if meta is not None else 0
        flow_id, partial = self._stream_state.get(key, (None, bytearray()))
        partial += data
        if flow_id is None and partial:
            try:
                flow_id, off = decode_varint(partial, 0)
            except IndexError:
                self._stream_state[key] = (None, partial)
                return FlowReturn.OK
            del partial[:off]
        ret = FlowReturn.OK
        while partial:
            try:
                plen, off = decode_varint(partial, 0)
            except IndexError:
                break
            if len(partial) < off + plen:
                break
            pkt = bytes(partial[off:off + plen])
            del partial[:off + plen]
            ret = self._pad_for(flow_id).push(
                Buffer(np.frombuffer(pkt, np.uint8), pts=buf.pts))
        self._stream_state[key] = (flow_id, partial)
        return ret

    def _event(self, pad: Pad, event) -> bool:
        from ...core.events import EventType

        if event.type in (EventType.STREAM_START, EventType.CAPS, EventType.SEGMENT):
            return True
        ok = True
        for p in self._pads.values():
            ok = p.push_event(event) and ok
        return ok


# ---------------------------------------------------------------------------
# WebTransport (net/webtransport.py session layer over the same QUIC)


_WT_PROPS = [
    Prop("address", "127.0.0.1", type="str"),
    Prop("port", 4445, type="uint"),
    Prop("bind-address", "0.0.0.0", type="str"),
    Prop("bind-port", 0, type="uint"),
    Prop("server-name", "localhost", type="str"),
    Prop("url", None, type="str", doc="https://host:port/path (overrides address/port)"),
    Prop("role", None, type="str", doc="client | server (defaults: sink=client, src=server)"),
    Prop("secure-connection", True, type="bool"),
    Prop("certificate-file", None, type="str"),
    Prop("certificate-database-file", None, type="str",
         doc="file of PEM certificates; the peer must present one of them"),
    Prop("private-key-file", None, type="str"),
    Prop("timeout", 5, type="uint"),
    Prop("initial-mtu", 1200, type="uint", minimum=1200),
    Prop("min-mtu", 1200, type="uint", minimum=1200),
    Prop("upper-bound-mtu", 1452, type="uint", minimum=1200, maximum=65527),
    Prop("max-udp-payload-size", 65527, type="uint", minimum=1200),
    Prop("datagram-receive-buffer-size", 1_250_000, type="uint64"),
    Prop("datagram-send-buffer-size", 1_048_576, type="uint64"),
    Prop("stats", None, type="object", doc="(read) live connection statistics"),
]


def _parse_wt_url(url):
    from urllib.parse import urlsplit

    u = urlsplit(url)
    return u.hostname or "127.0.0.1", u.port or 443, u.path or "/"


@register
class QuinnWtSink(BaseSink):
    """WebTransport sink: establishes a WT session (client by default) and
    sends buffers on one WT unidirectional stream."""

    ELEMENT_NAME = "quinnwtsink"
    ELEMENT_CLASS = "Sink/Network/QUIC"
    ELEMENT_DESCRIPTION = "Send data over the network via WebTransport"
    PROPERTIES = _WT_PROPS + [
        Prop("use-datagram", False, type="bool"),
        Prop("drop-buffer-for-datagram", False, type="bool",
             doc="drop buffers larger than the session's max datagram size "
                 "instead of erroring when use-datagram is set"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ep = None
        self._session = None
        self._stream: Optional[int] = None

    def on_ready_to_paused(self) -> None:
        from ...net.webtransport import WebTransportSession

        url = self.get_property("url")
        if url:
            host, port, path = _parse_wt_url(url)
        else:
            host, port, path = self.get_property("address"), self.get_property("port"), "/"
        holder = {}

        def factory(send):
            conn = QuicConnection(True, send, alpn=["h3"],
                                  server_name=self.get_property("server-name"),
                                  verify_peer=_pinned_verify_peer(self))
            holder["session"] = WebTransportSession(conn, True,
                                                    authority=f"{host}:{port}", path=path)
            return conn

        self._ep = _UdpQuicEndpoint(
            factory,
            (self.get_property("bind-address"), self.get_property("bind-port")),
            (host, port),
        )
        self._session = holder["session"]
        self._ep.conn.connect()
        if not self._ep.conn.wait_handshake(self.get_property("timeout")):
            raise RuntimeError(f"{self.name}: QUIC handshake timed out")
        self._session.start()
        if not self._session.wait_established(self.get_property("timeout")):
            raise RuntimeError(f"{self.name}: WebTransport session rejected")
        self._stream = None

    def on_paused_to_ready(self) -> None:
        if self._ep is not None:
            if self._ep.conn is not None:
                if self._stream is not None:
                    self._ep.conn.send_stream(self._stream, b"", fin=True)
                # same contract as quinnquicsink: queued stream data must
                # be acked before the endpoint closes
                self._ep.conn.drain(float(self.get_property("timeout")))
            self._ep.close()
            self._ep = None
            self._session = None

    def render(self, buffer: Buffer) -> FlowReturn:
        data = host_bytes(buffer.data, np.uint8)
        if self.get_property("use-datagram"):
            max_dg = getattr(self._ep.conn, "peer_max_datagram", 0)
            if self.get_property("drop-buffer-for-datagram") \
                    and max_dg and len(data) + 16 > max_dg:
                return FlowReturn.OK  # oversized datagram: dropped
            self._session.send_datagram(data)
            return FlowReturn.OK
        if self._stream is None:
            self._stream = self._session.open_uni_stream()
        self._session.send_stream(self._stream, data)
        return FlowReturn.OK


@register
class QuinnWtSrc(BaseSrc):
    """WebTransport source: accepts a WT session (server by default) and
    emits received stream data / datagrams as buffers."""

    ELEMENT_NAME = "quinnwtsrc"
    ELEMENT_CLASS = "Source/Network/QUIC"
    ELEMENT_DESCRIPTION = "Receive data over the network via WebTransport"
    IS_LIVE = True
    PROPERTIES = _WT_PROPS + [
        Prop("caps", None, type="object"),
        Prop("idle-timeout", 2_000_000_000, type="uint64"),
        Prop("is-live", False, type="bool"),
        Prop("keep-alive-interval", 0, type="uint64",
             doc="ns between PING frames on an idle connection (0 = off)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._ep = None
        self._session = None
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue()

    @property
    def bound_port(self) -> int:
        assert self._ep is not None
        return self._ep.bound_port

    def start(self) -> None:
        from ...net.webtransport import WebTransportSession

        def factory(send):
            conn = QuicConnection(False, send, alpn=["h3"])
            session = WebTransportSession(conn, False)
            session.on_stream_data = lambda sid, data, fin: (
                self._queue.put(data) if data else None)
            session.on_datagram = self._queue.put
            self._session = session
            session.start()
            return conn

        self._ep = _UdpQuicEndpoint(
            factory,
            (self.get_property("bind-address") if self.get_property("bind-port")
             else self.get_property("address"),
             self.get_property("bind-port") or self.get_property("port")),
            keepalive_ns=self.get_property("keep-alive-interval"),
            rcvbuf=self.get_property("datagram-receive-buffer-size"),
            sndbuf=self.get_property("datagram-send-buffer-size"),
        )

    def stop(self) -> None:
        if self._ep is not None:
            self._ep.close()
            self._ep = None
        self._queue.put(None)

    def fixate(self, caps: Caps) -> Caps:
        prop = self.get_property("caps")
        if prop is not None:
            return parse_caps(prop) if isinstance(prop, str) else prop
        return Caps.builder("application/octet-stream")

    def create(self):
        timeout = self.get_property("idle-timeout")
        try:
            item = self._queue.get(timeout=(timeout / 1e9) if timeout else None)
        except queue.Empty:
            return None
        if item is None:
            return None
        return Buffer(np.frombuffer(item, np.uint8))
