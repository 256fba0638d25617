"""whipsink / whepsrc: WHIP and WHEP over the full WebRTC stack.

Parity target: net/webrtchttp (whipsink, whepsrc).  The reference
implements these on webrtcbin — full ICE/DTLS/SRTP behind WHIP/WHEP
HTTP signaling.  Since the in-repo stack landed (net/webrtc_peer.py),
these names are the same elements as whipclientsink / whepclientsrc
(elements/net/whipwhep.py): POST an SDP offer (application/sdp, Bearer
auth), 201 Created + Location resource, DELETE on teardown, media over
ICE (RFC 8445) + DTLS 1.2 (RFC 6347) + SRTP (RFC 3711).

The earlier plain-RTP media divergence is gone; whipsink interops with
whipserversrc (and any WHIP server) end-to-end encrypted.
"""
from __future__ import annotations

from ...core import Prop, register
from .whipwhep import WhepClientSrc, WhipClientSink


# shared ICE/transport knobs the reference exposes on the webrtchttp pair
# (whipsink/whepsrc wrap webrtcbin there; the in-repo ICE stack consumes
# the same configuration)
_ICE_PROPS = [
    Prop("stun-server", None, type="str",
         doc="stun://host:port used for server-reflexive candidates "
             "(the in-repo ICE stack gathers host candidates by default; "
             "a STUN exchange is attempted when set)"),
    Prop("turn-server", None, type="str",
         doc="turn(s)://user:pass@host:port relay (accepted; relayed "
             "candidates require a TURN allocation this ICE stack does "
             "not implement — documented gap)"),
    Prop("ice-transport-policy", "all", type="enum",
         choices=["all", "relay"],
         doc="relay restricts to relayed candidates (with no TURN "
             "support that fails negotiation by design)"),
    Prop("use-link-headers", False, type="bool",
         doc="read STUN/TURN configuration from the endpoint's Link "
             "response headers (RFC 9725 §4.4)"),
]


@register
class WhipSink(WhipClientSink):
    ELEMENT_NAME = "whipsink"
    ELEMENT_DESCRIPTION = "Sends media to a WHIP endpoint (RFC 9725, DTLS-SRTP)"
    PROPERTIES = WhipClientSink.PROPERTIES + _ICE_PROPS + [
        Prop("timeout", 32, type="uint", maximum=3600,
             doc="seconds allowed for the WHIP HTTP round trips"),
    ]


@register
class WhepSrc(WhepClientSrc):
    ELEMENT_NAME = "whepsrc"
    ELEMENT_DESCRIPTION = "Receives media from a WHEP endpoint (DTLS-SRTP)"
    PROPERTIES = WhepClientSrc.PROPERTIES + _ICE_PROPS + [
        Prop("video-caps", None, type="object",
             doc="video media description offered (overrides caps for the "
                 "video m-line when set)"),
        Prop("audio-caps", None, type="object",
             doc="audio media description offered"),
    ]

    def property_changed(self, name, value) -> None:
        if name in ("video-caps", "audio-caps") and value is not None:
            # the offered m-line follows whichever media caps were set last
            self._props["caps"] = value if isinstance(value, str) else str(value)
