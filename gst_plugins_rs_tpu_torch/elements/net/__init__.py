"""The network elements ported so far: the G.711 codecs, the RTP payloaders
and depayloaders (audio, video, MPEG and ancillary data), the ONVIF metadata
family, the RTP session (rtpsend, rtprecv, ts-jitterbuffer), RaptorQ FEC,
the UDP sources and sink, MPEG-TS over RTP and UDP, the congestion
controller, the RTSP source, the HTTP source and Icecast sink, the HLS
and DASH segmenting sinks, and the WebRTC family (webrtcsink, webrtcsrc,
webrtcsend, webrtcrecv, the WHIP and WHEP clients and servers, whipsink,
whepsrc, and the Janus, Kinesis Video and UEPS signaller sinks).  Importing
this package registers them."""
from . import codecs, dashsink, gccbwe, hlsmultivariant, hlssink, http, janusvr, kvs_ueps, mp2t, onvif, raptorq, rtpbin2, rtpcodecs, rtpextra, rtppay, rtsp, rtpvideo, udp, webrtc, webrtcbin2, webrtchttp, whipwhep  # noqa: F401
