"""The network elements ported so far: the G.711 codecs, the RTP payloaders
and depayloaders (audio, video, MPEG and ancillary data), the ONVIF metadata
family, the RTP session (rtpsend, rtprecv, ts-jitterbuffer), RaptorQ FEC,
the UDP sources and sink, MPEG-TS over RTP and UDP, the congestion
controller, the RTSP source, the HTTP source and Icecast sink, and the HLS
and DASH segmenting sinks.  Importing this package registers them."""
from . import codecs, dashsink, gccbwe, hlsmultivariant, hlssink, http, mp2t, onvif, raptorq, rtpbin2, rtpcodecs, rtpextra, rtppay, rtsp, rtpvideo, udp  # noqa: F401
