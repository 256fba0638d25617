"""The network elements ported so far: the G.711 codecs, the RTP payloaders
and depayloaders (audio, video, MPEG and ancillary data), the ONVIF metadata
family, the RTP session (rtpsend, rtprecv, ts-jitterbuffer), RaptorQ FEC,
the UDP sources and sink, MPEG-TS over RTP and UDP, and the congestion
controller.  Importing this package registers them."""
from . import codecs, gccbwe, mp2t, onvif, raptorq, rtpbin2, rtpcodecs, rtpextra, rtppay, rtpvideo, udp  # noqa: F401
