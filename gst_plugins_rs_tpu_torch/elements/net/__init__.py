"""The network elements ported so far: the G.711 codecs, the RTP payloaders
and depayloaders (PCMA/PCMU, L8/L16, KLV), the ONVIF metadata family and
the RTP session (rtpsend, rtprecv, ts-jitterbuffer).  Importing this package
registers them."""
from . import codecs, onvif, rtpbin2, rtppay  # noqa: F401
