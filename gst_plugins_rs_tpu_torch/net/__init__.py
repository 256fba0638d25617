"""Host-side network and crypto helpers of the port: NaCl crypto_box for the
sodium elements, and the RTP core that elements/net builds on (RTP packets
and header extensions, RTCP, the jitterbuffer)."""
