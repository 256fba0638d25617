"""Stream switching and recording elements of the port: togglerecord,
fallbackswitch, livesync and fallbacksrc."""
