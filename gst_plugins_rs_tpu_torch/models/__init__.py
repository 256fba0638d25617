"""Models of the port: the YOLOX zoo, its s2d engine, Demucs and the weight carrier."""
