"""The port's parallel layer: stream banks on one device (streams.py) and
their throughput benchmark (benchmark.py).  The mesh paths wait for
torch.distributed (ROADMAP queue A, item 6)."""
