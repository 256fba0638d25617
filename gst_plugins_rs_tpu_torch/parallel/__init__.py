"""The port's parallel layer: element-chain fusion (fuse.py: a fused run
replayed as one CUDA graph on the card), stream banks on one device
(streams.py) and their throughput benchmark (benchmark.py).  The mesh paths
wait for torch.distributed (ROADMAP queue A, item 3)."""
