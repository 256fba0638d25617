"""The port's parallel layer: element-chain fusion (fuse.py: a fused run
replayed as one CUDA graph on the card), a single-process device mesh and
its collectives (mesh.py), stream banks, sharded over a mesh or not
(streams.py), and their throughput benchmark (benchmark.py), one long
stream's time axis sharded over a mesh (timeshard.py) and tensor-parallel
YOLOX (modelparallel.py)."""
