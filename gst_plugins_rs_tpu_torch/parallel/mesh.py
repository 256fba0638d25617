"""A device mesh in one process: the port's stand-in for jax.sharding.Mesh
and the collectives of `shard_map`.

Every mesh path of the JAX package is single-controller: one Python process
holds `jax.devices()` and runs `shard_map` bodies with collectives between
them, from inside an element of an ordinary pipeline.  The port keeps that
shape.  A `Mesh` is a list of devices under one axis name (from
`_device.visible_devices()`, which `set_virtual_devices(n)` can make n
logical devices cycling over the real ones: 8 shards on the CPU in the
tests, 4 shards on one card in chip_smoke.py).

A sharded value is a plain list of per-shard tensors, shard k on
`mesh.devices[k]` (`shard`, `replicate`, `gather`).  A sharded body is
written in lockstep: one comprehension over the shards per phase, with a
collective between phases.  The collectives are explicit tensor moves:

    ppermute(parts, perm)   shard dst receives shard src's tensor; a shard
                            that receives nothing gets zeros
    all_gather(parts)       every shard gets all shards stacked [S, ...]
    psum(parts), pmax(parts)  every shard gets the sum / maximum
    axis_index(mesh)        the shard indices 0..S-1

Each is `.to(device, non_blocking=True)`, `torch.stack` and a sum: across
several cards these are peer copies, on one device they move nothing.

Aliasing: shards that share a device share storage.  `.to(same device)`
returns the tensor itself, `shard` returns views of its input, and a
replicated result (all_gather, psum, pmax) is one tensor that every shard
on a device holds.  A body that writes in place clones first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

Parts = List[torch.Tensor]


class Mesh:
    """A one-axis device mesh: `devices` (a list of torch.device, one a
    shard, repeats allowed), `axis_names` and `shape[axis]`."""

    def __init__(self, devices: Sequence, axis_names: Union[str, Tuple[str, ...]]):
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if len(names) != 1:
            raise ValueError(f"a mesh has one axis, got {names}")
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = names
        self.shape: Dict[str, int] = {names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({self.axis_names[0]!r}: {self.size}, {[str(d) for d in self.devices]})"


def canonical(dev) -> torch.device:
    """dev with its index: "cuda" is the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> Parts:
    """Split x into mesh.size equal slices along `dim`, slice k on shard k's
    device.  Raises ValueError when the axis does not divide, as JAX's
    device_put with a sharded axis does."""
    n = mesh.size
    if x.shape[dim] % n:
        raise ValueError(f"a sharding over {n} devices implies that the size of dimension "
                         f"{dim} should be divisible by {n}, but it is equal to "
                         f"{x.shape[dim]} (full shape: {tuple(x.shape)})")
    return [p.to(d, non_blocking=True) for p, d in zip(x.chunk(n, dim), mesh.devices)]


def replicate(x: torch.Tensor, mesh: Mesh) -> Parts:
    """x on every shard's device (one tensor for shards sharing a device)."""
    return [x.to(d, non_blocking=True) for d in mesh.devices]


def gather(parts: Parts, dim: int = 0, device=None) -> torch.Tensor:
    """The global value of a sharded value: the parts concatenated along
    `dim` on `device` (default: shard 0's)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)


def axis_index(mesh: Mesh) -> List[int]:
    return list(range(mesh.size))


def ppermute(parts: Parts, perm: Sequence[Tuple[int, int]]) -> Parts:
    """Shard dst receives shard src's tensor for every (src, dst) in perm;
    a shard that is no destination receives zeros."""
    out: List = [None] * len(parts)
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device, non_blocking=True)
    return [torch.zeros_like(p) if o is None else o for o, p in zip(out, parts)]


def _replicated(parts: Parts, reduce: Callable[[Parts], torch.Tensor]) -> Parts:
    """reduce(all parts moved to d), computed once per distinct device d
    and handed to every shard on it."""
    done: Dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        if p.device not in done:
            done[p.device] = reduce([q.to(p.device, non_blocking=True) for q in parts])
        out.append(done[p.device])
    return out


def all_gather(parts: Parts) -> Parts:
    """Every shard gets all parts stacked on a new leading axis [S, ...]."""
    return _replicated(parts, torch.stack)


def psum(parts: Parts) -> Parts:
    """Every shard gets the sum of all parts, summed in shard order."""
    def total(ps):
        acc = ps[0]
        for q in ps[1:]:
            acc = acc + q
        return acc

    return _replicated(parts, total)


def pmax(parts: Parts) -> Parts:
    return _replicated(parts, lambda ps: torch.stack(ps).amax(0))


__all__ = ["Mesh", "all_gather", "axis_index", "canonical", "gather", "pmax", "ppermute", "psum",
           "replicate", "shard"]
