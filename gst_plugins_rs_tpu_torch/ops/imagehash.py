"""Perceptual image hashing (videocompare's compute path).

The port of gst_plugins_rs_tpu/ops/imagehash.py: the `image_hasher`
algorithms the reference uses (video/videofx/src/videocompare/
hashed_image.rs), Mean / Gradient / VertGradient / DoubleGradient /
Blockhash, 64-bit hashes, Hamming distance.  Rec.709 luma; the downscales
use the weights of `jax.image.resize` (linear, antialiased;
ops/image_resize.py), as the JAX package does.  The blockhash median is the
mean of the two middle block sums, as `jnp.median` takes it (torch.median
returns the lower one).  All of it runs on the device; only the distance
is read back.
"""
from __future__ import annotations

import torch

from .image_resize import resize

HASH_SIZE = 8


def to_luma(frame: torch.Tensor) -> torch.Tensor:
    """[H, W, C] uint -> [H, W] f32 luma (Rec.709 coefficients like the
    `image` crate)."""
    f = frame.to(torch.float32)
    if f.shape[-1] == 1:
        return f[..., 0]
    return 0.2126 * f[..., 0] + 0.7152 * f[..., 1] + 0.0722 * f[..., 2]


def hash_values(frame: torch.Tensor, *, algo: str):
    """(left, right): the two f32 vectors whose comparison left > right is
    the hash of `algo` ([64] each)."""
    luma = to_luma(frame)
    if algo == "mean":
        small = resize(luma, (HASH_SIZE, HASH_SIZE), "linear")
        return small.ravel(), torch.mean(small).expand(small.numel())
    if algo == "gradient":
        small = resize(luma, (HASH_SIZE, HASH_SIZE + 1), "linear")
        return small[:, 1:].ravel(), small[:, :-1].ravel()
    if algo == "vertgradient":
        small = resize(luma, (HASH_SIZE + 1, HASH_SIZE), "linear")
        return small[1:, :].ravel(), small[:-1, :].ravel()
    if algo == "doublegradient":
        half = HASH_SIZE // 2
        small = resize(luma, (half + 1, half + 1), "linear")
        return (torch.cat([small[:half, 1:].ravel(), small[1:, :half].ravel()]),
                torch.cat([small[:half, :-1].ravel(), small[:-1, :half].ravel()]))
    if algo == "blockhash":
        # block median hash over the original image (no resampling)
        H, W = luma.shape
        bh, bw = H // HASH_SIZE, W // HASH_SIZE
        blocks = luma[: bh * HASH_SIZE, : bw * HASH_SIZE]
        sums = blocks.reshape(HASH_SIZE, bh, HASH_SIZE, bw).sum(dim=(1, 3)).ravel()
        ordered = torch.sort(sums).values
        mid = sums.numel() // 2
        median = (ordered[mid - 1] + ordered[mid]) * 0.5
        return sums, median.expand(sums.numel())
    raise ValueError(f"unknown hash algorithm {algo!r}")


def hash_image(frame: torch.Tensor, *, algo: str) -> torch.Tensor:
    """frame: [H, W, C] -> bool bits [64]."""
    left, right = hash_values(frame, algo=algo)
    return left > right


def hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a != b)


__all__ = ["hash_image", "hash_values", "hamming", "to_luma", "HASH_SIZE"]
