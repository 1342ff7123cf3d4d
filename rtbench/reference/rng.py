"""Counter-based light draws: a frozen copy of the renderer's murmur3 hash.

Every draw is a pure function of (seed, ray id, stream): the 32-bit murmur3
finalizer applied to the ray id mixed with the seed, then to the stream. The
values are held in int64 in [0, 2^32) and masked after every step; a 32 x 32
bit product is split into 16-bit halves so that no intermediate passes 2^49.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
C1 = 0x85EBCA6B
C2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = mul32(h, C1)
    h = h ^ (h >> 13)
    h = mul32(h, C2)
    return h ^ (h >> 16)


def hash_u32(seed: int, ray_id: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    h = fmix32((ray_id.to(torch.int64) & M32) ^ ((int(seed) + GOLDEN) & M32))
    s = stream.to(torch.int64) & M32
    return fmix32(h ^ ((mul32(s, C1) + GOLDEN) & M32))


def uniform01(seed: int, ray_id: torch.Tensor, stream: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1): the hash's top 24 bits."""
    return (hash_u32(seed, ray_id, stream) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def randint(seed: int, ray_id: torch.Tensor, stream: torch.Tensor, maxval: torch.Tensor):
    """Uniform int32 in [0, maxval)."""
    u = uniform01(seed, ray_id, stream)
    return torch.minimum((u * maxval.to(torch.float32)).to(torch.int32),
                         (maxval - 1).to(torch.int32))
