"""Counter-based deterministic RNG for light sampling (murmur3 finalizer).

Every draw is a pure hash of (seed, ray_id, stream), bit-identical to
`esctp1raytracer_tpu/utils/rng.py`, so a render does not depend on ray
chunking or execution order, and the port draws the same light samples
as the JAX package. There is no global generator.

The hash is uint32 arithmetic. PyTorch has no uint32 shifts on every
backend, so values are held in int64 in [0, 2^32) and every step is
masked back to 32 bits. A 32 x 32-bit multiply could exceed int64, so
`_mul32` splits the constant into 16-bit halves: no intermediate passes
2^49, and the low 32 bits are exact.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a 32-bit constant c."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    h = h ^ (h >> 16)
    return h


def _u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def hash_u32(seed, ray_id: torch.Tensor, stream) -> torch.Tensor:
    """Mix (seed, ray_id, stream) into uniform 32-bit values (int64 tensor).

    `stream` may be a scalar or a tensor broadcastable against `ray_id`
    (e.g. ray_id [R, 1] x stream [L] -> draws [R, L]).
    """
    h = _u32(ray_id, None)
    h = _fmix32(h ^ ((int(seed) + _GOLDEN) & _M32))
    s = _u32(stream, h.device)
    h = _fmix32(h ^ ((_mul32(s, _C1) + _GOLDEN) & _M32))
    return h


def uniform01(seed, ray_id: torch.Tensor, stream) -> torch.Tensor:
    """Uniform float32 in [0, 1) per draw — 24 mantissa-quality bits."""
    bits = hash_u32(seed, ray_id, stream)
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def randint(seed, ray_id: torch.Tensor, stream, maxval: torch.Tensor) -> torch.Tensor:
    """Uniform int32 in [0, maxval) per draw (maxval broadcastable, >= 1)."""
    u = uniform01(seed, ray_id, stream)
    maxval = torch.as_tensor(maxval, device=u.device)
    return torch.minimum((u * maxval.to(torch.float32)).to(torch.int32),
                         (maxval - 1).to(torch.int32))
