"""Axis-aligned bounding boxes (counterpart of `esctp1raytracer_tpu/accel/aabb.py`)."""

from __future__ import annotations

from typing import Tuple

import torch

from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

BIG = 1e30  # the JAX package's empty-box and miss value


def triangle_bounds(tris: TriangleBuffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-triangle AABB (bmin, bmax) [N, 3]."""
    v = torch.stack([tris.v0, tris.v1, tris.v2], dim=1)  # [N, 3, 3]
    return torch.amin(v, dim=1), torch.amax(v, dim=1)


def aabb_intersect(o: torch.Tensor, inv_d: torch.Tensor, bmin: torch.Tensor,
                   bmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab test (broadcastable): returns (tnear, tfar, hit).

    The reference's semantics (src/scene/aabb.cpp:67-110): hit iff the
    [tnear, tfar] interval is non-empty with tfar >= 0. `inv_d` is the
    per-component reciprocal direction.
    """
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tnear = torch.amax(torch.minimum(t0, t1), dim=-1)
    tfar = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tnear, tfar, (tnear <= tfar) & (tfar >= 0.0)
