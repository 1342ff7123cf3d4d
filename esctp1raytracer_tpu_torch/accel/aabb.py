"""Axis-aligned bounding boxes (counterpart of `esctp1raytracer_tpu/accel/aabb.py`)."""

from __future__ import annotations

from typing import Tuple

import torch

from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer


def triangle_bounds(tris: TriangleBuffer) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-triangle AABB (bmin, bmax) [N, 3]."""
    v = torch.stack([tris.v0, tris.v1, tris.v2], dim=1)  # [N, 3, 3]
    return torch.amin(v, dim=1), torch.amax(v, dim=1)
