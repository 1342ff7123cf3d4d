"""Pinhole look-at camera (counterpart of `esctp1raytracer_tpu/core/camera.py`).

vfov is the top-to-bottom field of view in degrees; the basis is (u, v, w)
with w = normalize(lookfrom - lookat); a ray through image fraction (s, t)
is normalize(lower_left_corner + s*horizontal + t*vertical - origin), with
s = w/(W-1), t = h/(H-1). `ray_grid` emits the whole [H, W] ray grid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


@dataclass
class Camera:
    origin: torch.Tensor  # [3]
    lower_left_corner: torch.Tensor  # [3]
    horizontal: torch.Tensor  # [3]
    vertical: torch.Tensor  # [3]

    @staticmethod
    def look_at(
        lookfrom,
        lookat,
        vup=(0.0, 1.0, 0.0),
        vfov: float = 60.0,
        aspect: float = 4.0 / 3.0,
        device=None,
    ) -> "Camera":
        f32 = dict(dtype=torch.float32, device=device)
        lookfrom = torch.as_tensor(lookfrom, **f32)
        lookat = torch.as_tensor(lookat, **f32)
        vup = torch.as_tensor(vup, **f32)
        theta = vfov * math.pi / 180.0
        # float32 tan on the host, as numpy rounds it (the JAX package's
        # tan rounds the same way; torch.tan can differ by an ulp).
        half_height = torch.tensor(np.tan(np.float32(theta / 2.0)), **f32)
        half_width = aspect * half_height
        w = _normalize(lookfrom - lookat)
        u = _normalize(torch.linalg.cross(vup, w))
        v = torch.linalg.cross(w, u)
        origin = lookfrom
        lower_left_corner = origin - u * half_width - v * half_height - w
        return Camera(
            origin=origin,
            lower_left_corner=lower_left_corner,
            horizontal=u * 2.0 * half_width,
            vertical=v * 2.0 * half_height,
        )

    def to(self, device) -> "Camera":
        return Camera(*(t.to(device) for t in (
            self.origin, self.lower_left_corner, self.horizontal, self.vertical)))

    def get_ray(self, s: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Rays through image fractions s, t -> (origins, unit dirs) [..., 3]."""
        s = torch.as_tensor(s, dtype=torch.float32, device=self.origin.device)[..., None]
        t = torch.as_tensor(t, dtype=torch.float32, device=self.origin.device)[..., None]
        direction = (
            self.lower_left_corner + self.horizontal * s + self.vertical * t - self.origin
        )
        direction = _normalize(direction)
        origin = torch.broadcast_to(self.origin, direction.shape)
        return origin, direction

    def ray_grid(self, width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """All camera rays for a width x height image, [H, W, 3] each."""
        f32 = dict(dtype=torch.float32, device=self.origin.device)
        ws = torch.arange(width, **f32) / float(width - 1)
        hs = torch.arange(height, **f32) / float(height - 1)
        s = torch.broadcast_to(ws[None, :], (height, width))
        t = torch.broadcast_to(hs[:, None], (height, width))
        return self.get_ray(s, t)
