"""Differentiable-parameter partitioning of a Scene.

Only `float_params` / `merge_params` of `esctp1raytracer_tpu/parallel/
sharding.py` are ported; the mesh-sharded renderers wait (ROADMAP.md
Queue 1, item 16). The float leaves come out in the JAX package's leaf
order (dataclass field order), so the two gradient lists line up.
"""

from __future__ import annotations

from typing import List

import torch

from esctp1raytracer_tpu_torch.scene.types import Scene


def float_params(scene: Scene) -> List[torch.Tensor]:
    """The differentiable (floating) leaves as a flat list."""
    return [t for _, t in scene.leaves() if t.is_floating_point()]


def merge_params(scene: Scene, params) -> Scene:
    """Rebuild a Scene from float params + the original non-float leaves."""
    it = iter(params)
    return scene.map(lambda _, t: next(it) if t.is_floating_point() else t)
