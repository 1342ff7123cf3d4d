"""Scene data model: flat, padded, fixed-shape SoA tables of tensors.

The PyTorch counterpart of `esctp1raytracer_tpu/scene/types.py`, field for
field: the same tables, the same padding to `DEFAULT_PAD_MULTIPLE`, the
same `valid` masks, and the same dtypes (float32, int32, bool). A table is
a dataclass of tensors; `.to(device)` moves it, `.detach()` cuts it out of
the autograd graph (the port's `stop_gradient` on a scene).

`scene_from_numpy` / `scene_to_numpy` carry a scene across by dotted leaf
name ("triangles.v0", "spheres.radius", "lights.tri_idx", ...), so the
JAX package and the port can compute on the very same tables.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

DEFAULT_PAD_MULTIPLE = 512


def pad_to(n: int, multiple: int = DEFAULT_PAD_MULTIPLE) -> int:
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


@dataclass
class Material:
    """Phong material (ka, kd, ks, ke, ns); a light source iff ke != 0."""

    ka: np.ndarray
    kd: np.ndarray
    ks: np.ndarray
    ke: np.ndarray
    ns: float

    @property
    def is_light(self) -> bool:
        return float(np.dot(self.ke, self.ke)) > 0.0

    @staticmethod
    def make(ka=(0, 0, 0), kd=(0, 0, 0), ks=(0, 0, 0), ke=(0, 0, 0), ns=1.0) -> "Material":
        return Material(
            ka=np.asarray(ka, np.float32),
            kd=np.asarray(kd, np.float32),
            ks=np.asarray(ks, np.float32),
            ke=np.asarray(ke, np.float32),
            ns=float(ns),
        )


@dataclass
class MeshData:
    """One loaded geometry on the host: de-indexed corners + material."""

    name: str
    vertices: np.ndarray  # [F, 3, 3] float32
    normals: Optional[np.ndarray]  # [F, 3, 3] float32 or None
    uv: Optional[np.ndarray]  # [F, 3, 2] float32 or None
    material: Material

    @property
    def num_faces(self) -> int:
        return int(self.vertices.shape[0])


class _Table:
    """A dataclass whose fields are tensors or nested tables."""

    def map(self, fn: Callable[[str, torch.Tensor], torch.Tensor], prefix: str = ""):
        """New table with fn(dotted_name, tensor) applied to every leaf."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            name = prefix + f.name
            kw[f.name] = v.map(fn, name + ".") if isinstance(v, _Table) else fn(name, v)
        return dataclasses.replace(self, **kw)

    def leaves(self, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
        """(dotted_name, tensor) for every leaf, in field order (JAX's leaf order)."""
        out = []
        self.map(lambda name, t: out.append((name, t)) or t, prefix)
        return out

    def to(self, device):
        return self.map(lambda _, t: t.to(device))

    def detach(self):
        return self.map(lambda _, t: t.detach())


@dataclass
class TriangleBuffer(_Table):
    """Flat padded SoA triangle table with per-triangle material."""

    v0: torch.Tensor  # [N, 3]
    v1: torch.Tensor  # [N, 3]
    v2: torch.Tensor  # [N, 3]
    n0: torch.Tensor  # [N, 3]
    n1: torch.Tensor  # [N, 3]
    n2: torch.Tensor  # [N, 3]
    has_normals: torch.Tensor  # [N] bool
    uv0: torch.Tensor  # [N, 2]
    uv1: torch.Tensor  # [N, 2]
    uv2: torch.Tensor  # [N, 2]
    has_uv: torch.Tensor  # [N] bool
    ka: torch.Tensor  # [N, 3]
    kd: torch.Tensor  # [N, 3]
    ks: torch.Tensor  # [N, 3]
    ke: torch.Tensor  # [N, 3]
    ns: torch.Tensor  # [N]
    is_light: torch.Tensor  # [N] bool
    geom_id: torch.Tensor  # [N] int32
    prim_id: torch.Tensor  # [N] int32
    valid: torch.Tensor  # [N] bool

    @property
    def capacity(self) -> int:
        return int(self.v0.shape[0])

    def take(self, idx: torch.Tensor) -> "TriangleBuffer":
        """Gather triangles by index (differentiable w.r.t. the buffers)."""
        idx = idx.long()
        return self.map(lambda _, a: a[idx])

    @staticmethod
    def empty(capacity: int = DEFAULT_PAD_MULTIPLE, device=None) -> "TriangleBuffer":
        z3 = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
        z2 = torch.zeros((capacity, 2), dtype=torch.float32, device=device)
        z1 = torch.zeros((capacity,), dtype=torch.float32, device=device)
        zb = torch.zeros((capacity,), dtype=torch.bool, device=device)
        zi = torch.full((capacity,), -1, dtype=torch.int32, device=device)
        return TriangleBuffer(
            v0=z3, v1=z3, v2=z3, n0=z3, n1=z3, n2=z3, has_normals=zb,
            uv0=z2, uv1=z2, uv2=z2, has_uv=zb,
            ka=z3, kd=z3, ks=z3, ke=z3, ns=z1, is_light=zb,
            geom_id=zi, prim_id=zi, valid=zb,
        )


@dataclass
class SphereBuffer(_Table):
    """Flat padded SoA sphere table (differentiable w.r.t. center/radius)."""

    center: torch.Tensor  # [S, 3]
    radius: torch.Tensor  # [S]
    ka: torch.Tensor  # [S, 3]
    kd: torch.Tensor  # [S, 3]
    ks: torch.Tensor  # [S, 3]
    ke: torch.Tensor  # [S, 3]
    ns: torch.Tensor  # [S]
    valid: torch.Tensor  # [S] bool

    @property
    def capacity(self) -> int:
        return int(self.center.shape[0])

    @staticmethod
    def empty(capacity: int = 8, device=None) -> "SphereBuffer":
        z3 = torch.zeros((capacity, 3), dtype=torch.float32, device=device)
        z1 = torch.zeros((capacity,), dtype=torch.float32, device=device)
        zb = torch.zeros((capacity,), dtype=torch.bool, device=device)
        return SphereBuffer(center=z3, radius=z1, ka=z3, kd=z3, ks=z3, ke=z3,
                            ns=z1, valid=zb)


@dataclass
class LightTable(_Table):
    """Light source l owns triangles `tri_idx[l, :face_count[l]]`."""

    tri_idx: torch.Tensor  # [L, F] int32, padded with repeats of face 0
    face_count: torch.Tensor  # [L] int32

    @property
    def num_lights(self) -> int:
        return int(self.tri_idx.shape[0])

    @property
    def max_faces(self) -> int:
        return int(self.tri_idx.shape[1])

    @staticmethod
    def empty(device=None) -> "LightTable":
        return LightTable(
            tri_idx=torch.zeros((0, 1), dtype=torch.int32, device=device),
            face_count=torch.zeros((0,), dtype=torch.int32, device=device),
        )


@dataclass
class Scene(_Table):
    """The complete flattened scene consumed by every renderer backend."""

    triangles: TriangleBuffer
    spheres: SphereBuffer
    lights: LightTable

    @property
    def num_triangles(self) -> int:
        return self.triangles.capacity

    @property
    def num_spheres(self) -> int:
        return self.spheres.capacity

    @property
    def num_lights(self) -> int:
        return self.lights.num_lights


def scene_from_numpy(d: Dict[str, np.ndarray]) -> Scene:
    """Build a Scene from {dotted leaf name: array} (copies the arrays)."""

    def table(cls, prefix):
        return cls(**{f.name: torch.as_tensor(np.array(d[prefix + f.name]))
                      for f in dataclasses.fields(cls)})

    return Scene(
        triangles=table(TriangleBuffer, "triangles."),
        spheres=table(SphereBuffer, "spheres."),
        lights=table(LightTable, "lights."),
    )


def scene_to_numpy(scene: Scene) -> Dict[str, np.ndarray]:
    """{dotted leaf name: numpy array} for every leaf of the scene."""
    return {name: t.detach().cpu().numpy() for name, t in scene.leaves()}
