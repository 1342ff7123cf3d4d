"""Scene flattening + the procedural builders the benchmark scene needs.

Host-side numpy, ported from `esctp1raytracer_tpu/scene/builders.py`:
`scene_from_mesh` flattens meshes into one padded SoA triangle table with
per-triangle material and a compacted light-face table; `icosphere_mesh`,
`_ground_plane`, `_area_light` and `make_spheres` build the pieces.
`bench_scene()` is the benchmark workload's scene (two subdivision-4
icospheres, a ground plane and an area light: 10,244 triangles, 10,752
once padded). Tables are built on the CPU; move them with `.to(device)`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from esctp1raytracer_tpu_torch.scene.types import (
    DEFAULT_PAD_MULTIPLE,
    LightTable,
    Material,
    MeshData,
    Scene,
    SphereBuffer,
    TriangleBuffer,
    pad_to,
)


def scene_from_mesh(
    meshes: Sequence[MeshData],
    spheres: Optional[SphereBuffer] = None,
    pad_multiple: int = DEFAULT_PAD_MULTIPLE,
) -> Scene:
    """Flatten loaded geometries into a padded Scene."""
    total = sum(m.num_faces for m in meshes)
    if total == 0:
        raise ValueError("scene has no triangles")
    capacity = pad_to(total, pad_multiple)

    v = np.zeros((capacity, 3, 3), np.float32)
    n = np.zeros((capacity, 3, 3), np.float32)
    has_normals = np.zeros((capacity,), bool)
    uv = np.zeros((capacity, 3, 2), np.float32)
    has_uv = np.zeros((capacity,), bool)
    ka = np.zeros((capacity, 3), np.float32)
    kd = np.zeros((capacity, 3), np.float32)
    ks = np.zeros((capacity, 3), np.float32)
    ke = np.zeros((capacity, 3), np.float32)
    ns = np.ones((capacity,), np.float32)
    is_light = np.zeros((capacity,), bool)
    geom_id = np.full((capacity,), -1, np.int32)
    prim_id = np.full((capacity,), -1, np.int32)
    valid = np.zeros((capacity,), bool)

    light_faces: List[List[int]] = []

    cursor = 0
    for gi, mesh in enumerate(meshes):
        f = mesh.num_faces
        sl = slice(cursor, cursor + f)
        v[sl] = mesh.vertices
        if mesh.normals is not None:
            n[sl] = mesh.normals
            has_normals[sl] = True
        if mesh.uv is not None:
            uv[sl] = mesh.uv
            has_uv[sl] = True
        mat = mesh.material
        ka[sl] = mat.ka
        kd[sl] = mat.kd
        ks[sl] = mat.ks
        ke[sl] = mat.ke
        ns[sl] = mat.ns
        geom_id[sl] = gi
        prim_id[sl] = np.arange(f, dtype=np.int32)
        valid[sl] = True
        if mat.is_light:
            # One light *source* per emissive geometry.
            is_light[sl] = True
            light_faces.append(list(range(cursor, cursor + f)))
        cursor += f

    if light_faces:
        max_faces = max(len(lf) for lf in light_faces)
        tri_idx = np.zeros((len(light_faces), max_faces), np.int32)
        face_count = np.zeros((len(light_faces),), np.int32)
        for li, lf in enumerate(light_faces):
            # Pad with repeats of the first face: padded slots are never
            # sampled (the face is drawn below face_count) but stay in range.
            tri_idx[li] = lf[0]
            tri_idx[li, : len(lf)] = lf
            face_count[li] = len(lf)
        lights = LightTable(tri_idx=torch.from_numpy(tri_idx),
                            face_count=torch.from_numpy(face_count))
    else:
        lights = LightTable.empty()

    t = torch.from_numpy
    triangles = TriangleBuffer(
        v0=t(v[:, 0].copy()), v1=t(v[:, 1].copy()), v2=t(v[:, 2].copy()),
        n0=t(n[:, 0].copy()), n1=t(n[:, 1].copy()), n2=t(n[:, 2].copy()),
        has_normals=t(has_normals),
        uv0=t(uv[:, 0].copy()), uv1=t(uv[:, 1].copy()), uv2=t(uv[:, 2].copy()),
        has_uv=t(has_uv),
        ka=t(ka), kd=t(kd), ks=t(ks), ke=t(ke), ns=t(ns),
        is_light=t(is_light), geom_id=t(geom_id), prim_id=t(prim_id),
        valid=t(valid),
    )

    if spheres is None:
        spheres = SphereBuffer.empty(8)

    return Scene(triangles=triangles, spheres=spheres, lights=lights)


def make_spheres(
    centers: Sequence[Sequence[float]],
    radii: Sequence[float],
    materials: Sequence[Material],
    capacity: Optional[int] = None,
) -> SphereBuffer:
    s = len(radii)
    cap = capacity if capacity is not None else max(8, pad_to(s, 8))
    center = np.zeros((cap, 3), np.float32)
    radius = np.zeros((cap,), np.float32)
    ka = np.zeros((cap, 3), np.float32)
    kd = np.zeros((cap, 3), np.float32)
    ks = np.zeros((cap, 3), np.float32)
    ke = np.zeros((cap, 3), np.float32)
    ns = np.ones((cap,), np.float32)
    valid = np.zeros((cap,), bool)
    for i in range(s):
        center[i] = np.asarray(centers[i], np.float32)
        radius[i] = radii[i]
        ka[i], kd[i], ks[i], ke[i], ns[i] = (
            materials[i].ka, materials[i].kd, materials[i].ks,
            materials[i].ke, materials[i].ns,
        )
        valid[i] = True
    t = torch.from_numpy
    return SphereBuffer(center=t(center), radius=t(radius), ka=t(ka), kd=t(kd),
                        ks=t(ks), ke=t(ke), ns=t(ns), valid=t(valid))


def _quad_mesh(name: str, quad: Sequence[Sequence[float]], material: Material) -> MeshData:
    """Fan-triangulate one quad (v0,v1,v2 / v0,v2,v3) into a MeshData."""
    q = np.asarray(quad, np.float32)
    tris = np.stack([q[[0, 1, 2]], q[[0, 2, 3]]], axis=0)
    return MeshData(name=name, vertices=tris, normals=None, uv=None, material=material)


def _ground_plane(y: float = 0.0, half: float = 50.0,
                  material: Optional[Material] = None) -> MeshData:
    mat = material or Material.make(ka=(0.5, 0.5, 0.5), kd=(0.5, 0.5, 0.5), ns=10.0)
    quad = ((-half, y, half), (half, y, half), (half, y, -half), (-half, y, -half))
    return _quad_mesh("ground", quad, mat)


def _area_light(center=(0.0, 5.0, 0.0), half: float = 1.0,
                ke=(17.0, 12.0, 4.0)) -> MeshData:
    cx, cy, cz = center
    quad = (
        (cx - half, cy, cz + half), (cx - half, cy, cz - half),
        (cx + half, cy, cz - half), (cx + half, cy, cz + half),
    )
    mat = Material.make(ka=(0.78, 0.78, 0.78), kd=(0.78, 0.78, 0.78), ke=ke, ns=10.0)
    return _quad_mesh("light", quad, mat)


def icosphere_mesh(subdivisions: int = 4, radius: float = 1.0,
                   center=(0.0, 1.0, 0.0),
                   material: Optional[Material] = None,
                   smooth: bool = True) -> MeshData:
    """Procedural icosphere (20 * 4^s triangles; s=4 -> 5120), with
    optional smooth per-corner normals."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
         (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
         (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64,
    )
    for _ in range(subdivisions):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    unit = verts[faces]  # [F, 3, 3] on the unit sphere
    tri = (unit * radius + np.asarray(center)).astype(np.float32)
    normals = unit.astype(np.float32) if smooth else None
    mat = material or Material.make(ka=(0.4, 0.4, 0.7), kd=(0.4, 0.4, 0.7),
                                    ks=(0.3, 0.3, 0.3), ns=32.0)
    return MeshData(name="icosphere", vertices=tri, normals=normals, uv=None, material=mat)


def bench_scene() -> Scene:
    """The benchmark scene: 2 * 5120 + 2 + 2 = 10,244 triangles (10,752 padded)."""
    meshes = [
        icosphere_mesh(subdivisions=4, radius=1.0, center=(-1.3, 1.0, 0.0)),
        icosphere_mesh(subdivisions=4, radius=1.0, center=(1.3, 1.0, 0.0),
                       smooth=False),
        _ground_plane(),
        _area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]
    return scene_from_mesh(meshes)
