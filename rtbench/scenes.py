"""Scenes of the benchmark's configurations, made from their files' recipes.

A configuration file (`rtbench/configs/<name>.json`) describes its scene as
data: a list of meshes (`icosphere`, `quads` or `soup`, each with a material)
and a list of spheres. `make_meshes` turns the recipe into plain numpy arrays, the
inputs that the benchmark hands to both sides: the port gets them through its
public `scene_from_mesh` / `make_spheres`, the plain reference
(`rtbench/reference/`) reads the arrays themselves. The icosphere recipe is a
frozen copy of the subdivided icosahedron that `bench.py:175-183` renders, so
the scene is the port's `bench_scene()` table for table, and the soup recipe
a frozen copy of the draws of `scene/builders.py:random_scene`, so that a soup
of 100,000 triangles with its ground and light is `random_scene(100_000)`
(CPU tests hold both).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Mesh:
    """One geometry of the scene: corners [F, 3, 3], optional smooth normals, a material."""

    name: str
    vertices: np.ndarray
    normals: np.ndarray | None
    material: dict


@dataclass
class SceneArrays:
    """The scene as flat unpadded arrays (what the reference reads)."""

    v: np.ndarray          # [N, 3, 3] corners
    n: np.ndarray          # [N, 3, 3] corner normals (zeros where absent)
    has_n: np.ndarray      # [N] bool
    mat: dict              # ka, kd, ks, ke [N, 3]; ns [N]
    lights: List[List[int]]  # the triangle indices of each light source, in order
    spheres: dict          # center [S, 3], radius [S], ka kd ks ke [S, 3], ns [S]


def _material(spec: dict) -> dict:
    m = {k: np.asarray(spec.get(k, (0.0, 0.0, 0.0)), np.float32) for k in ("ka", "kd", "ks", "ke")}
    m["ns"] = float(spec.get("ns", 1.0))
    return m


def _icosphere(subdivisions: int, radius: float, center, smooth: bool):
    """Corners and (smooth) normals of a subdivided icosahedron, 20 * 4^s faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
         (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
         (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
         (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
         (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
         (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)
    for _ in range(subdivisions):
        vlist = list(verts)
        cache = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = vlist[a] + vlist[b]
                cache[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)
    unit = verts[faces]
    tri = (unit * radius + np.asarray(center)).astype(np.float32)
    return tri, (unit.astype(np.float32) if smooth else None)


def _quads(quads) -> np.ndarray:
    """Fan-triangulated quads: (q0, q1, q2) and (q0, q2, q3) each."""
    tris = []
    for q in quads:
        qa = np.asarray(q, np.float32)
        tris += [qa[[0, 1, 2]], qa[[0, 2, 3]]]
    return np.stack(tris)


def _soup(count: int, seed: int, extent: float) -> np.ndarray:
    """`count` independent small triangles: centres uniform in a cube of half-side
    `extent` folded above the ground (y -> |y| / 2), corners within 0.25 of them."""
    rng = np.random.RandomState(seed)
    centers = (rng.rand(count, 1, 3) - 0.5) * 2.0 * extent
    centers[..., 1] = np.abs(centers[..., 1]) * 0.5
    offsets = (rng.rand(count, 3, 3) - 0.5) * 0.5
    return (centers + offsets).astype(np.float32)


def make_meshes(scene_spec: dict) -> List[Mesh]:
    """The recipe's meshes, in order."""
    out = []
    for m in scene_spec["meshes"]:
        if m["kind"] == "icosphere":
            v, n = _icosphere(m["subdivisions"], m["radius"], m["center"], m.get("smooth", True))
        elif m["kind"] == "quads":
            v, n = _quads(m["quads"]), None
        elif m["kind"] == "soup":
            v, n = _soup(m["count"], m["seed"], m["extent"]), None
        else:
            raise ValueError(f"unknown mesh kind {m['kind']!r}")
        out.append(Mesh(m.get("name", m["kind"]), v, n, _material(m["material"])))
    return out


def scene_arrays(scene_spec: dict) -> SceneArrays:
    """The recipe as the reference's flat arrays: triangles in mesh order, one
    light source per emissive mesh."""
    meshes = make_meshes(scene_spec)
    v = np.concatenate([m.vertices for m in meshes])
    n = np.concatenate([m.normals if m.normals is not None else np.zeros_like(m.vertices)
                        for m in meshes])
    has_n = np.concatenate([np.full(len(m.vertices), m.normals is not None) for m in meshes])
    mat = {k: np.concatenate([np.broadcast_to(m.material[k], (len(m.vertices), 3))
                              for m in meshes]).astype(np.float32) for k in ("ka", "kd", "ks", "ke")}
    mat["ns"] = np.concatenate([np.full(len(m.vertices), m.material["ns"], np.float32)
                                for m in meshes])
    lights, cursor = [], 0
    for m in meshes:
        if float(np.dot(m.material["ke"], m.material["ke"])) > 0.0:
            lights.append(list(range(cursor, cursor + len(m.vertices))))
        cursor += len(m.vertices)
    sph = scene_spec.get("spheres", [])
    spheres = {"center": np.asarray([s["center"] for s in sph], np.float32).reshape(-1, 3),
               "radius": np.asarray([s["radius"] for s in sph], np.float32)}
    for k in ("ka", "kd", "ks", "ke"):
        spheres[k] = np.asarray([_material(s["material"])[k] for s in sph], np.float32).reshape(-1, 3)
    spheres["ns"] = np.asarray([_material(s["material"])["ns"] for s in sph], np.float32)
    return SceneArrays(v=v, n=n, has_n=has_n, mat=mat, lights=lights, spheres=spheres)


def port_scene(scene_spec: dict, device: str):
    """The recipe as the port's padded Scene on `device`, through its public builders."""
    from esctp1raytracer_tpu_torch.scene.builders import make_spheres, scene_from_mesh
    from esctp1raytracer_tpu_torch.scene.types import Material, MeshData

    def material(m):
        return Material.make(ka=m["ka"], kd=m["kd"], ks=m["ks"], ke=m["ke"], ns=m["ns"])

    meshes = [MeshData(name=m.name, vertices=m.vertices, normals=m.normals, uv=None,
                       material=material(m.material)) for m in make_meshes(scene_spec)]
    sph = scene_spec.get("spheres", [])
    spheres = None
    if sph:
        spheres = make_spheres([s["center"] for s in sph], [s["radius"] for s in sph],
                               [material(_material(s["material"])) for s in sph], device=device)
    return scene_from_mesh(meshes, spheres=spheres, device=device)
