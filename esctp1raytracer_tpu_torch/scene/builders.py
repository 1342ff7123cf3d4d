"""Scene flattening + procedural scene builders.

Host-side numpy, ported from `esctp1raytracer_tpu/scene/builders.py`:
`scene_from_mesh` flattens meshes into one padded SoA triangle table with
per-triangle material and a compacted light-face table; `icosphere_mesh`,
`_ground_plane`, `_area_light` and `make_spheres` build the pieces.
Scenes: `bench_scene()` (the benchmark workload: two subdivision-4
icospheres, a ground plane and an area light, 10,244 triangles), the
Cornell box and its variants (`cornell_box`, `cornell_variant`), and the
BASELINE configs 1 to 5 (`sphere_plane_scene`, `ten_sphere_scene`,
`mesh_scene`, `mixed_scene`, `random_scene`). Tables are built with numpy
on the host and land on `device`, the card unless the caller names
another (`device="cpu"`, as the CPU tests do).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

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
    device="cuda",
) -> Scene:
    """Flatten loaded geometries into a padded Scene on `device`."""
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
        lights = LightTable.empty(device="cpu")

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
        spheres = SphereBuffer.empty(8, device="cpu")

    return Scene(triangles=triangles, spheres=spheres, lights=lights).to(device)


def make_spheres(
    centers: Sequence[Sequence[float]],
    radii: Sequence[float],
    materials: Sequence[Material],
    capacity: Optional[int] = None,
    device="cuda",
) -> SphereBuffer:
    """A padded sphere table on `device` (the card unless the caller names another)."""
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
                        ks=t(ks), ke=t(ke), ns=t(ns), valid=t(valid)).to(device)


def _quad_mesh(name: str, quad: Sequence[Sequence[float]], material: Material) -> MeshData:
    """Fan-triangulate one quad (v0,v1,v2 / v0,v2,v3) into a MeshData."""
    q = np.asarray(quad, np.float32)
    tris = np.stack([q[[0, 1, 2]], q[[0, 2, 3]]], axis=0)
    return MeshData(name=name, vertices=tris, normals=None, uv=None, material=material)


# --- Canonical Cornell box (public-domain data, Williams College 2011) ----

_CORNELL_MATERIALS = {
    "floor": Material.make(ka=(0.725, 0.71, 0.68), kd=(0.725, 0.71, 0.68), ns=10.0),
    "ceiling": Material.make(ka=(0.725, 0.71, 0.68), kd=(0.725, 0.71, 0.68), ns=10.0),
    "backWall": Material.make(ka=(0.725, 0.71, 0.68), kd=(0.725, 0.71, 0.68), ns=10.0),
    "rightWall": Material.make(ka=(0.14, 0.45, 0.091), kd=(0.14, 0.45, 0.091), ns=10.0),
    "leftWall": Material.make(ka=(0.63, 0.065, 0.05), kd=(0.63, 0.065, 0.05), ns=10.0),
    "shortBox": Material.make(ka=(0.725, 0.71, 0.68), kd=(0.725, 0.71, 0.68), ns=10.0),
    "tallBox": Material.make(ka=(0.725, 0.71, 0.68), kd=(0.725, 0.71, 0.68), ns=10.0),
    "light": Material.make(ka=(0.78, 0.78, 0.78), kd=(0.78, 0.78, 0.78),
                           ke=(17.0, 12.0, 4.0), ns=10.0),
}

_CORNELL_QUADS: List[Tuple[str, Tuple]] = [
    ("floor", ((-1.01, 0.0, 0.99), (1.0, 0.0, 0.99), (1.0, 0.0, -1.04), (-0.99, 0.0, -1.04))),
    ("ceiling", ((-1.02, 1.99, 0.99), (-1.02, 1.99, -1.04), (1.0, 1.99, -1.04), (1.0, 1.99, 0.99))),
    ("backWall", ((-0.99, 0.0, -1.04), (1.0, 0.0, -1.04), (1.0, 1.99, -1.04), (-1.02, 1.99, -1.04))),
    ("rightWall", ((1.0, 0.0, -1.04), (1.0, 0.0, 0.99), (1.0, 1.99, 0.99), (1.0, 1.99, -1.04))),
    ("leftWall", ((-1.01, 0.0, 0.99), (-0.99, 0.0, -1.04), (-1.02, 1.99, -1.04), (-1.02, 1.99, 0.99))),
    ("shortBox", ((0.53, 0.6, 0.75), (0.7, 0.6, 0.17), (0.13, 0.6, 0.0), (-0.05, 0.6, 0.57))),
    ("shortBox", ((-0.05, 0.0, 0.57), (-0.05, 0.6, 0.57), (0.13, 0.6, 0.0), (0.13, 0.0, 0.0))),
    ("shortBox", ((0.53, 0.0, 0.75), (0.53, 0.6, 0.75), (-0.05, 0.6, 0.57), (-0.05, 0.0, 0.57))),
    ("shortBox", ((0.7, 0.0, 0.17), (0.7, 0.6, 0.17), (0.53, 0.6, 0.75), (0.53, 0.0, 0.75))),
    ("shortBox", ((0.13, 0.0, 0.0), (0.13, 0.6, 0.0), (0.7, 0.6, 0.17), (0.7, 0.0, 0.17))),
    ("shortBox", ((0.53, 0.0, 0.75), (0.7, 0.0, 0.17), (0.13, 0.0, 0.0), (-0.05, 0.0, 0.57))),
    ("tallBox", ((-0.53, 1.2, 0.09), (0.04, 1.2, -0.09), (-0.14, 1.2, -0.67), (-0.71, 1.2, -0.49))),
    ("tallBox", ((-0.53, 0.0, 0.09), (-0.53, 1.2, 0.09), (-0.71, 1.2, -0.49), (-0.71, 0.0, -0.49))),
    ("tallBox", ((-0.71, 0.0, -0.49), (-0.71, 1.2, -0.49), (-0.14, 1.2, -0.67), (-0.14, 0.0, -0.67))),
    ("tallBox", ((-0.14, 0.0, -0.67), (-0.14, 1.2, -0.67), (0.04, 1.2, -0.09), (0.04, 0.0, -0.09))),
    ("tallBox", ((0.04, 0.0, -0.09), (0.04, 1.2, -0.09), (-0.53, 1.2, 0.09), (-0.53, 0.0, 0.09))),
    ("tallBox", ((-0.53, 0.0, 0.09), (0.04, 0.0, -0.09), (-0.14, 0.0, -0.67), (-0.71, 0.0, -0.49))),
    ("light", ((-0.24, 1.98, 0.16), (-0.24, 1.98, -0.22), (0.23, 1.98, -0.22), (0.23, 1.98, 0.16))),
]


def _quad_tris(quads) -> np.ndarray:
    """Fan-triangulate quads into [2 * len(quads), 3, 3] corners."""
    tris = []
    for q in quads:
        qa = np.asarray(q, np.float32)
        tris.append(qa[[0, 1, 2]])
        tris.append(qa[[0, 2, 3]])
    return np.stack(tris)


def cornell_meshes(faithful_shapes: bool = True) -> List[MeshData]:
    """The Cornell-Original scene as MeshData.

    faithful_shapes=True keeps the reference loader's shape grouping of
    CornellBox-Original.obj: the shortBox quads precede their `g` statement
    and land in the leftWall shape (a red short box), and the "shortBox"
    shape holds the tallBox quads with the tallBox material.
    """
    if not faithful_shapes:
        return _cornell_shell()
    shape_plan = [
        ("floor", ["floor"], "floor"),
        ("ceiling", ["ceiling"], "ceiling"),
        ("backWall", ["backWall"], "backWall"),
        ("rightWall", ["rightWall"], "rightWall"),
        ("leftWall", ["leftWall", "shortBox"], "leftWall"),
        ("shortBox", ["tallBox"], "tallBox"),
        ("light", ["light"], "light"),
    ]
    return [MeshData(name=shape, uv=None, normals=None, material=_CORNELL_MATERIALS[mat],
                     vertices=_quad_tris([q for n, q in _CORNELL_QUADS if n in members]))
            for shape, members, mat in shape_plan]


def cornell_box(pad_multiple: int = DEFAULT_PAD_MULTIPLE,
                faithful_shapes: bool = True, device="cuda") -> Scene:
    """The canonical benchmark scene: 36 triangles, one area light."""
    return scene_from_mesh(cornell_meshes(faithful_shapes), pad_multiple=pad_multiple,
                           device=device)


# --- Cornell variants (procedural equivalents of the reference's model files)

_MIRROR_MATERIAL = Material.make(  # CornellBox-Mirror.mtl tallBox
    ka=(0.01, 0.01, 0.01), kd=(0.01, 0.01, 0.01), ks=(0.95, 0.95, 0.95), ns=1000.0)
_GLOSSY_MATERIAL = Material.make(  # CornellBox-Glossy.mtl shortBox
    ka=(0.525, 0.51, 0.48), kd=(0.525, 0.51, 0.48), ks=(0.8, 0.8, 0.8), ns=40.0)
_WATER_MATERIAL = Material.make(  # CornellBox-Water.mtl water
    ka=(0.01, 0.01, 0.01), kd=(0.30, 0.30, 0.70), ks=(0.01, 0.01, 0.01), ns=200.0)
_LEFT_SPHERE_MATERIAL = Material.make(  # CornellBox-Sphere.mtl leftSphere
    ka=(0.01, 0.01, 0.01), kd=(0.01, 0.01, 0.01), ks=(0.95, 0.95, 0.95), ns=1024.0)
_RIGHT_SPHERE_MATERIAL = Material.make(  # CornellBox-Sphere.mtl rightSphere
    ka=(0.01, 0.01, 0.01), kd=(0.30, 0.30, 0.30), ks=(0.01, 0.01, 0.01), ns=1024.0)
_WHITE_LIGHT = Material.make(ka=(0.78, 0.78, 0.78), kd=(0.78, 0.78, 0.78),
                             ke=(10.0, 10.0, 10.0), ns=10.0)


def _wall(rgb, ns=10.0):
    return Material.make(ka=rgb, kd=rgb, ns=ns)


# Wall/light swaps of the empty-box variants (walls + light panel, no boxes).
_EMPTY_OVERRIDES = {
    "empty_co": {  # orange left wall, cyan right wall
        "leftWall": _wall((0.953, 0.357, 0.212)),
        "rightWall": _wall((0.486, 0.631, 0.663)),
        "light": _WHITE_LIGHT,
    },
    "empty_rg": {},  # original red/green walls, original light
    "empty_white": {
        **{g: _wall((1.0, 1.0, 1.0))
           for g in ("floor", "ceiling", "backWall", "leftWall", "rightWall")},
        "light": _WHITE_LIGHT,
    },
    "empty_squashed": {  # red left wall, blue right wall
        "rightWall": _wall((0.161, 0.133, 0.427)),
        "light": _WHITE_LIGHT,
    },
}


def _cornell_shell(material_overrides=None, drop_groups=()) -> List[MeshData]:
    """Cornell meshes (clean grouping) with per-group material swaps."""
    overrides = material_overrides or {}
    order = []
    for name, _ in _CORNELL_QUADS:
        if name not in drop_groups and name not in order:
            order.append(name)
    return [MeshData(name=name, normals=None, uv=None,
                     vertices=_quad_tris([q for n, q in _CORNELL_QUADS if n == name]),
                     material=overrides.get(name, _CORNELL_MATERIALS[name]))
            for name in order]


def water_surface_mesh(n: int = 64, amplitude: float = 0.05, y: float = 0.35,
                       extent: float = 0.99,
                       material: Optional[Material] = None) -> MeshData:
    """A sine-wave water heightfield with analytic smooth normals."""
    mat = material or _WATER_MATERIAL
    xs = np.linspace(-extent, extent, n + 1, dtype=np.float32)
    zs = np.linspace(-extent, extent, n + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    kx, kz = np.float32(2.5 * np.pi), np.float32(2.0 * np.pi)
    Y = y + amplitude * np.sin(kx * X) * np.cos(kz * Z)
    dYdx = amplitude * kx * np.cos(kx * X) * np.cos(kz * Z)
    dYdz = -amplitude * kz * np.sin(kx * X) * np.sin(kz * Z)
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)  # [n+1, n+1, 3]
    N = np.stack([-dYdx, np.ones_like(Y), -dYdz], axis=-1)
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).astype(np.float32)

    def corners(A):
        a, b, c, d = A[:-1, :-1], A[1:, :-1], A[1:, 1:], A[:-1, 1:]
        t1 = np.stack([a, b, c], axis=2)
        t2 = np.stack([a, c, d], axis=2)
        return np.concatenate([t1, t2], axis=2).reshape(-1, 3, A.shape[-1])

    return MeshData(name="water", vertices=corners(P), normals=corners(N), uv=None,
                    material=mat)


CORNELL_VARIANTS = ("original", "mirror", "glossy", "sphere", "water", "empty_co",
                    "empty_rg", "empty_white", "empty_squashed", "empty_nolight")


def cornell_variant(name: str = "original", device="cuda") -> Scene:
    """Procedural equivalents of the reference's Cornell model variants.

    original | mirror (tallBox -> 0.95 specular, Ns 1000) | glossy (shortBox
    -> 0.8 specular, Ns 40) | sphere (boxes -> two analytic spheres) | water
    (boxes -> dense sine heightfield) | empty_co / empty_rg / empty_white
    (walls + light, no boxes) | empty_squashed (y squash + shallow water) |
    empty_nolight (no emissive geometry).
    """
    if name == "original":
        return cornell_box(device=device)
    if name == "mirror":
        return scene_from_mesh(_cornell_shell({"tallBox": _MIRROR_MATERIAL}), device=device)
    if name == "glossy":
        return scene_from_mesh(_cornell_shell({"shortBox": _GLOSSY_MATERIAL}), device=device)
    no_boxes = ("shortBox", "tallBox")
    if name == "sphere":
        spheres = make_spheres(
            centers=[(0.446, 0.332, 0.377), (-0.42, 0.33, -0.3)],
            radii=[0.325, 0.325],
            materials=[_LEFT_SPHERE_MATERIAL, _RIGHT_SPHERE_MATERIAL],
            device=device,
        )
        return scene_from_mesh(_cornell_shell(drop_groups=no_boxes), spheres=spheres,
                               device=device)
    if name == "water":
        return scene_from_mesh(_cornell_shell(drop_groups=no_boxes) + [water_surface_mesh()],
                               device=device)
    if name in _EMPTY_OVERRIDES:
        meshes = _cornell_shell(_EMPTY_OVERRIDES[name], drop_groups=no_boxes)
        if name == "empty_squashed":
            ys = np.asarray([1.0, 1.59 / 1.99, 1.0], np.float32)
            meshes = [MeshData(name=m.name, vertices=m.vertices * ys, normals=None, uv=None,
                               material=m.material) for m in meshes]
            meshes.append(water_surface_mesh(n=16, amplitude=0.02, y=0.22))
        return scene_from_mesh(meshes, device=device)
    if name == "empty_nolight":
        return scene_from_mesh(_cornell_shell(drop_groups=no_boxes + ("light",)), device=device)
    raise ValueError(f"unknown cornell variant {name!r}; expected one of "
                     + "|".join(CORNELL_VARIANTS))


# --- BASELINE.json procedural configs -------------------------------------

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


def sphere_plane_scene(device="cuda") -> Scene:
    """BASELINE config 1: single sphere + ground plane (256², depth 1)."""
    spheres = make_spheres(
        centers=[(0.0, 1.0, 0.0)],
        radii=[1.0],
        materials=[Material.make(ka=(0.7, 0.2, 0.2), kd=(0.7, 0.2, 0.2),
                                 ks=(0.2, 0.2, 0.2), ns=32.0)],
        device=device,
    )
    meshes = [_ground_plane(), _area_light(center=(0.0, 6.0, 2.0), half=1.5)]
    return scene_from_mesh(meshes, spheres=spheres, device=device)


def ten_sphere_scene(seed: int = 0, device="cuda") -> Scene:
    """BASELINE config 2: 10-sphere Phong scene with shadows (512², depth 2)."""
    rng = np.random.RandomState(seed)
    centers, radii, mats = [], [], []
    for i in range(10):
        angle = 2.0 * np.pi * i / 10.0
        r = 0.35 + 0.25 * rng.rand()
        centers.append((3.0 * np.cos(angle), r, 3.0 * np.sin(angle)))
        radii.append(r)
        color = rng.rand(3).astype(np.float32) * 0.7 + 0.2
        mats.append(Material.make(ka=color, kd=color, ks=(0.3, 0.3, 0.3), ns=64.0))
    spheres = make_spheres(centers, radii, mats, device=device)
    meshes = [_ground_plane(), _area_light(center=(0.0, 7.0, 0.0), half=2.0)]
    return scene_from_mesh(meshes, spheres=spheres, device=device)


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


def mesh_scene(subdivisions: int = 4, device="cuda") -> Scene:
    """BASELINE config 3: an icosphere mesh (20 * 4^s triangles), a ground
    plane and an area light."""
    meshes = [
        icosphere_mesh(subdivisions=subdivisions),
        _ground_plane(),
        _area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]
    return scene_from_mesh(meshes, device=device)


def mixed_scene(device="cuda") -> Scene:
    """BASELINE config 4: spheres + mesh, depth-4 reflections, differentiable
    (1,284 triangles, 1,536 once padded; 3 spheres)."""
    spheres = make_spheres(
        centers=[(2.2, 0.8, 0.0), (-2.2, 0.6, 0.5), (0.0, 0.5, 2.4)],
        radii=[0.8, 0.6, 0.5],
        materials=[
            Material.make(ka=(0.2, 0.2, 0.25), kd=(0.3, 0.3, 0.35),
                          ks=(0.7, 0.7, 0.7), ns=128.0),
            Material.make(ka=(0.6, 0.2, 0.2), kd=(0.6, 0.2, 0.2),
                          ks=(0.3, 0.3, 0.3), ns=32.0),
            Material.make(ka=(0.2, 0.5, 0.2), kd=(0.2, 0.5, 0.2),
                          ks=(0.4, 0.4, 0.4), ns=64.0),
        ],
        device=device,
    )
    meshes = [
        icosphere_mesh(subdivisions=3, radius=0.9, center=(0.0, 0.9, -1.5),
                       material=Material.make(ka=(0.4, 0.4, 0.7), kd=(0.4, 0.4, 0.7),
                                              ks=(0.5, 0.5, 0.5), ns=64.0)),
        _ground_plane(),
        _area_light(center=(0.0, 7.0, 1.0), half=2.0),
    ]
    return scene_from_mesh(meshes, spheres=spheres, device=device)


def bench_scene(device="cuda") -> Scene:
    """The benchmark scene: 2 * 5120 + 2 + 2 = 10,244 triangles (10,752 padded)."""
    meshes = [
        icosphere_mesh(subdivisions=4, radius=1.0, center=(-1.3, 1.0, 0.0)),
        icosphere_mesh(subdivisions=4, radius=1.0, center=(1.3, 1.0, 0.0),
                       smooth=False),
        _ground_plane(),
        _area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]
    return scene_from_mesh(meshes, device=device)


def random_scene(num_triangles: int = 100_000, seed: int = 0,
                 extent: float = 20.0, device="cuda") -> Scene:
    """BASELINE config 5: a soup of `num_triangles` small triangles above a
    ground plane, and one area light (numpy's RandomState(seed), as in the
    JAX package, so the tables are equal)."""
    rng = np.random.RandomState(seed)
    centers = (rng.rand(num_triangles, 1, 3) - 0.5) * 2.0 * extent
    centers[..., 1] = np.abs(centers[..., 1]) * 0.5  # keep above ground
    offsets = (rng.rand(num_triangles, 3, 3) - 0.5) * 0.5
    tris = (centers + offsets).astype(np.float32)
    color = (0.3, 0.5, 0.7)
    mat = Material.make(ka=color, kd=color, ks=(0.2, 0.2, 0.2), ns=16.0)
    soup = MeshData(name="soup", vertices=tris, normals=None, uv=None, material=mat)
    meshes = [soup, _ground_plane(half=3 * extent),
              _area_light(center=(0.0, 1.5 * extent, 0.0), half=extent / 4)]
    return scene_from_mesh(meshes, device=device)
