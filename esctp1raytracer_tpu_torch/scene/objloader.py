"""Wavefront OBJ/MTL loader — tinyobjloader-equivalent, pure Python.

Counterpart of `esctp1raytracer_tpu/scene/objloader.py`, line for line.

Matches the observable semantics of the reference loader
(`model::loadobj`, reference src/scene/sceneloader.cpp:14-106, which wraps
the vendored tinyobjloader src/scene/tiny_obj_loader.h:1386-1721):

* shapes split on `o`/`g` statements (a new shape starts when a name tag is
  seen after faces have been collected);
* faces are fan-triangulated (tinyobj's `triangulate=true`,
  sceneloader.cpp:24-25), so quads become two triangles;
* negative OBJ indices are relative to the current vertex count;
* one material per shape, taken from the first face (sceneloader.cpp:42-50);
* Ka/Kd/Ks/Ke/Ns copied into the Phong material (sceneloader.cpp:52-61);
* a shape is a light source iff dot(ke,ke) > 0 (sceneloader.cpp:63-64);
* corners are de-indexed — one vertex/normal/uv record per corner
  (sceneloader.cpp:73-97) — and loaded normals are normalized (:88).

Divergence from the reference (documented): a face with no `usemtl` gets a
default gray material instead of the reference's out-of-bounds
`obj_materials[-1]` read (undefined behavior, sceneloader.cpp:52).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from esctp1raytracer_tpu_torch.scene.types import Material, MeshData
from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)

_DEFAULT_MATERIAL = Material.make(
    ka=(0.2, 0.2, 0.2), kd=(0.6, 0.6, 0.6), ks=(0.0, 0.0, 0.0),
    ke=(0.0, 0.0, 0.0), ns=1.0,
)


def _parse_floats(parts: List[str], n: int) -> Tuple[float, ...]:
    vals = [float(p) for p in parts[:n]]
    while len(vals) < n:
        vals.append(0.0)
    return tuple(vals)


def load_mtl(path: str) -> Dict[str, Material]:
    """Parse an MTL file into {name: Material}.

    Reads the fields the reference consumes: Ka (ambient), Kd (diffuse),
    Ks (specular), Ke (emission), Ns (shininess)
    (reference src/scene/sceneloader.cpp:52-61). Other MTL statements
    (Ni, d, illum, maps) are accepted and ignored.
    """
    materials: Dict[str, Material] = {}
    current: Optional[str] = None
    fields: Dict[str, object] = {}

    def flush():
        nonlocal current, fields
        if current is not None:
            materials[current] = Material.make(
                ka=fields.get("ka", (0, 0, 0)),
                kd=fields.get("kd", (0, 0, 0)),
                ks=fields.get("ks", (0, 0, 0)),
                ke=fields.get("ke", (0, 0, 0)),
                ns=fields.get("ns", 1.0),
            )
        current, fields = None, {}

    with open(path, "r") as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0].lower()
            if key == "newmtl":
                flush()
                current = parts[1] if len(parts) > 1 else ""
            elif key == "ka":
                fields["ka"] = _parse_floats(parts[1:], 3)
            elif key == "kd":
                fields["kd"] = _parse_floats(parts[1:], 3)
            elif key == "ks":
                fields["ks"] = _parse_floats(parts[1:], 3)
            elif key == "ke":
                fields["ke"] = _parse_floats(parts[1:], 3)
            elif key == "ns":
                fields["ns"] = float(parts[1])
    flush()
    return materials


class _ShapeAccum:
    def __init__(self, name: str):
        self.name = name
        self.corner_vertices: List[Tuple[float, float, float]] = []
        self.corner_normals: List[Optional[Tuple[float, float, float]]] = []
        self.corner_uvs: List[Optional[Tuple[float, float]]] = []
        self.material_name: Optional[str] = None  # first face's material

    @property
    def num_faces(self) -> int:
        return len(self.corner_vertices) // 3


def load_obj(path: str) -> List[MeshData]:
    """Load an OBJ file into a list of MeshData (one per shape).

    Equivalent of `model::loadobj` (reference src/scene/sceneloader.cpp:14).
    Raises FileNotFoundError / ValueError on bad input, matching the
    reference's `throw std::runtime_error` on load failure (:28-30).
    """
    base_dir = os.path.dirname(os.path.abspath(path))

    vertices: List[Tuple[float, float, float]] = []
    normals: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    materials: Dict[str, Material] = {}

    shapes: List[_ShapeAccum] = []
    current = _ShapeAccum("")
    current_material: Optional[str] = None

    def new_shape(name: str):
        nonlocal current
        # tinyobj starts a new shape on o/g only once faces exist.
        if current.num_faces > 0:
            shapes.append(current)
        current = _ShapeAccum(name)

    def resolve(idx: int, count: int, kind: str) -> int:
        if idx > 0:
            r = idx - 1
        elif idx < 0:
            r = count + idx
        else:
            raise ValueError(f"OBJ index 0 is invalid ({kind}) in {path}")
        if not (0 <= r < count):
            raise ValueError(f"OBJ {kind} index {idx} out of range in {path}")
        return r

    with open(path, "r") as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            key = parts[0]

            if key == "v":
                vertices.append(_parse_floats(parts[1:], 3))
            elif key == "vn":
                normals.append(_parse_floats(parts[1:], 3))
            elif key == "vt":
                texcoords.append(_parse_floats(parts[1:], 2))
            elif key == "mtllib":
                for mtl_name in parts[1:]:
                    mtl_path = os.path.join(base_dir, mtl_name)
                    if os.path.exists(mtl_path):
                        materials.update(load_mtl(mtl_path))
                    else:
                        logger.warning("mtllib not found: %s", mtl_path)
            elif key == "usemtl":
                current_material = parts[1] if len(parts) > 1 else None
            elif key in ("o", "g"):
                new_shape(parts[1] if len(parts) > 1 else "")
            elif key == "f":
                corners = []
                for token in parts[1:]:
                    comps = token.split("/")
                    vi = resolve(int(comps[0]), len(vertices), "vertex")
                    ti = None
                    ni = None
                    if len(comps) > 1 and comps[1]:
                        ti = resolve(int(comps[1]), len(texcoords), "texcoord")
                    if len(comps) > 2 and comps[2]:
                        ni = resolve(int(comps[2]), len(normals), "normal")
                    corners.append((vi, ti, ni))
                if len(corners) < 3:
                    raise ValueError(f"Face with <3 vertices in {path}")
                # Fan triangulation around corner 0 (tinyobj triangulate=true).
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    if current.num_faces == 0:
                        current.material_name = current_material
                    for vi, ti, ni in tri:
                        current.corner_vertices.append(vertices[vi])
                        current.corner_normals.append(
                            normals[ni] if ni is not None else None
                        )
                        current.corner_uvs.append(
                            texcoords[ti] if ti is not None else None
                        )

    if current.num_faces > 0:
        shapes.append(current)

    meshes: List[MeshData] = []
    for shape in shapes:
        f = shape.num_faces
        verts = np.asarray(shape.corner_vertices, np.float32).reshape(f, 3, 3)

        # The reference pushes normals per corner only when present; a shape
        # either has normals for all corners or the smooth-normal path is
        # skipped (normals.empty(), src/main.cpp:733). We treat a shape as
        # having normals iff every corner has one.
        has_all_normals = all(n is not None for n in shape.corner_normals)
        norm_arr = None
        if has_all_normals and f > 0:
            norm_arr = np.asarray(shape.corner_normals, np.float32).reshape(f, 3, 3)
            lengths = np.linalg.norm(norm_arr, axis=-1, keepdims=True)
            norm_arr = norm_arr / np.maximum(lengths, 1e-30)  # :88 normalize

        has_all_uv = all(t is not None for t in shape.corner_uvs)
        uv_arr = None
        if has_all_uv and f > 0:
            uv_arr = np.asarray(shape.corner_uvs, np.float32).reshape(f, 3, 2)

        material = materials.get(shape.material_name, _DEFAULT_MATERIAL)
        if shape.material_name is not None and shape.material_name not in materials:
            logger.warning("material %r not found; using default", shape.material_name)

        meshes.append(
            MeshData(
                name=shape.name,
                vertices=verts,
                normals=norm_arr,
                uv=uv_arr,
                material=material,
            )
        )

    if not meshes:
        raise ValueError(f"No triangles loaded from {path}")
    return meshes
