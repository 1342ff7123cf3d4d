"""JSON material overrides — the reference's abandoned `.mat` experiment,
working. Counterpart of `esctp1raytracer_tpu/scene/matjson.py`.

The reference ships `cornell_box.mat` (a JSON principled-material file)
next to its OBJ, with the loader commented out
(src/scene/sceneloader.cpp:108-146, model::getMaterial). Here the
capability exists, for both schemas:

* Phong fields directly: `{material_name: {ka/kd/ks/ke: [r,g,b], ns: f}}`.
* The reference's typed schema (src/models/cornell_box.mat): a `Type`
  field selects `principled` (baseColor/metallic/diffuse/specular),
  `alloy` (color/edgeColor/roughness), `luminous` (color), or
  `thinGlass` (eta/attenuationColor/attenuationDistance/thickness),
  each mapped onto the renderer's Phong material (mapping documented per
  converter below). Unknown types/fields warn and are ignored.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np

from esctp1raytracer_tpu_torch.scene.objloader import load_obj
from esctp1raytracer_tpu_torch.scene.types import Material, MeshData
from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)

_FIELDS = ("ka", "kd", "ks", "ke", "ns")


def _vec(fields: dict, key: str, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    return np.asarray(fields.get(key, default), np.float32).reshape(3)


def _roughness_to_ns(roughness: float) -> float:
    # Beckmann-roughness -> Blinn-Phong exponent (standard 2/a^2 - 2 map).
    a = max(float(roughness), 1e-3)
    return max(2.0 / (a * a) - 2.0, 2.0)


def _typed_to_phong(name: str, typ: str, fields: dict) -> dict:
    """Map one reference typed material onto Phong ka/kd/ks/ke/ns.

    These are capability mappings, not BSDF-exact: the renderer is a
    Whitted Phong tracer, so metals become tinted speculars, luminous
    becomes ke, and thinGlass (no refraction path) becomes a strong
    specular with the attenuation color as the diffuse tint (warned).
    """
    if typ == "principled":
        base = _vec(fields, "baseColor", (1.0, 1.0, 1.0))
        diffuse = float(fields.get("diffuse", 1.0))
        specular = float(fields.get("specular", 0.0))
        metallic = float(fields.get("metallic", 0.0))
        kd = base * diffuse * (1.0 - metallic)
        # metallic tints the highlight with the base color
        ks = (np.float32(specular) * ((1.0 - metallic) * np.ones(3, np.float32)
                                      + metallic * base))
        ns = _roughness_to_ns(fields.get("roughness", 0.25))
        return {"ka": kd, "kd": kd, "ks": ks.astype(np.float32), "ns": ns}
    if typ == "alloy":
        color = _vec(fields, "color", (1.0, 1.0, 1.0))
        edge = _vec(fields, "edgeColor", color)
        ks = ((color + edge) * 0.5).astype(np.float32)  # grazing/normal mix
        ns = _roughness_to_ns(fields.get("roughness", 0.1))
        dark = np.asarray((0.01, 0.01, 0.01), np.float32)
        return {"ka": dark, "kd": dark, "ks": ks, "ns": ns}
    if typ == "luminous":
        color = _vec(fields, "color", (1.0, 1.0, 1.0))
        power = float(fields.get("power", 1.0))
        return {"ke": (color * power).astype(np.float32)}
    if typ == "thinglass":
        logger.warning(
            "material %r: thinGlass has no refraction path in the Whitted "
            "tracer; mapping to a specular surface", name)
        atten = _vec(fields, "attenuationColor", (1.0, 1.0, 1.0))
        return {"ka": atten * 0.05, "kd": atten * 0.05,
                "ks": np.asarray((0.9, 0.9, 0.9), np.float32), "ns": 500.0}
    logger.warning("material %r: unknown Type %r ignored", name, typ)
    return {}


def load_material_overrides(path: str) -> Dict[str, dict]:
    with open(path) as fh:
        data = json.load(fh)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: expected a JSON object of materials")
    out: Dict[str, dict] = {}
    for name, fields in data.items():
        if not isinstance(fields, dict):
            raise ValueError(f"{path}: material {name!r} must be an object")
        lowered = {k.lower(): k for k in fields}
        if "type" in lowered:
            typ = str(fields[lowered["type"]]).lower()
            out[name] = _typed_to_phong(name, typ, {
                k: v for k, v in fields.items() if k.lower() != "type"
            })
            continue
        override = {}
        for key, value in fields.items():
            lower = key.lower()
            if lower in ("ka", "kd", "ks", "ke"):
                vec = np.asarray(value, np.float32).reshape(3)
                override[lower] = vec
            elif lower == "ns":
                override["ns"] = float(value)
        out[name] = override
    return out


def apply_material_overrides(
    meshes: Sequence[MeshData], overrides: Dict[str, dict],
    by: str = "name",
) -> List[MeshData]:
    """Return meshes with materials overridden by shape name."""
    used = set()
    result = []
    for mesh in meshes:
        override = overrides.get(mesh.name)
        if override:
            used.add(mesh.name)
            mat = mesh.material
            new = Material(
                ka=override.get("ka", mat.ka), kd=override.get("kd", mat.kd),
                ks=override.get("ks", mat.ks), ke=override.get("ke", mat.ke),
                ns=override.get("ns", mat.ns),
            )
            mesh = dataclasses.replace(mesh, material=new)
        result.append(mesh)
    for name in set(overrides) - used:
        logger.warning("material override %r matched no shape", name)
    return result


def load_obj_with_mat(obj_path: str) -> List[MeshData]:
    """Load an OBJ and apply a sibling `<model>.mat` JSON if present —
    the file-layout convention the reference set up
    (src/scene/sceneloader.cpp:21-22)."""
    meshes = load_obj(obj_path)
    mat_path = os.path.splitext(obj_path)[0] + ".mat"
    if os.path.exists(mat_path):
        meshes = apply_material_overrides(meshes, load_material_overrides(mat_path))
    return meshes
