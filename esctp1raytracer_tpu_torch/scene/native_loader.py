"""ctypes binding for the native C++ OBJ loader (native/objloader.cpp).

Counterpart of `esctp1raytracer_tpu/scene/native_loader.py`: a compiled
loader for production-scale assets, built on demand by
`utils/nativebuild.py`. The pure-Python loader (scene/objloader.py) has
the same semantics (pinned by tests/test_torch_io.py).
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from esctp1raytracer_tpu_torch.scene.types import Material, MeshData
from esctp1raytracer_tpu_torch.utils.debug import get_logger
from esctp1raytracer_tpu_torch.utils.nativebuild import NativeLibrary, last_build_error

logger = get_logger(__name__)


def _declare(lib: ctypes.CDLL) -> None:
    handle, i32 = ctypes.c_void_p, ctypes.c_int32
    fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    signatures = {
        "esc_load_obj": (handle, [ctypes.c_char_p]),
        "esc_error": (ctypes.c_char_p, [handle]),
        "esc_num_shapes": (i32, [handle]),
        "esc_shape_faces": (i32, [handle, i32]),
        "esc_shape_name": (ctypes.c_char_p, [handle, i32]),
        "esc_shape_has_normals": (i32, [handle, i32]),
        "esc_shape_has_uvs": (i32, [handle, i32]),
        "esc_shape_vertices": (None, [handle, i32, fptr]),
        "esc_shape_normals": (None, [handle, i32, fptr]),
        "esc_shape_uvs": (None, [handle, i32, fptr]),
        "esc_shape_material": (i32, [handle, i32, fptr]),
        "esc_free": (None, [handle]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


_LIB = NativeLibrary("objloader", _declare)


def native_available() -> bool:
    return _LIB.get() is not None


def load_obj_native(path: str) -> List[MeshData]:
    """Load an OBJ with the C++ parser; raises like the Python loader."""
    lib = _LIB.get()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {last_build_error() or 'unknown'}")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    handle = lib.esc_load_obj(str(path).encode())
    try:
        err = lib.esc_error(handle)
        if err:
            raise ValueError(err.decode())
        meshes: List[MeshData] = []
        for s in range(lib.esc_num_shapes(handle)):
            faces = lib.esc_shape_faces(handle, s)
            name = lib.esc_shape_name(handle, s).decode()
            verts = np.empty(faces * 9, np.float32)
            lib.esc_shape_vertices(handle, s, verts)
            normals = None
            if lib.esc_shape_has_normals(handle, s):
                normals = np.empty(faces * 9, np.float32)
                lib.esc_shape_normals(handle, s, normals)
                normals = normals.reshape(faces, 3, 3)
            uv = None
            if lib.esc_shape_has_uvs(handle, s):
                uv = np.empty(faces * 6, np.float32)
                lib.esc_shape_uvs(handle, s, uv)
                uv = uv.reshape(faces, 3, 2)
            mat = np.empty(13, np.float32)
            if not lib.esc_shape_material(handle, s, mat):
                logger.warning("material for shape %r not found; using default", name)
            material = Material(ka=mat[0:3].copy(), kd=mat[3:6].copy(), ks=mat[6:9].copy(),
                                ke=mat[9:12].copy(), ns=float(mat[12]))
            meshes.append(MeshData(name=name, vertices=verts.reshape(faces, 3, 3),
                                   normals=normals, uv=uv, material=material))
        return meshes
    finally:
        lib.esc_free(handle)
