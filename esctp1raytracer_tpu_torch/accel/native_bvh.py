"""ctypes binding for the native BVH builder (native/bvh.cpp).

Counterpart of `esctp1raytracer_tpu/accel/native_bvh.py`, built on demand
by `utils/nativebuild.py`. Its nodes equal the numpy builder's
(tests/test_torch_accel.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from esctp1raytracer_tpu_torch.utils.nativebuild import NativeLibrary, last_build_error


def _declare(lib: ctypes.CDLL) -> None:
    fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.esc_bvh_build.restype = ctypes.c_void_p
    lib.esc_bvh_build.argtypes = [fptr, ctypes.c_int32, ctypes.c_int32]
    lib.esc_bvh_num_nodes.restype = ctypes.c_int32
    lib.esc_bvh_num_nodes.argtypes = [ctypes.c_void_p]
    lib.esc_bvh_fetch.restype = None
    lib.esc_bvh_fetch.argtypes = [ctypes.c_void_p, fptr, fptr, iptr, iptr, iptr, iptr, iptr]
    lib.esc_bvh_free.restype = None
    lib.esc_bvh_free.argtypes = [ctypes.c_void_p]


_LIB = NativeLibrary("bvh", _declare)


def native_bvh_available() -> bool:
    return _LIB.get() is not None


def build_bvh_native(verts: np.ndarray, orig_idx: np.ndarray, leaf_size: int):
    """BVH over verts [N, 3, 3] (orig_idx: their triangle indices) from the C++ builder."""
    from esctp1raytracer_tpu_torch.accel.bvh import BVH

    lib = _LIB.get()
    if lib is None:
        raise RuntimeError(f"native BVH unavailable: {last_build_error() or 'unknown'}")
    n = verts.shape[0]
    flat = np.ascontiguousarray(verts.reshape(n * 9), np.float32)
    handle = lib.esc_bvh_build(flat, n, leaf_size)
    try:
        m = lib.esc_bvh_num_nodes(handle)
        bmin = np.empty(m * 3, np.float32)
        bmax = np.empty(m * 3, np.float32)
        left, right, start, count = (np.empty(m, np.int32) for _ in range(4))
        order = np.empty(n, np.int32)
        lib.esc_bvh_fetch(handle, bmin, bmax, left, right, start, count, order)
    finally:
        lib.esc_bvh_free(handle)
    return BVH(bmin=bmin.reshape(m, 3), bmax=bmax.reshape(m, 3), left=left, right=right,
               start=start, count=count, order=orig_idx[order], verts=verts[order])
