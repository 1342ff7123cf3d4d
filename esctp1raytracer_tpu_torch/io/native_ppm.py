"""ctypes binding for the native PPM writer (native/ppm.cpp).

Counterpart of `esctp1raytracer_tpu/io/native_ppm.py`. The pure-Python
writer string-formats W*H lines (2M of them at 1920x1080); the native
one hand-formats the same bytes into a buffered stream. Built on demand
by `utils/nativebuild.py`; byte-identical output to `io/ppm.py`'s Python
writer is pinned by tests/test_torch_io.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from esctp1raytracer_tpu_torch.utils.nativebuild import NativeLibrary


def _declare(lib: ctypes.CDLL) -> None:
    lib.esc_write_ppm_p3.restype = ctypes.c_int
    lib.esc_write_ppm_p3.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_int, ctypes.c_int]


_LIB = NativeLibrary("ppm", _declare)


def native_available() -> bool:
    return _LIB.get() is not None


def write_ppm_native(path: str, image: np.ndarray) -> bool:
    """Write [H, W, 3] float via the native writer. False = unavailable
    (the caller falls back to the Python writer); raises on an IO error."""
    lib = _LIB.get()
    if lib is None:
        return False
    img = np.ascontiguousarray(np.asarray(image), dtype=np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an [H, W, 3] image, got shape {img.shape}")
    h, w, _ = img.shape
    rc = lib.esc_write_ppm_p3(str(path).encode(),
                              img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), int(w), int(h))
    if rc != 0:
        raise OSError(f"native ppm writer failed with code {rc} for {path}")
    return True
