"""Build the port's CUDA sources into C-ABI shared libraries at first use.

`load(name)` compiles `csrc/<name>.cu` with nvcc for sm_90a into
`build/torch_kernels/` at the repository root (named by a hash of the
sources and flags, so an edit rebuilds) and loads it with ctypes. The
ptxas report (registers, shared memory, spills) is kept beside the
library as `<name>-<hash>.log`. Nothing is built when a module is
imported, and nothing but the repository's own sources goes in.

Every source exports `<name>_error_string(int)`, and every entry point
returns cudaGetLastError(): `check_launch` raises on a refused launch.
`check_tensors` validates a wrapper's tensors before their pointers go
to the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# No -use_fast_math: the kernels need IEEE division.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. The kernels that share lane_plane.cuh's per-pair test
# round every product and sum on its own, as their plain PyTorch versions
# do: contracted FMAs moved last-ulp values that four bounces of
# reflections grew past the image bar. (rt_mxu's contraction calls fmaf
# explicitly, which the flag leaves alone.) The Adam update is held bit for
# bit to PyTorch's tensor operations, which contract nothing across them.
SOURCE_FLAGS = {name: ["-fmad=false"] for name in ("lane", "fused", "rt_tile", "rt_mxu", "adam")}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def lib_path(name: str) -> Path:
    """Where the library of csrc/<name>.cu, as the sources and flags stand, is built."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, [])).encode())
    for dep in sorted(CSRC.glob("*.cu*")):
        digest.update(dep.name.encode() + dep.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless an up-to-date library exists; returns its path."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, [])
    lib = lib_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    lib = ctypes.CDLL(str(build(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if an entry point of csrc/<name>.cu returned a CUDA error."""
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")


def check_tensors(want: dict, device) -> None:
    """Raise ValueError unless each {name: (tensor, dtype, shape)} lies on
    `device` with that dtype and shape, contiguous."""
    for name, (x, dtype, shape) in want.items():
        if x.device != device or x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: want {dtype} {tuple(shape)} on {device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
