"""Build-on-demand helper for the port's host C++ components (`native/`).

Counterpart of `esctp1raytracer_tpu/utils/nativebuild.py`. Each small
ctypes library (the OBJ loader, the PPM writer, the BVH builder) is
compiled with g++ at first use, from the port's own copy of its source,
into `build/torch_native/` at the repository root under a name that hashes
the source and the flags, so an edit rebuilds (as `kernels/_build.py`
does for the CUDA kernels). The flags are plain `-O3`, without
`-march=native`: a library built for one host's CPU could fault on another
that shares the checkout, and contracted FMAs would make the loader's
normals depend on the host. The last failure is kept so a caller can say
why a native path is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
FLAGS = ["-O3", "-shared", "-fPIC"]

_last_error: str = ""


def last_build_error() -> str:
    """The most recent build failure description ('' if none)."""
    return _last_error


def build_shared(src: str, lib: str, timeout: float = 180.0) -> bool:
    """Compile ``src`` into shared library ``lib``; False (+recorded
    reason) on failure. Writes a temporary file and renames it, so a
    concurrent loader sees all of the library or none."""
    global _last_error
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, str(src), "-o", tmp], check=True, capture_output=True,
                       timeout=timeout)
        os.replace(tmp, lib)
        _last_error = ""
        return True
    except FileNotFoundError:
        _last_error = "g++ not found (toolchain absent)"
    except subprocess.SubprocessError as exc:
        stderr = getattr(exc, "stderr", b"") or b""
        if isinstance(stderr, bytes):
            stderr = stderr.decode(errors="replace")
        _last_error = f"{exc}: {stderr[-400:]}"
    if os.path.exists(tmp):
        os.remove(tmp)
    return False


def library_path(name: str) -> Path:
    """Where native/<name>.cpp builds: named by a hash of it and the flags."""
    src = NATIVE_DIR / f"{name}.cpp"
    digest = hashlib.sha256(" ".join(FLAGS).encode() + src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_shared(name: str) -> Optional[ctypes.CDLL]:
    """Build native/<name>.cpp unless its library exists, and load it; None
    (with `last_build_error()` saying why) when it cannot be built or loaded."""
    global _last_error
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if not build_shared(str(NATIVE_DIR / f"{name}.cpp"), str(lib)):
            return None
    try:
        return ctypes.CDLL(str(lib))
    except OSError as exc:
        _last_error = f"cannot load {lib}: {exc}"
        return None


class NativeLibrary:
    """native/<name>.cpp, built and loaded at first use (once, under a lock),
    its functions' ctypes signatures set by `declare(lib)`. `get()` is None
    when it cannot be built or loaded; the failure is logged once."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and not self._failed:
                lib = load_shared(self.name)
                if lib is None:
                    logger.warning("native %s unavailable (%s)", self.name, _last_error)
                    self._failed = True
                else:
                    self._declare(lib)
                    self._lib = lib
            return self._lib
