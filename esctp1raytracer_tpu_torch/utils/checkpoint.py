"""Checkpoint/resume for optimized scene parameters.

Counterpart of `esctp1raytracer_tpu/utils/checkpoint.py`, in its file
format key for key: a compressed npz holding `__version__`,
`__num_leaves__`, `__step__`, `leaf_{i}` for every scene leaf in the JAX
package's leaf order (`Scene.leaves()`: dataclass field order) and
`extra_{key}` for each optimizer array. A checkpoint written by either
package loads in the other, optimizer state included.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from esctp1raytracer_tpu_torch.scene.types import Scene

_FORMAT_VERSION = 1


def _host(value: Any) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array-like."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_checkpoint(path: str, scene: Scene, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Save all scene arrays (+ optional optimizer arrays) atomically."""
    leaves = [t for _, t in scene.leaves()]
    payload = {
        "__version__": np.int64(_FORMAT_VERSION),
        "__num_leaves__": np.int64(len(leaves)),
        "__step__": np.int64(step),
    }
    for i, leaf in enumerate(leaves):
        payload[f"leaf_{i}"] = _host(leaf)
    for key, value in (extra or {}).items():
        payload[f"extra_{key}"] = _host(value)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, template: Scene) -> Tuple[Scene, int, Dict[str, np.ndarray]]:
    """Restore a scene (shapes validated against `template`; each leaf with
    the template leaf's dtype, on its device), the step counter, and any
    extra arrays (as numpy)."""
    with np.load(path) as data:
        version = int(data["__version__"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"checkpoint version {version} != {_FORMAT_VERSION}")
        leaves = template.leaves()
        num = int(data["__num_leaves__"])
        if num != len(leaves):
            raise ValueError(
                f"checkpoint has {num} leaves; template has {len(leaves)} "
                "(different scene structure)"
            )
        arrays = {}
        for i, (name, leaf) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {arr.shape} != scene {tuple(leaf.shape)}"
                )
            arrays[name] = arr
        extra = {
            key[len("extra_"):]: data[key]
            for key in data.files if key.startswith("extra_")
        }
        scene = template.map(lambda name, leaf: torch.as_tensor(
            arrays[name], device=leaf.device).to(leaf.dtype))
        # The sphere slots in use, read from the loaded mask on the host.
        scene = dataclasses.replace(scene, spheres=scene.spheres.occupy(arrays["spheres.valid"]))
        return scene, int(data["__step__"]), extra
