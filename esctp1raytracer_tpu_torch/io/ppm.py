"""P3 (ASCII) PPM writer and reader, byte-compatible with the reference.

Counterpart of `esctp1raytracer_tpu/io/ppm.py`. The reference's writer
(src/main.cpp:658-689): header "P3\\nW H\\n255", rows emitted h = H-1 .. 0,
each channel clamped to 1.0 then scaled by 255 and *truncated* to int,
one "r g b\\n" triplet per line. The writers take a numpy array or a
tensor on any device; the reader serves golden-image comparisons.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(image) -> np.ndarray:
    if isinstance(image, torch.Tensor):
        return image.detach().cpu().numpy()
    return np.asarray(image)


def write_ppm(path: str, image) -> None:
    """Write image [H, W, 3] float (row h = framebuffer row h) as P3 PPM.

    Uses the native C++ writer (native/ppm.cpp) when it builds,
    byte-identical to `write_ppm_python`, which it falls back to otherwise."""
    from esctp1raytracer_tpu_torch.io.native_ppm import write_ppm_native

    image = _host(image)
    if not write_ppm_native(path, image):
        write_ppm_python(path, image)


def write_ppm_python(path: str, image) -> None:
    """The pure-Python writer (the parity oracle of the native one)."""
    image = _host(image)
    h, w, _ = image.shape
    # Clamp only the top end, like the reference (no negative colors occur).
    clamped = np.minimum(image.astype(np.float32), 1.0)
    values = (clamped * 255.0).astype(np.int32)  # C-style truncation
    flipped = values[::-1]  # rows h = H-1 .. 0
    with open(path, "w") as fh:
        fh.write(f"P3\n{w} {h}\n255\n")
        flat = flipped.reshape(-1, 3)
        fh.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        fh.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back into float [H, W, 3] in framebuffer row order
    (row 0 = bottom row, inverting the writer's flip), values in [0, 1]."""
    with open(path, "r") as fh:
        tokens = []
        for line in fh:
            line = line.split("#", 1)[0]
            tokens.extend(line.split())
    if tokens[0] != "P3":
        raise ValueError(f"not a P3 PPM: {path}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4 : 4 + w * h * 3], np.float32).reshape(h, w, 3)
    return data[::-1] / float(maxval)
