#!/usr/bin/env python
"""Generate the pinned golden-pixel grid from the PyTorch port.

Counterpart of scripts/make_golden_pixels.py, on the port's own oracle
(`esctp1raytracer_tpu_torch.testing.oracle_render`, scalar NumPy, seed 0)
and the port's `jnp` render, with the same rule: across the
canonical 48x36 Cornell view, keep the pixels whose 3x3 neighborhood is
flat (per-channel peak-to-peak < 0.02: no eps-window or silhouette
boundary can move them) and where the render agrees with the oracle to
1e-5, then walk a lattice (step 4, 3, 2, 1) until at least 64 survive.
The grid pins the whole shading path; tests/test_torch_scripts.py holds
this script's output equal to tests/golden/cornell_pixels_48x36.npz.

The render runs on the card unless --device cpu is given; the oracle runs
on the host, and the pinned values are the oracle's. The device only
decides which pixels pass the 1e-5 agreement gate, so a run on the card
reproduces the committed grid wherever the card's render agrees with the
oracle on the same pixels as the CPU's does (chip_smoke.py holds it).

Writes {rows, cols, rgb} to --out (default build/cornell_pixels_48x36.npz;
never into tests/golden/). Deterministic: re-running reproduces the file.

Usage: python scripts/make_golden_pixels_torch.py [--out PATH] [--device cpu]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import os  # noqa: E402

import numpy as np  # noqa: E402

from esctp1raytracer_tpu_torch import Camera, RenderConfig, cornell_box, render  # noqa: E402
from esctp1raytracer_tpu_torch.testing import oracle_render  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402

W, H = 48, 36
FLAT_TOL = 0.02    # 3x3 neighborhood peak-to-peak ceiling (per channel)
AGREE_TOL = 1e-5   # oracle-vs-jnp ceiling for a pixel to be pinnable
TARGET = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def golden_grid(device="cuda"):
    """(rows, cols, rgb, lattice step) of the pinned pixels, the render on `device`."""
    scene = cornell_box(device=device)
    ref = oracle_render(scene, (0, 1, 2), (0, 1, 0), W, H)
    cam = Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=W / H, device=device)
    img = render(scene, cam, W, H, RenderConfig(backend="jnp", seed=0)).cpu().numpy()

    diff = np.abs(ref - img).max(-1)
    print(f"oracle vs jnp: max|diff| {diff.max():.2e}, "
          f"frac<=1e-5 {(diff <= AGREE_TOL).mean():.4f}")

    # Flatness: per-channel peak-to-peak over the 3x3 neighborhood.
    flat = np.zeros((H, W), bool)
    for r in range(1, H - 1):
        for c in range(1, W - 1):
            nb = ref[r - 1:r + 2, c - 1:c + 2]
            if (nb.max((0, 1)) - nb.min((0, 1))).max() < FLAT_TOL:
                flat[r, c] = True

    good = flat & (diff <= AGREE_TOL)
    print(f"candidate pixels: {good.sum()} of {H * W}")

    # Walk a lattice, densifying until >= TARGET pixels survive the filter.
    rows, cols = [], []
    for step in (4, 3, 2, 1):
        rows, cols = [], []
        for r in range(1, H - 1, step):
            for c in range(1, W - 1, step):
                if good[r, c]:
                    rows.append(r)
                    cols.append(c)
        if len(rows) >= TARGET:
            break
    if len(rows) < TARGET:
        raise SystemExit(f"only {len(rows)} pinnable pixels")
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    return rows, cols, ref[rows, cols].astype(np.float32), step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "build", "cornell_pixels_48x36.npz"))
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES)
    args = ap.parse_args(argv)
    dev.require(args.device)
    rows, cols, rgb, step = golden_grid(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, rows=rows, cols=cols, rgb=rgb)
    print(f"pinned {len(rows)} pixels (lattice step {step}) -> {args.out}")
    print(f"coverage: rows {rows.min()}-{rows.max()}, cols {cols.min()}-{cols.max()}, "
          f"lit fraction {(rgb.max(-1) > 0.01).mean():.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
