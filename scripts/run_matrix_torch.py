#!/usr/bin/env python
"""Strategy-matrix runner of the PyTorch / CUDA port — the reference's
scripts/run.sh, framework-side.

Counterpart of scripts/run_matrix.py: renders the canonical Cornell
workload once per execution strategy {sequential(jnp), --thread(sharded),
--bvh(mxu), --ispc(auto)}, writes output<suffix>.ppm files, prints the
per-strategy timing table, and cross-checks the images against each
other (a strategy matches when fewer than 0.5% of its pixels differ from
the first strategy's by more than 1e-3). The same flags, the same
RUN_MATRIX_STRATEGIES filter and the same JSON keys, plus `--device`
(the card unless `--device cpu`) and, per strategy, the kernel wrappers'
launch counts over its first call.

The thread legs render through `render_sharded` on `make_mesh()` after
`init_distributed()`: under torchrun the world's ranks, else a one-rank
mesh. Each call is timed on the host clock up to a `torch.cuda.synchronize()`.

`--golden` renders light_mode="reference_cpp" at the golden image's full
size (4 seeds averaged, shadow_eps = float epsilon: the reference's own
self-shadow back-off), on the default backend (jnp) as the JAX script
does, in 262,144-ray chunks (the counter RNG makes the image
chunk-independent), and holds the mean to the bars of
tests/test_golden.py at full resolution: the median 8x8-patch difference
< 0.03, more than 0.9 of the patches < 0.12, |mean difference| < 0.02.

Usage: python scripts/run_matrix_torch.py [--out DIR] [--size WxH] [--scene ...]
       [--golden tests/golden/cornell_cpp_mean.npz] [--json PATH] [--device cpu]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from esctp1raytracer_tpu_torch import Camera, RenderConfig, render, write_ppm  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches  # noqa: E402
from esctp1raytracer_tpu_torch.parallel import (  # noqa: E402
    init_distributed, make_mesh, render_sharded,
)
from esctp1raytracer_tpu_torch.scene.builders import CORNELL_VARIANTS, cornell_variant  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402

STRATEGIES = [
    # (suffix, backend, sharded) — one row per reference strategy
    # (scripts/run.sh:36-41: none, --thread, --bvh, --bvh --thread, --ispc),
    # same mapping as the CLI strategy flags (cli.py:main).
    ("sequential", "jnp", False),
    ("thread", "auto", True),   # best kernel, sharded over the rank mesh
    ("bvh", "mxu", False),
    ("bvh_thread", "auto", True),  # accelerated search + sharded rays
    ("ispc", "auto", False),  # auto: fused/lane/mxtile/tile by scene shape
]
CHUNK = 262144  # rays per chunk of the tensor-op routes' broadcast search
GOLDEN_SEEDS = 4


def golden_leg(path, scene, cam, device):
    """The 4-seed reference_cpp mean at the golden's size against the
    golden image: the statistics, with "pass" by tests/test_golden.py's bars."""
    data = np.load(path)
    gold = data["image"].astype(np.float32) / 255.0
    gh, gw, _ = gold.shape
    acc = []
    dev.synchronize(device)
    t0 = time.perf_counter()
    for seed in range(GOLDEN_SEEDS):
        gcfg = RenderConfig(light_mode="reference_cpp", seed=seed, shadow_eps=1.1920929e-07,
                            ray_chunk=CHUNK)
        gimg = render(scene, cam, gw, gh, gcfg).cpu().numpy()
        acc.append(np.minimum(gimg, 1.0))
    golden_ms = (time.perf_counter() - t0) * 1e3
    mine = np.mean(acc, axis=0)

    def patches(a):
        h, w, _ = a.shape
        return a[: h - h % 8, : w - w % 8].reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3))

    pd = np.abs(patches(gold) - patches(mine)).max(-1)
    px = np.abs(gold - mine).max(-1)
    stats = {
        "golden": os.path.basename(path),
        "size": f"{gw}x{gh}",
        "seeds_averaged": GOLDEN_SEEDS,
        "render_4seed_ms": golden_ms,
        "mean_lum_delta": float(abs(mine.mean() - gold.mean())),
        "mean_abs_diff": float(px.mean()),
        "patch8_median": float(np.median(pd)),
        "patch8_frac_lt_0.12": float((pd < 0.12).mean()),
        "pixel_flip_frac_gt_0.1": float((px > 0.1).mean()),
    }
    stats["pass"] = bool(stats["patch8_median"] < 0.03 and stats["patch8_frac_lt_0.12"] > 0.9
                         and stats["mean_lum_delta"] < 0.02)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="output/plain")
    ap.add_argument("--size", default="1024x768")
    ap.add_argument("--eye", default="0,1,2")
    ap.add_argument("--look", default="0,1,0")
    ap.add_argument("--scene", default="original", choices=CORNELL_VARIANTS,
                    help="Cornell model variant (src/models/cornell/*)")
    ap.add_argument("--depth", type=int, default=1, help="Whitted reflection bounces")
    ap.add_argument("--json", default="",
                    help="also write the strategy table as JSON")
    ap.add_argument("--golden", default="",
                    help="path to tests/golden/cornell_cpp_mean.npz: render "
                         "light_mode=reference_cpp at FULL size (4 seeds averaged) and "
                         "record the diff statistics vs the reference binary's mean image")
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES,
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)
    dev.require(args.device)
    device = args.device
    width, height = (int(x) for x in args.size.split("x"))
    eye = tuple(float(x) for x in args.eye.split(","))
    look = tuple(float(x) for x in args.look.split(","))

    os.makedirs(args.out, exist_ok=True)
    scene = cornell_variant(args.scene, device=device)
    cam = Camera.look_at(eye, look, vfov=60.0, aspect=width / height, device=device)
    init_distributed()
    mesh = make_mesh()

    # RUN_MATRIX_STRATEGIES=sequential,ispc limits the legs (smoke tests,
    # quick iterations); default = all five reference strategies.
    strategies = STRATEGIES
    env_filter = os.environ.get("RUN_MATRIX_STRATEGIES")
    if env_filter:
        keep = {s.strip() for s in env_filter.split(",")}
        strategies = [s for s in STRATEGIES if s[0] in keep]

    images = {}
    table_rows = []
    print(f"{'strategy':<12} {'backend':<8} {'first(ms)':>10} {'steady(ms)':>11} {'Mrays/s':>9}")
    for suffix, backend, sharded in strategies:
        # The tensor-op routes bound their broadcast intermediates by
        # chunking (mxu too at depth > 1); the kernel routes run unchunked.
        chunk = CHUNK if (backend == "jnp" or (backend == "mxu" and args.depth > 1)) else 0
        cfg = RenderConfig(backend=backend, ray_chunk=chunk, depth=args.depth)

        def go(k=0):
            # k > 0 nudges the camera origin by k * 1e-6 scene units, so no
            # two timed calls render the same rays.
            c = cam if not k else dataclasses.replace(cam, origin=cam.origin + k * 1e-6)
            if sharded:
                return render_sharded(scene, c, width, height, cfg, mesh)
            return render(scene, c, width, height, cfg)

        def timed(k):
            dev.synchronize(device)
            t0 = time.perf_counter()
            im = go(k)
            dev.synchronize(device)
            return im, (time.perf_counter() - t0) * 1e3

        launches.reset()
        img, first = timed(0)
        counts = launches.read()
        steady = min(timed(k)[1] for k in (1, 2, 3))
        mrays = width * height / (steady / 1e3) / 1e6
        print(f"{suffix:<12} {backend:<8} {first:>10.1f} {steady:>11.1f} {mrays:>9.2f}")
        table_rows.append((suffix, backend, first, steady, mrays, counts))
        arr = img.cpu().numpy()
        images[suffix] = arr
        write_ppm(os.path.join(args.out, f"output{suffix}.ppm"), arr)

    # Cross-strategy comparison (same seed -> near-identical images;
    # borderline eps-window pixels may flip between backends).
    base_name = strategies[0][0]
    base = images[base_name]
    ok = True
    flips_by = {}
    for suffix, arr in images.items():
        if suffix == base_name:
            continue
        diff = np.abs(arr - base).max(-1)
        flips = float((diff > 1e-3).mean())
        flips_by[suffix] = flips
        status = "OK" if flips < 0.005 else "MISMATCH"
        ok &= flips < 0.005
        print(f"  {suffix:<10} vs {base_name}: {flips*100:.3f}% pixels differ -> {status}")
    golden_stats = None
    if args.golden:
        golden_stats = golden_leg(args.golden, scene, cam, device)
        print("golden vs reference_cpp (full res):",
              " ".join(f"{k}={v}" for k, v in golden_stats.items()
                       if k not in ("golden", "size")))
        ok &= golden_stats["pass"]

    if args.json:
        rec = {
            "workload": {"scene": f"cornell_{args.scene}" if args.scene != "original"
                         else "cornell", "size": args.size, "eye": args.eye,
                         "look": args.look, "depth": args.depth},
            "backend_platform": "gpu" if device == "cuda" else "cpu",
            "device_kind": dev.kind(device),
            "card": dev.card(device),
            "host": platform.node(),
            "strategies": [
                {"strategy": s, "backend": b, "first_ms": f, "steady_ms": st,
                 "mrays_per_s": m, "launches": c}
                for s, b, f, st, m, c in table_rows
            ],
            "cross_check_flip_frac": flips_by,
            "all_match": bool(ok),
        }
        if golden_stats is not None:
            rec["golden_vs_reference"] = golden_stats
        with open(args.json, "w") as fh:
            json.dump(rec, fh, indent=1)
        print(f"wrote {args.json}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
