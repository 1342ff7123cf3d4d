#!/usr/bin/env python
"""BASELINE.json config matrix benchmark of the PyTorch / CUDA port.

Counterpart of scripts/bench_configs.py: the same five configs (names,
builders, eyes, sizes, depths), the same command line, and one JSON line
per config: forward ms, forward+backward ms, rays/s, the backend
`resolve_backend` picks, and the device. It adds the card's name and
power limit (nvidia-smi), each leg's peak device memory, and the launch
counts of the kernel wrappers over one forward and one fwd+bwd.

  1. sphere+plane        256x256   depth 1
  2. 10-sphere + shadows 512x512   depth 2
  3. ~10k-tri mesh       1920x1080 depth 1
  4. mixed sphere+mesh   1920x1080 depth 4 (differentiable)
  5. 100k-tri soup       3840x2160 depth 1

Each config traces the whole frame as one wavefront through `trace_rays`:
the forward loss is sum(color^2), the backward the gradient of sum(color)
with respect to every float scene leaf. (The JAX script splits giant
frames into host-level slices, a workaround for a TPU watchdog; the card
runs config 5's 8.3M rays whole.) Times come from CUDA events over warm
calls, best of 2 batches of 2 calls, the ray ids moved on by a frame's
rays per call so no two calls draw the same light samples.

Usage: python scripts/bench_configs_torch.py [name] [--json=PATH] [--device cpu]
  (no name: every config in a subprocess of its own; --device cpu for tests,
  at small sizes through run_config)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from esctp1raytracer_tpu_torch import Camera, RenderConfig  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import resolve_backend, trace_rays  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402
from esctp1raytracer_tpu_torch.utils.timing import elapsed_ms  # noqa: E402

CONFIGS = [
    ("sphere_plane_256", builders.sphere_plane_scene, (0, 2, 6), 256, 256, 1),
    ("ten_sphere_512", builders.ten_sphere_scene, (0, 4, 8), 512, 512, 2),
    ("mesh10k_1080p", lambda device: builders.mesh_scene(4, device=device), (0, 2, 6),
     1920, 1080, 1),
    ("mixed_1080p_d4", builders.mixed_scene, (0, 2.5, 7), 1920, 1080, 4),
    ("soup100k_4k", lambda device: builders.random_scene(100_000, device=device),
     (0, 18, 45), 3840, 2160, 1),
]


ITERS, BATCHES = 2, 2  # timed calls per batch, batches (the best batch counts)


def run_config(name, make_scene, eye, width, height, depth, backward=True, device="cuda"):
    """Bench one config on `device`; prints and returns its JSON record."""
    dev.require(device)
    scene = make_scene(device=device)
    cam = Camera.look_at(eye, (0, 1, 0), vfov=60.0, aspect=width / height, device=device)
    backend = os.environ.get("ESCTP_BENCH_BACKEND", "auto")
    cfg = RenderConfig(backend=backend, depth=depth, ray_chunk=0)
    o, d = cam.ray_grid(width, height)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    rays = o.shape[0]
    ids = torch.arange(rays, dtype=torch.int64, device=device)
    base = float_params(scene)
    calls = [0]

    def next_ids():
        # A frame's rays further along the id stream per call: new light draws.
        calls[0] += 1
        return ids + calls[0] * rays

    def fwd():
        with torch.no_grad():
            return torch.sum(trace_rays(o, d, merge_params(scene, base), next_ids(), cfg) ** 2)

    def bwd():
        params = [p.detach().requires_grad_(True) for p in base]
        loss = torch.sum(trace_rays(o, d, merge_params(scene, params), next_ids(), cfg))
        return torch.autograd.grad(loss, params, allow_unused=True)

    def timeit(fn):
        fn()  # warm
        best = float("inf")
        for _ in range(BATCHES):
            best = min(best, elapsed_ms(fn, device, ITERS))
        return best

    loss, fwd_launches = launches.counted(fwd)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError(f"{name}: the forward loss is {loss.item()}")
    dev.reset_peak(device)
    dt_f = timeit(fwd)
    record = {
        "config": name, "rays": rays, "tris": scene.num_triangles,
        "depth": depth, "backend": resolve_backend(cfg, scene),
        "device": dev.kind(device), "card": dev.card(device),
        "forward_ms": dt_f,
        "forward_rays_per_s": rays / (dt_f / 1e3),
        "forward_peak_gib": dev.peak_gib(device),
        "launches": {"forward": fwd_launches},
    }
    if backward:
        grads, bwd_launches = launches.counted(bwd)
        if not all(g is None or bool(torch.isfinite(g).all()) for g in grads):
            raise RuntimeError(f"{name}: a gradient is not finite")
        dev.reset_peak(device)
        dt_b = timeit(bwd)
        record["fwd_bwd_ms"] = dt_b
        record["fwd_bwd_rays_per_s"] = rays / (dt_b / 1e3)
        record["fwd_bwd_peak_gib"] = dev.peak_gib(device)
        record["launches"]["fwd_bwd"] = bwd_launches
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", help="run the configs whose name holds this, in process")
    ap.add_argument("--json", help="write every config's record to this file")
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES)
    args = ap.parse_args(argv)
    device, json_path, only = args.device, args.json, args.name
    dev.require(device)
    if only is None:
        # One subprocess per config: each config's timings and peak memory
        # start from a fresh process and allocator.
        lines, failed = [], []
        for name, *_ in CONFIGS:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), name, "--device", device],
                check=False, capture_output=True, text=True)
            sys.stderr.write(proc.stderr)
            sys.stdout.write(proc.stdout)
            sys.stdout.flush()
            if proc.returncode != 0:
                failed.append((name, proc.returncode))
            lines += [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if failed:
            raise SystemExit(f"bench_configs_torch: configs failed: {failed}")
        if json_path:
            records = [json.loads(ln) for ln in lines]
            with open(json_path, "w") as f:
                json.dump(records, f, indent=1)
                f.write("\n")
            print(f"# wrote {json_path} ({len(records)} configs)", file=sys.stderr)
        return 0
    matched = [c for c in CONFIGS if only in c[0]]
    if not matched:
        raise SystemExit(f"no config matches {only!r}")
    for name, make_scene, eye, w, h, depth in matched:
        run_config(name, make_scene, eye, w, h, depth, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
