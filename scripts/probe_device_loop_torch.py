#!/usr/bin/env python
"""Per-frame time of the BASELINE configs and the flagship, on the card.

Counterpart of scripts/probe_device_loop.py: the same six configs (the
flagship is `bench_scene`, bench.py's scene), a forward mode and a
`--grad` mode (each frame computes the gradient of sum(color^2) with
respect to every float scene leaf and folds the gradients' squared norm
into the running scalar), and `--json=`.

Two numbers per config:
* `frame_ms`, the loop difference. The counterpart of the JAX probe's
  jitted `lax.fori_loop` is a loop of K frames captured as one CUDA graph
  (`utils/graphs.py`; the first call of each K runs eagerly, the second
  captures), frame i with its ray ids moved on by i * rays (new light
  draws each frame), the loop's start ids its input. The per-frame time is
  (T(K2) - T(K1)) / (K2 - K1) between CUDA events, best of 3 per K, with
  the JAX probe's (k1, k2) rule. The difference cancels the fixed cost of
  a call; a replay has no per-operation host dispatch left in it.
* `device_frame_ms`, a loop of one frame under torch.profiler
  (`utils.profiling.device_time`): the summed time of the device
  operations the frame ran, and the busy share of the profiled frame's
  wall time. This is the number with the host taken out.

Usage: python scripts/probe_device_loop_torch.py [name ...] [--grad] [--json=PATH]
  [--device cpu]   (names select configs by substring; --device cpu is for
  tests: the loop on the host clock, no profile)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from esctp1raytracer_tpu_torch import Camera, RenderConfig  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import resolve_backend, trace_rays  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402
from esctp1raytracer_tpu_torch.utils.graphs import graphed  # noqa: E402
from esctp1raytracer_tpu_torch.utils.profiling import device_time  # noqa: E402
from esctp1raytracer_tpu_torch.utils.timing import elapsed_ms  # noqa: E402

from bench_configs_torch import CONFIGS as BENCH_CONFIGS  # noqa: E402  (this directory)

# bench_configs_torch's five configs, with the flagship second, as in the JAX probe.
CONFIGS = [BENCH_CONFIGS[0],
           ("flagship_10k_1080p", builders.bench_scene, (0, 2, 6), 1920, 1080, 1),
           *BENCH_CONFIGS[1:]]


def loop_k(rays):
    """(k1, k2): small frames need a wide K spread, or the per-call jitter
    swamps the difference (the JAX probe's rule)."""
    return (1, 3) if rays > 1_000_000 else (2, 50)


def make_frame(scene, o, d, cfg, grad):
    """frame(ids) -> a scalar of the frame at ray ids `ids`: sum(color^2), or
    with `grad` the squared norm of its gradient with respect to every
    float leaf."""
    base = float_params(scene)

    def frame(ids):
        if not grad:
            with torch.no_grad():
                c = trace_rays(o, d, merge_params(scene, base), ids, cfg)
                return torch.sum(c * c)
        params = [p.detach().requires_grad_(True) for p in base]
        c = trace_rays(o, d, merge_params(scene, params), ids, cfg)
        gs = torch.autograd.grad(torch.sum(c * c), params, allow_unused=True)
        return sum(torch.sum(g * g) for g in gs if g is not None)

    return frame


def make_loop(frame, ids):
    """run(k) -> the sum of k frames' scalars, frame i at ids + (start + i) *
    rays, the start moving on by k per call; on the card one CUDA graph per
    k with the start ids its input (the JAX probe's fori_loop)."""
    rays = ids.shape[0]
    start = [0]

    @graphed(static_argnames=("k",))
    def loop(first, k):
        acc = torch.zeros((), device=first.device)
        for i in range(k):
            acc = acc + frame(first + i * rays)
        return acc

    def run(k):
        out = loop(ids + start[0] * rays, k)
        start[0] += k
        return out

    return run


def loop_ms(run, k1, k2, device, reps=3):
    """Per-frame ms from the K2-vs-K1 loop difference, and the raw loop ms."""
    ts = {}
    for k in (k1, k2):
        run(k)  # warm: eager
        run(k)  # on the card, the capture
        ts[k] = min(elapsed_ms(lambda: run(k), device) for _ in range(reps))
    return (ts[k2] - ts[k1]) / (k2 - k1), ts


def probe(name, make_scene, eye, w, h, depth, grad=False, device="cuda"):
    """One config's record (printed as a JSON line)."""
    dev.require(device)
    scene = make_scene(device=device)
    cam = Camera.look_at(eye, (0, 1, 0), vfov=60.0, aspect=w / h, device=device)
    o, d = cam.ray_grid(w, h)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    rays = o.shape[0]
    cfg = RenderConfig(backend="auto", depth=depth, ray_chunk=0)
    run = make_loop(make_frame(scene, o, d, cfg, grad),
                    torch.arange(rays, dtype=torch.int64, device=device))
    k1, k2 = loop_k(rays)
    ms, raw = loop_ms(run, k1, k2, device)
    rec = {"config": name, "rays": rays, "backend": resolve_backend(cfg, scene),
           "leg": "fwd+bwd" if grad else "fwd",
           "frame_ms": ms, "rays_per_s": rays / (ms / 1e3) if ms > 0 else None,
           "loop_k": [k1, k2], "raw_ms": {str(kk): v for kk, v in raw.items()},
           "device": dev.kind(device), "card": dev.card(device)}
    if device == "cuda" and k1 != 1:
        run(1)  # warm a loop of one frame: eager, then the capture
        run(1)
    launches.reset()
    if device == "cuda":
        prof = device_time(lambda: run(1))
        rec.update(device_frame_ms=prof["device_ms"], device_ops=prof["device_ops"],
                   profiled_wall_ms=prof["wall_ms"], busy_share=prof["busy_share"],
                   device_rays_per_s=rays / (prof["device_ms"] / 1e3))
    else:
        run(1)
        rec.update(device_frame_ms=None, device_ops=None, profiled_wall_ms=None,
                   busy_share=None, device_rays_per_s=None)
    rec["launches_per_frame"] = launches.read()
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="configs whose name holds one of these (default all)")
    ap.add_argument("--grad", action="store_true", help="fwd+bwd frames")
    ap.add_argument("--json", help="write the records to this file")
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES)
    args = ap.parse_args(argv)
    dev.require(args.device)
    records = []
    for name, mk, eye, w, h, depth in CONFIGS:
        if args.names and not any(n in name for n in args.names):
            continue
        records.append(probe(name, mk, eye, w, h, depth, grad=args.grad, device=args.device))
    if not records:
        raise SystemExit(f"no config matches {args.names}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
            f.write("\n")
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
