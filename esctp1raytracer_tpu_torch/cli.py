"""Command-line entry point with reference-parity flags.

Counterpart of `esctp1raytracer_tpu/cli.py`, with its flags, choices,
defaults, `--scene` table, strategy mapping, messages and exit codes. It
mirrors the reference CLI (src/main.cpp:417-695):
  -m model.obj   path to the OBJ model
  -o out.ppm     output image (without it: "Nothing saved: use -o ...")
  -v x,y,z       eye position        (default 0,1,3 — src/main.cpp:426)
  -l x,y,z       look-at point       (default 0,1,0)
  -w w,h         window size         (default 1024,768 — and unlike the
                 reference, -w actually works; quirk 7 fixed)
  --thread --bvh --ispc   the reference's execution strategies, mapped to
                 backends (see below)
  --test         run the built-in self-checks
  --debug --trace   verbosity levels (src/debug.h)

Strategy mapping (reference -> port):
  (none)    sequential C++ loop      -> backend "jnp"
  --ispc    SIMD over triangles      -> backend "auto" (the fused
            whole-frame kernel on eligible scenes)
  --bvh     flatten + BVH            -> backend "mxu" (the feature
            contraction; the reference BVH is slower than its own brute
            force, SURVEY quirk 3)
  --thread  one thread per row       -> mode "sharded": the ray grid split
            over the ranks (`render_sharded`; one rank alone, the world's
            ranks under torchrun), backend "auto" (also with --bvh)
Explicit --mode/--backend win over the mapped flags. In sharded mode only
rank 0 writes the image and prints the timing block.

Extensions: --depth (Whitted reflection bounces), --seed, --vfov,
--light-mode {area,reference_cpp}, --chunk, and, for the port only,
--device {cuda,cpu} (the card unless the CPU is asked for; with no card,
--device cuda fails).

The stderr timing block reproduces the reference's report fields
(src/main.cpp:645-654); the timer stops after the card has finished.
"""

from __future__ import annotations

import argparse
import sys

from esctp1raytracer_tpu_torch.utils.debug import DEBUG, INFO, TRACE, set_level

BACKENDS = ("jnp", "mxu", "pallas", "tile", "mxtile", "lane", "fused", "auto")


def _vec3(text: str):
    parts = [float(x) for x in text.split(",")]
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(f"expected x,y,z got {text!r}")
    return tuple(parts)


def _vec2i(text: str):
    parts = [int(x) for x in text.split(",")]
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected w,h got {text!r}")
    return tuple(parts)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="esctp1raytracer_tpu_torch",
        description="Differentiable Whitted ray tracer on PyTorch and CUDA",
    )
    p.add_argument("-m", dest="model", default="", help="OBJ model path")
    p.add_argument("-o", dest="output", default="", help="output PPM path")
    p.add_argument("-v", dest="eye", type=_vec3, default=(0.0, 1.0, 3.0),
                   help="eye position x,y,z")
    p.add_argument("-l", dest="look", type=_vec3, default=(0.0, 1.0, 0.0),
                   help="look-at point x,y,z")
    p.add_argument("-w", dest="window", type=_vec2i, default=(1024, 768),
                   help="window size w,h")
    p.add_argument("--thread", action="store_true",
                   help="reference strategy: data-parallel (-> sharded)")
    p.add_argument("--bvh", action="store_true",
                   help="reference strategy: accelerated (-> mxu backend)")
    p.add_argument("--ispc", action="store_true",
                   help="reference strategy: SIMD (-> auto backend: the fused kernel)")
    p.add_argument("--test", action="store_true", help="run self-tests and exit")
    p.add_argument("--debug", action="store_true", help="debug verbosity")
    p.add_argument("--trace", action="store_true", help="trace verbosity")
    p.add_argument("--mode", dest="mode", default="",
                   choices=["", "single", "sharded", *BACKENDS],
                   help="execution mode: single device or sharded (a backend name "
                        "here is legacy shorthand for --backend NAME)")
    p.add_argument("--backend", dest="backend", default="", choices=["", *BACKENDS],
                   help="kernel backend (overrides strategy flags)")
    p.add_argument("--depth", type=int, default=1, help="reflection bounces")
    p.add_argument("--seed", type=int, default=0, help="light-sampling seed")
    p.add_argument("--vfov", type=float, default=60.0, help="vertical fov (deg)")
    p.add_argument("--chunk", type=int, default=0,
                   help="rays per wavefront (0 = whole grid, fastest)")
    p.add_argument("--light-mode", default="area",
                   choices=["area", "reference_cpp"],
                   help="area sampling (corrected) or reference-C++ compat")
    p.add_argument("--scene", default="",
                   choices=["", "cornell", "cornell_mirror", "cornell_glossy",
                            "cornell_sphere", "cornell_water",
                            "cornell_empty_co", "cornell_empty_rg",
                            "cornell_empty_white", "cornell_empty_squashed",
                            "cornell_empty_nolight", "sphere_plane",
                            "ten_sphere", "mesh", "mixed", "random100k"],
                   help="procedural scene instead of -m")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to render: the CUDA card (default) or the CPU")
    return p


def self_test(device: str = "cuda") -> int:
    """Vector-math and intersection self-checks on tensors on `device` —
    the working version of the reference's commented-out test.ispc
    (src/ispc/test.ispc:22-38)."""
    import torch

    from esctp1raytracer_tpu_torch.core.intersect import mt_intersect, sphere_intersect

    def vec(*xs):
        return torch.tensor(xs, dtype=torch.float32, device=device)

    checks = []
    a, b = vec(1.0, 0.0, 0.0), vec(0.0, 1.0, 0.0)
    checks.append(("dot orthogonal", float(torch.dot(a, b)) == 0.0))
    checks.append(("cross right-handed",
                   bool(torch.allclose(torch.linalg.cross(a, b), vec(0.0, 0.0, 1.0)))))
    t, u, v, ok = mt_intersect(vec(0.25, 0.25, 1.0), vec(0.0, 0.0, -1.0),
                               vec(0.0, 0.0, 0.0), vec(1.0, 0.0, 0.0), vec(0.0, 1.0, 0.0))
    checks.append(("triangle hit", bool(ok) and abs(float(t) - 1.0) < 1e-6))
    t, ok = sphere_intersect(vec(0.0, 0.0, 3.0), vec(0.0, 0.0, -1.0), vec(0.0, 0.0, 0.0),
                             vec(1.0))
    checks.append(("sphere hit", bool(ok) and abs(float(t) - 2.0) < 1e-5))

    failed = [name for name, passed in checks if not passed]
    for name, passed in checks:
        print(f"  {'PASS' if passed else 'FAIL'}  {name}")
    print(f"Self-test: {len(checks) - len(failed)}/{len(checks)} passed")
    return 1 if failed else 0


def _procedural_scene(name: str, device: str):
    from esctp1raytracer_tpu_torch.scene import builders

    if name == "cornell":
        return builders.cornell_box(device=device)
    if name.startswith("cornell_"):
        return builders.cornell_variant(name[len("cornell_"):], device=device)
    return {
        "sphere_plane": builders.sphere_plane_scene,
        "ten_sphere": builders.ten_sphere_scene,
        "mesh": builders.mesh_scene,
        "mixed": builders.mixed_scene,
        "random100k": lambda device: builders.random_scene(100_000, device=device),
    }[name](device=device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.trace:
        set_level(TRACE)
    elif args.debug:
        set_level(DEBUG)
    else:
        set_level(INFO)

    mode, backend = args.mode, args.backend
    if mode in BACKENDS:  # legacy: --mode <backend>
        backend = backend or mode
        mode = "single"
    if not mode:
        mode = "sharded" if args.thread else "single"
    if not args.test and not (args.model or args.scene):
        print("No model: use -m model.obj or --scene", file=sys.stderr)
        return 2

    # Heavy imports after flag parsing so --help and usage errors stay fast.
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("No CUDA device: the port renders on the card unless --device cpu is given",
              file=sys.stderr)
        return 1
    if args.test:
        return self_test(args.device)

    from esctp1raytracer_tpu_torch import Camera, RenderConfig, render, scene_from_mesh
    from esctp1raytracer_tpu_torch.io.ppm import write_ppm
    from esctp1raytracer_tpu_torch.utils.timing import Timer

    if not backend:
        if args.ispc:
            # "auto" resolves to the fused whole-frame kernel on eligible
            # scenes: the port's counterpart of the ISPC trace.
            backend = "auto"
        elif args.bvh:
            # --bvh --thread: accelerated + data-parallel -> the best
            # kernel for the scene, sharded over the ranks.
            backend = "auto" if mode == "sharded" else "mxu"
        elif mode == "sharded":
            backend = "auto"
        else:
            backend = "jnp"

    rank = 0
    if mode == "sharded":
        import torch.distributed as dist

        from esctp1raytracer_tpu_torch.parallel import init_distributed, make_mesh, render_sharded

        # Before any tensor is made: under NCCL it binds the rank to its card.
        init_distributed()
        rank = dist.get_rank() if dist.is_initialized() else 0

    if args.model:
        from esctp1raytracer_tpu_torch.scene.matjson import load_obj_with_mat

        # Applies a sibling <model>.mat JSON override when present — the
        # convention the reference set up but never wired in.
        scene = scene_from_mesh(load_obj_with_mat(args.model), device=args.device)
    else:
        scene = _procedural_scene(args.scene, args.device)

    width, height = args.window
    cam = Camera.look_at(args.eye, args.look, vfov=args.vfov, aspect=width / height,
                         device=args.device)
    cfg = RenderConfig(backend=backend, depth=args.depth, seed=args.seed,
                       ray_chunk=args.chunk, light_mode=args.light_mode)

    with Timer("render") as timer:
        if mode == "sharded":
            image = render_sharded(scene, cam, width, height, cfg, make_mesh())
        else:
            image = render(scene, cam, width, height, cfg)
        if image.is_cuda:
            torch.cuda.synchronize(image.device)
    if rank:
        return 0

    # stderr timing block, same fields as the reference (src/main.cpp:645-654).
    timer.fields = {
        "Threaded": str(mode == "sharded").lower(),
        "Flattened": str(backend == "mxu").lower(),
        "ISPC": str(args.ispc or backend in ("fused", "pallas")).lower(),
        "Mode": f"{mode}/{backend}",
        "Devices": torch.cuda.device_count() if args.device == "cuda" else 1,
    }
    timer.report()

    if args.output:
        write_ppm(args.output, image)
        print(f"Rendered image in: {args.output}")
    else:
        print("Nothing saved: use -o to save rendered image")
    return 0


if __name__ == "__main__":
    sys.exit(main())
