"""Entry points of the PyTorch / CUDA port: the single-device forward and
the multi-rank dry run.

Counterpart of __graft_entry__.py's `entry` and `dryrun_multichip`. Both
run on the card unless the caller passes device="cpu"; with no card they
fail (there is no fallback to the CPU). The port runs eagerly, so
nothing is jitted: `entry` returns the forward step and its arguments,
and `dryrun_multichip` runs the sharded training steps themselves.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from esctp1raytracer_tpu_torch import Camera, RenderConfig
from esctp1raytracer_tpu_torch.core.render import trace_rays
from esctp1raytracer_tpu_torch.kernels import launches
from esctp1raytracer_tpu_torch.parallel import make_mesh, train_step_sharded
from esctp1raytracer_tpu_torch.scene.builders import mesh_scene, sphere_plane_scene
from esctp1raytracer_tpu_torch.utils import device as dev

# The dry run's backends, each with the mesh it runs on: with prims > 1 the
# prim-sharded blockwise search replaces the backend's own, so the hand
# kernels (lane, tile, auto's fused route) run on a rays-only mesh.
DRYRUN_BACKENDS = (("jnp", "mesh"), ("mxu", "mesh"), ("lane", "rays"), ("tile", "rays"),
                   ("auto", "rays"))


def entry(device="cuda"):
    """(fn, example_args): the forward render step on the flagship route,
    backend "auto" over `mesh_scene(4)` (5,124 triangles > 4096: mxtile,
    kernels K1 and K2) at 128x128; fn(scene, o, d, ids) -> colors [R, 3]."""
    dev.require(device)
    scene = mesh_scene(subdivisions=4, device=device)
    cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0, device=device)
    o, d = cam.ray_grid(128, 128)
    o, d = o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous()
    ids = torch.arange(o.shape[0], dtype=torch.int64, device=device)
    cfg = RenderConfig(backend="auto")

    def fwd(scene, o, d, ids):
        return trace_rays(o, d, scene, ids, cfg)

    return fwd, (scene, o, d, ids)


def _same_on_every_rank(x: torch.Tensor) -> bool:
    if not dist.is_initialized():
        return True
    lo, hi = x.detach().clone(), x.detach().clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    return bool(lo == hi)


def dryrun_multichip(n_devices: int, device="cuda"):
    """One full sharded training step (forward render, backward, all-reduced
    gradients, SGD update at lr 1e-3) per production backend, on the n
    ranks of the initialised process group (or one rank without one).

    Every rank calls it. The meshes: rays x prims with prims = 2 when n is
    even and >= 4, and a rays-only mesh; "jnp" and "mxu" run on the first,
    "lane", "tile" and "auto" (the fused route on this scene, its backward
    on lane) on the second. The scene is `sphere_plane_scene()`, the camera
    looks from (0, 2, 6) at (0, 1, 0), the target is a zero 16 x 16 image.
    Raises unless each loss is
    finite and the same on every rank. Returns {backend: {"loss",
    "launches" (every kernel wrapper's count over the step), "scene" (the
    updated scene)}} for callers to check; the JAX function returns nothing.
    """
    dev.require(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) called in a world of {world} ranks")
    prims = 2 if (n_devices >= 4 and n_devices % 2 == 0) else 1
    meshes = {"mesh": make_mesh(rays=n_devices // prims, prims=prims),
              "rays": make_mesh(rays=n_devices, prims=1)}
    scene = sphere_plane_scene(device=device)
    cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0, device=device)
    target = torch.zeros((16, 16, 3), dtype=torch.float32, device=device)
    out = {}
    for backend, mesh in DRYRUN_BACKENDS:
        (new_scene, loss), counts = launches.counted(
            lambda: train_step_sharded(scene, target, cam, lr=1e-3,
                                       cfg=RenderConfig(backend=backend), mesh=meshes[mesh]))
        if not bool(torch.isfinite(loss)):
            raise RuntimeError(f"dryrun training step ({backend}) produced non-finite loss "
                               f"{loss.item()}")
        if not _same_on_every_rank(loss):
            raise RuntimeError(f"dryrun training step ({backend}): the ranks' losses differ")
        out[backend] = {"loss": loss.item(), "launches": counts, "scene": new_scene}
    return out
