"""SPMD rendering and training over the ranks of `torch.distributed`.

Counterpart of `esctp1raytracer_tpu/parallel/sharding.py`: the ranks form
a ('rays', 'prims') grid (`make_mesh`), every rank holds the replicated
scene, and

* the **'rays' axis** splits the flattened ray grid: each rank builds the
  whole grid, pads it to a multiple of the axis exactly as the JAX
  package does (`_pad_rays`), and traces its contiguous shard through
  `trace_rays`, so backend "auto" resolves on each rank as it would
  unsharded (the flagship to mxtile, Cornell to the fused kernel);
* the **'prims' axis** splits the triangle table: each rank scans its
  contiguous slice with `_scan_blocks` (tensor ops, as in the JAX
  package) and the per-rank minima are combined with two MIN
  all-reduces, on t and then on the tie-broken index
  (`_prim_sharded_search`).

Training sums the per-shard losses and gradients over 'rays' and
averages them over 'prims' (whose ranks shade the same rays), with the
collectives run outside autograd on detached tensors, in one flat buffer.
Every rank reaches every collective in the same order: the searches are
called once per closest hit and once per shadow sweep, per bounce, with
no data-dependent skip.

The port runs eagerly, so it has nothing like the JAX package's jit cache
of sharded executables (`_JIT_CACHE`, `_mesh_key`): there is no trace to
reuse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.intersect import NO_HIT, _scan_blocks
from esctp1raytracer_tpu_torch.core.render import RenderConfig, trace_rays
from esctp1raytracer_tpu_torch.scene.types import Scene, float_params, merge_params

RAYS_AXIS = "rays"
PRIMS_AXIS = "prims"
INT32_MAX = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class Mesh:
    """A rays x prims grid of ranks, and this rank's place in it.

    `devices` holds the global ranks, shape (rays, prims); `groups[axis]`
    is the process group of this rank's line along `axis`, or None when
    no process group exists (a 1 x 1 grid in one process, whose
    collectives are identities).
    """

    devices: np.ndarray
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return {RAYS_AXIS: self.devices.shape[0], PRIMS_AXIS: self.devices.shape[1]}

    def all_reduce(self, x: torch.Tensor, axis: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place all-reduce of x over `axis`; returns x."""
        group = self.groups[axis]
        if group is not None:
            dist.all_reduce(x, op=op, group=group)
        return x

    def barrier(self) -> None:
        if dist.is_initialized():
            dist.barrier()


def make_mesh(
    devices=None,
    rays: Optional[int] = None,
    prims: int = 1,
) -> Mesh:
    """A ('rays', 'prims') mesh over the world's ranks (`devices`: the
    global ranks in mesh order, default all). Default: all ranks on 'rays'.

    With a process group, every rank must call it, in the same order
    (it creates the line groups collectively).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices) if devices is not None else list(range(world))
    n = len(devices)
    if rays is None:
        rays = n // prims
    if rays * prims != n:
        raise ValueError(f"mesh {rays}x{prims} != {n} devices")
    if sorted(devices) != list(range(world)):
        raise ValueError(f"mesh ranks {devices} are not the world's {world} ranks")
    arr = np.asarray(devices, dtype=np.int64).reshape(rays, prims)
    rank = dist.get_rank() if dist.is_initialized() else 0
    (i,), (j,) = np.nonzero(arr == rank)
    groups = {RAYS_AXIS: None, PRIMS_AXIS: None}
    if dist.is_initialized():
        # new_group is collective over the world: every rank makes every
        # line group, in the same order, and keeps its own.
        for col in range(prims):
            g = dist.new_group([int(x) for x in arr[:, col]])
            if col == j:
                groups[RAYS_AXIS] = g
        for row in range(rays):
            g = dist.new_group([int(x) for x in arr[row, :]])
            if row == i:
                groups[PRIMS_AXIS] = g
    return Mesh(devices=arr, rank=rank, coords={RAYS_AXIS: int(i), PRIMS_AXIS: int(j)},
                groups=groups)


def _prim_sharded_search(cfg: RenderConfig, mesh: Mesh):
    """Triangle search with the primitive table split along 'prims'.

    Each rank scans its contiguous slice of the (replicated) table; the
    per-rank minima are combined with two MIN all-reduces (t, then the
    index among the ranks that reached the minimum), which gives the
    single-device scan's answer: ties resolve to the lowest triangle index
    on both levels. It has no `.occlusion`: `any_hit` goes through
    `argmin_hit` with it.
    """

    def search(o, d, tris, eps, t_limit=None):
        # t_limit is a cull hint (see argmin_hit); the blockwise scan has
        # no per-block cull list, so it is unused here.
        n_shards = mesh.shape[PRIMS_AXIS]
        cap = tris.capacity
        if cap % n_shards:
            raise ValueError(
                f"triangle capacity {cap} is not divisible by the 'prims' "
                f"axis size {n_shards}; the trailing {cap % n_shards} "
                "triangles would never be tested. Pad the table (capacities "
                "are already padded to powers of two) or change the mesh."
            )
        shard = cap // n_shards
        base = mesh.coords[PRIMS_AXIS] * shard
        local = tris.map(lambda _, a: a[base:base + shard])
        t_loc, idx_loc = _scan_blocks(
            o, d, local, eps, min(cfg.block_size, shard), use_mxu=cfg.backend != "jnp"
        )
        idx_loc = torch.where(idx_loc >= 0, idx_loc + base, NO_HIT)
        t_best = mesh.all_reduce(t_loc.clone(), PRIMS_AXIS, dist.ReduceOp.MIN)
        cand = torch.where((t_loc == t_best) & (idx_loc >= 0), idx_loc, INT32_MAX)
        idx_min = mesh.all_reduce(cand, PRIMS_AXIS, dist.ReduceOp.MIN)
        idx_best = torch.where(idx_min == INT32_MAX, NO_HIT, idx_min)
        return t_best, idx_best

    return search


def _tri_search(cfg: RenderConfig, mesh: Mesh):
    return _prim_sharded_search(cfg, mesh) if mesh.shape[PRIMS_AXIS] > 1 else None


def _pad_rays(o, d, ids, multiple: int):
    r = o.shape[0]
    pad = (-r) % multiple
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
        d = torch.cat([d, torch.tensor([[0.0, 0.0, 1.0]], dtype=d.dtype,
                                       device=d.device).expand(pad, 3)])
        ids = torch.cat([ids, torch.arange(r, r + pad, dtype=ids.dtype, device=ids.device)])
    return o, d, ids, r


def _shard_rays(camera: Camera, width: int, height: int, mesh: Mesh):
    """(o, d, ids, r, this rank's slice) of the padded flattened ray grid."""
    o, d = camera.ray_grid(width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    n_rays_axis = mesh.shape[RAYS_AXIS]
    o, d, ids, r = _pad_rays(o, d, ids, n_rays_axis)
    shard = o.shape[0] // n_rays_axis
    start = mesh.coords[RAYS_AXIS] * shard
    return o, d, ids, r, slice(start, start + shard)


def render_sharded(
    scene: Scene,
    camera: Camera,
    width: int,
    height: int,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Render with the ray grid sharded over mesh axis 'rays' (and the
    primitive scan over 'prims' when that axis is > 1).

    Every rank returns the whole [height, width, 3] image: each writes its
    shard into a zeroed frame, and one SUM all-reduce over 'rays' gathers
    them (exact: every pixel is one shard's value plus zeros; PyTorch
    documents gloo's CUDA support for all-reduce and broadcast, not
    all-gather). Not differentiable: train through `loss_and_grad_sharded`.
    """
    if mesh is None:
        mesh = make_mesh()
    o, d, ids, r, sl = _shard_rays(camera, width, height, mesh)
    with torch.no_grad():
        color = trace_rays(o[sl], d[sl], scene, ids[sl], cfg,
                           tri_search=_tri_search(cfg, mesh))
        full = torch.zeros_like(o)
        full[sl] = color
        mesh.all_reduce(full, RAYS_AXIS)
    return full[:r].reshape(height, width, 3)


def loss_and_grad_sharded(
    scene: Scene,
    target: torch.Tensor,  # [H, W, 3]
    camera: Camera,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, list]:
    """Mean-squared-error loss to a target image + all-reduced scene grads.

    Every rank renders its ray shard and runs the backward locally
    (`torch.autograd.grad` of sum(err^2) / (3 r) over its live rays); the
    loss and the gradients of the replicated scene are then SUM-all-reduced
    over 'rays', and over 'prims' summed and scaled by 1/prims. Returns
    (loss, grads as the float-leaf list), the same on every rank.
    """
    if mesh is None:
        mesh = make_mesh()
    height, width = target.shape[0], target.shape[1]
    o, d, ids, r, sl = _shard_rays(camera, width, height, mesh)
    tgt = target.reshape(-1, 3)
    pad = o.shape[0] - r
    live = torch.ones((o.shape[0],), dtype=torch.bool, device=o.device)
    if pad:
        tgt = torch.cat([tgt, torch.zeros((pad, 3), dtype=tgt.dtype, device=tgt.device)])
        live[r:] = False
    inv_n = float(np.float32(1.0 / float(r * 3)))

    with torch.enable_grad():
        params = [p.detach().requires_grad_(True) for p in float_params(scene)]
        color = trace_rays(o[sl], d[sl], merge_params(scene, params), ids[sl], cfg,
                           tri_search=_tri_search(cfg, mesh))
        err = torch.where(live[sl, None], color - tgt[sl], 0.0)
        loss = torch.sum(err * err) * inv_n
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]

    flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
    mesh.all_reduce(flat, RAYS_AXIS)
    if mesh.shape[PRIMS_AXIS] > 1:
        mesh.all_reduce(flat, PRIMS_AXIS)
        flat = flat * (1.0 / mesh.shape[PRIMS_AXIS])
    out, k = [], 1
    for g in grads:
        out.append(flat[k:k + g.numel()].reshape(g.shape))
        k += g.numel()
    return flat[0], out


def train_step_sharded(
    scene: Scene,
    target: torch.Tensor,
    camera: Camera,
    lr: float = 1e-2,
    cfg: RenderConfig = RenderConfig(),
    mesh: Optional[Mesh] = None,
) -> Tuple[Scene, torch.Tensor]:
    """One SGD step on all float scene parameters toward a target image —
    the full fwd+bwd+all-reduce+update pipeline."""
    loss, grads = loss_and_grad_sharded(scene, target, camera, cfg, mesh)
    with torch.no_grad():
        new_params = [p - lr * g for p, g in zip(float_params(scene), grads)]
    return merge_params(scene, new_params), loss
