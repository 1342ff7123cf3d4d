"""The renderer: camera rays -> closest hit -> shade -> (reflect)* -> image.

Counterpart of `esctp1raytracer_tpu/core/render.py`, with the same
`RenderConfig` fields and backend strings, and the same routing:

  "jnp"    — broadcast Möller–Trumbore over the padded table (tensor ops);
  "mxu"    — the same search as the feature contraction (tensor ops);
  "mxtile" — the hand-written CUDA search kernels K1/K2 (kernels/rt_mxu.py);
  "lane"   — the ray-lane CUDA search kernel K4 (kernels/lane_pallas.py);
  "tile"   — the tile CUDA search kernels K5/K6 (kernels/rt_tile.py);
  "fused"  — the whole-frame CUDA kernel K3 (kernels/fused_pallas.py) when
             `fused_supported`, else the lane/tile fallback;
  "auto"   — fused when eligible, else lane < 4096 triangles <= mxtile <=
             32,768 < tile.

Every backend is ported, and no backend quietly runs another.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.intersect import EPS, any_hit, closest_hit
from esctp1raytracer_tpu_torch.core.shading import shade
from esctp1raytracer_tpu_torch.kernels import lane_pallas, rt_mxu, rt_tile, tables
from esctp1raytracer_tpu_torch.kernels.fused_pallas import (
    _fallback_cfg, fused_supported, fused_trace_diff,
)
from esctp1raytracer_tpu_torch.scene.types import Scene
from esctp1raytracer_tpu_torch.utils import profiling
from esctp1raytracer_tpu_torch.utils.debug import TRACE, current_level
from esctp1raytracer_tpu_torch.utils.graphs import graphed


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (the JAX package's fields and defaults)."""

    depth: int = 1
    eps: float = EPS
    shadow_eps: float = 1e-4
    block_size: int = 512
    ray_chunk: int = 0  # 0 = trace all rays in one wavefront
    # "jnp"|"mxu"|"tile"|"mxtile"|"lane"|"fused"|"auto" ("pallas" = "auto")
    backend: str = "jnp"
    seed: int = 0
    light_mode: str = "area"

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def _auto_backend(scene: Scene = None) -> str:
    """Size-based half of "auto": lane < 4096 tris <= mxtile <= MXU_TRI_LIMIT < tile."""
    n = scene.triangles.capacity if scene is not None else 0
    if n < 4096:
        return "lane"
    return "mxtile" if n <= rt_mxu.MXU_TRI_LIMIT else "tile"


def _canon_backend(backend: str) -> str:
    """"pallas" is an alias of "auto"."""
    return "auto" if backend == "pallas" else backend


def resolve_backend(cfg: RenderConfig, scene: Scene = None) -> str:
    """Concrete backend trace_rays routes (cfg, scene) to: the fused gate
    first, then the size rule."""
    backend = _canon_backend(cfg.backend)
    if backend in ("fused", "auto") and scene is not None:
        if fused_supported(scene, cfg.depth, cfg.light_mode):
            return "fused"
        if backend == "fused":
            backend = _fallback_cfg(scene, cfg).backend
    if backend == "auto":
        backend = _auto_backend(scene)
    return backend


def _search_fns(cfg: RenderConfig, scene: Scene = None):
    """(tri_search, use_mxu) for a concrete or "auto" backend."""
    backend = _canon_backend(cfg.backend)
    if backend == "auto":
        backend = _auto_backend(scene)
    if backend == "tile":
        return rt_tile.tile_tri_search, True
    if backend == "mxtile":
        return rt_mxu.mxu_tile_search, True
    if backend == "lane":
        return lane_pallas.lane_tri_search, True
    if backend == "mxu":
        return None, True
    if backend == "jnp":
        return None, False
    raise ValueError(f"unknown backend {cfg.backend!r}")


def trace_rays(o, d, scene: Scene, ray_ids: torch.Tensor, cfg: RenderConfig,
               tri_search=None) -> torch.Tensor:
    """Trace one wavefront of rays [R, 3] to colors [R, 3].

    Depth 1 is the primary ray + shadow rays; depth > 1 adds Whitted
    reflections. With cfg.ray_chunk > 0 the rays go through in chunks of
    that size; the counter-based RNG makes the result chunk-independent.
    A ray that is no longer active keeps its origin and direction and is
    searched and shaded again at each later bounce, then masked out; while
    spans are on, each bounce after the first adds the rays it traces to
    the counter `render.reflect_rays` and the active ones among them to
    `render.reflect_live` (summed on the device). The segmented searches'
    scene tables are built once for all chunks and bounces
    (`tables.search_tables`).
    """
    with tables.search_tables():
        return _trace_rays(o, d, scene, ray_ids, cfg, tri_search)


def _trace_rays(o, d, scene: Scene, ray_ids: torch.Tensor, cfg: RenderConfig,
                tri_search) -> torch.Tensor:
    r = o.shape[0]
    if cfg.ray_chunk and cfg.ray_chunk < r:
        inner = cfg.replace(ray_chunk=0)
        chunks = [_trace_rays(o[i:i + cfg.ray_chunk], d[i:i + cfg.ray_chunk], scene,
                             ray_ids[i:i + cfg.ray_chunk], inner, tri_search)
                  for i in range(0, r, cfg.ray_chunk)]
        return torch.cat(chunks)
    if _canon_backend(cfg.backend) in ("fused", "auto"):
        if tri_search is None and fused_supported(scene, cfg.depth, cfg.light_mode):
            # The whole-frame kernel, differentiable through its backward's
            # re-derivation on a non-fused route.
            return fused_trace_diff(o, d, scene, ray_ids, cfg)
        if cfg.backend == "fused":  # refused by the gate, or a search is injected
            cfg = _fallback_cfg(scene, cfg)
    if tri_search is None:
        tri_search, use_mxu = _search_fns(cfg, scene)
    else:  # an injected search replaces the backend's own
        use_mxu = _canon_backend(cfg.backend) != "jnp"
    eps = cfg.eps

    def occl(oo, dd, t_limit):
        return any_hit(oo, dd, t_limit, scene, eps, block_size=cfg.block_size,
                       use_mxu=use_mxu, tri_search=tri_search)

    color = torch.zeros((r, 3), dtype=torch.float32, device=o.device)
    throughput = torch.ones((r, 3), dtype=torch.float32, device=o.device)
    active = torch.ones((r,), dtype=torch.bool, device=o.device)
    for bounce in range(cfg.depth):
        if bounce and profiling.enabled():
            profiling.count("render.reflect_rays", r)
            profiling.count("render.reflect_live", active.sum())
        # The winner's packed row is gathered once and shared with shading:
        # one warp-merged scatter-add per bounce in the backward.
        hit, trow = closest_hit(o, d, scene, eps, block_size=cfg.block_size,
                                use_mxu=use_mxu, tri_search=tri_search, with_row=True)
        if current_level() >= TRACE:
            _trace_summary(bounce, hit)
        local, hit_p, normal, ks = shade(
            o, d, hit, scene, cfg.seed, ray_ids, occl, shadow_eps=cfg.shadow_eps,
            bounce=bounce, light_mode=cfg.light_mode, trow=trow)
        color = color + throughput * torch.where(active[:, None], local, 0.0)
        if bounce + 1 < cfg.depth:
            active = active & hit.hit & (torch.amax(ks, dim=-1) > 0.0)
            throughput = torch.where(active[:, None], throughput * ks, 0.0)
            d_dot_n = torch.sum(d * normal, dim=-1, keepdim=True)
            refl = d - 2.0 * d_dot_n * normal
            refl = refl * torch.rsqrt(
                torch.clamp(torch.sum(refl * refl, dim=-1, keepdim=True), min=1e-12))
            o = torch.where(active[:, None], hit_p, o)
            d = torch.where(active[:, None], refl, d)
    return color


def _trace_summary(bounce: int, hit) -> None:
    """The reference dumps per-hit info under --trace (src/ispc/trace.ispc:94-100,
    src/main.cpp:607-616); for a wavefront: the bounce's hit count and ray 0's
    hit record. It reads them back from the device, so it runs only at TRACE."""
    t0, p0, u0, v0 = (x[0].detach().cpu().numpy() for x in (hit.t, hit.prim, hit.u, hit.v))
    print(f"trace[bounce {bounce}]: hits={int(hit.hit.sum())}/{hit.hit.shape[0]} "
          f"t[0]={t0} prim[0]={p0} u[0]={u0} v[0]={v0}", flush=True)


@graphed(static_argnames=("width", "height", "cfg"))
def render(scene: Scene, camera: Camera, width: int, height: int,
           cfg: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Render a [height, width, 3] float32 image (row h = image row h).

    On the card one CUDA graph per (scene and camera shapes, width, height,
    cfg), as the JAX package jits it (utils/graphs.py): the camera rays,
    `trace_rays` and the reshape. Under autograd with an input that
    requires grad it runs eagerly, or inline in an enclosing capture.
    """
    o, d = camera.ray_grid(width, height)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    ray_ids = torch.arange(o.shape[0], dtype=torch.int64, device=o.device)
    return trace_rays(o, d, scene, ray_ids, cfg).reshape(height, width, 3)


def render_to_numpy(scene: Scene, camera: Camera, width: int, height: int,
                    cfg: RenderConfig = RenderConfig()) -> np.ndarray:
    """`render`, copied to the host as a numpy array [height, width, 3]."""
    return render(scene, camera, width, height, cfg).detach().cpu().numpy()
