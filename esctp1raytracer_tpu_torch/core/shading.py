"""Phong/Blinn shading with sampled area lights and shadow rays.

Counterpart of `esctp1raytracer_tpu/core/shading.py`, both light modes:
per light source, one random face and one parallelogram point on it (or
the reference C++ path's corner point, light_mode="reference_cpp"), a
shadow ray from the backed-off hit point, and
(ka*0.5 + ke)/L + (kd*max(d,0) + ks*dot(N,H)^Ns)/L where the light is
visible and d > 0. Draws come from the counter-based hash on the global
ray id, so they equal the JAX package's draw for draw. Every masked lane
is sanitized (double `where`, `_TINY` floors) so no NaN reaches a gradient.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from esctp1raytracer_tpu_torch.core.intersect import (
    HitRecord, packed_tri_table, select_rows, take_rows,
)
from esctp1raytracer_tpu_torch.scene.types import Scene
from esctp1raytracer_tpu_torch.utils import rng

_TINY = 1e-12


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_TINY))


def surface_attributes(o, d, hit: HitRecord, scene: Scene, shadow_eps: float,
                       trow: torch.Tensor = None):
    """Per-ray surface data at the winner: (hit_point [R,3], normal [R,3], material dict).

    Zero-safe for missed rays. trow is the winner's packed_tri_table row
    when the caller already gathered it (closest_hit with_row=True).
    """
    safe_prim = torch.clamp(hit.prim, min=0).long()
    sph = scene.spheres
    if trow is None:
        trow = take_rows(packed_tri_table(scene.triangles), safe_prim)
    tv0, tv1, tv2 = trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
    n0, n1, n2 = trow[:, 9:12], trow[:, 12:15], trow[:, 15:18]

    n_geom = _normalize(torch.linalg.cross(tv1 - tv0, tv2 - tv0))
    u, v = hit.u[:, None], hit.v[:, None]
    n_smooth = _normalize(n1 * u + n2 * v + n0 * (1.0 - u - v))
    has_n = trow[:, 31:32] > 0.5
    n_tri = torch.where(has_n, n_smooth, n_geom)

    # Back-off: hit = origin + dir * (t - eps).
    t_safe = torch.where(hit.hit, hit.t, 1.0)[:, None]
    hit_p = o + d * (t_safe - shadow_eps)

    # Sphere normal: sanitize the unselected branch completely (the
    # division's backward squares the denominator; padded radius-0
    # spheres would give 0/0).
    is_s = hit.is_sphere[:, None]
    sphere_prim = torch.where(hit.is_sphere, safe_prim, 0)
    sph_packed = torch.cat(
        [sph.center, sph.radius[:, None], sph.ka, sph.kd, sph.ks, sph.ke,
         sph.ns[:, None]], dim=1)  # [M, 17]
    srow = select_rows(sph_packed, sphere_prim)  # [R, 17]
    center, radius = srow[:, 0:3], srow[:, 3]
    r_safe = torch.where(hit.is_sphere, torch.clamp(radius, min=1e-6), 1.0)
    n_sph = torch.where(is_s, hit_p - center, 0.0) / r_safe[:, None]

    normal = torch.where(is_s, n_sph, n_tri)

    def pick(tri_vals, sph_vals):
        cond = is_s if tri_vals.dim() == 2 else hit.is_sphere
        return torch.where(cond, sph_vals, tri_vals)

    mat = {
        "ka": pick(trow[:, 18:21], srow[:, 4:7]),
        "kd": pick(trow[:, 21:24], srow[:, 7:10]),
        "ks": pick(trow[:, 24:27], srow[:, 10:13]),
        "ke": pick(trow[:, 27:30], srow[:, 13:16]),
        "ns": pick(trow[:, 30], srow[:, 16]),
    }
    mask = hit.hit[:, None]
    hit_p = torch.where(mask, hit_p, 0.0)
    normal = torch.where(mask, normal, 0.0)
    return hit_p, normal, mat


def sample_lights(scene: Scene, seed: int, ray_ids: torch.Tensor, bounce: int = 0,
                  mode: str = "area") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One sample point per (ray, light source): (P [R, L, 3], light_tri [R, L], L).

    mode="area": random face of the source, then the parallelogram point
    v0 + (v1-v0) r1 + (v2-v0) r2, with stream ids (bounce*1024 + l)*4.
    mode="reference_cpp": the reference C++ path's degenerate sampling
    (quirk 2): the drawn face id indexes the de-indexed corner array, so P
    is corner `face % 3` of face `face // 3`; r1 and r2 are drawn, unused.
    """
    if mode not in ("area", "reference_cpp"):
        raise ValueError(f"unknown light_mode {mode!r}")
    lights = scene.lights
    L = lights.num_lights
    num_rays = ray_ids.shape[0]
    dev = ray_ids.device
    if L == 0:
        return (torch.zeros((num_rays, 0, 3), dtype=torch.float32, device=dev),
                torch.zeros((num_rays, 0), dtype=torch.int32, device=dev), 0)

    streams = (bounce * 1024 + torch.arange(L, dtype=torch.int64, device=dev)) * 4  # [L]
    rid = ray_ids[:, None]
    face = rng.randint(seed, rid, streams, lights.face_count[None, :])  # [R, L]
    r1 = rng.uniform01(seed, rid, streams + 1)[..., None]
    r2 = rng.uniform01(seed, rid, streams + 2)[..., None]

    # tri_idx [L, F]; want [R, L] = tri_idx[l, face[r, l]].
    F = lights.max_faces
    tri_idx = lights.tri_idx[None].expand(num_rays, L, F)
    tri = torch.gather(tri_idx, 2, face[:, :, None].long())[:, :, 0]

    tris = scene.triangles
    if mode == "reference_cpp":
        src_tri = torch.gather(tri_idx, 2, (face // 3)[:, :, None].long())[:, :, 0]
        corner = (face % 3)[:, :, None]
        p = torch.where(corner == 0, take_rows(tris.v0, src_tri),
                        torch.where(corner == 1, take_rows(tris.v1, src_tri),
                                    take_rows(tris.v2, src_tri)))
        return p, tri, L
    light_packed = torch.cat([tris.v0, tris.v1, tris.v2], dim=1)
    if L * F <= 16:
        # Small light tables: gather the [L, F, 9] corners once and pick
        # each ray's face by a select chain (the backward is F masked
        # reductions instead of a scatter-add over every ray).
        lc = take_rows(light_packed, lights.tri_idx)  # [L, F, 9]
        rows = torch.zeros(face.shape + (9,), dtype=torch.float32, device=dev)
        for f in range(F):
            rows = torch.where((face == f)[..., None], lc[None, :, f, :], rows)
    else:
        rows = take_rows(light_packed, tri)  # [R, L, 9]
    v0, v1, v2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    p = v0 + (v1 - v0) * r1 + (v2 - v0) * r2
    return p, tri, L


def shade(o, d, hit: HitRecord, scene: Scene, seed: int, ray_ids: torch.Tensor,
          occlusion_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
          shadow_eps: float = 1e-4, bounce: int = 0, light_mode: str = "area",
          trow: torch.Tensor = None):
    """Shade one wavefront against all light sources.

    occlusion_fn(origins [M,3], dirs [M,3], t_limit [M]) -> occluded [M] bool.
    Returns (color [R,3], hit_point [R,3], normal [R,3], ks [R,3]).
    """
    r = o.shape[0]
    hit_p, normal, mat = surface_attributes(o, d, hit, scene, shadow_eps, trow=trow)

    p_light, _, num_l = sample_lights(scene, seed, ray_ids, bounce, light_mode)
    if num_l == 0:
        # The sum over no light source: exactly black, and still a function of
        # the scene, so that a backward runs and gives zero gradients.
        return torch.sum(hit_p[:, None, :][:, :0], dim=1), hit_p, normal, mat["ks"]

    l_vec = p_light - hit_p[:, None, :]  # [R, L, 3]
    dist = torch.sqrt(torch.clamp(torch.sum(l_vec * l_vec, dim=-1), min=_TINY))  # [R, L]
    l_dir = l_vec / dist[..., None]
    d_nl = torch.sum(normal[:, None, :] * l_dir, dim=-1)  # [R, L]
    # Back-facing points are unlit whatever the occlusion: a negative
    # t_limit lets the culling backends drop their shadow rays.
    t_limit = torch.where(d_nl > 0.0, dist - shadow_eps, -1.0)

    # Missed primary rays: park the shadow origin far outside every box
    # so the culling drops them (the result is masked by `visible`).
    far = hit_p.new_full((3,), 3e7)
    occl_origin = torch.where(hit.hit[:, None], hit_p, far)

    def flat(a):
        return a.reshape((r * num_l,) + a.shape[2:])

    occluded = occlusion_fn(
        flat(torch.broadcast_to(occl_origin[:, None, :], l_vec.shape)),
        flat(l_dir),
        flat(t_limit),
    ).reshape(r, num_l)

    h_vec = _normalize((normal[:, None, :] + l_dir) * 2.0)
    spec_dot = torch.clamp(torch.sum(normal[:, None, :] * h_vec, dim=-1), min=0.0)
    # pow with a floor keeps grads finite at grazing angles.
    spec = torch.pow(torch.clamp(spec_dot, min=_TINY), mat["ns"][:, None])

    inv_l = 1.0 / num_l
    base = (mat["ka"] * 0.5 + mat["ke"])[:, None, :] * inv_l  # [R, 1, 3]
    lit = (mat["kd"][:, None, :] * d_nl[..., None]
           + mat["ks"][:, None, :] * spec[..., None]) * inv_l
    visible = hit.hit[:, None] & ~occluded & (d_nl > 0.0)
    color = torch.sum(torch.where(visible[..., None], base + lit, 0.0), dim=1)
    return color, hit_p, normal, mat["ks"]
