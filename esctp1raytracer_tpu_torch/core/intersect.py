"""Primitive intersection: Möller–Trumbore triangles + analytic spheres.

Counterpart of `esctp1raytracer_tpu/core/intersect.py`, function for
function:

* `mt_intersect` / `sphere_intersect` keep the same acceptance window
  (det outside (-eps, eps), u in [eps, 1], v >= eps, u+v <= 1, t >= eps)
  and the same NaN-safe double `where`s, so gradients through masked
  lanes stay finite;
* `ray_features` / `tri_features` / `hits_from_features` are the feature
  formulation: [det, t*det, u*det, v*det] = rf[16] @ tf[16, 4];
* `closest_hit` runs the O(R*N) search under `torch.no_grad()` on
  detached inputs and then recomputes t/u/v differentiably at the single
  winning primitive per ray (an O(R) gather), so the backward never
  touches the search.

The sphere sites (`argmin_hit`'s sphere search, `any_hit`'s sphere term,
`closest_hit`'s sphere recompute and shading's `surface_attributes`) run
over the sphere table's occupied slots [0, `SphereBuffer.slots`) and not
at all when there are none: the padded slots can never win. While spans
are on, each adds the rows it ran over and the table's slots to its
innermost span as the counters `intersect.sphere_slots` and
`intersect.sphere_capacity` (`count_sphere_slots`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from esctp1raytracer_tpu_torch.kernels.winner import winner_fields
from esctp1raytracer_tpu_torch.scene.types import Scene, SphereBuffer, TriangleBuffer
from esctp1raytracer_tpu_torch.utils import profiling
from esctp1raytracer_tpu_torch.utils.profiling import annotate

# float32 machine epsilon (the reference's std::numeric_limits<float>::epsilon()).
EPS = float(np.finfo(np.float32).eps)
T_MAX = float(torch.finfo(torch.float32).max)  # the largest float32, as in the JAX package
BIG = 1e30  # miss sentinel
NO_HIT = -1
SELECT_LIMIT = 16  # the most rows `select_rows` reads by a select chain

# Pass each ray's best sphere hit as a t-ceiling to the triangle search's
# cull pre-pass (argmin_hit). A real sphere hit bounds the winner, so this
# only drops blocks that cannot hold it.
SPHERE_PREHIT = True


def vec3(like: torch.Tensor, x: float, y: float, z: float) -> torch.Tensor:
    """The vector (x, y, z) in like's dtype on its device, made by fills: a
    tensor copied from host memory could not be captured in a CUDA graph."""
    return torch.stack([like.new_full((), v) for v in (x, y, z)])


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b)  # broadcasts over the batch dims


def mt_intersect(o, d, v0, v1, v2, eps=EPS):
    """Möller–Trumbore with mask semantics; all inputs broadcast.

    Returns (t, u, v, ok); ok is the acceptance window without the
    closest-hit comparison. Misses get t = BIG.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok_det = torch.abs(det) >= eps
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = ok_det & (u >= eps) & (u <= 1.0) & (v >= eps) & (u + v <= 1.0) & (t >= eps)
    t = torch.where(ok, t, BIG)
    return t, u, v, ok


def sphere_intersect(o, d, center, radius, eps=EPS):
    """Analytic ray-sphere hit (d normalized) -> (t, ok); t = BIG on miss."""
    oc = o - center
    b = _dot(oc, d)
    c0 = _dot(oc, oc) - radius * radius
    disc = b * b - c0
    ok_disc = disc >= 0.0
    # Double-where with a STRICT guard keeps sqrt' finite at disc == 0.
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t_near = -b - sq
    t_far = -b + sq
    t = torch.where(t_near >= eps, t_near, t_far)
    ok = ok_disc & (t >= eps)
    t = torch.where(ok, t, BIG)
    return t, ok


# --------------------------------------------------------------------------
# Feature formulation: intersection numerators as one contraction
# --------------------------------------------------------------------------
# With n = e1 x e2: det = -d.n, t*det = o.n - v0.n, u*det = det3(o-v0, d, e2),
# v*det = det3(d, o-v0, e1) — trilinear forms, so
# [det, t*det, u*det, v*det] = ray_features[16] @ tri_features[16, 4].

NUM_FEATURES = 16


def ray_features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[..., 3] origin/direction -> [..., 16] moment features [d, o, o⊗d, 1]."""
    od = o[..., :, None] * d[..., None, :]  # o_i d_j, row-major (i, j)
    ones = torch.ones(o.shape[:-1] + (1,), dtype=o.dtype, device=o.device)
    return torch.cat([d, o, od.reshape(*o.shape[:-1], 9), ones], dim=-1)


def _eps_cross_matrix(e: torch.Tensor) -> torch.Tensor:
    """C(e)_{ij} = sum_k eps_{ijk} e_k for e [..., 3] -> [..., 3, 3]."""
    zero = torch.zeros_like(e[..., 0])
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    return torch.stack(
        [
            torch.stack([zero, ez, -ey], dim=-1),
            torch.stack([-ez, zero, ex], dim=-1),
            torch.stack([ey, -ex, zero], dim=-1),
        ],
        dim=-2,
    )


def tri_features(v0, v1, v2) -> torch.Tensor:
    """Per-triangle coefficient columns [..., 16, 4] for (det, t*det, u*det, v*det)."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = _cross(e1, e2)
    zero3 = torch.zeros_like(n)
    zero9 = torch.zeros(n.shape[:-1] + (9,), dtype=n.dtype, device=n.device)
    zero1 = torch.zeros(n.shape[:-1] + (1,), dtype=n.dtype, device=n.device)

    col_det = torch.cat([-n, zero3, zero9, zero1], dim=-1)
    col_t = torch.cat([zero3, n, zero9, -_dot(v0, n)[..., None]], dim=-1)
    c_e2 = _eps_cross_matrix(e2).reshape(*n.shape[:-1], 9)
    col_u = torch.cat([_cross(v0, e2), zero3, c_e2, zero1], dim=-1)
    c_e1 = _eps_cross_matrix(e1).reshape(*n.shape[:-1], 9)
    col_v = torch.cat([-_cross(v0, e1), zero3, -c_e1, zero1], dim=-1)
    return torch.stack([col_det, col_t, col_u, col_v], dim=-1)


def hits_from_features(rf: torch.Tensor, tf: torch.Tensor, eps=EPS):
    """MT for all (ray, triangle) pairs: rf [R, 16], tf [B, 16, 4] -> [R, B] each.

    One float32 contraction [R, 16] @ [16, B*4]. It must be f32-faithful:
    the JAX package measured bf16x3 (and so TF32) flipping ~6% of shadow
    tests, so callers on the card keep `allow_tf32` off.
    """
    tf_mat = torch.swapaxes(tf, 0, 1).reshape(NUM_FEATURES, -1)  # [16, B*4]
    s = (rf @ tf_mat).reshape(rf.shape[0], tf.shape[0], 4)
    det, t_num, u_num, v_num = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    ok_det = torch.abs(det) >= eps
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    t = t_num * inv_det
    u = u_num * inv_det
    v = v_num * inv_det
    ok = ok_det & (u >= eps) & (u <= 1.0) & (v >= eps) & (u + v <= 1.0) & (t >= eps)
    t = torch.where(ok, t, BIG)
    return t, u, v, ok


# --------------------------------------------------------------------------
# Closest hit / any hit over the padded primitive table
# --------------------------------------------------------------------------


@dataclass
class HitRecord:
    """Per-ray hit info."""

    t: torch.Tensor  # [R] distance (BIG on miss)
    u: torch.Tensor  # [R] barycentric u (triangles only)
    v: torch.Tensor  # [R] barycentric v
    prim: torch.Tensor  # [R] int32 index into the tri/sphere buffer, -1 on miss
    is_sphere: torch.Tensor  # [R] bool
    hit: torch.Tensor  # [R] bool


def _scan_blocks(o, d, tris: TriangleBuffer, eps, block_size: int, use_mxu: bool):
    """Masked argmin of hit t over triangle blocks -> (best_t [R], best_idx [R] int32).

    Strict < across ascending blocks and argmin's first index within a
    block: ties go to the lowest triangle index.
    """
    n = tris.capacity
    block_size = min(block_size, n)
    while n % block_size:  # capacity is padded; fall back to a divisor
        block_size //= 2
    num_blocks = n // block_size
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_idx = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    rf = ray_features(o, d) if use_mxu else None
    for b in range(num_blocks):
        sl = slice(b * block_size, (b + 1) * block_size)
        bv0, bv1, bv2 = tris.v0[sl], tris.v1[sl], tris.v2[sl]
        if use_mxu:
            t_blk, _, _, ok = hits_from_features(rf, tri_features(bv0, bv1, bv2), eps)
        else:
            t_blk, _, _, ok = mt_intersect(
                o[:, None, :], d[:, None, :],
                bv0[None, :, :], bv1[None, :, :], bv2[None, :, :], eps,
            )
        t_blk = torch.where(ok & tris.valid[sl][None, :], t_blk, BIG)
        blk_min, blk_arg = torch.min(t_blk, dim=1)
        better = blk_min < best_t
        best_t = torch.where(better, blk_min, best_t)
        best_idx = torch.where(better, blk_arg.to(torch.int32) + b * block_size, best_idx)
    return best_t, best_idx


def count_sphere_slots(spheres: SphereBuffer) -> None:
    """A sphere site's counters (module docstring): Python ints, no tensor read."""
    profiling.count("intersect.sphere_slots", spheres.slots)
    profiling.count("intersect.sphere_capacity", spheres.capacity)


def _sphere_best(o, d, spheres: SphereBuffer, eps):
    """Masked argmin over the sphere table's occupied slots; with none, every
    ray misses."""
    k = spheres.slots
    if not k:
        return (o.new_full((o.shape[0],), BIG),
                torch.full((o.shape[0],), NO_HIT, dtype=torch.int32, device=o.device))
    t, ok = sphere_intersect(
        o[:, None, :], d[:, None, :],
        spheres.center[None, :k, :], spheres.radius[None, :k], eps,
    )
    t = torch.where(ok & spheres.valid[None, :k], t, BIG)
    best_t, best_idx = torch.min(t, dim=1)
    best_idx = torch.where(best_t < BIG, best_idx.to(torch.int32), NO_HIT)
    return best_t, best_idx


def argmin_hit(o, d, scene: Scene, eps=EPS, block_size: int = 512,
               use_mxu: bool = True, tri_search=None, t_limit=None):
    """Winning primitive per ray: (best_t, prim_idx, is_sphere). Pure search.

    `tri_search(o, d, tris, eps, t_limit=...)` lets a backend replace the
    triangle scan; `t_limit` is a per-ray ceiling it may use to cull work.
    """
    count_sphere_slots(scene.spheres)
    sph_t, sph_idx = _sphere_best(o, d, scene.spheres, eps)
    if tri_search is None:
        tri_t, tri_idx = _scan_blocks(o, d, scene.triangles, eps, block_size, use_mxu)
    else:
        hint = t_limit
        if hint is None and SPHERE_PREHIT:
            hint = sph_t
        if hint is not None:
            tri_t, tri_idx = tri_search(o, d, scene.triangles, eps, t_limit=hint)
        else:
            tri_t, tri_idx = tri_search(o, d, scene.triangles, eps)
    if not scene.spheres.slots:  # every winner is a triangle
        prim = torch.where(tri_t < BIG, tri_idx, NO_HIT)
        return tri_t, prim, torch.zeros_like(tri_t, dtype=torch.bool)
    is_sphere = sph_t < tri_t
    best_t = torch.where(is_sphere, sph_t, tri_t)
    prim = torch.where(is_sphere, sph_idx, tri_idx)
    prim = torch.where(best_t < BIG, prim, NO_HIT)
    return best_t, prim, is_sphere & (best_t < BIG)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along dim 0 (`jnp.take(table, idx, axis=0)`), any idx shape.

    Through `index_select`, whose backward is an `index_add_` scatter-add
    (atomics on the card). Plain `table[idx]` differentiates through a
    sort-based deterministic kernel that serializes the many rays hitting
    one triangle: 221 ms of a 336 ms 1080p fwd+bwd step on the H100. The
    winner's packed row does not come through here: `winner_fields`.
    """
    flat = torch.index_select(table, 0, idx.reshape(-1).long())
    return flat.reshape(idx.shape + table.shape[1:])


def select_rows(table: torch.Tensor, idx: torch.Tensor,
                limit: int = SELECT_LIMIT) -> torch.Tensor:
    """table[idx], as a select chain when the table has <= `limit` rows.

    The gather's backward is a scatter-add over every ray; for a tiny
    table the chain's backward is `rows` masked reductions instead.
    """
    n = table.shape[0]
    if n > limit:
        return take_rows(table, idx)
    out = torch.zeros(idx.shape + table.shape[1:], dtype=table.dtype, device=table.device)
    for j in range(n):
        out = torch.where((idx == j)[..., None], table[j], out)
    return out


def sphere_rows(packed: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """packed[idx] for a sphere table's packed columns [S, C] and sphere
    indices below k: the select chain over its first k rows, or, for a
    table too large for a chain, the gather the whole table takes."""
    if packed.shape[0] > SELECT_LIMIT:
        return take_rows(packed, idx)
    # All rows: the table itself, with no slice in the autograd graph.
    return select_rows(packed if k == packed.shape[0] else packed[:k], idx)


def packed_tri_table(tris: TriangleBuffer) -> torch.Tensor:
    """[N, 32] per-triangle row: v0 v1 v2 | n0 n1 n2 | ka kd ks ke | ns | has_normals.

    One table means the winner fetch (`winner_fields`) is one gather of
    twelve fields, and its backward one warp-merged scatter-add of their
    gradients into the table, which this cat's backward splits into the
    leaves.
    """
    return torch.cat(
        [tris.v0, tris.v1, tris.v2, tris.n0, tris.n1, tris.n2,
         tris.ka, tris.kd, tris.ks, tris.ke, tris.ns[:, None],
         tris.has_normals[:, None].to(torch.float32)], dim=1)


def closest_hit(o, d, scene: Scene, eps=EPS, block_size: int = 512,
                use_mxu: bool = True, tri_search=None, with_row: bool = False):
    """Differentiable closest hit.

    The search runs under no_grad on detached inputs; t/u/v are then
    recomputed differentiably on the winning primitive. with_row=True also
    returns the winner's packed_tri_table row for shading, as the fields of
    a `WinnerRow` (`winner_fields`).
    """
    with annotate("intersect.closest_hit"):
        with torch.no_grad():
            best_t, prim, is_sphere = argmin_hit(
                o.detach(), d.detach(), scene.detach(), eps, block_size, use_mxu,
                tri_search,
            )
        hit = prim >= 0
        # Missed rays and sphere winners (whose index is a sphere's, not a
        # triangle's) read triangle row 0: their gradient there is zero.
        trow = winner_fields(packed_tri_table(scene.triangles),
                             torch.where(hit & ~is_sphere, prim, 0))
        t_tri, u_tri, v_tri, _ = mt_intersect(o, d, trow.v0, trow.v1, trow.v2, eps)
        # Borderline winners can be accepted by the (differently rounded)
        # search yet rejected by this recompute: fall back to the search's t.
        t_tri = torch.where(t_tri < BIG, t_tri, best_t)

        count_sphere_slots(scene.spheres)
        k = scene.spheres.slots
        if not k:  # no sphere: every winner is a triangle
            t = torch.where(hit, t_tri, BIG)
            u = torch.where(hit, u_tri, 0.0)
            v = torch.where(hit, v_tri, 0.0)
            rec = HitRecord(t=t, u=u, v=v, prim=prim, is_sphere=is_sphere, hit=hit)
            return (rec, trow) if with_row else rec

        # Sphere recompute with sanitized masked lanes: non-sphere rays see a
        # benign unit sphere hit along the axis, so no inf * 0 reaches the grads.
        is_s = is_sphere
        sphere_prim = torch.where(is_s, prim, 0).long()
        sph_packed = torch.cat([scene.spheres.center, scene.spheres.radius[:, None]], dim=1)
        srow = sphere_rows(sph_packed, sphere_prim, k)  # [R, 4]
        c, r = srow[:, 0:3], srow[:, 3]
        m = is_s[:, None]
        o_s = torch.where(m, o, vec3(o, 0.0, 0.0, 3.0))
        d_s = torch.where(m, d, vec3(d, 0.0, 0.0, -1.0))
        c_s = torch.where(m, c, 0.0)
        r_s = torch.where(is_s, r, 1.0)
        t_sph, _ = sphere_intersect(o_s, d_s, c_s, r_s, eps)
        t_sph = torch.where(t_sph < BIG, t_sph, best_t)

        t = torch.where(is_sphere, t_sph, t_tri)
        t = torch.where(hit, t, BIG)
        u = torch.where(hit & ~is_sphere, u_tri, 0.0)
        v = torch.where(hit & ~is_sphere, v_tri, 0.0)
        rec = HitRecord(t=t, u=u, v=v, prim=prim, is_sphere=is_sphere, hit=hit)
        return (rec, trow) if with_row else rec


@torch.no_grad()
def any_hit(o, d, t_limit, scene: Scene, eps=EPS, block_size: int = 512,
            use_mxu: bool = True, tri_search=None) -> torch.Tensor:
    """Occlusion query [R] bool: does any primitive block (eps, t_limit)?

    Non-differentiable. A backend's dedicated any-hit (`tri_search.occlusion`)
    is used when it has one; otherwise closest-hit-then-compare.
    """
    with annotate("intersect.any_hit"):
        o, d, t_limit, scene = o.detach(), d.detach(), t_limit.detach(), scene.detach()
        occl_fn = getattr(tri_search, "occlusion", None)
        if occl_fn is not None:
            tri_occ = occl_fn(o, d, t_limit, scene.triangles, eps)
            count_sphere_slots(scene.spheres)
            if not scene.spheres.slots:
                return tri_occ
            sph_t, _ = _sphere_best(o, d, scene.spheres, eps)
            return tri_occ | (sph_t < t_limit)
        best_t, _, _ = argmin_hit(o, d, scene, eps, block_size, use_mxu, tri_search,
                                  t_limit=t_limit)
        return best_t < t_limit
