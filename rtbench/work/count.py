"""The least work of each search job, counted from the cell's own wavefronts.

The rule is the benchmark's and no implementation's: it reads neither the
port's block lists nor its skipped-operation constants, so a faster cull in
the program cannot raise the count, and a share of the roofline cannot pass
100% unless the time leaves out part of the work.

* closest hit: per ray, the triangles whose own bounding box the ray's slab
  test enters at or before its closest hit (every box along a ray that
  misses), each at one Möller–Trumbore test: the least that any exact
  box-culled search must test;
* any hit: per shadow ray that is traced (t_limit > 0), the triangles whose
  box it enters before t_limit, or one pair where the ray is occluded;
* search: both (a kernel that serves the closest-hit and the shadow search);
* frame: both, plus the shading arithmetic per hit and per light draw.

Bytes: each input read once and each output written once. Where the records
hold a seeded share of a step's rays, the pairs, the per-ray bytes and the
shading's counts are scaled up to the whole step; the table's bytes are not.
A kernel that a
job gains without its metric's file naming it reads high: that calls for a
recount in a `benchmark` change, not here.
"""

from __future__ import annotations

import torch

# One Möller–Trumbore test with the two edges given per triangle: d x e2 (9),
# det (5), o - v0 (3), u (6), (o - v0) x e1 (9), v (6), t (6), 1/det (1),
# u + v (1); comparisons are not counted.
MT_PAIR_FLOPS = 46
# Per hit and bounce: the backed-off hit point (7), the geometric normal (24).
SHADE_HIT_FLOPS = 31
# Per hit and light draw: the point on the face (18), the light vector, its
# length and direction (12), n.l (5), the shadow ray's limit (1), the half
# vector (12), the specular power (6), the Phong sum (12).
SHADE_DRAW_FLOPS = 66
RAY_BYTES = 24          # origin and direction, float32
ID_BYTES = 4            # a 32-bit ray id (the light draws' counter)
LIMIT_BYTES = 4         # a shadow ray's t_limit
HIT_OUT_BYTES = 8       # t and the winner's index
OCCL_OUT_BYTES = 1      # the occluded flag
COLOR_BYTES = 12        # an RGB float32 color
TRI_GEOM_BYTES = 36     # three corners, float32
TRI_ALL_BYTES = 124     # corners, corner normals, ka kd ks ke, ns
PAIRS_PER_BLOCK = 1 << 23


def boxes(v0, v1, v2):
    """Each triangle's own axis-aligned box: (lo, hi) [N, 3]."""
    return torch.minimum(torch.minimum(v0, v1), v2), torch.maximum(torch.maximum(v0, v1), v2)


def entered(o, d, lo, hi, t_max, strict: bool) -> torch.Tensor:
    """Per ray, how many boxes its slab test enters at t_entry <= t_max (< with
    `strict`), where t_entry = max(0, the slabs' near distance) and the box is
    entered when that is at most the far distance."""
    r, n = o.shape[0], lo.shape[0]
    tiny = torch.full_like(d, 1e-30)
    d = torch.where(d.abs() < 1e-30, torch.copysign(tiny, d), d)
    inv = 1.0 / d
    out = torch.zeros(r, dtype=torch.int64, device=o.device)
    rb = max(1, PAIRS_PER_BLOCK // n)
    for a in range(0, r, rb):
        oo, ii = o[a:a + rb, None, :], inv[a:a + rb, None, :]
        t1, t2 = (lo[None] - oo) * ii, (hi[None] - oo) * ii
        near = torch.clamp(torch.amax(torch.minimum(t1, t2), -1), min=0.0)
        far = torch.amin(torch.maximum(t1, t2), -1)
        tm = t_max[a:a + rb, None]
        before = near < tm if strict else near <= tm
        out[a:a + rb] = ((near <= far) & before).sum(1)
    return out


def _closest(lo, hi, rec):
    o, d, t_hit = rec[1:4]
    pairs = int(entered(o, d, lo, hi, t_hit, strict=False).sum())
    return pairs, o.shape[0] * (RAY_BYTES + HIT_OUT_BYTES)


def _any(lo, hi, rec):
    o, d, t_lim, occ = rec[1:5]
    live = t_lim > 0.0
    n_live = int(live.sum())
    if not n_live:
        return 0, 0
    per = entered(o[live], d[live], lo, hi, t_lim[live], strict=True)
    pairs = int(torch.where(occ[live], 1, per).sum())
    return pairs, n_live * (RAY_BYTES + LIMIT_BYTES + OCCL_OUT_BYTES)


JOBS = ("closest_hit", "any_hit", "search", "frame")


def count(job: str, tris, records, scale: float = 1.0) -> dict:
    """{"flops", "bytes", "pairs"} of `job` over one step's searches.

    tris: (v0, v1, v2) [N, 3] of the step's scene; records: the reference's
    `("closest_hit", o, d, t_hit, bounce)` and `("any_hit", o, d, t_limit,
    occluded, hit)` entries of every pass, in order; scale: the step's rays over
    the rays the records hold (1: all of them)."""
    if job not in JOBS:
        raise ValueError(f"unknown job {job!r}")
    lo, hi = boxes(*tris)
    table = lo.shape[0] * TRI_GEOM_BYTES
    pairs = ray_bytes = tables = 0
    for rec in records:
        if rec[0] == "closest_hit" and job != "any_hit":
            p, b = _closest(lo, hi, rec)
        elif rec[0] == "any_hit" and job != "closest_hit":
            p, b = _any(lo, hi, rec)
        else:
            continue
        pairs, ray_bytes, tables = pairs + p, ray_bytes + b, tables + table
    pairs = round(pairs * scale)
    flops = pairs * MT_PAIR_FLOPS
    nbytes = round(ray_bytes * scale) + tables
    if job == "frame":
        # A frame reads its camera rays, ids and the whole table once per pass
        # and writes a color per ray; the searches' own traffic stays inside.
        cams = [r for r in records if r[0] == "closest_hit" and r[4] == 0]
        hits = sum(int(torch.isfinite(r[3]).sum()) for r in records if r[0] == "closest_hit")
        draws = sum(int(r[5].sum()) for r in records if r[0] == "any_hit")
        flops += round(hits * scale) * SHADE_HIT_FLOPS + round(draws * scale) * SHADE_DRAW_FLOPS
        nbytes = sum(round(r[1].shape[0] * scale) * (RAY_BYTES + ID_BYTES + COLOR_BYTES)
                     + lo.shape[0] * TRI_ALL_BYTES for r in cams)
    return {"flops": flops, "bytes": nbytes, "pairs": pairs}


def least_seconds(work: dict, peaks: dict) -> float:
    """The larger of the operations over the float32 peak and the bytes over HBM's."""
    return max(work["flops"] / peaks["fp32_flops_per_s"], work["bytes"] / peaks["hbm_bytes_per_s"])
