"""Block-culling pre-pass (counterpart of `esctp1raytracer_tpu/kernels/cull.py`).

Rays are slab-tested against 128-triangle block AABBs; the kernels then
loop only over the blocks that survive for their ray group. Besides the
per-ray test (`block_cull_mask`), the JAX package's selectable pre-pass
modes use one conservative interval test per ray group
(`group_cull_mask`) and a sort-free compaction with a dense fallback
(`extract_lists`). Every function here is bit-equal to its JAX
counterpart on the same inputs.
"""

from __future__ import annotations

import torch

COHERENT = 8  # rays per bundle sharing one culled block list


def block_cull_mask(o: torch.Tensor, d: torch.Tensor, aabbs: torch.Tensor,
                    t_limit: torch.Tensor = None, return_entry: bool = False):
    """Slab-test rays [R, 3] against block AABBs [8, NB] -> keep mask [R, NB].

    NaN-safe: a zero direction component with the origin exactly on a slab
    plane gives 0 * inf = NaN, and the negated comparisons keep that block
    (a conservative extra test, never a wrongly culled hit). With `t_limit`
    [R], blocks entered beyond it are culled too. return_entry=True also
    returns the slab entry t [R, NB] (meaningful where the mask is set),
    which orders the any-hit lists nearest-first.
    """
    inv = 1.0 / d  # inf on zero components is correct slab behaviour
    bmin = aabbs[0:3].T  # [NB, 3]
    bmax = aabbs[3:6].T
    t0 = (bmin[None] - o[:, None]) * inv[:, None]  # [R, NB, 3]
    t1 = (bmax[None] - o[:, None]) * inv[:, None]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    reject = (tn > tf) | (tf < 0.0)
    if t_limit is not None:
        reject |= tn > t_limit[:, None]
    if return_entry:
        return ~reject, tn
    return ~reject


def group_cull_mask(o: torch.Tensor, d: torch.Tensor, aabbs: torch.Tensor,
                    t_limit: torch.Tensor = None, group: int = COHERENT) -> torch.Tensor:
    """Interval slab test per `group`-ray bundle -> keep mask [R / group, NB].

    One conservative test per bundle from the component intervals of its
    rays (min/max of o and d, the interval reciprocal of d): for each axis
    the entry (exit) bound is the min (max) of the eight corner products
    in the JAX package's order, and a sign change of a direction component
    inside the bundle unbounds that axis. NaN lanes keep the block. With
    `t_limit` [R], the ceiling is the bundle's largest.
    """
    nb = o.shape[0] // group
    ob = o.reshape(nb, group, 3)
    db = d.reshape(nb, group, 3)
    o_lo, o_hi = torch.amin(ob, dim=1), torch.amax(ob, dim=1)
    d_lo, d_hi = torch.amin(db, dim=1), torch.amax(db, dim=1)
    unbounded = (d_lo <= 0.0) & (d_hi >= 0.0)  # sign flip (or exact zero)
    inv_a = 1.0 / torch.where(unbounded, 1.0, d_hi)
    inv_b = 1.0 / torch.where(unbounded, 1.0, d_lo)
    inv_lo = torch.minimum(inv_a, inv_b)
    inv_hi = torch.maximum(inv_a, inv_b)
    bmin = aabbs[0:3].T  # [NB, 3]
    bmax = aabbs[3:6].T
    big = 3.4e38
    tn = o.new_full((nb, bmin.shape[0]), -big)
    tf = o.new_full((nb, bmin.shape[0]), big)
    for a in range(3):
        lo1 = bmin[None, :, a] - o_hi[:, a:a + 1]
        hi1 = bmin[None, :, a] - o_lo[:, a:a + 1]
        lo2 = bmax[None, :, a] - o_hi[:, a:a + 1]
        hi2 = bmax[None, :, a] - o_lo[:, a:a + 1]
        il, ih = inv_lo[:, a:a + 1], inv_hi[:, a:a + 1]
        p = [lo1 * il, lo1 * ih, hi1 * il, hi1 * ih, lo2 * il, lo2 * ih, hi2 * il, hi2 * ih]
        near = far = p[0]
        for q in p[1:]:
            near = torch.minimum(near, q)
            far = torch.maximum(far, q)
        unb = unbounded[:, a:a + 1]
        tn = torch.maximum(tn, torch.where(unb, -big, near))
        tf = torch.minimum(tf, torch.where(unb, big, far))
    reject = (tn > tf) | (tf < 0.0)
    if t_limit is not None:
        # NaN tn compares False here too -> keep (conservative).
        reject |= tn > torch.amax(t_limit.reshape(nb, group), dim=1)[:, None]
    return ~reject


# Extraction list cap: bundles with more kept blocks sweep every block
# (the dense fallback: exact, just unculled).
CULL_EXTRACT_K = 32


def extract_lists(gmask: torch.Tensor, k: int = CULL_EXTRACT_K):
    """Compacted ascending block lists without a sort: (ids [B, NB] int32,
    only the first cnt entries meaningful; cnt [B] int32). Exact for
    cnt <= k; a row with more kept blocks gets ids = iota, cnt = NB. The
    JAX package's k min-reductions, so the ids past cnt match too."""
    nb, ns = gmask.shape
    k = min(k, ns)
    iota = torch.arange(ns, dtype=torch.int32, device=gmask.device)
    masked = torch.where(gmask, iota, ns)
    cols = []
    last = torch.full((nb, 1), -1, dtype=torch.int32, device=gmask.device)
    for _ in range(k):
        cur = torch.amin(torch.where(masked > last, masked, ns), dim=1, keepdim=True)
        cols.append(cur)
        last = cur
    ids = torch.cat(cols + [iota[None, k:].expand(nb, ns - k)], dim=1).to(torch.int32)
    cnt = torch.sum(gmask, dim=1, dtype=torch.int32)
    over = cnt > k
    return torch.where(over[:, None], iota[None], ids), torch.where(over, ns, cnt).to(torch.int32)
