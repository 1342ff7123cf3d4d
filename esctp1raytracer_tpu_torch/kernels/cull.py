"""Block-culling pre-pass (counterpart of `esctp1raytracer_tpu/kernels/cull.py`).

Rays are slab-tested against 128-triangle block AABBs; the kernels then
loop only over the blocks that survive for their ray group.
"""

from __future__ import annotations

import torch


def block_cull_mask(o: torch.Tensor, d: torch.Tensor, aabbs: torch.Tensor,
                    t_limit: torch.Tensor = None) -> torch.Tensor:
    """Slab-test rays [R, 3] against block AABBs [8, NB] -> keep mask [R, NB].

    NaN-safe: a zero direction component with the origin exactly on a slab
    plane gives 0 * inf = NaN, and the negated comparisons keep that block
    (a conservative extra test, never a wrongly culled hit). With `t_limit`
    [R], blocks entered beyond it are culled too.
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
    return ~reject
