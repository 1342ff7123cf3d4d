"""mxtile search: the ray-triangle test as a K=16 feature contraction.

Counterpart of `esctp1raytracer_tpu/kernels/rt_mxu.py`. Möller–Trumbore's
four quantities are trilinear forms in (o, d, triangle):

    [det, t*det, u*det, v*det] = ray_features[16] @ tri_features[16, 4]

Triangles are Morton-sorted and packed into blocks of SUB = 128, each a
[16, 512] column slab (det | t*det | u*det | v*det) with a box
(`aabbs` [8, NSUB]). Rays go in groups of RAY_TILE = 128; a group visits,
in ascending order, the blocks whose box one of its rays keeps in a slab
test (`kernels/cull.py:block_cull_mask`). Two kernels, hand-written in
CUDA (`csrc/rt_mxu.cu`), take the padded rays (`tables.pad_rays`), the
boxes and the table, and cull and sweep per group:

* `mxu_kernel` (K1): closest hit per ray — minimum t, ties to the lowest
  sorted index;
* `mxu_occl_kernel` (K2): any hit with t < t_limit per ray, over the
  culled blocks and, when given, one extra sub-block of plane constants
  that every ray tests (the oversized triangles, `tables.Tables.oversized`).

The JAX package builds each group's list and feature rows in device
memory first (`_prep_mxu`, a slab-test pre-pass compacted by a stable
argsort) and sweeps the oversized triangles with tensor ops
(`rt_tile._oversized_occl`); the kernels cull in shared memory, form the
features in registers, skip padding-only blocks (inverted box: every
triangle there is dropped) and contract only the coefficients that can be
non-zero, which changes no result. Each kernel has a plain PyTorch version
beside it (`_mxu_search_plain`, `_mxu_occl_plain`) with the same
arguments: it builds `_prep_mxu`'s lists and features and sweeps them
with the same visit order and tie rule. A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernel or raises.
Each wrapper counts its kernel launches in its `launches` attribute.

The scene tables (the cluster sort, the packed segments, the oversized
sub-block) are `kernels/tables.py`'s, shared with the tile route: inside a
`tables.search_tables()` block one sort and pack serve every chunk and
bounce of a trace.

Precision: the contraction must be float32-faithful. The JAX package
measured bf16x3 flipping ~1% of winners and ~6% of shadow tests, so the
kernels use float32 FMAs on the CUDA cores, and the plain version's
`bmm` needs `torch.backends.cuda.matmul.allow_tf32 = False` on the card.
Sums taken in another order than the reference's change last-ulp t
values: a winner can flip only on an exact near-tie.

The JAX package's pre-pass switch, with its name, default and
resolution rule: `CULL_MODE` (None = "argsort"; "exact" and "interval"
as in `rt_tile`, the interval test over the whole 128-ray group; any
other name, "hier" and "entry" among them, is "argsort"). Each mode is
one instantiation of the same kernels on the card, slower there than the
default (PERF.md §6). The JAX package's bf16x3 contraction
(`SEARCH_BF16X3`) is not ported: it made K1 2.5x slower on the card,
where the contraction runs on float32 CUDA cores and not on an MXU.
"""

from __future__ import annotations

import ctypes

import torch

from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT, ray_features, tri_features
from esctp1raytracer_tpu_torch.kernels import _build, tables
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask, extract_lists, group_cull_mask
from esctp1raytracer_tpu_torch.kernels.tables import (
    RAY_W, ROWS, SUB, eps_tensor, orig_index, pad_rays, ptr, sweep_oversized,
)
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer
from esctp1raytracer_tpu_torch.utils import profiling

RAY_TILE = 128  # rays per group = threads per CUDA block
MXU_TRI_LIMIT = 32_768  # triangles per segment (256 blocks)

_INT_BIG = 2**31 - 1

# The pre-pass switch (module docstring), as in the JAX package.
CULL_MODE = None  # None = auto = "argsort"
_MODES = {"exact": 1, "interval": 2}  # the kernels' mode numbers; any other name is argsort


def _resolve_cull_mode() -> str:
    """The search's mode: CULL_MODE, else "argsort". (The JAX package's
    `_resolve_cull_mode(coherent, nsub)` reads neither argument.)"""
    return "argsort" if CULL_MODE is None else CULL_MODE


def _pack_mxu(sorted_tris: TriangleBuffer, exclude=None):
    """Pack feature columns quantity-major: tfq [NSUB, 16, 512], aabbs [8, NSUB].

    Column layout per block: [0:128) det | [128:256) t*det | [256:384)
    u*det | [384:512) v*det. Invalid or excluded triangles get zero
    columns (det = 0 fails the window) and an inverted box.
    """
    npad = sorted_tris.capacity
    keep = sorted_tris.valid if exclude is None else sorted_tris.valid & ~exclude
    tf = tri_features(sorted_tris.v0, sorted_tris.v1, sorted_tris.v2)
    tf = torch.where(keep[:, None, None], tf, 0.0)  # [N, 16, 4]
    nsub = npad // SUB
    tfq = (tf.reshape(nsub, SUB, 16, 4)
           .permute(0, 2, 3, 1)  # [NSUB, 16, 4, 128]
           .reshape(nsub, 16, 4 * SUB)
           .contiguous())
    return tfq, tables.block_boxes(sorted_tris, keep)


def _prep_mxu(o, d, aabbs, t_limit, m: int = RAY_TILE, cull_mode: str = "argsort"):
    """The JAX package's cull pre-pass: pad rays to m, cull per m-ray
    group in `cull_mode`, build feature rows.

    Returns (rf [G, m, 16], ids [G, NSUB] int32, cnt [G] int32,
    tl [G, m] or None, padded ray count, NSUB). Row g of `ids` lists the
    blocks some ray of group g can hit, ascending, in its first cnt[g]
    entries ("argsort": a stable argsort of the group's keep mask;
    "exact": extracted, every block above `cull.CULL_EXTRACT_K`;
    "interval": one interval test per group, extracted alike).
    """
    r = o.shape[0]
    pad = (-r) % m
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
        if t_limit is not None:
            t_limit = torch.cat([t_limit, t_limit.new_full((pad,), -1.0)])
    rp = r + pad
    nsub = aabbs.shape[1]
    if cull_mode == "interval":
        ids, cnt = extract_lists(group_cull_mask(o, d, aabbs, t_limit, group=m))
    else:
        mask = block_cull_mask(o, d, aabbs, t_limit)
        gmask = torch.any(mask.reshape(rp // m, m, nsub), dim=1)
        if cull_mode == "exact":
            ids, cnt = extract_lists(gmask)
        else:
            ids = torch.argsort((~gmask).to(torch.int64), dim=1, stable=True).to(torch.int32)
            cnt = torch.sum(gmask, dim=1).to(torch.int32)
    rf = ray_features(o, d).reshape(rp // m, m, 16)
    tl = None if t_limit is None else t_limit.reshape(rp // m, m)
    return rf, ids, cnt, tl, rp, nsub


def _window(s, eps, t_limit=None):
    """Split one block's [..., 512] contraction and apply the acceptance window."""
    det, t_num, u_num, v_num = torch.split(s, SUB, dim=-1)
    ok_det = torch.abs(det) >= eps
    inv = 1.0 / det  # det == 0 fails ok_det; its inf/NaN never passes
    t = t_num * inv
    u = u_num * inv
    v = v_num * inv
    ok = ok_det & (torch.minimum(u, v) >= eps) & (u + v <= 1.0) & (t >= eps)
    if t_limit is not None:
        ok = ok & (t < t_limit[..., None])
    return t, ok


def _listed(jb, tfq):
    """Block ids jb [G] as gather indices: an id past the table (an "exact"
    or "interval" list's entries past its count hold NSUB) reads the last
    block, which the sweeps mask out."""
    return jb.long().clamp(max=tfq.shape[0] - 1)


def _sweep_search(eps, ids, cnt, rf, tfq):
    """K1's sweep of given lists: (t [G, m] f32, sorted idx [G, m] int32).

    A running (t, block) per (ray, column) over the ascending block list,
    updated on strict <, then the lowest index among the minimum t.
    """
    g, m, _ = rf.shape
    bt = torch.full((g, m, SUB), BIG, dtype=torch.float32, device=rf.device)
    bb = torch.full((g, m, SUB), NO_HIT, dtype=torch.int32, device=rf.device)
    kmax = int(cnt.max()) if g else 0
    for k in range(kmax):
        jb = ids[:, k]
        t, ok = _window(torch.bmm(rf, tfq[_listed(jb, tfq)]), eps)
        better = ok & (t < bt) & (k < cnt)[:, None, None]
        bt = torch.where(better, t, bt)
        bb = torch.where(better, jb[:, None, None], bb)
    lane = torch.arange(SUB, dtype=torch.int32, device=rf.device)
    bi = torch.where(bb >= 0, bb * SUB + lane, _INT_BIG)
    tmin = torch.amin(bt, dim=-1, keepdim=True)
    imin = torch.amin(torch.where(bt == tmin, bi, _INT_BIG), dim=-1)
    tmin = tmin[..., 0]
    return tmin, torch.where(tmin < BIG, imin, NO_HIT)


def _sweep_occl(eps, ids, cnt, rf, tl, tfq):
    """K2's sweep of given lists: occluded [G, m] int32 (1 = some hit in (eps, t_limit))."""
    g, m, _ = rf.shape
    occ = torch.zeros((g, m), dtype=torch.bool, device=rf.device)
    kmax = int(cnt.max()) if g else 0
    for k in range(kmax):
        _, ok = _window(torch.bmm(rf, tfq[_listed(ids[:, k], tfq)]), eps, tl)
        occ |= torch.any(ok, dim=-1) & (k < cnt)[:, None]
    return occ.to(torch.int32)


def _plain_lists(rays, aabbs, cnt_out, mode="argsort"):
    """`_prep_mxu` in `mode` on padded rays [Rp, 8] (their t_limit column
    culls; +inf culls nothing): (rf, ids, cnt, tl); writes cnt to cnt_out
    when given."""
    rf, ids, cnt, tl, _, _ = _prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6],
                                       cull_mode=mode)
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    return rf, ids, cnt, tl


def _mxu_search_plain(eps, rays, aabbs, tfq, cnt_out=None, mode="argsort"):
    """Plain version of K1: `_prep_mxu`'s lists in `mode`, swept by
    `_sweep_search`. Returns (t [Rp] f32, sorted idx [Rp] int32)."""
    rf, ids, cnt, _ = _plain_lists(rays, aabbs, cnt_out, mode)
    t, idx = _sweep_search(eps, ids, cnt, rf, tfq)
    return t.reshape(-1), idx.reshape(-1)


def _mxu_occl_plain(eps, rays, aabbs, tfq, ov=None, cnt_out=None, mode="argsort"):
    """Plain version of K2: `_prep_mxu`'s lists in `mode`, swept by
    `_sweep_occl`, ORed with every ray against the sub-block of plane
    constants `ov` [1, 16, 128] when given (`tables.sweep_oversized`, as
    K6's plain version does). Returns occluded [Rp] int32."""
    rf, ids, cnt, tl = _plain_lists(rays, aabbs, cnt_out, mode)
    occ = _sweep_occl(eps, ids, cnt, rf, tl, tfq).reshape(-1)
    if ov is not None:
        occ |= sweep_oversized(eps, rays, ov)
    return occ


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/rt_mxu.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rt_mxu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_mxu_search.argtypes = [vp] * 7 + [ci, ci, vp]
        lib.rt_mxu_occl.argtypes = [vp] * 7 + [ci, ci, vp]
        lib.rt_mxu_search_mode.argtypes = [vp] * 7 + [ci] * 3 + [vp]
        lib.rt_mxu_occl_mode.argtypes = [vp] * 7 + [ci] * 3 + [vp]
        for fn in ("rt_mxu_search", "rt_mxu_occl", "rt_mxu_search_mode", "rt_mxu_occl_mode"):
            getattr(lib, fn).restype = ci
        _LIB = lib
    return _LIB


def _check(eps, rays, aabbs, tfq, ov=None, cnt_out=None):
    """Validate the kernels' inputs; returns (G, NSUB)."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"mxtile kernels take CUDA or CPU tensors, got {dev}")
    g, nsub = rays.shape[0] // RAY_TILE, aabbs.shape[1]
    if nsub > MXU_TRI_LIMIT // SUB:
        raise ValueError(f"aabbs: {nsub} blocks, the kernels take at most "
                         f"{MXU_TRI_LIMIT // SUB}")
    want = {"eps": (eps, torch.float32, (1,)),
            "rays": (rays, torch.float32, (RAY_TILE * g, RAY_W)),
            "aabbs": (aabbs, torch.float32, (8, nsub)),
            "tfq": (tfq, torch.float32, (nsub, 16, 4 * SUB))}
    if ov is not None:
        want["ov"] = (ov, torch.float32, (1, ROWS, SUB))
    if cnt_out is not None:
        want["cnt_out"] = (cnt_out, torch.int32, (g,))
    _build.check_tensors(want, dev)
    if any(x is not None and x.data_ptr() % 16 for x in (rays, tfq, ov)):
        raise ValueError("rays, tfq and ov must be 16-byte aligned (float4 loads, cp.async)")
    return g, nsub


def mxu_kernel(eps, rays, aabbs, tfq, cnt_out=None, mode="argsort"):
    """K1, closest hit per ray over the blocks each 128-ray group keeps.

    eps f32 [1]; rays f32 [128G, 8] (o, d, t_limit, pad; from
    `tables.pad_rays`; t_limit only culls, t is never clamped to it);
    aabbs f32 [8, NSUB] (NSUB <= 256); tfq f32 [NSUB, 16, 512]; cnt_out
    int32 [G] or None: receives each group's list length (padding-only
    blocks included); mode: the pre-pass mode whose lists the kernel walks
    (module docstring). Returns (t [128G] f32 — BIG on a miss, sorted index
    [128G] int32 — -1 on a miss).
    """
    if rays.device.type == "cpu":
        return _mxu_search_plain(eps, rays, aabbs, tfq, cnt_out, mode)
    g, nsub = _check(eps, rays, aabbs, tfq, cnt_out=cnt_out)
    m = _MODES.get(mode, 0)
    t = torch.empty((RAY_TILE * g,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((RAY_TILE * g,), dtype=torch.int32, device=rays.device)
    if g:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (ptr(x) for x in (eps, rays, aabbs, tfq, t, idx, cnt_out))
        if m == 0:
            err = _lib().rt_mxu_search(*ptrs, g, nsub, stream)
        else:
            err = _lib().rt_mxu_search_mode(*ptrs, g, nsub, m, stream)
        _build.check_launch(_lib(), "rt_mxu", err)
        mxu_kernel.launches += 1
    return t, idx


def mxu_occl_kernel(eps, rays, aabbs, tfq, ov=None, cnt_out=None, mode="argsort"):
    """K2, any hit per ray with eps <= t < t_limit over the blocks each
    group keeps, and over the sub-block of plane constants ov f32
    [1, 16, 128] for every ray when given. Other inputs as `mxu_kernel`.
    Returns int32 [128G] (1 = occluded).
    """
    if rays.device.type == "cpu":
        return _mxu_occl_plain(eps, rays, aabbs, tfq, ov, cnt_out, mode)
    g, nsub = _check(eps, rays, aabbs, tfq, ov, cnt_out)
    m = _MODES.get(mode, 0)
    occ = torch.empty((RAY_TILE * g,), dtype=torch.int32, device=rays.device)
    if g:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (ptr(x) for x in (eps, rays, aabbs, tfq, ov, occ, cnt_out))
        if m == 0:
            err = _lib().rt_mxu_occl(*ptrs, g, nsub, stream)
        else:
            err = _lib().rt_mxu_occl_mode(*ptrs, g, nsub, m, stream)
        _build.check_launch(_lib(), "rt_mxu", err)
        mxu_occl_kernel.launches += 1
    return occ


mxu_kernel.launches = 0
mxu_occl_kernel.launches = 0


def _tables(tris: TriangleBuffer) -> tables.Tables:
    """`tris`' tables (`tables.lookup`), counted on the innermost span: one
    `rt_mxu.table_calls`, and one `rt_mxu.table_builds` where this call
    builds the cluster sort."""
    found = tables.lookup(tris)
    profiling.count("rt_mxu.table_calls", 1)
    if not found.built:
        profiling.count("rt_mxu.table_builds", 1)
    return found


def _tested(rays):
    """While spans are on, the kernels' cnt_out: each group's list length,
    summed into the counter of the search's span (utils/profiling.py)."""
    if not profiling.enabled():
        return None
    return torch.empty((rays.shape[0] // RAY_TILE,), dtype=torch.int32, device=rays.device)


def mxu_tile_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    `t_limit` only culls (see `mxu_kernel`). Segments combine first-wins:
    an earlier segment keeps a tie. The span `rt_mxu.prepass` holds the
    rays' padding and the sort and pack where this call builds them
    (`tables.search_tables`); while spans are on, the counters `rt_mxu.table_calls`
    and `rt_mxu.table_builds` count the call and its build, and
    `rt_mxu.closest_hit_blocks` sums the blocks K1's groups test.
    """
    with profiling.annotate("rt_mxu.prepass"):
        eps_arr = eps_tensor(eps, o.device)
        rays = pad_rays(o, d, t_limit)
        segments = _tables(tris).segments(_pack_mxu, MXU_TRI_LIMIT)
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    mode = _resolve_cull_mode()
    for tfq, aabbs, perm_k in segments:
        cnt = _tested(rays)
        t_k, idx_k = mxu_kernel(eps_arr, rays, aabbs, tfq, cnt_out=cnt, mode=mode)
        if cnt is not None:
            profiling.count("rt_mxu.closest_hit_blocks", cnt.sum())
        t_k, idx_k = t_k[:r], idx_k[:r]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, orig_index(idx_k, perm_k), best_i)
    return best_t, best_i


def mxu_tile_occlusion(o, d, t_limit, tris: TriangleBuffer, eps) -> torch.Tensor:
    """Occlusion [R] bool: any accepted hit in (eps, t_limit). The oversized
    triangles go to the first segment's K2 launch as one extra sub-block.
    Spans and counter as `mxu_tile_search` (`rt_mxu.any_hit_blocks`)."""
    with profiling.annotate("rt_mxu.prepass"):
        eps_arr = eps_tensor(eps, o.device)
        rays = pad_rays(o, d, t_limit)
        found = _tables(tris)
        segments = found.segments(_pack_mxu, MXU_TRI_LIMIT, exclude_oversized=True)
        ov = found.oversized()
    r = o.shape[0]
    occluded = torch.zeros((r,), dtype=torch.bool, device=o.device)
    mode = _resolve_cull_mode()
    for k, (tfq, aabbs, _) in enumerate(segments):
        cnt = _tested(rays)
        occluded |= mxu_occl_kernel(eps_arr, rays, aabbs, tfq, ov if k == 0 else None,
                                    cnt_out=cnt, mode=mode)[:r] > 0
        if cnt is not None:
            profiling.count("rt_mxu.any_hit_blocks", cnt.sum())
    return occluded


mxu_tile_search.occlusion = mxu_tile_occlusion
