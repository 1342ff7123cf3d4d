"""Tile search: 8-ray bundles x 128-triangle sub-blocks (the `tile` backend).

Counterpart of `esctp1raytracer_tpu/kernels/rt_tile.py`. Triangles are
cluster-sorted (Morton order, oversized ones segregated) and packed into
sub-blocks of SUB = 128 by the scene-table layer the mxtile search
shares (`kernels/tables.py`, `pack_planes`), each a [16, 128] slab of
plane/barycentric constants: the table `tc` [NSUB, 16, 128] holds per
triangle the normal, n.v0, w_u, b_u, w_v, b_v and keep (13 rows, padded
to 16); dropped triangles have a zero normal, so det == 0 rejects them. Rays go in
bundles of COHERENT = 8. A bundle visits, in ascending order, the
sub-blocks whose box (`aabbs` [8, NSUB]) one of its rays keeps in a slab
test (`kernels/cull.py:block_cull_mask`). Two kernels, hand-written in
CUDA (`csrc/rt_tile.cu`), take the padded rays, the boxes and the table,
and cull and sweep per bundle:

* `tile_kernel` (K5): closest hit per ray -- minimum t, ties to the
  lowest sorted index;
* `tile_occl_kernel` (K6): any hit with eps <= t < t_limit per ray, over
  the culled sub-blocks and, when given, one extra sub-block that every
  ray tests (the oversized triangles).

The JAX package builds each bundle's list in device memory first (a
slab-test pre-pass compacted by a stable argsort, `_lists` here); the
kernels build theirs in registers and skip padding-only sub-blocks
(inverted box: every triangle there is dropped), which changes no result.
Each kernel has a plain PyTorch version beside it (`_tile_search_plain`,
`_tile_occl_plain`) with the same arguments: it builds the JAX package's
lists and sweeps them with the same visit order and tie rule. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises. Each wrapper counts its kernel launches in its
`launches` attribute. The per-pair test is the one K3 and K4 use
(`lane_pallas.plane_pair`, `csrc/lane_plane.cuh`).

The closest-hit search culls with its caller's `t_limit` (a sphere hit,
say) but never clamps t to it, as the JAX kernel does: a kept sub-block
may still return a hit beyond the limit. Oversized triangles (ground
planes, area lights) stay in the search table; the occlusion excludes up
to OVER_CAP of them from the segment tables and K6 tests them as one
extra sub-block in the first segment's launch: their shared box could
never be culled by a shadow ray's t-limit, while out here the floor
fails the direction test and the light's tight box fails the t-window.
Tables over TILE_TRI_LIMIT triangles go through in segments, combined
first-wins.

While spans are on (`utils/profiling.py`), each search's table work -- the
rays' padding, the one cluster sort of a trace (built by the first search
that asks), each search's packed segments and the any-hit search's
oversized sub-block -- is the span `rt_tile.prepass`, and the any-hit
search counts, on its caller's innermost span (`intersect.any_hit`), the
live shadow rays that each launch after the first tests
(`rt_tile.occl_later_rays`) and those of them that an earlier launch
already found occluded (`rt_tile.occl_settled_rays`): K6 tests them again.

The JAX package's pre-pass switches, with its names, defaults and
resolution rules (`tile_tri_search`, `tile_occlusion`):

* `CULL_MODE` (None = "argsort"): how a bundle's list is built --
  "argsort" (the per-ray mask, ascending), "exact" (the same, but more
  than `cull.CULL_EXTRACT_K` kept sub-blocks sweep every sub-block),
  "interval" (one interval test per bundle, `cull.group_cull_mask`, with
  the same fallback), "hier" (superblocks of HIER_GROUP first, at most
  HIER_K kept, else every sub-block; padding-only sub-blocks are never
  listed) and "entry" (nearest-first by the bundle's slab entry t; for
  the any-hit search only: K5's tie rule needs ascending lists);
* `OCCL_EARLY_EXIT` (E, 0 = off): "entry" lists for the any-hit search,
  tested for "every ray occluded" every E sub-blocks.

K5 and K6 run each mode on the card as another instantiation of the
kernels (the default, argsort with E = 0, is the kernels' own two-level
cull), visiting the same sub-blocks as the plain version's lists in the
same order, and count the same kept total. Every mode is slower on the
card than the default (PERF.md §6), as the JAX package measured on
the TPU. The JAX package's coarse cull (`_CULL_COLS`) and oversized
pre-hit (`PRIMARY_PREHIT`) are not ported: the first never acts at its
default on a segment of at most 1024 sub-blocks, the second made the
search 7-11x slower on the card.
"""

from __future__ import annotations

import ctypes

import torch

from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT
from esctp1raytracer_tpu_torch.kernels import _build, tables
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask, extract_lists, group_cull_mask
from esctp1raytracer_tpu_torch.kernels.lane_pallas import plane_pair
from esctp1raytracer_tpu_torch.kernels.tables import (
    RAY_GROUP, RAY_W, ROWS, SUB, eps_tensor, orig_index, pack_planes, pad_rays, plane_hits, ptr,
    sweep_oversized,
)
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer
from esctp1raytracer_tpu_torch.utils import profiling

COHERENT = 8  # rays per bundle = one warp's rays in the kernels
TILE_TRI_LIMIT = 131_072  # triangles per segment: NSUB <= 1024
# The list builder holds ~40 bytes per (ray, sub-block) pair of slab
# temporaries at its peak (kernels/cull.py), so it streams in ray chunks
# of about this many pairs: 64M pairs keep the peak near 2.7 GB, and
# config 5 (8.3M rays x 784 sub-blocks) runs in 98 chunks. Any chunk that
# is a multiple of COHERENT gives the same lists.
_PREPASS_ELEMS = 64 * 1024 * 1024
# The oversized sweep holds ~10 [rays, OVER_CAP] temporaries: 512k rays at
# a time keep them near 2.7 GB (config 5's 8.3M rays in one go: ~43 GB).
_SWEEP_RAYS = 1 << 19

_INT_BIG = 2**31 - 1

# The pre-pass switches (module docstring), as in the JAX package.
CULL_MODE = None  # None = auto = "argsort"
OCCL_EARLY_EXIT = 0
HIER_GROUP = 8  # sub-blocks per superblock of the "hier" lists
HIER_K = 32  # kept superblocks above which "hier" sweeps every sub-block
# The kernels' mode numbers; any other name is "argsort", as in the JAX package.
_MODES = {"exact": 1, "interval": 2, "hier": 3, "entry": 4}


def _resolve_cull_mode() -> str:
    """The search's mode: CULL_MODE, else "argsort". (The JAX package's
    `_resolve_cull_mode(coherent, nsub)` reads neither argument.)"""
    return "argsort" if CULL_MODE is None else CULL_MODE


def _oversized_hits(o, d, ov_buf: TriangleBuffer, eps):
    """One-pass sweep over the oversized set: (t [R, K], ok [R, K]), with
    the kernels' constants (`tables.pack_planes`) and per-pair test, so the
    merged result equals what the kernel would give."""
    return plane_hits(o, d, pack_planes(ov_buf)[0][0], eps)


def _oversized_occl(o, d, t_limit, ov_buf: TriangleBuffer, eps):
    """One-pass any-hit over the excluded set: [R] bool, in chunks of
    _SWEEP_RAYS rays (each ray's answer is its own)."""
    out = []
    for i in range(0, max(o.shape[0], 1), _SWEEP_RAYS):
        sl = slice(i, i + _SWEEP_RAYS)
        t, ok = _oversized_hits(o[sl], d[sl], ov_buf, eps)
        out.append(torch.any(ok & (t < t_limit[sl, None]), dim=1))
    return torch.cat(out)


# --------------------------------------------------------------------------
# The JAX package's per-bundle lists
# --------------------------------------------------------------------------


def _hier_cull_lists(o, d, t_limit, aabbs):
    """The JAX package's two-level lists for one ray chunk: a per-ray slab
    test of the superblock boxes (unions of HIER_GROUP adjacent sub-block
    boxes; all-padding ones masked) OR-folded per bundle, then of the
    sub-boxes of the first min(HIER_K, superblocks) superblocks of its
    stable argsort (the kept ones first). More kept superblocks: every
    sub-block, ascending, cnt = NSUB. Padding-only sub-blocks never enter
    a list. Returns (ids [chunk / 8, NSUB] int32, cnt [chunk / 8] int32)."""
    nsub = aabbs.shape[1]
    g = HIER_GROUP
    pad = (-nsub) % g
    aabbs_p = aabbs
    if pad:
        aabbs_p = torch.cat([aabbs, torch.cat([aabbs.new_full((3, pad), 1e30),
                                               aabbs.new_full((3, pad), -1e30),
                                               aabbs.new_zeros((2, pad))])], dim=1)
    ns = (nsub + pad) // g
    k = min(HIER_K, ns)
    smin = aabbs_p[0:3].reshape(3, ns, g).amin(2)
    smax = aabbs_p[3:6].reshape(3, ns, g).amax(2)
    sempty = (smin > smax).any(0)
    cm = block_cull_mask(o, d, torch.cat([smin, smax, aabbs.new_zeros((2, ns))]), t_limit)
    gs = cm.reshape(-1, COHERENT, ns).any(1) & ~sempty[None]
    over = torch.sum(gs, dim=1) > k
    sids = torch.argsort((~gs).to(torch.uint8), dim=1, stable=True)[:, :k]
    sub_ids = (sids[:, :, None] * g + torch.arange(g, device=o.device)).reshape(-1, k * g)
    nb = sub_ids.shape[0]
    ob = o.reshape(nb, COHERENT, 3)
    invd = 1.0 / d.reshape(nb, COHERENT, 3)
    tn = o.new_full((nb, COHERENT, k * g), float("-inf"))
    tf = o.new_full((nb, COHERENT, k * g), float("inf"))
    femp = torch.zeros((nb, k * g), dtype=torch.bool, device=o.device)
    for a in range(3):
        fmin_a, fmax_a = aabbs_p[a][sub_ids], aabbs_p[3 + a][sub_ids]  # [B, k*g]
        femp |= fmin_a > fmax_a
        oa, ia = ob[:, :, a, None], invd[:, :, a, None]
        t0a = (fmin_a[:, None, :] - oa) * ia  # [B, 8, k*g]
        t1a = (fmax_a[:, None, :] - oa) * ia
        tn = torch.maximum(tn, torch.minimum(t0a, t1a))
        tf = torch.minimum(tf, torch.maximum(t0a, t1a))
    reject = (tn > tf) | (tf < 0.0)
    if t_limit is not None:
        reject |= tn > t_limit.reshape(nb, COHERENT)[:, :, None]
    fm = (~reject).any(1) & (sub_ids < nsub) & ~femp
    cnt = torch.sum(fm, dim=1, dtype=torch.int32)
    order = torch.argsort((~fm).to(torch.uint8), dim=1, stable=True)
    ids = torch.take_along_dim(sub_ids, order, dim=1).to(torch.int32)
    iota = torch.arange(nsub, dtype=torch.int32, device=o.device)
    ids = (torch.cat([ids, iota[None, k * g:].expand(nb, -1)], dim=1) if nsub > k * g
           else ids[:, :nsub])
    return (torch.where(over[:, None], iota[None], ids),
            torch.where(over, nsub, cnt).to(torch.int32))


def _cull_lists(o, d, t_limit, aabbs, cull_mode="argsort"):
    """Per-bundle sub-block lists for one ray chunk, as the JAX package's
    `_cull_lists` builds them in `cull_mode`: (ids [chunk / 8, NSUB]
    int32, cnt [chunk / 8] int32). "argsort": a per-ray slab mask,
    OR-folded over each bundle, compacted by a stable argsort."""
    nsub = aabbs.shape[1]
    if cull_mode == "hier":
        return _hier_cull_lists(o, d, t_limit, aabbs)
    if cull_mode == "interval":
        return extract_lists(group_cull_mask(o, d, aabbs, t_limit, group=COHERENT))
    if cull_mode == "entry":
        # Nearest-first: keys are the bundle-min slab entry t (+inf where
        # culled). A NaN entry (kept) becomes -inf and an entry that
        # overflowed is clamped, so every kept block stays in the prefix.
        mask, tn = block_cull_mask(o, d, aabbs, t_limit, return_entry=True)
        tn = torch.minimum(torch.where(torch.isnan(tn), float("-inf"), tn), tn.new_tensor(3.0e38))
        gkey = torch.where(mask, tn, float("inf")).reshape(-1, COHERENT, nsub).amin(1)
        ids = torch.argsort(gkey, dim=1, stable=True).to(torch.int32)
        return ids, torch.sum(mask.reshape(-1, COHERENT, nsub).any(1), dim=1, dtype=torch.int32)
    gmask = torch.any(block_cull_mask(o, d, aabbs, t_limit).reshape(-1, COHERENT, nsub), dim=1)
    if cull_mode == "exact":
        return extract_lists(gmask)
    ids = torch.argsort((~gmask).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    return ids, torch.sum(gmask, dim=1, dtype=torch.int32)


def _lists(rays, aabbs, cull_mode="argsort"):
    """The JAX package's cull pre-pass (`_prep`) on padded rays [Rp, 8]:
    (ids [Rp / 8, NSUB] int32, cnt [Rp / 8] int32). Row b of `ids` lists,
    in its first cnt[b] entries, the sub-blocks bundle b sweeps, in the
    order `cull_mode` gives them, culling by the rays' t_limit (+inf: no
    cull). Streams in ray chunks of about _PREPASS_ELEMS (ray, sub-block)
    pairs (one chunk for a small wavefront)."""
    rp, nsub = rays.shape[0], aabbs.shape[1]
    # The JAX package coarsens the cull above 1024 sub-blocks; a segment
    # never has more (TILE_TRI_LIMIT / SUB), so that path is not carried over.
    assert nsub <= TILE_TRI_LIMIT // SUB, nsub
    chunk = max(RAY_GROUP, _PREPASS_ELEMS // nsub // RAY_GROUP * RAY_GROUP)
    ids = torch.empty((rp // COHERENT, nsub), dtype=torch.int32, device=rays.device)
    cnt = torch.empty((rp // COHERENT,), dtype=torch.int32, device=rays.device)
    for i in range(0, rp, chunk):
        r, bl = rays[i:i + chunk], slice(i // COHERENT, (i + chunk) // COHERENT)
        ids[bl], cnt[bl] = _cull_lists(r[:, 0:3], r[:, 3:6], r[:, 6], aabbs, cull_mode)
    return ids, cnt


# --------------------------------------------------------------------------
# Plain versions of K5 and K6
# --------------------------------------------------------------------------


def _bundle_rays(rays):
    """rays [Rp, 8] -> (o, d, t_limit), each a tuple or tensor of [B, 8, 1] columns."""
    r = rays.reshape(-1, COHERENT, RAY_W, 1)
    return (r[:, :, 0], r[:, :, 1], r[:, :, 2]), (r[:, :, 3], r[:, :, 4], r[:, :, 5]), r[:, :, 6]


def _block_pairs(tc, jb, o, d, eps):
    """Every bundle's 8 rays against its sub-block jb [B]: (t, ok) [B, 8, 128].
    An id past the table (an "exact" or "interval" list's entries past its
    count hold NSUB) reads the last sub-block; the sweeps mask it out."""
    c = tc[jb.long().clamp(max=tc.shape[0] - 1)][:, :12, None, :]  # [B, 12, 1, 128]
    return plane_pair(o, d, [c[:, i] for i in range(12)], eps)


def _sweep_search(eps, rays, ids, cnt, tc):
    """K5's sweep of given lists: (t [Rp] f32 -- BIG on a miss, sorted idx
    [Rp] int32 -- -1 on a miss).

    A running (t, sub-block) per (ray, lane) over the bundle's ascending
    list, updated on strict <, then the lowest index among the lanes at
    the minimum t: the minimum t, ties to the lowest sorted index.
    """
    eps = float(eps.reshape(-1)[0])
    b = cnt.shape[0]
    o, d, _ = _bundle_rays(rays)
    bt = torch.full((b, COHERENT, SUB), BIG, dtype=torch.float32, device=rays.device)
    bb = torch.full((b, COHERENT, SUB), NO_HIT, dtype=torch.int32, device=rays.device)
    for k in range(int(cnt.max()) if b else 0):
        jb = ids[:, k]
        t, ok = _block_pairs(tc, jb, o, d, eps)
        better = ok & (t < bt) & (k < cnt)[:, None, None]
        bt = torch.where(better, t, bt)
        bb = torch.where(better, jb[:, None, None], bb)
    lane = torch.arange(SUB, dtype=torch.int32, device=rays.device)
    bi = torch.where(bb >= 0, bb * SUB + lane, _INT_BIG)
    tmin = torch.amin(bt, dim=-1, keepdim=True)
    imin = torch.amin(torch.where(bt == tmin, bi, _INT_BIG), dim=-1)
    tmin = tmin[..., 0]
    return tmin.reshape(-1), torch.where(tmin < BIG, imin, NO_HIT).reshape(-1)


def _sweep_occl(eps, rays, ids, cnt, tc, early_exit=0):
    """K6's sweep of given lists: occluded [Rp] int32 (1 = some hit with
    eps <= t < t_limit in the bundle's list). With early_exit E > 0 a
    bundle stops at the first multiple of E listed sub-blocks after which
    every one of its rays is occluded (the JAX kernel's exit; the same
    answer)."""
    eps = float(eps.reshape(-1)[0])
    b = cnt.shape[0]
    o, d, tl = _bundle_rays(rays)
    occ = torch.zeros((b, COHERENT), dtype=torch.bool, device=rays.device)
    active = torch.ones((b,), dtype=torch.bool, device=rays.device)
    for k in range(int(cnt.max()) if b else 0):
        if early_exit and k and k % early_exit == 0:
            active &= ~occ.all(1)
        t, ok = _block_pairs(tc, ids[:, k], o, d, eps)
        occ |= torch.any(ok & (t < tl), dim=-1) & ((k < cnt) & active)[:, None]
    return occ.to(torch.int32).reshape(-1)


def _search_mode(mode):
    """K5's modes: an "entry" list is not ascending, and K5's tie rule (the
    lowest sorted index at the minimum t) needs ascending visits."""
    if mode == "entry":
        raise ValueError('the tile search (K5) takes no "entry" lists: they are the any-hit '
                         "search's (K6), nearest-first; use argsort, exact, interval or hier")
    return mode


def _tile_search_plain(eps, rays, aabbs, tc, cnt_out=None, mode="argsort"):
    """Plain version of K5: the JAX package's lists in `mode` (`_lists`),
    swept by `_sweep_search`. Writes the lists' lengths to cnt_out when
    given."""
    ids, cnt = _lists(rays, aabbs, _search_mode(mode))
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    return _sweep_search(eps, rays, ids, cnt, tc)


def _tile_occl_plain(eps, rays, aabbs, tc, ov=None, cnt_out=None, mode="argsort",
                     early_exit=0):
    """Plain version of K6: the JAX package's lists in `mode` (`_lists`),
    swept by `_sweep_occl` (with its exit period `early_exit`), ORed with
    every ray against the sub-block `ov` [1, 16, 128] when given. Writes
    the lists' lengths to cnt_out."""
    ids, cnt = _lists(rays, aabbs, mode)
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    occ = _sweep_occl(eps, rays, ids, cnt, tc, early_exit)
    if ov is not None:
        occ |= sweep_oversized(eps, rays, ov)
    return occ


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/rt_tile.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rt_tile")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_tile_search.argtypes = [vp] * 8 + [ci, ci, vp]
        lib.rt_tile_occl.argtypes = [vp] * 8 + [ci, ci, vp]
        lib.rt_tile_search_mode.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        lib.rt_tile_occl_mode.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        for fn in ("rt_tile_search", "rt_tile_occl", "rt_tile_search_mode", "rt_tile_occl_mode"):
            getattr(lib, fn).restype = ci
        _LIB = lib
    return _LIB


def _check(eps, rays, aabbs, tc, ov=None, cnt_out=None):
    """Validate the kernels' inputs; returns (bundles, NSUB)."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"tile kernels take CUDA or CPU tensors, got {dev}")
    b, nsub = rays.shape[0] // COHERENT, aabbs.shape[1]
    if nsub > TILE_TRI_LIMIT // SUB:
        raise ValueError(f"aabbs: {nsub} sub-blocks, the kernels take at most "
                         f"{TILE_TRI_LIMIT // SUB}")
    want = {"eps": (eps, torch.float32, (1,)), "rays": (rays, torch.float32, (COHERENT * b, RAY_W)),
            "aabbs": (aabbs, torch.float32, (8, nsub)),
            "tc": (tc, torch.float32, (nsub, ROWS, SUB))}
    if ov is not None:
        want["ov"] = (ov, torch.float32, (1, ROWS, SUB))
    if cnt_out is not None:
        want["cnt_out"] = (cnt_out, torch.int32, (b,))
    _build.check_tensors(want, dev)
    return b, nsub


def _group_boxes(aabbs):
    """The kernels' first cull level, [8, ceil(NSUB / 32)]: per run of 32
    sub-blocks, the union of the boxes that are not inverted (rows 0-5;
    inverted where every one is: padding only) and, in row 6, 1 where one
    of them is inverted (padding only, which the union does not contain:
    counting a bundle's kept sub-blocks tests such a group box by box)."""
    nsub = aabbs.shape[1]
    pad = (-nsub) % 32
    inverted = (aabbs[0:3] > aabbs[3:6]).any(0)
    lo = torch.cat([aabbs[0:3], aabbs.new_full((3, pad), float("inf"))], 1).reshape(3, -1, 32)
    hi = torch.cat([aabbs[3:6], aabbs.new_full((3, pad), float("-inf"))], 1).reshape(3, -1, 32)
    flag = torch.cat([inverted, inverted.new_zeros(pad)]).reshape(1, -1, 32).any(-1)
    return torch.cat([lo.amin(-1), hi.amax(-1), flag.to(aabbs.dtype),
                      aabbs.new_zeros((1, flag.shape[1]))]).contiguous()


def tile_kernel(eps, rays, aabbs, tc, cnt_out=None, mode="argsort"):
    """K5, closest hit per ray over the sub-blocks each bundle keeps.

    eps f32 [1]; rays f32 [8B, 8] (o, d, t_limit, pad; from `tables.pad_rays`;
    t_limit only culls, t is never clamped to it); aabbs f32 [8, NSUB]; tc
    f32 [NSUB, 16, 128]; cnt_out int32 [B] or None: receives each bundle's
    list length (padding-only sub-blocks included; counting them costs the
    kernel a box-by-box test of their groups); mode: the pre-pass mode
    whose lists the kernel walks (module docstring). Returns (t [8B] f32 --
    BIG on a miss, sorted index [8B] int32 -- -1 on a miss).
    """
    if rays.device.type == "cpu":
        return _tile_search_plain(eps, rays, aabbs, tc, cnt_out, mode)
    m = _MODES.get(_search_mode(mode), 0)
    b, nsub = _check(eps, rays, aabbs, tc, cnt_out=cnt_out)
    t = torch.empty((COHERENT * b,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((COHERENT * b,), dtype=torch.int32, device=rays.device)
    if b:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        if m == 0:
            ptrs = (ptr(x) for x in (eps, rays, aabbs, _group_boxes(aabbs), tc, t, idx, cnt_out))
            err = _lib().rt_tile_search(*ptrs, b, nsub, stream)
        else:
            ptrs = (ptr(x) for x in (eps, rays, aabbs, tc, t, idx, cnt_out))
            err = _lib().rt_tile_search_mode(*ptrs, b, nsub, m, HIER_GROUP, HIER_K, stream)
        _build.check_launch(_lib(), "rt_tile", err)
        tile_kernel.launches += 1
    return t, idx


def tile_occl_kernel(eps, rays, aabbs, tc, ov=None, cnt_out=None, mode="argsort",
                     early_exit=0):
    """K6, any hit per ray with eps <= t < t_limit over the sub-blocks each
    bundle keeps, and over the sub-block ov f32 [1, 16, 128] for every ray
    when given. early_exit E > 0: the bundle tests "every ray occluded or
    unable to be" every E listed sub-blocks (else after each). Other inputs
    as `tile_kernel` ("entry" lists too). Returns int32 [8B] (1 = occluded).
    """
    if rays.device.type == "cpu":
        return _tile_occl_plain(eps, rays, aabbs, tc, ov, cnt_out, mode, early_exit)
    m = _MODES.get(mode, 0)
    b, nsub = _check(eps, rays, aabbs, tc, ov, cnt_out)
    occ = torch.empty((COHERENT * b,), dtype=torch.int32, device=rays.device)
    if b:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        if m == 0 and not early_exit:
            ptrs = (ptr(x) for x in (eps, rays, aabbs, _group_boxes(aabbs), tc, ov, occ, cnt_out))
            err = _lib().rt_tile_occl(*ptrs, b, nsub, stream)
        else:
            ptrs = (ptr(x) for x in (eps, rays, aabbs, tc, ov, occ, cnt_out))
            err = _lib().rt_tile_occl_mode(*ptrs, b, nsub, m, HIER_GROUP, HIER_K,
                                           max(int(early_exit), 1), stream)
        _build.check_launch(_lib(), "rt_tile", err)
        tile_occl_kernel.launches += 1
    return occ


tile_kernel.launches = 0
tile_occl_kernel.launches = 0


# --------------------------------------------------------------------------
# Search entry points
# --------------------------------------------------------------------------


def tile_tri_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    `t_limit` only culls (see the module docstring). Segments combine
    first-wins: an earlier segment keeps a tie. The tables are
    `tables.lookup`'s: built by this call, or shared in an open scope. The
    span `rt_tile.prepass` holds the rays' padding and the sort and pack
    where this call builds them.
    """
    with profiling.annotate("rt_tile.prepass"):
        eps_arr = eps_tensor(eps, o.device)
        rays = pad_rays(o, d, t_limit)
        segments = tables.lookup(tris).segments(pack_planes, TILE_TRI_LIMIT)
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    mode = _resolve_cull_mode()
    for tc, aabbs, perm_k in segments:
        t_k, idx_k = tile_kernel(eps_arr, rays, aabbs, tc, mode=mode)
        t_k, idx_k = t_k[:r], idx_k[:r]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, orig_index(idx_k, perm_k), best_i)
    return best_t, best_i


def _occl_mode() -> str:
    """The any-hit search's mode: CULL_MODE when set, else "entry" under
    OCCL_EARLY_EXIT (nearest-first lists), else "argsort"."""
    if CULL_MODE is not None:
        return CULL_MODE
    return "entry" if OCCL_EARLY_EXIT else "argsort"


def tile_occlusion(o, d, t_limit, tris: TriangleBuffer, eps) -> torch.Tensor:
    """Occlusion [R] bool: any accepted hit in (eps, t_limit). The oversized
    triangles go to the first segment's K6 launch as one extra sub-block.
    Tables and span as `tile_tri_search` (the oversized sub-block's pack
    too); before each launch after the first, the two counters of the
    module docstring, summed on the device (live: t_limit > 0)."""
    with profiling.annotate("rt_tile.prepass"):
        eps_arr = eps_tensor(eps, o.device)
        rays = pad_rays(o, d, t_limit)
        found = tables.lookup(tris)
        segments = found.segments(pack_planes, TILE_TRI_LIMIT, exclude_oversized=True)
        ov = found.oversized()
    r = o.shape[0]
    occluded = torch.zeros((r,), dtype=torch.bool, device=o.device)
    mode = _occl_mode()
    for k, (tc, aabbs, _) in enumerate(segments):
        if k and profiling.enabled():
            live = t_limit > 0.0
            profiling.count("rt_tile.occl_later_rays", live.sum())
            profiling.count("rt_tile.occl_settled_rays", (live & occluded).sum())
        occluded |= tile_occl_kernel(eps_arr, rays, aabbs, tc, ov if k == 0 else None,
                                     mode=mode, early_exit=OCCL_EARLY_EXIT)[:r] > 0
    return occluded


tile_tri_search.occlusion = tile_occlusion
