"""Tile search: 8-ray bundles x 128-triangle sub-blocks (the `tile` backend).

Counterpart of `esctp1raytracer_tpu/kernels/rt_tile.py`. Triangles are
cluster-sorted (Morton order, oversized ones segregated) and packed into
sub-blocks of SUB = 128, each a [16, 128] slab of plane/barycentric
constants: the table `tc` [NSUB, 16, 128] holds per triangle the normal,
n.v0, w_u, b_u, w_v, b_v and keep (13 rows, padded to 16); dropped
triangles have a zero normal, so det == 0 rejects them. Rays go in
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
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from esctp1raytracer_tpu_torch.accel.clusters import build_clusters
from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT, vec3
from esctp1raytracer_tpu_torch.kernels import _build
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask
from esctp1raytracer_tpu_torch.kernels.lane_pallas import plane_pair
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

RAY_GROUP = 128  # rays are padded to a multiple of this, as in the JAX package
COHERENT = 8  # rays per bundle = one warp's rays in the kernels
SUB = 128  # triangles per sub-block
TILE_TRI_LIMIT = 131_072  # triangles per segment: NSUB <= 1024
OVER_CAP = 128  # oversized triangles excluded from the occlusion tables: one sub-block
ROWS = 16  # constant rows per sub-block (13 used)
RAY_W = 8  # floats per ray: o, d, t_limit, pad
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


def _clustered_tables(tris: TriangleBuffer):
    """Cluster-sort + segregate oversized triangles.

    Returns (sorted_tris, perm, exclude [N] bool in sorted order,
    ov_buf TriangleBuffer[OVER_CAP], ov_orig [OVER_CAP] original indices).
    """
    clustered = build_clusters(tris)
    st, perm, ov = clustered.tris, clustered.perm, clustered.oversized
    n = tris.capacity
    pos = torch.arange(n, dtype=torch.int64, device=perm.device)
    # Sorted layout is [normal | oversized | invalid]: the oversized run
    # starts right after the normal ones; exclude at most OVER_CAP of them.
    n_norm = torch.sum(st.valid & ~ov)
    exclude = ov & (pos < n_norm + OVER_CAP)
    idx = torch.clamp(n_norm + torch.arange(OVER_CAP, device=perm.device), max=n - 1)
    ov_buf = dataclasses.replace(st.take(idx), valid=exclude[idx])
    ov_orig = perm[idx]
    return st, perm, exclude, ov_buf, ov_orig


def _oversized_hits(o, d, ov_buf: TriangleBuffer, eps):
    """One-pass sweep over the oversized set: (t [R, K], ok [R, K]).

    The plane-constant formulation and op order of the JAX package's tile
    kernels, so the merged result equals what the kernel would give.
    """
    v0, v1, v2 = ov_buf.v0, ov_buf.v1, ov_buf.v2
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = torch.linalg.cross(e1, e2)
    nrm = torch.where(ov_buf.valid[:, None], nrm, 0.0)
    nn = torch.sum(nrm * nrm, dim=-1, keepdim=True)
    w_u = torch.linalg.cross(e2, nrm) / nn
    w_v = torch.linalg.cross(nrm, e1) / nn
    nv0 = torch.sum(nrm * v0, dim=-1)[None]
    bu = -torch.sum(w_u * v0, dim=-1)[None]
    bv = -torch.sum(w_v * v0, dim=-1)[None]

    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    nx, ny, nz = nrm[None, :, 0], nrm[None, :, 1], nrm[None, :, 2]
    wux, wuy, wuz = w_u[None, :, 0], w_u[None, :, 1], w_u[None, :, 2]
    wvx, wvy, wvz = w_v[None, :, 0], w_v[None, :, 1], w_v[None, :, 2]
    det = -(dx * nx + dy * ny + dz * nz)
    ok_det = torch.abs(det) >= eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    t = ((ox * nx + oy * ny + oz * nz) - nv0) * inv
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = wux * px + wuy * py + wuz * pz + bu
    v = wvx * px + wvy * py + wvz * pz + bv
    ok = ok_det & (torch.minimum(u, v) >= eps) & (u + v <= 1.0) & (t >= eps)
    return t, ok


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
# Packing
# --------------------------------------------------------------------------


def _pad_sorted(sorted_tris: TriangleBuffer, perm, exclude, capacity: int):
    """Pad the sorted table with invalid triangles to `capacity`."""
    pad = capacity - sorted_tris.capacity
    if not pad:
        return sorted_tris, perm, exclude
    filler = TriangleBuffer.empty(pad, device=perm.device)
    sorted_tris = sorted_tris.map(lambda name, a: torch.cat([a, getattr(filler, name)]))
    return (sorted_tris, torch.cat([perm, perm.new_full((pad,), NO_HIT)]),
            torch.cat([exclude, exclude.new_zeros((pad,))]))


def _pack_sub(sorted_tris: TriangleBuffer, exclude=None):
    """Pack constants at SUB granularity: tc [NSUB, 16, 128], aabbs [8, NSUB].

    Invalid or excluded triangles get a zero normal (det == 0 rejects
    them; their w rows are NaN, as in the JAX package, and never read
    past the det test) and an inverted box. Given the OVER_CAP oversized
    triangles, it computes `_oversized_hits`' constants with its ops.
    """
    npad = sorted_tris.capacity
    keep = sorted_tris.valid
    if exclude is not None:
        keep = keep & ~exclude
    v0 = sorted_tris.v0
    e1 = sorted_tris.v1 - v0
    e2 = sorted_tris.v2 - v0
    nrm = torch.linalg.cross(e1, e2)
    nrm = torch.where(keep[:, None], nrm, 0.0)
    nn = torch.sum(nrm * nrm, dim=-1, keepdim=True)
    w_u = torch.linalg.cross(e2, nrm) / nn
    w_v = torch.linalg.cross(nrm, e1) / nn
    rows = [
        nrm[:, 0], nrm[:, 1], nrm[:, 2], torch.sum(nrm * v0, dim=-1),
        w_u[:, 0], w_u[:, 1], w_u[:, 2], -torch.sum(w_u * v0, dim=-1),
        w_v[:, 0], w_v[:, 1], w_v[:, 2], -torch.sum(w_v * v0, dim=-1),
        keep.to(torch.float32),
    ]
    table = torch.cat([torch.stack(rows), nrm.new_zeros((ROWS - len(rows), npad))])
    nsub = npad // SUB
    tc = table.reshape(ROWS, nsub, SUB).permute(1, 0, 2).contiguous()  # [NSUB, 16, 128]

    v = torch.stack([v0, sorted_tris.v1, sorted_tris.v2], dim=1)
    bmin = torch.where(keep[:, None], torch.amin(v, dim=1), 1e30)
    bmax = torch.where(keep[:, None], torch.amax(v, dim=1), -1e30)
    blk_min = torch.amin(bmin.reshape(nsub, SUB, 3), dim=1)
    blk_max = torch.amax(bmax.reshape(nsub, SUB, 3), dim=1)
    aabbs = torch.cat([blk_min.T, blk_max.T, torch.zeros_like(blk_min.T[:2])], dim=0)
    return tc, aabbs


def _sliced(tris: TriangleBuffer, exclude_oversized: bool = False):
    """Cluster-sort, pad and pack the table in segments: one, padded to a
    multiple of SUB, up to TILE_TRI_LIMIT triangles; else TILE_TRI_LIMIT-sized
    ones.

    Returns (generator of (tc [NSUB, 16, 128], aabbs [8, NSUB], perm_k
    [NSUB * 128] padded with -1), ov_buf, ov_orig). With exclude_oversized
    the tables reject the (up to OVER_CAP) oversized triangles, and the
    caller tests `ov_buf` once, outside the segments' tables.
    """
    sorted_tris, perm, exclude, ov_buf, ov_orig = _clustered_tables(tris)
    nseg = -(-tris.capacity // TILE_TRI_LIMIT)
    capacity = nseg * TILE_TRI_LIMIT if nseg > 1 else tris.capacity + (-tris.capacity) % SUB
    sorted_tris, perm, exclude = _pad_sorted(sorted_tris, perm, exclude, capacity)
    seg = capacity // nseg

    def segments():
        for k in range(nseg):
            sl = slice(k * seg, (k + 1) * seg)
            tc, aabbs = _pack_sub(sorted_tris.map(lambda _, a: a[sl]),
                                  exclude[sl] if exclude_oversized else None)
            yield tc, aabbs, perm[sl]

    return segments(), ov_buf, ov_orig


def tri_constants_sub(tris: TriangleBuffer, exclude_oversized: bool = False):
    """The one segment of a table of up to TILE_TRI_LIMIT triangles: (tc,
    aabbs, perm, ov_buf, ov_orig), as `_sliced` gives them."""
    segments, ov_buf, ov_orig = _sliced(tris, exclude_oversized)
    (tc, aabbs, perm), = segments
    return tc, aabbs, perm, ov_buf, ov_orig


# --------------------------------------------------------------------------
# Rays and the JAX package's per-bundle lists
# --------------------------------------------------------------------------


def _pad_rays(o, d, t_limit=None):
    """Pad rays to RAY_GROUP and pack them: rays [Rp, 8] (o, d, t_limit, 0).
    Without a t_limit the column holds +inf, which culls nothing
    (`tn > inf` is false, NaN included). Pad rays (origin 0, direction +z,
    t_limit -1 when there is one) are the JAX package's, so the lists of a
    partly padded bundle are too."""
    pad = (-o.shape[0]) % RAY_GROUP
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, vec3(d, 0.0, 0.0, 1.0).expand(pad, 3)])
        if t_limit is not None:
            t_limit = torch.cat([t_limit, t_limit.new_full((pad,), -1.0)])
    tl = o.new_full((o.shape[0], 1), float("inf")) if t_limit is None else t_limit[:, None]
    return torch.cat([o, d, tl, o.new_zeros((o.shape[0], RAY_W - 7))], dim=1)


def _cull_lists(o, d, t_limit, aabbs):
    """Per-bundle ascending sub-block lists for one ray chunk: a per-ray
    slab mask, OR-folded over each bundle, compacted by a stable argsort.
    Returns (ids [chunk / 8, NSUB] int32, cnt [chunk / 8] int32)."""
    nsub = aabbs.shape[1]
    mask = block_cull_mask(o, d, aabbs, t_limit)
    gmask = torch.any(mask.reshape(-1, COHERENT, nsub), dim=1)
    ids = torch.argsort((~gmask).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    return ids, torch.sum(gmask, dim=1, dtype=torch.int32)


def _lists(rays, aabbs):
    """The JAX package's cull pre-pass (`_prep`, argsort mode) on padded
    rays [Rp, 8]: (ids [Rp / 8, NSUB] int32, cnt [Rp / 8] int32). Row b of
    `ids` lists, ascending in its first cnt[b] entries, the sub-blocks some
    ray of bundle b keeps, culling by the rays' t_limit (+inf: no cull).
    Streams in ray chunks of about _PREPASS_ELEMS (ray, sub-block) pairs
    (one chunk for a small wavefront)."""
    rp, nsub = rays.shape[0], aabbs.shape[1]
    # The JAX package coarsens the cull above 1024 sub-blocks; a segment
    # never has more (TILE_TRI_LIMIT / SUB), so that path is not carried over.
    assert nsub <= TILE_TRI_LIMIT // SUB, nsub
    chunk = max(RAY_GROUP, _PREPASS_ELEMS // nsub // RAY_GROUP * RAY_GROUP)
    ids = torch.empty((rp // COHERENT, nsub), dtype=torch.int32, device=rays.device)
    cnt = torch.empty((rp // COHERENT,), dtype=torch.int32, device=rays.device)
    for i in range(0, rp, chunk):
        r, bl = rays[i:i + chunk], slice(i // COHERENT, (i + chunk) // COHERENT)
        ids[bl], cnt[bl] = _cull_lists(r[:, 0:3], r[:, 3:6], r[:, 6], aabbs)
    return ids, cnt


# --------------------------------------------------------------------------
# Plain versions of K5 and K6
# --------------------------------------------------------------------------


def _bundle_rays(rays):
    """rays [Rp, 8] -> (o, d, t_limit), each a tuple or tensor of [B, 8, 1] columns."""
    r = rays.reshape(-1, COHERENT, RAY_W, 1)
    return (r[:, :, 0], r[:, :, 1], r[:, :, 2]), (r[:, :, 3], r[:, :, 4], r[:, :, 5]), r[:, :, 6]


def _block_pairs(tc, jb, o, d, eps):
    """Every bundle's 8 rays against its sub-block jb [B]: (t, ok) [B, 8, 128]."""
    c = tc[jb.long()][:, :12, None, :]  # [B, 12, 1, 128]
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


def _sweep_occl(eps, rays, ids, cnt, tc):
    """K6's sweep of given lists: occluded [Rp] int32 (1 = some hit with
    eps <= t < t_limit in the bundle's list)."""
    eps = float(eps.reshape(-1)[0])
    b = cnt.shape[0]
    o, d, tl = _bundle_rays(rays)
    occ = torch.zeros((b, COHERENT), dtype=torch.bool, device=rays.device)
    for k in range(int(cnt.max()) if b else 0):
        t, ok = _block_pairs(tc, ids[:, k], o, d, eps)
        occ |= torch.any(ok & (t < tl), dim=-1) & (k < cnt)[:, None]
    return occ.to(torch.int32).reshape(-1)


def _tile_search_plain(eps, rays, aabbs, tc, cnt_out=None):
    """Plain version of K5: the JAX package's lists (`_lists`), swept by
    `_sweep_search`. Writes the lists' lengths to cnt_out when given."""
    ids, cnt = _lists(rays, aabbs)
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    return _sweep_search(eps, rays, ids, cnt, tc)


def _tile_occl_plain(eps, rays, aabbs, tc, ov=None, cnt_out=None):
    """Plain version of K6: the JAX package's lists (`_lists`), swept by
    `_sweep_occl`, ORed with every ray against the sub-block `ov`
    [1, 16, 128] when given. Writes the lists' lengths to cnt_out."""
    ids, cnt = _lists(rays, aabbs)
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    occ = _sweep_occl(eps, rays, ids, cnt, tc)
    if ov is not None:
        occ |= _sweep_occl(eps, rays, ids.new_zeros((cnt.shape[0], 1)), torch.ones_like(cnt), ov)
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
        lib.rt_tile_search.restype = lib.rt_tile_occl.restype = ci
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


def _ptr(t):
    return None if t is None else t.data_ptr()


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


def tile_kernel(eps, rays, aabbs, tc, cnt_out=None):
    """K5, closest hit per ray over the sub-blocks each bundle keeps.

    eps f32 [1]; rays f32 [8B, 8] (o, d, t_limit, pad; from `_pad_rays`;
    t_limit only culls, t is never clamped to it); aabbs f32 [8, NSUB]; tc
    f32 [NSUB, 16, 128]; cnt_out int32 [B] or None: receives each bundle's
    kept count (padding-only sub-blocks included; counting them costs the
    kernel a box-by-box test of their groups). Returns (t [8B] f32 -- BIG
    on a miss, sorted index [8B] int32 -- -1 on a miss).
    """
    if rays.device.type == "cpu":
        return _tile_search_plain(eps, rays, aabbs, tc, cnt_out)
    b, nsub = _check(eps, rays, aabbs, tc, cnt_out=cnt_out)
    t = torch.empty((COHERENT * b,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((COHERENT * b,), dtype=torch.int32, device=rays.device)
    if b:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (_ptr(x) for x in (eps, rays, aabbs, _group_boxes(aabbs), tc, t, idx, cnt_out))
        err = _lib().rt_tile_search(*ptrs, b, nsub, stream)
        _build.check_launch(_lib(), "rt_tile", err)
        tile_kernel.launches += 1
    return t, idx


def tile_occl_kernel(eps, rays, aabbs, tc, ov=None, cnt_out=None):
    """K6, any hit per ray with eps <= t < t_limit over the sub-blocks each
    bundle keeps, and over the sub-block ov f32
    [1, 16, 128] for every ray when given. Other inputs as `tile_kernel`.
    Returns int32 [8B] (1 = occluded).
    """
    if rays.device.type == "cpu":
        return _tile_occl_plain(eps, rays, aabbs, tc, ov, cnt_out)
    b, nsub = _check(eps, rays, aabbs, tc, ov, cnt_out)
    occ = torch.empty((COHERENT * b,), dtype=torch.int32, device=rays.device)
    if b:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (_ptr(x) for x in (eps, rays, aabbs, _group_boxes(aabbs), tc, ov, occ, cnt_out))
        err = _lib().rt_tile_occl(*ptrs, b, nsub, stream)
        _build.check_launch(_lib(), "rt_tile", err)
        tile_occl_kernel.launches += 1
    return occ


tile_kernel.launches = 0
tile_occl_kernel.launches = 0


# --------------------------------------------------------------------------
# Search entry points
# --------------------------------------------------------------------------


def _eps_tensor(eps: float, device):
    """eps as the kernels' f32 [1], by a fill (a CUDA graph can capture it)."""
    return torch.full((1,), eps, dtype=torch.float32, device=device)


def _orig(idx, perm):
    """Sorted index -> original index through perm (-1 stays -1)."""
    return torch.where(idx >= 0, perm[torch.clamp(idx, min=0).long()], NO_HIT)


def tile_tri_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    `t_limit` only culls (see the module docstring). Segments combine
    first-wins: an earlier segment keeps a tie.
    """
    eps_arr = _eps_tensor(eps, o.device)
    r = o.shape[0]
    rays = _pad_rays(o, d, t_limit)
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    segments, _, _ = _sliced(tris)
    for tc, aabbs, perm_k in segments:
        t_k, idx_k = tile_kernel(eps_arr, rays, aabbs, tc)
        t_k, idx_k = t_k[:r], idx_k[:r]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, _orig(idx_k, perm_k), best_i)
    return best_t, best_i


def tile_occlusion(o, d, t_limit, tris: TriangleBuffer, eps) -> torch.Tensor:
    """Occlusion [R] bool: any accepted hit in (eps, t_limit). The oversized
    triangles go to the first segment's K6 launch as one extra sub-block."""
    eps_arr = _eps_tensor(eps, o.device)
    r = o.shape[0]
    rays = _pad_rays(o, d, t_limit)
    occluded = torch.zeros((r,), dtype=torch.bool, device=o.device)
    segments, ov_buf, _ = _sliced(tris, exclude_oversized=True)
    ov, _ = _pack_sub(ov_buf)
    for k, (tc, aabbs, _) in enumerate(segments):
        occluded |= tile_occl_kernel(eps_arr, rays, aabbs, tc, ov if k == 0 else None)[:r] > 0
    return occluded


tile_tri_search.occlusion = tile_occlusion
