"""mxtile search: the ray-triangle test as a K=16 feature contraction.

Counterpart of `esctp1raytracer_tpu/kernels/rt_mxu.py`. Möller–Trumbore's
four quantities are trilinear forms in (o, d, triangle):

    [det, t*det, u*det, v*det] = ray_features[16] @ tri_features[16, 4]

Triangles are Morton-sorted and packed into blocks of SUB = 128, each a
[16, 512] column slab (det | t*det | u*det | v*det) with a box
(`aabbs` [8, NSUB]). Rays go in groups of RAY_TILE = 128; a group visits,
in ascending order, the blocks whose box one of its rays keeps in a slab
test (`kernels/cull.py:block_cull_mask`). Two kernels, hand-written in
CUDA (`csrc/rt_mxu.cu`), take the padded rays (`rt_tile._pad_rays`), the
boxes and the table, and cull and sweep per group:

* `mxu_kernel` (K1): closest hit per ray — minimum t, ties to the lowest
  sorted index;
* `mxu_occl_kernel` (K2): any hit with t < t_limit per ray, over the
  culled blocks and, when given, one extra sub-block of plane constants
  that every ray tests (the oversized triangles, `rt_tile._pack_sub`).

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

Precision: the contraction must be float32-faithful. The JAX package
measured bf16x3 flipping ~1% of winners and ~6% of shadow tests, so the
kernels use float32 FMAs on the CUDA cores, and the plain version's
`bmm` needs `torch.backends.cuda.matmul.allow_tf32 = False` on the card.
Sums taken in another order than the reference's change last-ulp t
values: a winner can flip only on an exact near-tie.
"""

from __future__ import annotations

import ctypes

import torch

from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT, ray_features, tri_features
from esctp1raytracer_tpu_torch.kernels import _build
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask
from esctp1raytracer_tpu_torch.kernels.rt_tile import (
    COHERENT, RAY_W, ROWS, _clustered_tables, _eps_tensor, _orig, _pack_sub, _pad_rays, _ptr,
    _sweep_occl as _tile_sweep_occl,
)
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

RAY_TILE = 128  # rays per group = threads per CUDA block
SUB = 128  # triangles per block = 128 columns per quantity
MXU_TRI_LIMIT = 32_768  # triangles per segment (256 blocks)

_INT_BIG = 2**31 - 1


def _pack_mxu(sorted_tris: TriangleBuffer, exclude=None):
    """Pack feature columns quantity-major: tfq [NSUB, 16, 512], aabbs [8, NSUB].

    Column layout per block: [0:128) det | [128:256) t*det | [256:384)
    u*det | [384:512) v*det. Invalid or excluded triangles get zero
    columns (det = 0 fails the window) and an inverted box.
    """
    npad = sorted_tris.capacity
    keep = sorted_tris.valid
    if exclude is not None:
        keep = keep & ~exclude
    tf = tri_features(sorted_tris.v0, sorted_tris.v1, sorted_tris.v2)
    tf = torch.where(keep[:, None, None], tf, 0.0)  # [N, 16, 4]
    nsub = npad // SUB
    tfq = (tf.reshape(nsub, SUB, 16, 4)
           .permute(0, 2, 3, 1)  # [NSUB, 16, 4, 128]
           .reshape(nsub, 16, 4 * SUB)
           .contiguous())

    v = torch.stack([sorted_tris.v0, sorted_tris.v1, sorted_tris.v2], dim=1)
    bmin = torch.where(keep[:, None], torch.amin(v, dim=1), 1e30)
    bmax = torch.where(keep[:, None], torch.amax(v, dim=1), -1e30)
    blk_min = torch.amin(bmin.reshape(nsub, SUB, 3), dim=1)
    blk_max = torch.amax(bmax.reshape(nsub, SUB, 3), dim=1)
    aabbs = torch.cat([blk_min.T, blk_max.T, torch.zeros_like(blk_min.T[:2])], dim=0)
    return tfq, aabbs


def _prep_mxu(o, d, aabbs, t_limit, m: int = RAY_TILE):
    """The JAX package's cull pre-pass: pad rays to m, cull per m-ray
    group, build feature rows.

    Returns (rf [G, m, 16], ids [G, NSUB] int32, cnt [G] int32,
    tl [G, m] or None, padded ray count, NSUB). Row g of `ids` lists the
    blocks some ray of group g can hit, ascending, in its first cnt[g]
    entries (a stable argsort of the group's keep mask).
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
    mask = block_cull_mask(o, d, aabbs, t_limit)
    gmask = torch.any(mask.reshape(rp // m, m, nsub), dim=1)
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
        t, ok = _window(torch.bmm(rf, tfq[jb.long()]), eps)
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
        _, ok = _window(torch.bmm(rf, tfq[ids[:, k].long()]), eps, tl)
        occ |= torch.any(ok, dim=-1) & (k < cnt)[:, None]
    return occ.to(torch.int32)


def _plain_lists(rays, aabbs, cnt_out):
    """`_prep_mxu` on padded rays [Rp, 8] (their t_limit column culls; +inf
    culls nothing): (rf, ids, cnt, tl); writes cnt to cnt_out when given."""
    rf, ids, cnt, tl, _, _ = _prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6])
    if cnt_out is not None:
        cnt_out.copy_(cnt)
    return rf, ids, cnt, tl


def _mxu_search_plain(eps, rays, aabbs, tfq, cnt_out=None):
    """Plain version of K1: `_prep_mxu`'s lists, swept by `_sweep_search`.
    Returns (t [Rp] f32, sorted idx [Rp] int32)."""
    rf, ids, cnt, _ = _plain_lists(rays, aabbs, cnt_out)
    t, idx = _sweep_search(eps, ids, cnt, rf, tfq)
    return t.reshape(-1), idx.reshape(-1)


def _mxu_occl_plain(eps, rays, aabbs, tfq, ov=None, cnt_out=None):
    """Plain version of K2: `_prep_mxu`'s lists, swept by
    `_sweep_occl`, ORed with every ray against the sub-block of plane
    constants `ov` [1, 16, 128] when given (`rt_tile._sweep_occl`, as
    K6's plain version does). Returns occluded [Rp] int32."""
    rf, ids, cnt, tl = _plain_lists(rays, aabbs, cnt_out)
    occ = _sweep_occl(eps, ids, cnt, rf, tl, tfq).reshape(-1)
    if ov is not None:
        b = rays.shape[0] // COHERENT
        occ |= _tile_sweep_occl(eps, rays, ids.new_zeros((b, 1)), cnt.new_ones((b,)), ov)
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
        lib.rt_mxu_search.restype = lib.rt_mxu_occl.restype = ci
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


def mxu_kernel(eps, rays, aabbs, tfq, cnt_out=None):
    """K1, closest hit per ray over the blocks each 128-ray group keeps.

    eps f32 [1]; rays f32 [128G, 8] (o, d, t_limit, pad; from
    `rt_tile._pad_rays`; t_limit only culls, t is never clamped to it);
    aabbs f32 [8, NSUB] (NSUB <= 256); tfq f32 [NSUB, 16, 512]; cnt_out
    int32 [G] or None: receives each group's kept count (padding-only
    blocks included). Returns (t [128G] f32 — BIG on a miss, sorted index
    [128G] int32 — -1 on a miss).
    """
    if rays.device.type == "cpu":
        return _mxu_search_plain(eps, rays, aabbs, tfq, cnt_out)
    g, nsub = _check(eps, rays, aabbs, tfq, cnt_out=cnt_out)
    t = torch.empty((RAY_TILE * g,), dtype=torch.float32, device=rays.device)
    idx = torch.empty((RAY_TILE * g,), dtype=torch.int32, device=rays.device)
    if g:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (_ptr(x) for x in (eps, rays, aabbs, tfq, t, idx, cnt_out))
        _build.check_launch(_lib(), "rt_mxu", _lib().rt_mxu_search(*ptrs, g, nsub, stream))
        mxu_kernel.launches += 1
    return t, idx


def mxu_occl_kernel(eps, rays, aabbs, tfq, ov=None, cnt_out=None):
    """K2, any hit per ray with eps <= t < t_limit over the blocks each
    group keeps, and over the sub-block of plane constants ov f32
    [1, 16, 128] for every ray when given. Other inputs as `mxu_kernel`.
    Returns int32 [128G] (1 = occluded).
    """
    if rays.device.type == "cpu":
        return _mxu_occl_plain(eps, rays, aabbs, tfq, ov, cnt_out)
    g, nsub = _check(eps, rays, aabbs, tfq, ov, cnt_out)
    occ = torch.empty((RAY_TILE * g,), dtype=torch.int32, device=rays.device)
    if g:
        stream = torch.cuda.current_stream(rays.device).cuda_stream
        ptrs = (_ptr(x) for x in (eps, rays, aabbs, tfq, ov, occ, cnt_out))
        _build.check_launch(_lib(), "rt_mxu", _lib().rt_mxu_occl(*ptrs, g, nsub, stream))
        mxu_occl_kernel.launches += 1
    return occ


mxu_kernel.launches = 0
mxu_occl_kernel.launches = 0


def _segments(tris: TriangleBuffer, exclude_oversized: bool):
    """Cluster-sort + slice into MXU_TRI_LIMIT-sized segments.

    Returns (generator of (tfq, aabbs, perm_k), ov_buf, ov_orig).
    """
    sorted_tris, perm, exclude, ov_buf, ov_orig = _clustered_tables(tris)
    seg = MXU_TRI_LIMIT
    nseg = -(-tris.capacity // seg)
    pad = nseg * seg - tris.capacity if nseg > 1 else (-tris.capacity) % SUB
    if pad:
        filler = TriangleBuffer.empty(pad, device=perm.device)
        sorted_tris = sorted_tris.map(lambda name, a: torch.cat([a, getattr(filler, name)]))
        perm = torch.cat([perm, perm.new_full((pad,), NO_HIT)])
        exclude = torch.cat([exclude, exclude.new_zeros((pad,))])
    seg = sorted_tris.capacity // nseg

    def gen():
        for k in range(nseg):
            sl = slice(k * seg, (k + 1) * seg)
            tfq, aabbs = _pack_mxu(sorted_tris.map(lambda _, a: a[sl]),
                                   exclude[sl] if exclude_oversized else None)
            yield tfq, aabbs, perm[sl]

    return gen(), ov_buf, ov_orig


def mxu_tile_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    `t_limit` only culls (see `mxu_kernel`). Segments combine first-wins:
    an earlier segment keeps a tie.
    """
    eps_arr = _eps_tensor(eps, o.device)
    r = o.shape[0]
    rays = _pad_rays(o, d, t_limit)
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    segments, _, _ = _segments(tris, exclude_oversized=False)
    for tfq, aabbs, perm_k in segments:
        t_k, idx_k = mxu_kernel(eps_arr, rays, aabbs, tfq)
        t_k, idx_k = t_k[:r], idx_k[:r]
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, _orig(idx_k, perm_k), best_i)
    return best_t, best_i


def mxu_tile_occlusion(o, d, t_limit, tris: TriangleBuffer, eps) -> torch.Tensor:
    """Occlusion [R] bool: any accepted hit in (eps, t_limit). The oversized
    triangles go to the first segment's K2 launch as one extra sub-block."""
    eps_arr = _eps_tensor(eps, o.device)
    r = o.shape[0]
    rays = _pad_rays(o, d, t_limit)
    occluded = torch.zeros((r,), dtype=torch.bool, device=o.device)
    segments, ov_buf, _ = _segments(tris, exclude_oversized=True)
    ov, _ = _pack_sub(ov_buf)
    for k, (tfq, aabbs, _) in enumerate(segments):
        occluded |= mxu_occl_kernel(eps_arr, rays, aabbs, tfq, ov if k == 0 else None)[:r] > 0
    return occluded


mxu_tile_search.occlusion = mxu_tile_occlusion
