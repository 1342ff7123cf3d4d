"""mxtile search: the ray-triangle test as a K=16 feature contraction.

Counterpart of `esctp1raytracer_tpu/kernels/rt_mxu.py`. Möller–Trumbore's
four quantities are trilinear forms in (o, d, triangle):

    [det, t*det, u*det, v*det] = ray_features[16] @ tri_features[16, 4]

Triangles are Morton-sorted and packed into blocks of SUB = 128, each a
[16, 512] column slab (det | t*det | u*det | v*det). Rays go in groups of
RAY_TILE = 128; a slab-test pre-pass gives every group an ascending list
of the blocks it can hit (`ids`) and their number (`cnt`). Two kernels,
hand-written in CUDA (`csrc/rt_mxu.cu`), then sweep those lists:

* `mxu_kernel` (K1): closest hit per ray — minimum t, ties to the lowest
  sorted index;
* `mxu_occl_kernel` (K2): any hit with t < t_limit per ray.

Each kernel has a plain PyTorch version beside it (`_mxu_search_plain`,
`_mxu_occl_plain`) with the same lists, visit order and tie rule. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. Each wrapper counts its kernel launches
in its `launches` attribute.

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
from esctp1raytracer_tpu_torch.kernels.rt_tile import _clustered_tables, _oversized_occl
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

RAY_TILE = 128  # rays per group = threads per CUDA block
SUB = 128  # triangles per block = 128 columns per quantity
MXU_TRI_LIMIT = 32_768  # triangles per segment (256 blocks)

_INT_BIG = 2**31 - 1


def _pack_mxu(sorted_tris: TriangleBuffer, exclude=None):
    """Pack feature columns quantity-major: tfq [NSUB, 16, 512], aabbs [8, NSUB].

    Column layout per block: [0:128) det | [128:256) t*det | [256:384)
    u*det | [384:512) v*det. Invalid or excluded triangles get zero
    columns: det = 0 fails the window.
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
    """Pad rays to m, cull per m-ray group, build feature rows.

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


def _mxu_search_plain(eps, ids, cnt, rf, tfq):
    """Plain version of K1: (t [G, m] f32, sorted idx [G, m] int32).

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


def _mxu_occl_plain(eps, ids, cnt, rf, tl, tfq):
    """Plain version of K2: occluded [G, m] int32 (1 = some hit in (eps, t_limit))."""
    g, m, _ = rf.shape
    occ = torch.zeros((g, m), dtype=torch.bool, device=rf.device)
    kmax = int(cnt.max()) if g else 0
    for k in range(kmax):
        _, ok = _window(torch.bmm(rf, tfq[ids[:, k].long()]), eps, tl)
        occ |= torch.any(ok, dim=-1) & (k < cnt)[:, None]
    return occ.to(torch.int32)


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/rt_mxu.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("rt_mxu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.rt_mxu_search, lib.rt_mxu_occl):
            fn.argtypes = [vp] * 7 + [ci, ci, vp]
            fn.restype = ci
        lib.rt_mxu_error_string.argtypes = [ci]
        lib.rt_mxu_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(eps, ids, cnt, rf, tfq, tl=None):
    """Validate the kernels' inputs; returns (G, NSUB)."""
    dev = rf.device
    if dev.type != "cuda":
        raise ValueError(f"mxtile kernels take CUDA or CPU tensors, got {dev}")
    g, nsub = ids.shape
    want = {"eps": (eps, torch.float32, (1,)), "ids": (ids, torch.int32, (g, nsub)),
            "cnt": (cnt, torch.int32, (g,)), "rf": (rf, torch.float32, (g, RAY_TILE, 16)),
            "tfq": (tfq, torch.float32, (nsub, 16, 4 * SUB))}
    if tl is not None:
        want["tl"] = (tl, torch.float32, (g, RAY_TILE))
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rf.data_ptr() % 16 or tfq.data_ptr() % 16:
        raise ValueError("rf and tfq must be 16-byte aligned (float4 loads)")
    return g, nsub


def _launch(fn, tensors, g, nsub, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(t.data_ptr() for t in tensors), g, nsub, stream)
    if err:
        msg = _lib().rt_mxu_error_string(err).decode()
        raise RuntimeError(f"mxtile kernel launch failed: {msg} ({err})")


def mxu_kernel(eps, ids, cnt, rf, tfq):
    """K1, closest hit per ray over each group's block list.

    eps f32 [1]; ids int32 [G, NSUB]; cnt int32 [G]; rf f32 [G, 128, 16];
    tfq f32 [NSUB, 16, 512]. Returns (t [G, 128] f32 — BIG on miss,
    sorted index [G, 128] int32 — -1 on miss).
    """
    if rf.device.type == "cpu":
        return _mxu_search_plain(eps, ids, cnt, rf, tfq)
    g, nsub = _check(eps, ids, cnt, rf, tfq)
    t = torch.empty((g, RAY_TILE), dtype=torch.float32, device=rf.device)
    idx = torch.empty((g, RAY_TILE), dtype=torch.int32, device=rf.device)
    _launch(_lib().rt_mxu_search, (eps, ids, cnt, rf, tfq, t, idx), g, nsub, rf.device)
    mxu_kernel.launches += 1
    return t, idx


def mxu_occl_kernel(eps, ids, cnt, rf, tl, tfq):
    """K2, any hit per ray with eps <= t < tl over each group's block list.

    Inputs as `mxu_kernel`, plus tl f32 [G, 128]. Returns int32 [G, 128]
    (1 = occluded).
    """
    if rf.device.type == "cpu":
        return _mxu_occl_plain(eps, ids, cnt, rf, tl, tfq)
    g, nsub = _check(eps, ids, cnt, rf, tfq, tl)
    occ = torch.empty((g, RAY_TILE), dtype=torch.int32, device=rf.device)
    _launch(_lib().rt_mxu_occl, (eps, ids, cnt, rf, tl, tfq, occ), g, nsub, rf.device)
    mxu_occl_kernel.launches += 1
    return occ


mxu_kernel.launches = 0
mxu_occl_kernel.launches = 0


def _mxu_search(o, d, tfq, aabbs, eps, t_limit=None, m: int = RAY_TILE):
    r = o.shape[0]
    rf, ids, cnt, _, _, _ = _prep_mxu(o, d, aabbs, t_limit, m)
    t, idx = mxu_kernel(eps, ids, cnt, rf, tfq)
    return t.reshape(-1)[:r], idx.reshape(-1)[:r]


def _mxu_occl(o, d, t_limit, tfq, aabbs, eps, m: int = RAY_TILE):
    r = o.shape[0]
    rf, ids, cnt, tl, _, _ = _prep_mxu(o, d, aabbs, t_limit, m)
    return mxu_occl_kernel(eps, ids, cnt, rf, tl, tfq).reshape(-1)[:r] > 0


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


def _eps_tensor(eps, device):
    return torch.as_tensor(eps, dtype=torch.float32, device=device).reshape(1)


def mxu_tile_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    Segments combine first-wins: an earlier segment keeps a tie.
    """
    eps_arr = _eps_tensor(eps, o.device)
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    best_i = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    segments, _, _ = _segments(tris, exclude_oversized=False)
    for tfq, aabbs, perm_k in segments:
        t_k, idx_k = _mxu_search(o, d, tfq, aabbs, eps_arr, t_limit)
        orig_k = torch.where(idx_k >= 0, perm_k[torch.clamp(idx_k, min=0).long()], NO_HIT)
        better = t_k < best_t
        best_t = torch.where(better, t_k, best_t)
        best_i = torch.where(better, orig_k, best_i)
    return best_t, best_i


def mxu_tile_occlusion(o, d, t_limit, tris: TriangleBuffer, eps) -> torch.Tensor:
    """Occlusion [R] bool: any accepted hit in (eps, t_limit)."""
    eps_arr = _eps_tensor(eps, o.device)
    occluded = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    segments, ov_buf, _ = _segments(tris, exclude_oversized=True)
    for tfq, aabbs, _ in segments:
        occluded |= _mxu_occl(o, d, t_limit, tfq, aabbs, eps_arr)
    return occluded | _oversized_occl(o, d, t_limit, ov_buf, eps)


mxu_tile_search.occlusion = mxu_tile_occlusion
