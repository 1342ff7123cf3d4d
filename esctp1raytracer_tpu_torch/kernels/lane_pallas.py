"""Ray-lane search (K4): brute-force closest hit for small triangle tables.

Counterpart of `esctp1raytracer_tpu/kernels/lane_pallas.py` (the file name
is kept so a reader finds it), here a CUDA kernel: `csrc/lane.cu`. One
thread is one ray, and it walks every triangle's 13 plane/barycentric
constants (normal, n.v0, w_u, b_u, w_v, b_v, valid) in ascending original
order, keeping a running (t, index) updated on strict <: the minimum t,
ties to the lowest original index. Invalid triangles carry a zero normal,
so det == 0 rejects them without a per-pair valid test.

`lane_kernel` launches the kernel on CUDA tensors and runs the plain
PyTorch version `_lane_search_plain` on CPU tensors, counting launches in
`lane_kernel.launches`. `lane_tri_search` is the `tri_search` hook of
core/intersect.py; it has no `.occlusion`, so `any_hit` runs closest hit
and then compares against t_limit, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT
from esctp1raytracer_tpu_torch.kernels import _build
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

LANE_TRI_LIMIT = 4096  # the JAX kernel's SMEM table bound (13 * N * 4 B, ~213 KB)
TCS_W = 13  # nx ny nz nv0 wux wuy wuz bu wvx wvy wvz bv valid
PLAIN_BLOCK = 128  # triangles per step of the plain versions


def lane_tri_constants(tris: TriangleBuffer) -> torch.Tensor:
    """Per-triangle plane + barycentric constants, [1, 13N] in original order."""
    e1 = tris.v1 - tris.v0
    e2 = tris.v2 - tris.v0
    nrm = torch.linalg.cross(e1, e2)
    nrm = torch.where(tris.valid[:, None], nrm, 0.0)
    nn = torch.sum(nrm * nrm, dim=-1, keepdim=True)
    nn = torch.where(nn > 0, nn, 1.0)
    w_u = torch.linalg.cross(e2, nrm) / nn
    w_v = torch.linalg.cross(nrm, e1) / nn
    cols = torch.stack([
        nrm[:, 0], nrm[:, 1], nrm[:, 2],
        torch.sum(nrm * tris.v0, dim=-1),
        w_u[:, 0], w_u[:, 1], w_u[:, 2],
        -torch.sum(w_u * tris.v0, dim=-1),
        w_v[:, 0], w_v[:, 1], w_v[:, 2],
        -torch.sum(w_v * tris.v0, dim=-1),
        tris.valid.to(torch.float32),
    ], dim=1)  # [N, 13]
    return cols.reshape(1, -1)


def valid_prefix(valid: torch.Tensor) -> torch.Tensor:
    """One past the last valid index, int32 [1] on valid's device (no sync)."""
    iota = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device)
    return (torch.amax(torch.where(valid, iota, -1)) + 1).reshape(1).to(torch.int32)


def plane_pair(o, d, c, eps):
    """The per-pair test of csrc/lane_plane.cuh:plane_hit, broadcast: ray
    components o = (ox, oy, oz), d = (dx, dy, dz) against the 12 constant
    rows c[0..11] (normal, n.v0, w_u, b_u, w_v, b_v) -> (t, ok)."""
    ox, oy, oz = o
    dx, dy, dz = d
    det = -(dx * c[0] + dy * c[1] + dz * c[2])
    ok_det = torch.abs(det) >= eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    t = ((ox * c[0] + oy * c[1] + oz * c[2]) - c[3]) * inv
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = c[4] * px + c[5] * py + c[6] * pz + c[7]
    v = c[8] * px + c[9] * py + c[10] * pz + c[11]
    ok = ok_det & (torch.minimum(u, v) >= eps) & (u + v <= 1.0) & (t >= eps)
    return t, ok


def lane_plane_hits(o, d, c, eps):
    """The kernel's per-pair test: o, d [R, 3] x constants c [B, 13]
    -> (t [R, B] with BIG where rejected, ok [R, B])."""
    t, ok = plane_pair((o[:, 0:1], o[:, 1:2], o[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
                       [c[:, i] for i in range(12)], eps)
    return torch.where(ok, t, BIG), ok


def _lane_search_plain(eps, n_tris, tcs, o, d):
    """Plain version of K4: (t [R] f32, idx [R] int32).

    Blocks of triangles in ascending order; within a block the minimum t
    and its lowest index, across blocks an update on strict <. That is the
    kernel's running (t, i) over ascending triangles: the minimum t, ties
    to the lowest index.
    """
    eps = float(eps.reshape(-1)[0])
    n = int(n_tris.reshape(-1)[0])
    c = tcs.reshape(-1, TCS_W)
    r = o.shape[0]
    bt = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    bi = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    for b0 in range(0, n, PLAIN_BLOCK):
        cb = c[b0:min(b0 + PLAIN_BLOCK, n)]
        t, _ = lane_plane_hits(o, d, cb, eps)
        tmin = torch.amin(t, dim=1, keepdim=True)
        iota = torch.arange(cb.shape[0], dtype=torch.int32, device=o.device)
        imin = torch.amin(torch.where(t == tmin, iota, 2**31 - 1), dim=1) + b0
        tmin = tmin[:, 0]
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bi = torch.where(better, imin, bi)
    return bt, torch.where(bt < BIG, bi, NO_HIT)


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/lane.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("lane")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lane_search.argtypes = [vp] * 7 + [ci, vp]
        lib.lane_search.restype = ci
        _LIB = lib
    return _LIB


def lane_kernel(eps, n_tris, tcs, o, d):
    """K4: closest hit per ray over triangles [0, n_tris).

    eps f32 [1]; n_tris int32 [1]; tcs f32 [1, 13N] (N <= LANE_TRI_LIMIT);
    o, d f32 [R, 3]. Returns (t [R] f32, BIG on a miss; idx [R] int32, -1
    on a miss).
    """
    dev = o.device
    if dev.type == "cpu":
        return _lane_search_plain(eps, n_tris, tcs, o, d)
    if dev.type != "cuda":
        raise ValueError(f"the lane kernel takes CUDA or CPU tensors, got {dev}")
    r = o.shape[0]
    n = tcs.shape[-1] // TCS_W
    if n > LANE_TRI_LIMIT:
        raise ValueError(f"lane kernel supports up to {LANE_TRI_LIMIT} triangles; got {n}")
    _build.check_tensors({
        "eps": (eps, torch.float32, (1,)), "n_tris": (n_tris, torch.int32, (1,)),
        "tcs": (tcs, torch.float32, (1, TCS_W * n)),
        "o": (o, torch.float32, (r, 3)), "d": (d, torch.float32, (r, 3)),
    }, dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev)
    lib = _lib()
    _build.check_launch(lib, "lane", lib.lane_search(
        eps.data_ptr(), n_tris.data_ptr(), tcs.data_ptr(), o.data_ptr(), d.data_ptr(),
        t.data_ptr(), idx.data_ptr(), r, torch.cuda.current_stream(dev).cuda_stream))
    lane_kernel.launches += 1
    return t, idx


lane_kernel.launches = 0


def lane_tri_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    t_limit is accepted for the hook's interface; with no per-block
    structure there is nothing to cull, and the caller's best_t < t_limit
    compare bounds the answer. The loop bound is one past the last valid
    triangle, so trailing padding costs nothing.
    """
    n = tris.capacity
    if n > LANE_TRI_LIMIT:
        raise ValueError(f"lane kernel supports up to {LANE_TRI_LIMIT} triangles; got {n}")
    tcs = lane_tri_constants(tris).contiguous()
    eps_arr = torch.as_tensor(eps, dtype=torch.float32, device=o.device).reshape(1)
    return lane_kernel(eps_arr, valid_prefix(tris.valid), tcs, o.contiguous(), d.contiguous())
