"""Ray-lane search (K4): brute-force closest hit for small triangle tables.

Counterpart of `esctp1raytracer_tpu/kernels/lane_pallas.py` (the file name
is kept so a reader finds it), here a CUDA kernel: `csrc/lane.cu`. One
thread is one ray, and it walks every triangle's 13 plane/barycentric
constants (normal, n.v0, w_u, b_u, w_v, b_v, valid) in ascending original
order, keeping a running (t, index) updated on strict <: the minimum t,
ties to the lowest original index. Invalid triangles carry a zero normal,
so det == 0 rejects them without a per-pair valid test. The kernel builds
the constants and the valid prefix itself, from the triangle buffer's
v0, v1, v2 and valid columns, so `lane_tri_search` is one launch.

`lane_kernel` launches the kernel on CUDA tensors and runs the plain
PyTorch version `_lane_plain` (`lane_tri_constants`, `valid_prefix`, then
`_lane_search_plain`) on CPU tensors, counting launches in
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
from esctp1raytracer_tpu_torch.utils.profiling import annotate

LANE_TRI_LIMIT = 4096  # the JAX kernel's SMEM table bound (13 * N * 4 B, ~213 KB)
TCS_W = 13  # nx ny nz nv0 wux wuy wuz bu wvx wvy wvz bv valid
PLAIN_BLOCK = 128  # triangles per step of the plain versions


def _constants(v0, v1, v2, valid) -> torch.Tensor:
    """The 13 constants per triangle of columns v0, v1, v2 [N, 3] and
    valid [N] -> [N, 13]. csrc/lane_plane.cuh:tri_constants rounds as this
    does on the CPU: each cross-product component one fused multiply-add
    (fmaf(a_i, b_j, -(a_j * b_i))), each 3-term sum as ((0 + x) + y) + z."""
    e1 = v1 - v0
    e2 = v2 - v0
    nrm = torch.linalg.cross(e1, e2)
    nrm = torch.where(valid[:, None], nrm, 0.0)
    nn = torch.sum(nrm * nrm, dim=-1, keepdim=True)
    nn = torch.where(nn > 0, nn, 1.0)
    w_u = torch.linalg.cross(e2, nrm) / nn
    w_v = torch.linalg.cross(nrm, e1) / nn
    return torch.stack([
        nrm[:, 0], nrm[:, 1], nrm[:, 2],
        torch.sum(nrm * v0, dim=-1),
        w_u[:, 0], w_u[:, 1], w_u[:, 2],
        -torch.sum(w_u * v0, dim=-1),
        w_v[:, 0], w_v[:, 1], w_v[:, 2],
        -torch.sum(w_v * v0, dim=-1),
        valid.to(torch.float32),
    ], dim=1)


def lane_tri_constants(tris: TriangleBuffer) -> torch.Tensor:
    """Per-triangle plane + barycentric constants, [1, 13N] in original order."""
    return _constants(tris.v0, tris.v1, tris.v2, tris.valid).reshape(1, -1)


def valid_prefix(valid: torch.Tensor) -> torch.Tensor:
    """One past the last valid index, int32 [1] on valid's device (no sync)."""
    iota = torch.arange(valid.shape[0], dtype=torch.int32, device=valid.device)
    return (torch.amax(torch.where(valid, iota, -1)) + 1).reshape(1).to(torch.int32)


def plane_skip(det, num, eps):
    """The exact division skip of csrc/lane_plane.cuh:plane_skip, broadcast:
    True where the pair is rejected whatever its division gives. Either
    |det| < eps, or (for eps > 0) the numerator num = o.n - n.v0 is zero,
    NaN or of the other sign than det, so that t = num * (1 / det) is <= 0
    or NaN, never >= eps."""
    same_sign = ((num > 0) & (det > 0)) | ((num < 0) & (det < 0))
    return ~(torch.abs(det) >= eps) | ((eps > 0) & ~same_sign)


def plane_pair(o, d, c, eps, skip=False):
    """The per-pair test of csrc/lane_plane.cuh:plane_hit, broadcast: ray
    components o = (ox, oy, oz), d = (dx, dy, dz) against the 12 constant
    rows c[0..11] (normal, n.v0, w_u, b_u, w_v, b_v) -> (t, ok). With skip,
    as plane_t_skip (K3, K4): ok is also False where `plane_skip` holds,
    which changes no ok and no accepted t."""
    ox, oy, oz = o
    dx, dy, dz = d
    det = -(dx * c[0] + dy * c[1] + dz * c[2])
    ok_det = torch.abs(det) >= eps
    inv = 1.0 / torch.where(ok_det, det, 1.0)
    num = (ox * c[0] + oy * c[1] + oz * c[2]) - c[3]
    t = num * inv
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = c[4] * px + c[5] * py + c[6] * pz + c[7]
    v = c[8] * px + c[9] * py + c[10] * pz + c[11]
    ok = ok_det & (torch.minimum(u, v) >= eps) & (u + v <= 1.0) & (t >= eps)
    if skip:
        ok = ok & ~plane_skip(det, num, eps)
    return t, ok


def lane_plane_hits(o, d, c, eps, skip=False):
    """The kernel's per-pair test: o, d [R, 3] x constants c [B, 13]
    -> (t [R, B] with BIG where rejected, ok [R, B])."""
    t, ok = plane_pair((o[:, 0:1], o[:, 1:2], o[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
                       [c[:, i] for i in range(12)], eps, skip)
    return torch.where(ok, t, BIG), ok


def lane_plane_skips(o, d, c, eps):
    """`plane_skip` of every pair: o, d [R, 3] x constants c [B, 13] -> [R, B],
    det and the numerator computed as `plane_pair` computes them."""
    o, d = o[:, :, None], d[:, :, None]
    det = -(d[:, 0] * c[:, 0] + d[:, 1] * c[:, 1] + d[:, 2] * c[:, 2])
    num = (o[:, 0] * c[:, 0] + o[:, 1] * c[:, 1] + o[:, 2] * c[:, 2]) - c[:, 3]
    return plane_skip(det, num, eps)


def _lane_search_plain(eps, n_tris, tcs, o, d):
    """The sweep of K4 (and of K3's closest hit): (t [R] f32, idx [R] int32)
    over the constants tcs [1, 13N] below n_tris (int32 [1]).

    Blocks of triangles in ascending order; within a block the minimum t
    and its lowest index, across blocks an update on strict <. That is the
    kernel's running (t, i) over ascending triangles: the minimum t, ties
    to the lowest index. Each pair goes through the division skip, as in
    the kernels.
    """
    eps = float(eps)
    n = int(n_tris.reshape(-1)[0])
    c = tcs.reshape(-1, TCS_W)
    r = o.shape[0]
    bt = torch.full((r,), BIG, dtype=torch.float32, device=o.device)
    bi = torch.full((r,), NO_HIT, dtype=torch.int32, device=o.device)
    for b0 in range(0, n, PLAIN_BLOCK):
        cb = c[b0:min(b0 + PLAIN_BLOCK, n)]
        t, _ = lane_plane_hits(o, d, cb, eps, skip=True)
        tmin = torch.amin(t, dim=1, keepdim=True)
        iota = torch.arange(cb.shape[0], dtype=torch.int32, device=o.device)
        imin = torch.amin(torch.where(t == tmin, iota, 2**31 - 1), dim=1) + b0
        tmin = tmin[:, 0]
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bi = torch.where(better, imin, bi)
    return bt, torch.where(bt < BIG, bi, NO_HIT)


def _lane_plain(eps, v0, v1, v2, valid, o, d):
    """Plain version of K4, with the kernel's arguments: its constants
    (`lane_tri_constants`), the valid prefix, then the sweep."""
    return _lane_search_plain(eps, valid_prefix(valid), _constants(v0, v1, v2, valid), o, d)


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/lane.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("lane")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lane_search.argtypes = [cf] + [vp] * 4 + [ci] + [vp] * 4 + [ci, vp]
        lib.lane_search.restype = ci
        lib.lane_launch_shape.argtypes = [ci, ci] + [ctypes.POINTER(ci)] * 4
        lib.lane_launch_shape.restype = ci
        _LIB = lib
    return _LIB


def launch_shape(rays: int, capacity: int) -> dict:
    """K4's launch over `rays` rays and a `capacity`-triangle buffer on the
    current card: threads per block, blocks resident per SM (from the
    kernel's registers and its shared memory), the grid, shared memory."""
    lib = _lib()
    out = [ctypes.c_int() for _ in range(4)]
    _build.check_launch(lib, "lane", lib.lane_launch_shape(rays, capacity, *map(ctypes.byref, out)))
    return dict(zip(("threads", "blocks_per_sm", "blocks", "smem_bytes"), (x.value for x in out)))


def lane_kernel(eps, v0, v1, v2, valid, o, d):
    """K4: closest hit per ray over the valid prefix of a triangle buffer.

    eps: float; v0, v1, v2 f32 [N, 3] and valid bool [N], the buffer's
    columns (N <= LANE_TRI_LIMIT); o, d f32 [R, 3]. Returns (t [R] f32, BIG
    on a miss; idx [R] int32, -1 on a miss).
    """
    dev = o.device
    if dev.type == "cpu":
        return _lane_plain(eps, v0, v1, v2, valid, o, d)
    if dev.type != "cuda":
        raise ValueError(f"the lane kernel takes CUDA or CPU tensors, got {dev}")
    r, n = o.shape[0], v0.shape[0]
    if n > LANE_TRI_LIMIT:
        raise ValueError(f"lane kernel supports up to {LANE_TRI_LIMIT} triangles; got {n}")
    _build.check_tensors({
        "v0": (v0, torch.float32, (n, 3)), "v1": (v1, torch.float32, (n, 3)),
        "v2": (v2, torch.float32, (n, 3)), "valid": (valid, torch.bool, (n,)),
        "o": (o, torch.float32, (r, 3)), "d": (d, torch.float32, (r, 3)),
    }, dev)
    t = torch.empty((r,), dtype=torch.float32, device=dev)
    idx = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return t, idx
    lib = _lib()
    _build.check_launch(lib, "lane", lib.lane_search(
        float(eps), v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), valid.data_ptr(), n,
        o.data_ptr(), d.data_ptr(), t.data_ptr(), idx.data_ptr(), r,
        torch.cuda.current_stream(dev).cuda_stream))
    lane_kernel.launches += 1
    return t, idx


lane_kernel.launches = 0


def lane_tri_search(o, d, tris: TriangleBuffer, eps, t_limit=None):
    """tri_search hook (core/intersect.py contract): (best_t [R], orig idx [R]).

    t_limit is accepted for the hook's interface; with no per-block
    structure there is nothing to cull, and the caller's best_t < t_limit
    compare bounds the answer. The loop bound is one past the last valid
    triangle, so trailing padding costs nothing. On the card this is one
    launch: the kernel builds the constants and the bound itself.
    """
    n = tris.capacity
    if n > LANE_TRI_LIMIT:
        raise ValueError(f"lane kernel supports up to {LANE_TRI_LIMIT} triangles; got {n}")
    with annotate("lane.search"):
        return lane_kernel(eps, tris.v0.contiguous(), tris.v1.contiguous(),
                           tris.v2.contiguous(), tris.valid.contiguous(), o.contiguous(),
                           d.contiguous())
