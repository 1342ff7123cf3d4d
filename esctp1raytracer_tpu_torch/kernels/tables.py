"""The scene tables of the two segmented searches, and the rays they take.

The mxtile search (`rt_mxu.py`: K1, K2) and the tile search (`rt_tile.py`:
K5, K6) search one table: the triangles cluster-sorted (`accel/clusters.py`:
Morton order, [normal | oversized | invalid]), padded to whole segments and
packed per segment into blocks of SUB triangles, each with a box (`aabbs`
[8, NSUB]). Each route has its own block format and segment size
(`rt_mxu._pack_mxu`, feature columns; `pack_planes`, plane constants, the
tile route's). Both routes' any-hit kernels take up to OVER_CAP oversized
triangles out of the segments and test them as one extra plane-constant
sub-block that every ray sees.

The tables depend on the triangles alone. Inside a `search_tables()` block
(`core/render.py:trace_rays`, the fused backward's re-derivation) the first
search call on a triangle table builds what it asks for of its `Tables`,
and the later calls on the same table, of either route, reuse it: one sort
for every chunk, bounce and search of a trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from esctp1raytracer_tpu_torch.accel.clusters import build_clusters
from esctp1raytracer_tpu_torch.core.intersect import NO_HIT, vec3
from esctp1raytracer_tpu_torch.kernels.lane_pallas import plane_pair
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

SUB = 128  # triangles per block, in both formats
OVER_CAP = 128  # oversized triangles excluded from the any-hit tables: one sub-block
ROWS = 16  # constant rows per plane-constant sub-block (13 used)
RAY_GROUP = 128  # rays are padded to a multiple of this, as in the JAX package
RAY_W = 8  # floats per ray: o, d, t_limit, pad


def cluster_sort(tris: TriangleBuffer):
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


def block_boxes(sorted_tris: TriangleBuffer, keep) -> torch.Tensor:
    """Per block of SUB triangles, the box of the kept ones: aabbs [8, NSUB]
    (min xyz, max xyz, 0, 0), inverted (1e30 > -1e30) where none is kept."""
    nsub = sorted_tris.capacity // SUB
    v = torch.stack([sorted_tris.v0, sorted_tris.v1, sorted_tris.v2], dim=1)
    bmin = torch.where(keep[:, None], torch.amin(v, dim=1), 1e30)
    bmax = torch.where(keep[:, None], torch.amax(v, dim=1), -1e30)
    blk_min = torch.amin(bmin.reshape(nsub, SUB, 3), dim=1)
    blk_max = torch.amax(bmax.reshape(nsub, SUB, 3), dim=1)
    return torch.cat([blk_min.T, blk_max.T, torch.zeros_like(blk_min.T[:2])], dim=0)


def pack_planes(sorted_tris: TriangleBuffer, exclude=None):
    """Pack plane constants at SUB granularity: tc [NSUB, 16, 128], aabbs
    [8, NSUB]; per triangle the normal, n.v0, w_u, b_u, w_v, b_v and keep
    (13 rows, padded to ROWS).

    Invalid or excluded triangles get a zero normal (det == 0 rejects
    them; their w rows are NaN, as in the JAX package, and never read
    past the det test) and an inverted box.
    """
    npad = sorted_tris.capacity
    keep = sorted_tris.valid if exclude is None else sorted_tris.valid & ~exclude
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
    tc = table.reshape(ROWS, npad // SUB, SUB).permute(1, 0, 2).contiguous()  # [NSUB, 16, 128]
    return tc, block_boxes(sorted_tris, keep)


def plane_hits(o, d, c, eps):
    """Rays o, d [R, 3] against one plane-constant sub-block c [16, 128]
    with the kernels' per-pair test: (t, ok) [R, 128]."""
    return plane_pair((o[:, 0:1], o[:, 1:2], o[:, 2:3]), (d[:, 0:1], d[:, 1:2], d[:, 2:3]),
                      list(c[:12]), eps)


def sweep_oversized(eps, rays, ov) -> torch.Tensor:
    """The plain versions' test of the oversized sub-block ov [1, 16, 128]:
    occluded [Rp] int32 (1 = some hit with eps <= t < t_limit) for padded
    rays [Rp, 8]."""
    t, ok = plane_hits(rays[:, 0:3], rays[:, 3:6], ov[0], float(eps.reshape(-1)[0]))
    return torch.any(ok & (t < rays[:, 6:7]), dim=-1).to(torch.int32)


class Tables:
    """One triangle table's search tables: the cluster sort, each route's
    packed segments with and without the oversized triangles, and the
    oversized sub-block, each built under no_grad from the detached
    triangles the first time a search asks for it."""

    def __init__(self, tris: TriangleBuffer):
        self.tris = tris.detach()  # holds the storages its key names
        self._sort = None
        self._segments = {}
        self._ov = None

    @property
    def built(self) -> bool:
        return self._sort is not None

    def sort(self):
        """`cluster_sort(tris)`."""
        if self._sort is None:
            with torch.no_grad():
                self._sort = cluster_sort(self.tris)
        return self._sort

    def segments(self, pack, seg: int, exclude_oversized: bool = False) -> list:
        """[(table, aabbs, perm_k)]: the sorted table padded with invalid
        triangles (perm -1) and packed by `pack(sorted_tris, exclude)` in
        segments, one padded to a multiple of SUB for up to `seg` triangles,
        else `seg`-sized ones. With exclude_oversized the packs drop the (up
        to OVER_CAP) oversized triangles."""
        key = (pack, seg, exclude_oversized)
        if key not in self._segments:
            sorted_tris, perm, exclude, _, _ = self.sort()
            n = sorted_tris.capacity
            nseg = -(-n // seg)
            pad = nseg * seg - n if nseg > 1 else (-n) % SUB
            with torch.no_grad():
                if pad:
                    filler = TriangleBuffer.empty(pad, device=perm.device)
                    sorted_tris = sorted_tris.map(
                        lambda name, a: torch.cat([a, getattr(filler, name)]))
                    perm = torch.cat([perm, perm.new_full((pad,), NO_HIT)])
                    exclude = torch.cat([exclude, exclude.new_zeros((pad,))])
                size = (n + pad) // nseg
                out = []
                for k in range(nseg):
                    sl = slice(k * size, (k + 1) * size)
                    table, aabbs = pack(sorted_tris.map(lambda _, a: a[sl]),
                                        exclude[sl] if exclude_oversized else None)
                    out.append((table, aabbs, perm[sl]))
            self._segments[key] = out
        return self._segments[key]

    def oversized(self) -> torch.Tensor:
        """The oversized triangles as one plane-constant sub-block [1, 16, 128]."""
        if self._ov is None:
            ov_buf = self.sort()[3]
            with torch.no_grad():
                self._ov = pack_planes(ov_buf)[0]
        return self._ov


_scope = threading.local()  # `memo`: the open `search_tables` block's tables by key


@contextlib.contextmanager
def search_tables():
    """Share the searches' scene tables inside the block: the first search
    call on a triangle table builds its `Tables`, the later calls on the same
    table reuse them. A nested block joins the open one; the tables go when
    the outermost block closes, so none outlives the trace that built it, and
    a CUDA graph captures the one build, which each replay runs again on its
    inputs. Outside a block each call builds its own."""
    if getattr(_scope, "memo", None) is not None:
        yield
        return
    _scope.memo = {}
    try:
        yield
    finally:
        _scope.memo = None


def _key(tris: TriangleBuffer) -> tuple:
    """The identity of the triangles' storage, which `detach()` keeps: device,
    address, shape, strides and version counter (an in-place write moves it)
    of v0, v1, v2 and valid. Host metadata only: no read of the card."""
    return tuple((t.device, t.data_ptr(), t.shape, t.stride(), t._version)
                 for t in (tris.v0, tris.v1, tris.v2, tris.valid))


def lookup(tris: TriangleBuffer) -> Tables:
    """`tris`' tables in the open `search_tables` block, else a call's own."""
    memo = getattr(_scope, "memo", None)
    if memo is None:
        return Tables(tris)
    key = _key(tris)
    if key not in memo:
        memo[key] = Tables(tris)
    return memo[key]


def pad_rays(o, d, t_limit=None):
    """Pad rays to RAY_GROUP and pack them: rays [Rp, 8] (o, d, t_limit, 0).
    Without a t_limit the column holds +inf, which culls nothing
    (`tn > inf` is false, NaN included). Pad rays (origin 0, direction +z,
    t_limit -1 when there is one) are the JAX package's, so the lists of a
    partly padded bundle or group are too."""
    pad = (-o.shape[0]) % RAY_GROUP
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, vec3(d, 0.0, 0.0, 1.0).expand(pad, 3)])
        if t_limit is not None:
            t_limit = torch.cat([t_limit, t_limit.new_full((pad,), -1.0)])
    tl = o.new_full((o.shape[0], 1), float("inf")) if t_limit is None else t_limit[:, None]
    return torch.cat([o, d, tl, o.new_zeros((o.shape[0], RAY_W - 7))], dim=1)


def eps_tensor(eps: float, device):
    """eps as the kernels' f32 [1], by a fill (a CUDA graph can capture it)."""
    return torch.full((1,), eps, dtype=torch.float32, device=device)


def orig_index(idx, perm):
    """Sorted index -> original index through perm (-1 stays -1)."""
    return torch.where(idx >= 0, perm[torch.clamp(idx, min=0).long()], NO_HIT)


def ptr(t):
    """A kernel argument's address (None for an absent one)."""
    return None if t is None else t.data_ptr()
