"""Oversized-triangle handling shared by the tile kernels.

Only the part of `esctp1raytracer_tpu/kernels/rt_tile.py` that the mxtile
path uses is ported here: the cluster sort with oversized segregation
(`_clustered_tables`) and the tensor-op sweep over the oversized set
(`_oversized_hits`, `_oversized_occl`). The tile kernels themselves
(`_tile_kernel`, `_occl_tile_kernel`) are not ported yet.

Oversized triangles (ground planes, area lights) sort into a trailing
block. For the occlusion pass they are also excluded from the kernel's
table and swept here, at most OVER_CAP of them: their shared block AABB
could never be culled by a shadow ray's t-limit, while out here the floor
fails the direction test and the light's tight box fails the t-window.
"""

from __future__ import annotations

import dataclasses

import torch

from esctp1raytracer_tpu_torch.accel.clusters import build_clusters
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

OVER_CAP = 128


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
    """One-pass any-hit over the excluded set: [R] bool."""
    t, ok = _oversized_hits(o, d, ov_buf, eps)
    return torch.any(ok & (t < t_limit[:, None]), dim=1)
