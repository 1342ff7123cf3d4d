"""Morton-ordered triangle clusters (counterpart of `esctp1raytracer_tpu/accel/clusters.py`).

Triangles sort by the 30-bit Morton code of their centroid, in three key
segments [normal | oversized | invalid]; the sorted order is cut into
clusters of 128 with one AABB each. The sort keys reach 0xFFFFFFFF, so
they are int64 here (PyTorch has no uint32 shifts on every backend), and
the argsort is stable, as `jnp.argsort` is: `perm` equals the JAX one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from esctp1raytracer_tpu_torch.accel.aabb import triangle_bounds
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

CLUSTER = 128

# Triangles whose AABB diagonal exceeds OVERSIZE_K x the median of the
# valid ones (ground planes, area lights) sort after all normal ones, so
# they do not inflate the dense mesh clusters' boxes.
OVERSIZE_K = 8.0


def _expand_bits_10(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of x (int64) so there are two zeros between each."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """30-bit 3D Morton codes (int64) for points [N, 3] (normalized internally)."""
    lo = torch.amin(points, dim=0)
    hi = torch.amax(points, dim=0)
    scale = torch.where(hi - lo > 1e-30, 1.0 / (hi - lo), 0.0)
    q = torch.clamp((points - lo) * scale, 0.0, 1.0)
    grid = torch.clamp((q * 1024.0).to(torch.int64), max=1023)
    return (
        (_expand_bits_10(grid[:, 0]) << 2)
        | (_expand_bits_10(grid[:, 1]) << 1)
        | _expand_bits_10(grid[:, 2])
    )


@dataclass
class ClusteredTriangles:
    """Morton-sorted triangle view + cluster AABB table."""

    tris: TriangleBuffer  # sorted
    perm: torch.Tensor  # [N] int32, sorted -> original
    cluster_min: torch.Tensor  # [C, 3]
    cluster_max: torch.Tensor  # [C, 3]
    oversized: torch.Tensor  # [N] bool (sorted order)


def build_clusters(tris: TriangleBuffer) -> ClusteredTriangles:
    n = tris.capacity
    if n % CLUSTER:
        raise ValueError(f"capacity {n} is not a multiple of {CLUSTER}")
    centroid = (tris.v0 + tris.v1 + tris.v2) / 3.0
    codes = morton_codes(centroid)
    tmin, tmax = triangle_bounds(tris)
    diag2 = torch.sum((tmax - tmin) ** 2, dim=1)
    # Masked median over VALID triangles: +inf fill, index the middle of
    # the valid prefix (a zero fill would drag it to 0 in sparse tables).
    n_valid = torch.sum(tris.valid)
    filled = torch.sort(torch.where(tris.valid, diag2, float("inf"))).values
    med2 = torch.index_select(filled, 0, (torch.clamp(n_valid - 1, min=0) // 2).reshape(1))[0]
    oversized = diag2 > (OVERSIZE_K * OVERSIZE_K) * torch.clamp(med2, min=1e-30)
    # Sort key segments [normal | oversized | invalid], Morton order within.
    codes = torch.where(oversized, codes + (1 << 30), codes)
    codes = torch.where(tris.valid, codes, 0xFFFFFFFF)
    perm = torch.argsort(codes, stable=True)
    sorted_tris = tris.take(perm)
    oversized_sorted = (oversized & tris.valid)[perm]

    bmin, bmax = triangle_bounds(sorted_tris)
    # Invalid triangles get inverted boxes (min 1e30, max -1e30). A slab test
    # (kernels/cull.py:block_cull_mask) keeps such a box for every ray; the
    # kernels that cull in registers recognise it and skip its block.
    bmin = torch.where(sorted_tris.valid[:, None], bmin, 1e30)
    bmax = torch.where(sorted_tris.valid[:, None], bmax, -1e30)
    c = n // CLUSTER
    return ClusteredTriangles(
        tris=sorted_tris, perm=perm.to(torch.int32),
        cluster_min=torch.amin(bmin.reshape(c, CLUSTER, 3), dim=1),
        cluster_max=torch.amax(bmax.reshape(c, CLUSTER, 3), dim=1),
        oversized=oversized_sorted,
    )


def cluster_table(clustered: ClusteredTriangles) -> torch.Tensor:
    """[8, C] float32 table: rows min xyz, max xyz, then two rows of zeros."""
    c = clustered.cluster_min.shape[0]
    rows = [clustered.cluster_min.T, clustered.cluster_max.T,
            clustered.cluster_min.new_zeros((2, c))]
    return torch.cat(rows, dim=0)
