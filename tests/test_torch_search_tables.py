"""Port: the segmented searches' scene tables, built once per trace
(`kernels/tables.py:search_tables`), on the CPU.

The cluster sort and the packed tables depend on the triangles alone, so a
`trace_rays` call and the fused backward's re-derivation build them once and
share them with every search call of their chunks and bounces, on the
mxtile route and on the tile route. Held here on config 4's scene
(`mixed_scene()`, depth 4) at a small size: one sort per trace or
re-derivation, counted at `build_clusters`; the colour and every leaf's
gradient bit-equal to a run with the scope replaced by a null context (a
build per search call); and no table kept past its trace. Both routes'
packs take their block boxes from one function.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, trace_rays  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas, rt_mxu, rt_tile, tables  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import (  # noqa: E402
    TriangleBuffer, float_params, merge_params,
)

W, H = 32, 18  # 576 camera rays
DEPTH = 4
CHUNK = 160  # 576 rays in 4 chunks, the last of 96
CAM = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=16 / 9, device="cpu")


@pytest.fixture(scope="module")
def scene():
    return builders.mixed_scene(device="cpu")


@pytest.fixture
def builds(monkeypatch):
    """The search's cluster sorts, counted (the fused forward's table build
    calls `build_clusters` through its own module, and is not counted)."""
    calls = []
    build = tables.build_clusters
    monkeypatch.setattr(tables, "build_clusters", lambda tris: calls.append(1) or build(tris))
    return calls


def _rays():
    o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(W, H))
    return o, d, torch.arange(o.shape[0], dtype=torch.int64)


def _color_and_grads(scene, cfg):
    """The wavefront's colour and the gradients of a weighted sum of it with
    respect to every float leaf."""
    o, d, ids = _rays()
    ps = [p.detach().requires_grad_(True) for p in float_params(scene)]
    color = trace_rays(o, d, merge_params(scene, ps), ids, cfg)
    weights = torch.linspace(0.5, 1.5, color.numel()).reshape(color.shape)
    grads = torch.autograd.grad(torch.sum(color * weights), ps, allow_unused=True)
    return color.detach(), grads


def _assert_bit_equal(got, want):
    color, grads = got
    color0, grads0 = want
    assert torch.equal(color, color0)
    assert len(grads) == len(grads0)
    for g, g0 in zip(grads, grads0):
        assert (g is None) == (g0 is None) and (g is None or torch.equal(g, g0))


def _chunks(chunk):
    return -(-W * H // chunk) if chunk else 1


def _one_build_per_call(scene, builds, cfg, monkeypatch):
    """One cluster sort for a `trace_rays` call on `cfg`, where a search per
    call builds one for each of its 2 x depth x chunks searches; colour and
    gradients bit-equal."""
    shared = _color_and_grads(scene, cfg)
    assert len(builds) == 1
    assert tables._scope.memo is None
    builds.clear()
    monkeypatch.setattr(tables, "search_tables", contextlib.nullcontext)
    per_call = _color_and_grads(scene, cfg)
    assert len(builds) == 2 * DEPTH * _chunks(cfg.ray_chunk)
    _assert_bit_equal(shared, per_call)
    assert any(g is not None and bool(g.abs().sum() > 0) for g in shared[1])


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_one_build_per_trace_rays_call(scene, builds, chunk, monkeypatch):
    """mxtile's plain route at depth 4, whole and in ray chunks."""
    _one_build_per_call(scene, builds, RenderConfig(backend="mxtile", depth=DEPTH, ray_chunk=chunk),
                        monkeypatch)


@pytest.mark.parametrize("chunk", [0, CHUNK])
def test_one_build_per_tile_trace_rays_call(scene, builds, chunk, monkeypatch):
    """The tile route's plain version at depth 4, whole and in ray chunks: its
    closest-hit and any-hit searches share one sort, as mxtile's do."""
    _one_build_per_call(scene, builds, RenderConfig(backend="tile", depth=DEPTH, ray_chunk=chunk),
                        monkeypatch)


def test_one_build_per_rederivation(scene, builds, monkeypatch):
    """The fused forward, then its backward's chunked mxtile re-derivation (4
    chunks x 4 bounces, 32 searches): one cluster sort for the whole
    re-derivation; colour and gradients bit-equal to a build per search."""
    monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
    monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", CHUNK)
    cfg = RenderConfig(backend="auto", depth=DEPTH)
    assert fused_pallas.fused_supported(scene, DEPTH, cfg.light_mode)
    shared = _color_and_grads(scene, cfg)
    assert len(builds) == 1
    assert tables._scope.memo is None
    builds.clear()
    monkeypatch.setattr(tables, "search_tables", contextlib.nullcontext)
    per_call = _color_and_grads(scene, cfg)
    assert len(builds) == 2 * DEPTH * _chunks(CHUNK)
    _assert_bit_equal(shared, per_call)


def _moved(scene):
    """Raise every triangle by 0.25 in place."""
    for v in (scene.triangles.v0, scene.triangles.v1, scene.triangles.v2):
        v[:, 1] += 0.25


def _trace(scene, cfg):
    o, d, ids = _rays()
    with torch.no_grad():
        return trace_rays(o, d, scene, ids, cfg)


def test_no_table_outlives_its_trace(builds):
    """Two calls with the vertices written in place between them: the second
    builds its own tables and gives the colour of a fresh copy of the moved
    scene."""
    scene = builders.mixed_scene(device="cpu")
    cfg = RenderConfig(backend="mxtile", depth=DEPTH, ray_chunk=CHUNK)
    first = _trace(scene, cfg)
    _moved(scene)
    second = _trace(scene, cfg)
    assert len(builds) == 2 and tables._scope.memo is None
    fresh = _trace(scene.map(lambda _, t: t.clone()), cfg)
    assert torch.equal(second, fresh) and not torch.equal(second, first)


def test_a_scope_keys_tables_by_triangle_storage(builds):
    """Inside one open scope: a nested trace reuses the open scope's tables, a
    copy of the table in other storage gets its own, and an in-place write
    (the version counter moves) builds anew; the scope's tables go when it
    closes."""
    scene = builders.mixed_scene(device="cpu")
    copy = scene.map(lambda _, t: t.clone())
    cfg = RenderConfig(backend="mxtile", depth=2)
    with tables.search_tables():
        a = _trace(scene, cfg)
        assert len(builds) == 1 and len(tables._scope.memo) == 1
        assert torch.equal(_trace(scene, cfg), a) and len(builds) == 1
        assert torch.equal(_trace(copy, cfg), a) and len(builds) == 2
        _moved(scene)
        _moved(copy)
        b = _trace(scene, cfg)
        assert len(builds) == 3 and not torch.equal(b, a)
        assert torch.equal(_trace(copy.map(lambda _, t: t.clone()), cfg), b)
    assert tables._scope.memo is None


def test_search_outside_a_scope_builds_per_call(scene, builds):
    """A search called on its own (no scope open) builds its tables for that
    call and keeps none."""
    o, d, _ = _rays()
    with torch.no_grad():
        t0, i0 = rt_mxu.mxu_tile_search(o, d, scene.triangles, 1e-6)
        t1, i1 = rt_mxu.mxu_tile_search(o, d, scene.triangles, 1e-6)
    assert len(builds) == 2 and torch.equal(t0, t1) and torch.equal(i0, i1)


def test_tile_search_outside_a_scope_builds_per_call(scene, builds):
    """The tile route's searches, each called on its own, build their tables
    for that call and keep none."""
    o, d, _ = _rays()
    tl = torch.full((o.shape[0],), 6.0)
    with torch.no_grad():
        t0, i0 = rt_tile.tile_tri_search(o, d, scene.triangles, 1e-6)
        t1, i1 = rt_tile.tile_tri_search(o, d, scene.triangles, 1e-6)
        occ = [rt_tile.tile_occlusion(o, d, tl, scene.triangles, 1e-6) for _ in range(2)]
    assert len(builds) == 4 and torch.equal(t0, t1) and torch.equal(i0, i1)
    assert torch.equal(*occ) and bool((i0 >= 0).any()) and bool(occ[0].any())


def _box_table():
    """Three blocks of random triangles: every third one invalid, the last
    block all invalid (padding only)."""
    n = 3 * 128
    v = torch.randn(n, 3, 3, generator=torch.Generator().manual_seed(3)) * 4.0
    valid = (torch.arange(n) % 3 != 0) & (torch.arange(n) < 256)
    leaves = {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2], "valid": valid}
    return TriangleBuffer.empty(n, device="cpu").map(lambda name, a: leaves.get(name, a))


@pytest.mark.parametrize("exclude", [False, True], ids=["search", "occlusion"])
def test_both_formats_share_the_block_boxes(exclude):
    """mxtile's feature columns (`rt_mxu._pack_mxu`) and the plane constants
    (`tables.pack_planes`) carry the boxes of `tables.block_boxes`: per block
    of 128, the min and max of its kept triangles' vertices (a loop here),
    inverted (1e30 > -1e30) where it keeps none; bit for bit, with and
    without excluded triangles."""
    tris = _box_table()
    n = tris.capacity
    drop = torch.arange(n) % 5 == 0 if exclude else None
    keep = tris.valid if drop is None else tris.valid & ~drop
    v = torch.stack([tris.v0, tris.v1, tris.v2], dim=1)
    want = torch.zeros(8, n // 128)
    for k in range(n // 128):
        kv = v[k * 128:(k + 1) * 128][keep[k * 128:(k + 1) * 128]].reshape(-1, 3)
        lo, hi = (kv.amin(0), kv.amax(0)) if kv.shape[0] else (1e30, -1e30)
        want[0:3, k], want[3:6, k] = lo, hi
    assert bool((want[0:3, :2] < want[3:6, :2]).all()) and bool((want[0:3, 2] > want[3:6, 2]).all())
    assert torch.equal(tables.block_boxes(tris, keep), want)
    for pack in (rt_mxu._pack_mxu, tables.pack_planes):
        assert torch.equal(pack(tris, drop)[1], want)
