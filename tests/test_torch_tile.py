"""Port vs JAX package: the tile search and occlusion (kernels/rt_tile.py).

The JAX functions run their Pallas kernels in interpret mode on the CPU
(rt_tile.py picks it off the TPU); the port's wrappers, given CPU
tensors, run their plain PyTorch versions. Both get the same rays (JAX's
camera, as numpy). Bars (tests/test_rt_tile.py): winners agree on >
99.8% of rays, t within rtol 1e-4 / atol 1e-5 where they agree (XLA on
the CPU contracts a*b + c into FMAs, PyTorch does not: winners may flip
on exact near-ties); occlusion agrees on > 99.9%. The packed constants
agree to 1e-6 of each row's scale, for the same reason; boxes, perm and
the cull lists are exact. The interpret-mode kernels compile once per
shape (~10 s each), so the cases share ray counts where they can.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import esctp1raytracer_tpu.kernels.rt_tile as jt  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.core.intersect import argmin_hit  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_tile as pt  # noqa: E402
from esctp1raytracer_tpu_torch.core.intersect import BIG  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer, scene_from_numpy  # noqa: E402

EPS = np.float32(np.finfo(np.float32).eps)
CORNELL_CAM = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), aspect=1.0)
MESH_CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), aspect=1.0)
# name: (builder, camera, frame side)
SCENES = {
    "cornell": (jb.cornell_box, CORNELL_CAM, 64),
    "mesh2": (lambda: jb.mesh_scene(2), MESH_CAM, 48),
    "mesh3": (lambda: jb.mesh_scene(3), MESH_CAM, 32),
}


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]})


def rays(cam, w, h):
    o, d = cam.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


_CASES = {}


def case(name):
    """(JAX scene, port scene, o, d) for a scene of SCENES, built once."""
    if name not in _CASES:
        build, cam, side = SCENES[name]
        js = build()
        _CASES[name] = (js, to_port(js), *rays(cam, side, side))
    return _CASES[name]


J = jnp.asarray


def T(a):
    return torch.from_numpy(np.array(a))


def hint(ps, o, d, seed=3):
    """A t_limit that culls: 0.5-1.5x each ray's true hit distance."""
    t, _ = pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS))
    scale = np.random.RandomState(seed).uniform(0.5, 1.5, o.shape[0]).astype(np.float32)
    return t.numpy() * scale


def assert_search_agrees(tj, ij, tp, ip, min_hits=0.3):
    tj, ij, tp, ip = np.asarray(tj), np.asarray(ij), tp.numpy(), ip.numpy()
    same = ij == ip
    assert same.mean() > 0.998, f"winner mismatch {1 - same.mean():.4f}"
    hit = same & (ij >= 0)
    np.testing.assert_allclose(tp[hit], tj[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tp[ip < 0], np.float32(BIG))
    assert (ip >= 0).mean() > min_hits


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("exclude", [False, True], ids=["search", "occlusion"])
def test_tables_match_jax(name, exclude):
    js, ps, _, _ = case(name)
    tc_j, ab_j, perm_j, ov_j, orig_j = jt.tri_constants_sub(js.triangles, exclude)
    tc_p, ab_p, perm_p, ov_p, orig_p = pt.tri_constants_sub(ps.triangles, exclude)
    a, b = np.asarray(tc_j), tc_p.numpy()
    assert b.shape == a.shape == (ps.num_triangles // 128, 16, 128)
    nan = np.isnan(a)  # dropped triangles' w rows: 0 / 0 in both packages
    np.testing.assert_array_equal(np.isnan(b), nan)
    a, b = np.where(nan, 0.0, a), np.where(nan, 0.0, b)
    scale = np.maximum(np.abs(a).max(axis=(0, 2), keepdims=True), 1e-30)
    assert (np.abs(a - b) <= 1e-6 * scale).all()
    np.testing.assert_array_equal(ab_p.numpy(), np.asarray(ab_j))
    np.testing.assert_array_equal(perm_p.numpy(), np.asarray(perm_j))
    np.testing.assert_array_equal(orig_p.numpy(), np.asarray(orig_j))
    np.testing.assert_array_equal(ov_p.valid.numpy(), np.asarray(ov_j.valid))


@pytest.mark.parametrize("name", ["mesh2", "mesh3"])
@pytest.mark.parametrize("with_limit", [False, True], ids=["no-limit", "t-limit"])
def test_prepass_matches_jax(name, with_limit):
    """cnt and the kept prefix of every bundle's list equal JAX's `_prep`
    (argsort mode), fed the same rays and boxes; so do the packed rays."""
    js, ps, o, d = case(name)
    o, d = o[:1000], d[:1000]  # a partly padded last bundle and group
    _, ab_j, _, _, _ = jt.tri_constants_sub(js.triangles)
    tl = hint(ps, o, d) if with_limit else None
    rays_j, ids_j, cnt_j, rp, nsub, _ = jt._prep(J(o), J(d), ab_j, None if tl is None else J(tl),
                                                 "argsort")
    rays_p, ids_p, cnt_p = pt._prep(T(o), T(d), T(np.asarray(ab_j)),
                                    None if tl is None else T(tl))
    ids_j, cnt_j = np.asarray(ids_j).reshape(-1, nsub), np.asarray(cnt_j).reshape(-1)
    assert ids_p.shape == (rp // 8, nsub) and ids_p.dtype == cnt_p.dtype == torch.int32
    np.testing.assert_array_equal(cnt_p.numpy(), cnt_j)
    kept = np.arange(nsub)[None] < cnt_j[:, None]
    np.testing.assert_array_equal(ids_p.numpy()[kept], ids_j[kept])
    np.testing.assert_array_equal(rays_p.numpy(), np.asarray(rays_j).reshape(rp, 8))
    assert 0 < cnt_j.mean() < nsub


@pytest.mark.parametrize("name", list(SCENES))
def test_search_matches_jax(name):
    js, ps, o, d = case(name)
    tj, ij = jt.tile_tri_search(J(o), J(d), js.triangles, EPS)
    tp, ip = pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS))
    assert tp.shape == (o.shape[0],) and tp.dtype == torch.float32 and ip.dtype == torch.int32
    assert_search_agrees(tj, ij, tp, ip)


@pytest.mark.parametrize("name", ["cornell", "mesh3"])
def test_search_with_t_limit_matches_jax(name):
    """The hint culls the lists but never clamps t: both packages return
    hits beyond it from the sub-blocks that survive."""
    js, ps, o, d = case(name)
    tl = hint(ps, o, d)
    tj, ij = jt.tile_tri_search(J(o), J(d), js.triangles, EPS, t_limit=J(tl))
    tp, ip = pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS), t_limit=T(tl))
    assert_search_agrees(tj, ij, tp, ip)
    beyond = (ip.numpy() >= 0) & (tp.numpy() > tl)
    assert beyond.any() and (np.asarray(tj)[beyond] > tl[beyond]).all()


@pytest.mark.parametrize("name", ["cornell", "mesh3"])
def test_occlusion_matches_jax(name):
    """Shadow rays from each camera hit toward a point near the light."""
    js, ps, o, d = case(name)
    t, _, _ = argmin_hit(J(o), J(d), js, EPS, use_mxu=False)
    hit = t < 1e29
    hp = o + d * (np.where(hit, np.asarray(t), 1.0)[:, None] - 1e-4)
    light = np.asarray([0.1, 1.9, 0.0] if name == "cornell" else [0.3, 5.9, 2.2], np.float32)
    lv = light - hp
    dist = np.sqrt(np.maximum((lv * lv).sum(-1), 1e-12))
    sd = (lv / dist[:, None]).astype(np.float32)
    tl = np.where(hit, dist - 1e-4, -1.0).astype(np.float32)
    hp = hp.astype(np.float32)
    occ_j = np.asarray(jt.tile_occlusion(J(hp), J(sd), J(tl), js.triangles, EPS))
    occ_p = pt.tile_occlusion(T(hp), T(sd), T(tl), ps.triangles, float(EPS)).numpy()
    assert (occ_j == occ_p).mean() > 0.999
    assert 0.01 < occ_p.mean() < 0.99


def test_nonmultiple_ray_count_matches_jax():
    js, ps, _, _ = case("cornell")
    o, d = rays(CORNELL_CAM, 33, 17)  # 561 rays
    tj, ij = jt.tile_tri_search(J(o), J(d), js.triangles, EPS)
    tp, ip = pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS))
    assert tp.shape == ip.shape == (561,)
    assert (ip.numpy() < 36).all()
    assert_search_agrees(tj, ij, tp, ip)


def _search_and_occlusion(ps, o, d):
    tl = hint(ps, o, d)
    t, i = pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS), t_limit=T(tl))
    occ = pt.tile_occlusion(T(o), T(d), T(tl), ps.triangles, float(EPS))
    return t, i, occ


def test_sliced_segments_match_resident(monkeypatch):
    """Over TILE_TRI_LIMIT the table goes through in segments, combined
    first-wins: the same results as one resident segment, exactly."""
    _, ps, o, d = case("mesh3")  # capacity 1536: 2 segments of 1024
    ref = _search_and_occlusion(ps, o, d)
    monkeypatch.setattr(pt, "TILE_TRI_LIMIT", 1024)
    segs, _, _ = pt._sliced(ps.triangles)
    assert len(list(segs)) == 2
    for a, b in zip(ref, _search_and_occlusion(ps, o, d)):
        assert torch.equal(a, b)
    assert bool(ref[2].any()) and bool((ref[1] >= 0).any())


def test_chunked_prepass_matches_one_shot(monkeypatch):
    """The cull pre-pass streams in ray chunks of about _PREPASS_ELEMS
    pairs; the lists, and so every result, of nine chunks equal those of
    one chunk (the default here) exactly."""
    _, ps, o, d = case("mesh2")  # 2304 rays x 4 sub-blocks
    _, aabbs, _, _, _ = pt.tri_constants_sub(ps.triangles)
    tl = T(hint(ps, o, d))
    one = pt._prep(T(o), T(d), aabbs, tl)
    ref = _search_and_occlusion(ps, o, d)
    monkeypatch.setattr(pt, "_PREPASS_ELEMS", 4096)  # 9 chunks of 256 rays
    chunked = pt._prep(T(o), T(d), aabbs, tl)
    assert torch.equal(one[0], chunked[0]) and torch.equal(one[2], chunked[2])
    kept = torch.arange(aabbs.shape[1])[None] < one[2][:, None]
    assert torch.equal(one[1][kept], chunked[1][kept])
    for a, b in zip(ref, _search_and_occlusion(ps, o, d)):
        assert torch.equal(a, b)


def test_chunked_oversized_sweep_matches_one_shot(monkeypatch):
    """The oversized any-hit sweep streams in chunks of _SWEEP_RAYS rays;
    its answers equal the one-shot sweep's exactly, and JAX's."""
    js, ps, o, d = case("mesh3")  # the ground plane and the light are oversized
    _, _, _, ov_j, _ = jt.tri_constants_sub(js.triangles, True)
    _, _, _, ov_p, _ = pt.tri_constants_sub(ps.triangles, True)
    tl = np.random.RandomState(5).uniform(0.0, 12.0, o.shape[0]).astype(np.float32)
    one = pt._oversized_occl(T(o), T(d), T(tl), ov_p, float(EPS))
    monkeypatch.setattr(pt, "_SWEEP_RAYS", 300)  # 4 chunks, the last partial
    chunked = pt._oversized_occl(T(o), T(d), T(tl), ov_p, float(EPS))
    assert torch.equal(one, chunked) and 0.01 < one.float().mean().item() < 0.99
    ref = np.asarray(jt._oversized_occl(J(o), J(d), J(tl), ov_j, EPS))
    assert (ref == chunked.numpy()).mean() > 0.999


def _tie_table():
    """Three sub-blocks; one triangle facing +z at sorted slots 5 (block 0),
    200 and 250 (block 1) and 300 (block 2); all else invalid."""
    n = 3 * 128
    v0, v1, v2 = torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n, 3)
    valid = torch.zeros(n, dtype=torch.bool)
    for i in (5, 200, 250, 300):
        v0[i] = torch.tensor([-1.0, -1.0, 0.0])
        v1[i] = torch.tensor([1.0, -1.0, 0.0])
        v2[i] = torch.tensor([0.0, 1.0, 0.0])
        valid[i] = True
    tris = dataclasses.replace(TriangleBuffer.empty(n), v0=v0, v1=v1, v2=v2, valid=valid)
    tc, _ = pt._pack_sub(tris)
    return tc


def test_plain_versions_tie_rule_and_empty_lists():
    """Equal t: the lowest sorted index among the visited sub-blocks wins,
    across sub-blocks and within one; a bundle with cnt = 0 misses."""
    tc = _tie_table()
    o = torch.tensor([[0.0, 0.0, 2.0]]).expand(32, 3)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(32, 3)
    tl = torch.full((32, 1), 1.5)
    rays = torch.cat([o, d, tl, torch.zeros(32, 1)], dim=1).contiguous()
    ids = torch.tensor([[0, 1, 2], [1, 2, 0], [2, 0, 1], [0, 1, 2]], dtype=torch.int32)
    cnt = torch.tensor([3, 2, 1, 0], dtype=torch.int32)
    eps = torch.tensor([EPS])
    n0 = (pt.tile_kernel.launches, pt.tile_occl_kernel.launches)
    t, idx = pt.tile_kernel(eps, rays, ids, cnt, tc)
    occ = pt.tile_occl_kernel(eps, rays, ids, cnt, tc)
    assert (pt.tile_kernel.launches, pt.tile_occl_kernel.launches) == n0  # CPU: plain version
    assert idx.tolist() == [5] * 8 + [200] * 8 + [300] * 8 + [-1] * 8
    assert torch.equal(t[:24], torch.full((24,), 2.0)) and bool((t[24:] == BIG).all())
    assert occ.dtype == torch.int32 and occ.tolist() == [0] * 32  # t = 2 is beyond 1.5
    occ = pt.tile_occl_kernel(eps, torch.cat([rays[:, :6], rays[:, 6:] + 1.0], 1), ids, cnt, tc)
    assert occ.tolist() == [1] * 24 + [0] * 8
