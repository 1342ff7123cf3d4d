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
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import esctp1raytracer_tpu.kernels.rt_tile as jt  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.core.intersect import argmin_hit  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_tile as pt  # noqa: E402
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask  # noqa: E402
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
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


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
    """cnt and the kept prefix of every bundle's list (`_lists`) equal JAX's
    `_prep` (argsort mode), fed the same rays and boxes; so do the packed
    rays (`_pad_rays`), but for the t_limit column when there is no limit:
    +inf there (it culls nothing), where JAX writes 0 and skips the test."""
    js, ps, o, d = case(name)
    o, d = o[:1000], d[:1000]  # a partly padded last bundle and group
    _, ab_j, _, _, _ = jt.tri_constants_sub(js.triangles)
    tl = hint(ps, o, d) if with_limit else None
    rays_j, ids_j, cnt_j, rp, nsub, _ = jt._prep(J(o), J(d), ab_j, None if tl is None else J(tl),
                                                 "argsort")
    rays_p = pt._pad_rays(T(o), T(d), None if tl is None else T(tl))
    ids_p, cnt_p = pt._lists(rays_p, T(np.asarray(ab_j)))
    ids_j, cnt_j = np.asarray(ids_j).reshape(-1, nsub), np.asarray(cnt_j).reshape(-1)
    assert ids_p.shape == (rp // 8, nsub) and ids_p.dtype == cnt_p.dtype == torch.int32
    np.testing.assert_array_equal(cnt_p.numpy(), cnt_j)
    kept = np.arange(nsub)[None] < cnt_j[:, None]
    np.testing.assert_array_equal(ids_p.numpy()[kept], ids_j[kept])
    rays_j = np.array(rays_j).reshape(rp, 8)
    if not with_limit:
        np.testing.assert_array_equal(rays_j[:, 6], 0.0)
        rays_j[:, 6] = np.inf
    np.testing.assert_array_equal(rays_p.numpy(), rays_j)
    assert 0 < cnt_j.mean() < nsub


@pytest.mark.parametrize("name", ["mesh2", "mesh3"])
@pytest.mark.parametrize("with_limit", [False, True], ids=["no-limit", "t-limit"])
def test_plain_versions_sweep_jax_lists(name, with_limit):
    """The plain K5 and K6 (rays, boxes and table in; lists built inside)
    equal the sweeps of JAX's own `_prep` lists exactly, and write JAX's
    cnt to cnt_out."""
    js, ps, o, d = case(name)
    tl = hint(ps, o, d) if with_limit else None
    eps = torch.tensor([EPS])
    wavefronts = [("search", False)] + ([("occlusion", True)] if with_limit else [])
    for what, exclude in wavefronts:
        tc, aabbs, _, _, _ = pt.tri_constants_sub(ps.triangles, exclude)
        _, ids_j, cnt_j, _, nsub, _ = jt._prep(J(o), J(d), J(aabbs.numpy()),
                                               None if tl is None else J(tl), "argsort")
        ids_j = T(np.asarray(ids_j).reshape(-1, nsub))
        cnt_j = T(np.asarray(cnt_j).reshape(-1))
        rays = pt._pad_rays(T(o), T(d), None if tl is None else T(tl))
        cnt_out = torch.full_like(cnt_j, -1)
        if what == "search":
            got = pt.tile_kernel(eps, rays, aabbs, tc, cnt_out)
            want = pt._sweep_search(eps, rays, ids_j, cnt_j, tc)
            assert (got[1] >= 0).float().mean().item() > 0.3
        else:
            got = (pt.tile_occl_kernel(eps, rays, aabbs, tc, None, cnt_out),)
            want = (pt._sweep_occl(eps, rays, ids_j, cnt_j, tc),)
            assert 0.01 < got[0].float().mean().item() < 0.99
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(cnt_out, cnt_j) and 0 < cnt_j.float().mean().item() < nsub


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
    """The list builder streams in ray chunks of about _PREPASS_ELEMS
    pairs; the lists, and so every result, of nine chunks equal those of
    one chunk (the default here) exactly."""
    _, ps, o, d = case("mesh2")  # 2304 rays x 4 sub-blocks
    _, aabbs, _, _, _ = pt.tri_constants_sub(ps.triangles)
    rays = pt._pad_rays(T(o), T(d), T(hint(ps, o, d)))
    one = pt._lists(rays, aabbs)
    ref = _search_and_occlusion(ps, o, d)
    monkeypatch.setattr(pt, "_PREPASS_ELEMS", 4096)  # 9 chunks of 256 rays
    chunked = pt._lists(rays, aabbs)
    assert torch.equal(one[1], chunked[1])
    kept = torch.arange(aabbs.shape[1])[None] < one[1][:, None]
    assert torch.equal(one[0][kept], chunked[0][kept])
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
    tris = dataclasses.replace(TriangleBuffer.empty(n, device="cpu"), v0=v0, v1=v1, v2=v2, valid=valid)
    tc, _ = pt._pack_sub(tris)
    return tc


def _tie_boxes():
    """Boxes of the tie table's three sub-blocks: x in [-1, 0.05 + 0.1 j],
    y and z in [-1, 1]. Rays at x = 0.1 k keep the sub-blocks j >= k."""
    lo = torch.full((3, 3), -1.0)
    hi = torch.ones(3, 3)
    hi[0] = torch.tensor([0.05, 0.15, 0.25])
    return torch.cat([lo, hi, torch.zeros(2, 3)])


def test_plain_versions_tie_rule_and_empty_lists():
    """Equal t: the lowest sorted index among the visited sub-blocks wins,
    across sub-blocks and within one; a bundle that keeps no sub-block
    misses. Bundle k's rays start at x = 0.1 k and keep sub-blocks k..2."""
    tc, aabbs = _tie_table(), _tie_boxes()
    x = torch.arange(4, dtype=torch.float32).repeat_interleave(8) * 0.1
    o = torch.stack([x, torch.zeros(32), torch.full((32,), 2.0)], dim=1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(32, 3)
    tl = torch.full((32, 1), 1.5)
    rays = torch.cat([o, d, tl, torch.zeros(32, 1)], dim=1).contiguous()
    eps = torch.tensor([EPS])
    cnt = torch.full((4,), -1, dtype=torch.int32)
    n0 = (pt.tile_kernel.launches, pt.tile_occl_kernel.launches)
    t, idx = pt.tile_kernel(eps, rays, aabbs, tc, cnt_out=cnt)
    assert cnt.tolist() == [3, 2, 1, 0]
    occ = pt.tile_occl_kernel(eps, rays, aabbs, tc)
    assert (pt.tile_kernel.launches, pt.tile_occl_kernel.launches) == n0  # CPU: plain version
    assert idx.tolist() == [5] * 8 + [200] * 8 + [300] * 8 + [-1] * 8
    assert torch.equal(t[:24], torch.full((24,), 2.0)) and bool((t[24:] == BIG).all())
    assert occ.dtype == torch.int32 and occ.tolist() == [0] * 32  # t = 2 is beyond 1.5
    occ = pt.tile_occl_kernel(eps, torch.cat([rays[:, :6], rays[:, 6:] + 1.0], 1), aabbs, tc)
    assert occ.tolist() == [1] * 24 + [0] * 8


def _without_padding_only(ids, cnt, aabbs):
    """The lists with every sub-block whose box is inverted (min > max on an
    axis: padding only) dropped, still ascending: (ids, cnt)."""
    nsub = aabbs.shape[1]
    kept = torch.zeros(ids.shape, dtype=torch.bool)
    kept.scatter_(1, ids.long(), torch.arange(nsub)[None] < cnt[:, None])
    kept &= ~(aabbs[0:3] > aabbs[3:6]).any(0)
    ids = torch.argsort((~kept).to(torch.uint8), dim=1, stable=True).to(torch.int32)
    return ids, kept.sum(1, dtype=torch.int32)


def test_padding_only_sub_blocks_change_nothing(monkeypatch):
    """The kernels skip kept sub-blocks whose box is inverted. On a
    two-segment table (the second one mostly padding), sweeping the lists
    without them gives the same t, index and occlusion, exactly."""
    _, ps, o, d = case("mesh3")
    monkeypatch.setattr(pt, "TILE_TRI_LIMIT", 1024)
    tl = hint(ps, o, d)
    rays = pt._pad_rays(T(o), T(d), T(tl))
    eps = torch.tensor([EPS])
    dropped = 0
    for exclude in (False, True):
        segs, _, _ = pt._sliced(ps.triangles, exclude_oversized=exclude)
        for tc, aabbs, _ in segs:
            ids, cnt = pt._lists(rays, aabbs)
            ids2, cnt2 = _without_padding_only(ids, cnt, aabbs)
            dropped += int((cnt - cnt2).sum())
            if exclude:
                pairs = [(pt._sweep_occl(eps, rays, ids, cnt, tc),
                          pt._sweep_occl(eps, rays, ids2, cnt2, tc))]
            else:
                pairs = zip(pt._sweep_search(eps, rays, ids, cnt, tc),
                            pt._sweep_search(eps, rays, ids2, cnt2, tc))
            assert all(torch.equal(x, y) for x, y in pairs)
    assert dropped > 0


def test_oversized_sub_block_folds_into_occlusion():
    """K6's plain version, given the oversized triangles packed as one
    sub-block, equals the segment sweep ORed with `_oversized_occl`
    exactly, and the entry point gives that answer."""
    _, ps, o, d = case("mesh3")  # the ground plane and the light are oversized
    tl = np.random.RandomState(5).uniform(0.0, 12.0, o.shape[0]).astype(np.float32)
    tc, aabbs, _, ov_buf, _ = pt.tri_constants_sub(ps.triangles, True)
    ov, _ = pt._pack_sub(ov_buf)
    assert ov.shape == (1, 16, 128)
    rays, eps, r = pt._pad_rays(T(o), T(d), T(tl)), torch.tensor([EPS]), o.shape[0]
    folded = pt._tile_occl_plain(eps, rays, aabbs, tc, ov)[:r] > 0
    segment = pt._tile_occl_plain(eps, rays, aabbs, tc)[:r] > 0
    oversized = pt._oversized_occl(T(o), T(d), T(tl), ov_buf, float(EPS))
    assert torch.equal(folded, segment | oversized)
    assert bool((oversized & ~segment).any()) and bool((segment & ~oversized).any())
    assert torch.equal(pt.tile_occlusion(T(o), T(d), T(tl), ps.triangles, float(EPS)), folded)


def _np_slab_keep(o, d, aabbs, t_limit=None, nan_min=np.minimum, nan_max=np.maximum):
    """The kernels' slab test in numpy: IEEE 1/d, NaN-propagating min and
    max (np.minimum, np.max), reject on tn > tf, tf < 0, tn > t_limit."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.float32(1.0) / d
        lo, hi = aabbs[0:3].T, aabbs[3:6].T
        t0 = (lo[None] - o[:, None]) * inv[:, None]
        t1 = (hi[None] - o[:, None]) * inv[:, None]
        mins, maxs = nan_min(t0, t1), nan_max(t0, t1)
        tn = nan_max(nan_max(mins[..., 0], mins[..., 1]), mins[..., 2])
        tf = nan_min(nan_min(maxs[..., 0], maxs[..., 1]), maxs[..., 2])
        reject = (tn > tf) | (tf < 0)
        if t_limit is not None:
            reject |= tn > t_limit[:, None]
    return ~reject, np.isnan(t0).any(-1) | np.isnan(t1).any(-1)


def test_slab_test_nan_semantics_match_block_cull_mask():
    """Axis-aligned rays (zero and negative-zero direction components) whose
    origins lie on box planes give 0 * inf = NaN slab values; a numpy slab
    test with NaN-propagating min and max (the kernels' `min.NaN`) equals
    `block_cull_mask` on every (ray, box), and keeps the NaN pairs. A
    NaN-dropping min and max (CUDA's fminf/fmaxf) would not."""
    rng = np.random.RandomState(11)
    lo = rng.uniform(-2, 1, (5, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 2, (5, 3)).astype(np.float32)
    aabbs = np.concatenate([lo.T, hi.T, np.zeros((2, 5), np.float32)])
    o, d = [], []
    for box in range(5):
        for axis in range(3):
            for plane in (lo[box, axis], hi[box, axis]):
                for along in range(3):
                    for sign in (1.0, -1.0):
                        p = rng.uniform(lo[box], hi[box]).astype(np.float32)
                        p[axis] = plane
                        v = np.array([0.0, 0.0, 0.0], np.float32) * -sign  # +-0 components
                        v[along] = sign
                        o.append(p)
                        d.append(v)
    o = np.concatenate([np.stack(o), rng.uniform(-3, 3, (64, 3)).astype(np.float32)])
    d = np.concatenate([np.stack(d), rng.normal(size=(64, 3)).astype(np.float32)])
    tl = rng.uniform(-1, 4, o.shape[0]).astype(np.float32)
    for t_limit in (None, tl):
        want, nan = _np_slab_keep(o, d, aabbs, t_limit)
        got = block_cull_mask(T(o), T(d), T(aabbs), None if t_limit is None else T(t_limit))
        np.testing.assert_array_equal(got.numpy(), want)
        assert nan.sum() > 50 and want[nan].all()
        dropping, _ = _np_slab_keep(o, d, aabbs, t_limit, np.fmin, np.fmax)
        assert (dropping != want).any()


def test_group_boxes_reject_only_what_every_member_rejects():
    """The kernels' first cull level (`_group_boxes`): a ray with a finite
    1/d that rejects a group's union box rejects every box of the group
    (`block_cull_mask`, with and without a t-limit), and a group holding an
    inverted box is flagged, as counting tests it box by box. Without the
    flag the union, which leaves inverted boxes out and is inverted for a
    group of nothing else, still covers every member that is not inverted:
    the kernels' test when they do not count. A zero direction component
    breaks that (a NaN slab keeps a member whose union is rejected), which
    is why the kernels keep every group for such a bundle."""
    rng = np.random.RandomState(3)
    nsub = 80  # three groups, the last one partial
    lo = rng.uniform(-4, 3, (nsub, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1.0, (nsub, 3)).astype(np.float32)
    pad = [5] + list(range(64, nsub))  # padding-only sub-blocks: all of group 2
    lo[pad], hi[pad] = 1e30, -1e30
    aabbs = T(np.concatenate([lo.T, hi.T, np.zeros((2, nsub), np.float32)]))
    gb = pt._group_boxes(aabbs)
    assert gb.shape == (8, 3) and gb[6].tolist() == [1.0, 0.0, 1.0]
    inverted = (gb[0:3] > gb[3:6]).any(0)
    assert inverted.tolist() == [False, False, True]
    live = ~(aabbs[0:3] > aabbs[3:6]).any(0)
    o = rng.uniform(-6, 6, (4000, 3)).astype(np.float32)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    tl = rng.uniform(0, 10, 4000).astype(np.float32)
    rejected = 0
    for t_limit in (None, T(tl)):
        member = block_cull_mask(T(o), T(d), aabbs, t_limit)
        group = block_cull_mask(T(o), T(d), gb, t_limit) | (gb[6] > 0)[None]
        assert not bool((member & ~group.repeat_interleave(32, 1)[:, :nsub]).any())
        swept = block_cull_mask(T(o), T(d), gb, t_limit) & ~inverted[None]
        assert not bool((member & live & ~swept.repeat_interleave(32, 1)[:, :nsub]).any())
        rejected += int((~group).sum())
    assert rejected > 1000
    # A ray along +y from x = lo.x of box 40 (d.x = 0, so 0 * inf = NaN there),
    # leaving the group's y range: the union rejects it, box 40 keeps it.
    o1 = T(np.array([[lo[40, 0], hi[32:64, 1].max() + 1.0, lo[40, 2] + 0.05]], np.float32))
    d1 = T(np.array([[0.0, 1.0, 0.0]], np.float32))
    assert bool(block_cull_mask(o1, d1, aabbs)[0, 40])
    assert not bool(block_cull_mask(o1, d1, gb)[0, 1])
