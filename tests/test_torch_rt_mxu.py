"""Port vs JAX package: the mxtile search and occlusion (kernels/rt_mxu.py).

The JAX functions run their Pallas kernels in interpret mode on the CPU;
the port's wrappers, given CPU tensors, run their plain PyTorch versions.
Bars (tests/test_rt_mxu.py): winner agreement > 99.9% and relative t
error < 1e-5 where winners agree (the feature contraction is summed in
another order, so winners may flip on exact near-ties); occlusion
agreement > 99.9%; list lengths (cnt) and the oversized fold exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import esctp1raytracer_tpu.kernels.rt_mxu as jm  # noqa: E402
import esctp1raytracer_tpu.kernels.rt_tile as jt  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.core.intersect import closest_hit  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_mxu as pm  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_tile as pt  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

EPS = np.float32(np.finfo(np.float32).eps)
CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


@pytest.fixture(scope="module")
def scenes():
    js = jb.scene_from_mesh([
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
        jb._ground_plane(),
        jb._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ])
    return js, to_port(js)


def rays(w, h):
    o, d = CAM.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def assert_search_agrees(tj, ij, tp, ip):
    tj, ij, tp, ip = np.asarray(tj), np.asarray(ij), tp.numpy(), ip.numpy()
    same = ij == ip
    assert same.mean() > 0.999, f"winner mismatch {1 - same.mean():.4f}"
    rel = np.abs(tj[same] - tp[same]) / np.maximum(np.abs(tj[same]), 1.0)
    assert rel.max() < 1e-5
    assert (ip >= 0).mean() > 0.3


@pytest.mark.parametrize("limit", [pm.MXU_TRI_LIMIT, 256], ids=["one-segment", "segments"])
def test_search_matches_jax(scenes, monkeypatch, limit):
    js, ps = scenes
    monkeypatch.setattr(jm, "MXU_TRI_LIMIT", limit)
    monkeypatch.setattr(pm, "MXU_TRI_LIMIT", limit)
    o, d = rays(48, 48) if limit == pm.MXU_TRI_LIMIT else rays(24, 24)
    tj, ij = jm.mxu_tile_search(jnp.asarray(o), jnp.asarray(d), js.triangles, EPS)
    tp, ip = pm.mxu_tile_search(torch.from_numpy(o), torch.from_numpy(d), ps.triangles,
                                float(EPS))
    assert_search_agrees(tj, ij, tp, ip)


def test_search_with_t_limit(scenes):
    js, ps = scenes
    o, d = rays(32, 32)
    tl = np.random.RandomState(3).uniform(2.0, 9.0, o.shape[0]).astype(np.float32)
    tj, ij = jm.mxu_tile_search(jnp.asarray(o), jnp.asarray(d), js.triangles, EPS,
                                t_limit=jnp.asarray(tl))
    tp, ip = pm.mxu_tile_search(torch.from_numpy(o), torch.from_numpy(d), ps.triangles,
                                float(EPS), t_limit=torch.from_numpy(tl))
    assert_search_agrees(tj, ij, tp, ip)


def test_occlusion_matches_jax(scenes):
    js, ps = scenes
    o, d = rays(32, 32)
    hit = closest_hit(jnp.asarray(o), jnp.asarray(d), js, EPS,
                      tri_search=jm.mxu_tile_search)
    hp = jnp.asarray(o) + jnp.asarray(d) * (jnp.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
    lv = jnp.asarray([0.0, 5.9, 2.0], jnp.float32) - hp
    dist = jnp.sqrt(jnp.maximum(jnp.sum(lv * lv, -1), 1e-12))
    sd = lv / dist[:, None]
    tl = jnp.where(hit.hit, dist - 1e-4, -1.0)
    occ_j = np.asarray(jm.mxu_tile_occlusion(hp, sd, tl, js.triangles, EPS))
    T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    occ_p = pm.mxu_tile_occlusion(T(hp), T(sd), T(tl), ps.triangles, float(EPS)).numpy()
    assert (occ_j == occ_p).mean() > 0.999
    assert 0.05 < occ_p.mean() < 0.95


def test_plain_tie_rule_lowest_sorted_index():
    """Two identical triangles in different blocks: the lower sorted index wins."""
    from esctp1raytracer_tpu_torch.core.intersect import ray_features, tri_features

    tri = torch.tensor([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]])
    v = torch.zeros(3 * 128, 3, 3)
    v[:, 2, 2] = 1e-3  # degenerate filler (det ~ 0 for these rays)
    v[200] = tri
    v[5] = tri
    tf = tri_features(v[:, 0], v[:, 1], v[:, 2])
    tfq = tf.reshape(3, 128, 16, 4).permute(0, 2, 3, 1).reshape(3, 16, 512).contiguous()
    o = torch.zeros(128, 3)
    o[:, 2] = 2.0
    d = torch.tensor([0.0, 0.0, -1.0]).expand(128, 3)
    rf = ray_features(o, d).reshape(1, 128, 16)
    ids = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    cnt = torch.tensor([3], dtype=torch.int32)
    t, idx = pm._sweep_search(torch.tensor([EPS]), ids, cnt, rf, tfq)
    assert (idx == 5).all() and torch.allclose(t, torch.full_like(t, 2.0))
    t, idx = pm._sweep_search(torch.tensor([EPS]), ids[:, [1, 2, 0]].contiguous(),
                              torch.tensor([2], dtype=torch.int32), rf, tfq)
    assert (idx == 200).all()  # block 0 not in the list


def _tables(js, exclude_oversized):
    (tfq, aabbs, _), = list(jm._segments(js.triangles, exclude_oversized)[0])
    return np.asarray(tfq), np.asarray(aabbs)


def _jax_cnt(o, d, aabbs, tl):
    _, _, cnt, _, _, _ = jm._prep_mxu(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabbs),
                                      None if tl is None else jnp.asarray(tl), 128, "argsort")
    return np.asarray(cnt).reshape(-1)


JEPS = jnp.asarray([EPS], jnp.float32)
def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("limit", [False, True], ids=["no-limit", "t-limit"])
def test_plain_search_matches_jax_kernel(scenes, limit):
    """K1's plain version (the wrapper on CPU tensors) against the JAX
    package's `_mxu_search` on the same table, with and without a t-limit
    cull; its cnt_out against the JAX `_prep_mxu`'s list lengths."""
    js, _ = scenes
    tfq, aabbs = _tables(js, False)
    o, d = rays(24, 21)  # 504 rays: the last group is padded
    tl = np.random.RandomState(5).uniform(2.0, 9.0, o.shape[0]).astype(np.float32) if limit \
        else None
    tj, ij = jm._mxu_search(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tfq), jnp.asarray(aabbs),
                            JEPS, None if tl is None else jnp.asarray(tl), interpret=True,
                            cull_mode="argsort")
    rays_p = pt._pad_rays(T(o), T(d), None if tl is None else T(tl))
    cnt = torch.full((rays_p.shape[0] // 128,), -1, dtype=torch.int32)
    tp, ip = pm.mxu_kernel(torch.tensor([EPS]), rays_p, T(aabbs), T(tfq), cnt_out=cnt)
    assert tp.shape == ip.shape == (rays_p.shape[0],)
    assert_search_agrees(tj, ij, tp[:o.shape[0]], ip[:o.shape[0]])
    assert np.array_equal(cnt.numpy(), _jax_cnt(o, d, aabbs, tl))


def _shadow_rays(js, light):
    o, d = rays(24, 21)
    hit = closest_hit(jnp.asarray(o), jnp.asarray(d), js, EPS, tri_search=jm.mxu_tile_search)
    hp = jnp.asarray(o) + jnp.asarray(d) * (jnp.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
    lv = jnp.asarray(light, jnp.float32) - hp
    dist = jnp.sqrt(jnp.maximum(jnp.sum(lv * lv, -1), 1e-12))
    return (np.asarray(hp), np.asarray(lv / dist[:, None]),
            np.asarray(jnp.where(hit.hit, dist - 1e-4, -1.0)))


def test_plain_occl_matches_jax_kernel(scenes):
    """K2's plain version against the JAX package's `_mxu_occl` on the
    occlusion table (oversized triangles excluded), its cnt_out against the
    JAX `_prep_mxu`'s; with the oversized sub-block folded in, it equals
    the segment sweep ORed with `_oversized_occl` exactly, and the JAX
    package's segment sweep ORed with its own `_oversized_occl`. The light
    sits above the area light, so the oversized triangles occlude."""
    js, ps = scenes
    tfq, aabbs = _tables(js, True)
    o, d, tl = _shadow_rays(js, [0.3, 8.0, 2.2])
    r = o.shape[0]
    occ_j = np.asarray(jm._mxu_occl(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl),
                                    jnp.asarray(tfq), jnp.asarray(aabbs), JEPS,
                                    interpret=True, cull_mode="argsort"))
    rays_p = pt._pad_rays(T(o), T(d), T(tl))
    cnt = torch.full((rays_p.shape[0] // 128,), -1, dtype=torch.int32)
    occ_p = pm.mxu_occl_kernel(torch.tensor([EPS]), rays_p, T(aabbs), T(tfq), cnt_out=cnt)
    assert occ_p.shape == (rays_p.shape[0],) and occ_p.dtype == torch.int32
    occ_p = occ_p[:r] > 0
    assert (occ_j == occ_p.numpy()).mean() > 0.999
    assert np.array_equal(cnt.numpy(), _jax_cnt(o, d, aabbs, tl))

    _, ov_buf, _ = pm._segments(ps.triangles, exclude_oversized=True)
    ov, _ = pt._pack_sub(ov_buf)
    folded = pm.mxu_occl_kernel(torch.tensor([EPS]), rays_p, T(aabbs), T(tfq), ov)[:r] > 0
    over = pt._oversized_occl(T(o), T(d), T(tl), ov_buf, float(EPS))
    assert torch.equal(folded, occ_p | over)
    assert bool((over & ~occ_p).any()) and 0.05 < folded.float().mean().item() < 0.95
    _, ov_j, _ = jm._segments(js.triangles, exclude_oversized=True)
    ref = occ_j | np.asarray(jt._oversized_occl(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl),
                                                ov_j, JEPS))
    assert (ref == folded.numpy()).mean() > 0.999


# Feature rows that can meet a non-zero coefficient, per quantity (det, t*det,
# u*det, v*det): the 25 row segments csrc/rt_mxu.cu stages and contracts.
NONZERO = {0: (0, 1, 2), 1: (3, 4, 5, 15), 2: (0, 1, 2, 7, 8, 9, 11, 12, 13),
           3: (0, 1, 2, 7, 8, 9, 11, 12, 13)}


def test_tri_features_structural_zeros():
    """The 39 coefficients that the CUDA kernels skip are exactly 0.0 on
    random triangles and on dropped ones (in the packed table), and the 25
    they contract are not (for random triangles)."""
    from esctp1raytracer_tpu_torch.core.intersect import tri_features
    from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer

    v = torch.from_numpy(np.random.RandomState(7).normal(0.0, 3.0, (256, 3, 3)).astype(np.float32))
    keep = torch.zeros((16, 4), dtype=torch.bool)
    for q, rows in NONZERO.items():
        keep[list(rows), q] = True
    assert int(keep.sum()) == 25
    tf = tri_features(v[:, 0], v[:, 1], v[:, 2])  # [N, 16, 4]
    assert bool((tf[:, ~keep] == 0.0).all()) and bool((tf[:, keep] != 0.0).all())
    valid = torch.arange(256) % 3 != 0
    tris = TriangleBuffer.empty(256, device="cpu").map(
        lambda name, a: {"v0": v[:, 0], "v1": v[:, 1], "v2": v[:, 2], "valid": valid}.get(name, a))
    tfq, _ = pm._pack_mxu(tris)  # [2, 16, 512]: column q * 128 + triangle in the block
    cols = tfq.reshape(2, 16, 4, 128).permute(0, 3, 1, 2).reshape(256, 16, 4)
    assert bool((cols[:, ~keep] == 0.0).all()) and bool((cols[~valid] == 0.0).all())
    assert bool((cols[valid][:, keep] != 0.0).all())
