"""Port vs JAX package: the mxtile search and occlusion (kernels/rt_mxu.py).

The JAX functions run their Pallas kernels in interpret mode on the CPU;
the port's wrappers, given CPU tensors, run their plain PyTorch versions.
Bars (tests/test_rt_mxu.py): winner agreement > 99.9% and relative t
error < 1e-5 where winners agree (the feature contraction is summed in
another order, so winners may flip on exact near-ties); occlusion
agreement > 99.9%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import esctp1raytracer_tpu.kernels.rt_mxu as jm  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.core.intersect import closest_hit  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_mxu as pm  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

EPS = np.float32(np.finfo(np.float32).eps)
CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]})


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
    t, idx = pm._mxu_search_plain(torch.tensor([EPS]), ids, cnt, rf, tfq)
    assert (idx == 5).all() and torch.allclose(t, torch.full_like(t, 2.0))
    t, idx = pm._mxu_search_plain(torch.tensor([EPS]), ids[:, [1, 2, 0]].contiguous(),
                                  torch.tensor([2], dtype=torch.int32), rf, tfq)
    assert (idx == 200).all()  # block 0 not in the list
