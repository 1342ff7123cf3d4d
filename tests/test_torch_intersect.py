"""Port vs JAX package: core/intersect.py on the `jnp` and `mxu` backends.

Tolerances (the bars of tests/test_rt_mxu.py): winner agreement > 99.9%
(the two packages sum the feature contraction in different orders, so a
winner may flip on an exact near-tie), relative t error < 1e-5 where the
winners agree, occlusion agreement > 99.9%. Elementwise intersection
formulas: 1e-5 relative on hits, identical acceptance masks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core import intersect as ji  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.scene.types import Material  # noqa: E402
from esctp1raytracer_tpu_torch.core import intersect as pi  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

EPS = np.float32(np.finfo(np.float32).eps)
CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


@pytest.fixture(scope="module")
def scenes():
    spheres = jb.make_spheres(
        [(0.0, 0.6, 1.5), (2.6, 0.4, 1.0)], [0.6, 0.4],
        [Material.make(kd=(0.2, 0.6, 0.2), ks=(0.5, 0.5, 0.5), ns=64.0),
         Material.make(kd=(0.6, 0.2, 0.2), ns=8.0)])
    js = jb.scene_from_mesh([
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
        jb._ground_plane(),
        jb._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ], spheres=spheres)
    return js, to_port(js)


def rays(w, h):
    o, d = CAM.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def test_elementwise_formulas():
    rs = np.random.RandomState(0)
    o = rs.randn(500, 3).astype(np.float32)
    d = rs.randn(500, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0, v1, v2 = (rs.randn(500, 3).astype(np.float32) for _ in range(3))
    c, r = rs.randn(500, 3).astype(np.float32), rs.uniform(0.2, 2.0, 500).astype(np.float32)
    T = torch.from_numpy

    tj, uj, vj, okj = ji.mt_intersect(o, d, v0, v1, v2, EPS)
    tp, up, vp, okp = pi.mt_intersect(T(o), T(d), T(v0), T(v1), T(v2), float(EPS))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    assert okp.sum() > 20
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-5)

    tj, okj = ji.sphere_intersect(o, d, c, r, EPS)
    tp, okp = pi.sphere_intersect(T(o), T(d), T(c), T(r), float(EPS))
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-5)

    rf_j = ji.ray_features(o, d)
    tf_j = ji.tri_features(v0[:64], v1[:64], v2[:64])
    rf_p, tf_p = pi.ray_features(T(o), T(d)), pi.tri_features(T(v0[:64]), T(v1[:64]), T(v2[:64]))
    np.testing.assert_array_equal(rf_p.numpy(), np.asarray(rf_j))
    np.testing.assert_allclose(tf_p.numpy(), np.asarray(tf_j), rtol=1e-6, atol=1e-6)
    tj, _, _, okj = ji.hits_from_features(rf_j, tf_j, EPS)
    tp, _, _, okp = pi.hits_from_features(rf_p, tf_p, float(EPS))
    agree = okp.numpy() == np.asarray(okj)
    assert agree.mean() > 0.999
    both = agree & np.asarray(okj)
    np.testing.assert_allclose(tp.numpy()[both], np.asarray(tj)[both], rtol=1e-5)


@pytest.mark.parametrize("use_mxu", [False, True], ids=["jnp", "mxu"])
def test_closest_hit_matches(scenes, use_mxu):
    js, ps = scenes
    o, d = rays(40, 40)
    hj = ji.closest_hit(jnp.asarray(o), jnp.asarray(d), js, EPS, use_mxu=use_mxu)
    hp = pi.closest_hit(torch.from_numpy(o), torch.from_numpy(d), ps, float(EPS),
                        use_mxu=use_mxu)
    pj, pp = np.asarray(hj.prim), hp.prim.numpy()
    same = (pj == pp) & (np.asarray(hj.is_sphere) == hp.is_sphere.numpy())
    assert same.mean() > 0.999, f"winner mismatch {1 - same.mean():.4f}"
    assert hp.is_sphere.any() and (~hp.is_sphere & hp.hit).any()
    tj, tp = np.asarray(hj.t), hp.t.numpy()
    rel = np.abs(tj[same] - tp[same]) / np.maximum(np.abs(tj[same]), 1.0)
    assert rel.max() < 1e-5
    np.testing.assert_allclose(hp.u.numpy()[same], np.asarray(hj.u)[same], atol=1e-5)
    np.testing.assert_allclose(hp.v.numpy()[same], np.asarray(hj.v)[same], atol=1e-5)


@pytest.mark.parametrize("use_mxu", [False, True], ids=["jnp", "mxu"])
def test_any_hit_matches(scenes, use_mxu):
    js, ps = scenes
    o, d = rays(32, 32)
    hit = ji.closest_hit(jnp.asarray(o), jnp.asarray(d), js, EPS)
    hp = np.array(jnp.asarray(o) + jnp.asarray(d) * (jnp.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4))
    lv = np.asarray([0.0, 5.9, 2.0], np.float32) - hp
    dist = np.sqrt(np.maximum((lv * lv).sum(-1), 1e-12)).astype(np.float32)
    sd = (lv / dist[:, None]).astype(np.float32)
    tl = np.where(np.asarray(hit.hit), dist - 1e-4, -1.0).astype(np.float32)
    occ_j = np.asarray(ji.any_hit(jnp.asarray(hp), jnp.asarray(sd), jnp.asarray(tl), js, EPS,
                                  use_mxu=use_mxu))
    occ_p = pi.any_hit(torch.from_numpy(hp), torch.from_numpy(sd), torch.from_numpy(tl), ps,
                       float(EPS), use_mxu=use_mxu).numpy()
    assert (occ_j == occ_p).mean() > 0.999
    assert 0 < occ_p.mean() < 1


def test_select_rows_and_packed_table(scenes):
    js, ps = scenes
    np.testing.assert_array_equal(pi.packed_tri_table(ps.triangles).numpy(),
                                  np.asarray(ji.packed_tri_table(js.triangles)))
    table = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([0, 5, 3, 3, 1])
    np.testing.assert_array_equal(pi.select_rows(table, idx).numpy(), table[idx].numpy())
    np.testing.assert_array_equal(pi.select_rows(table, idx, limit=2).numpy(), table[idx].numpy())


@pytest.mark.parametrize("name", ["EPS", "T_MAX", "BIG", "NO_HIT", "aabb.BIG"])
def test_constants_match_jax(name):
    """The module constants, by name, equal the JAX package's as float32."""
    from esctp1raytracer_tpu.accel import aabb as ja
    from esctp1raytracer_tpu_torch.accel import aabb as pa

    j, p = (ja.BIG, pa.BIG) if name == "aabb.BIG" else (getattr(ji, name), getattr(pi, name))
    assert np.float32(p) == np.float32(np.asarray(j))
