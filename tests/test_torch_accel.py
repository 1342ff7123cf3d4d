"""Port vs JAX package: clustering, oversized segregation, mxtile packing
and the cull pre-pass.

Tolerances: `perm`, `oversized`, `exclude`, `ids` and `cnt` exact (they
decide which triangles each ray group tests); the packed float tables
(`tfq`, `aabbs`, the oversized sweep's t) to 1e-6 relative, since XLA may
contract a*b + c into one FMA where PyTorch rounds twice.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.accel.clusters import build_clusters as j_build_clusters  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.kernels import rt_mxu as jm  # noqa: E402
from esctp1raytracer_tpu.kernels import rt_tile as jt  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu_torch.accel.clusters import build_clusters, morton_codes  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import rt_mxu as pm  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import rt_tile as pt  # noqa: E402
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
    o, d = np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)
    return o, d


def test_morton_codes_match():
    from esctp1raytracer_tpu.accel.clusters import morton_codes as j_morton

    pts = np.random.RandomState(0).randn(3000, 3).astype(np.float32) * 5
    np.testing.assert_array_equal(np.asarray(j_morton(jnp.asarray(pts))).astype(np.int64),
                                  morton_codes(torch.from_numpy(pts)).numpy())


def test_build_clusters_match(scenes):
    js, ps = scenes
    cj, cp = j_build_clusters(js.triangles), build_clusters(ps.triangles)
    np.testing.assert_array_equal(cp.perm.numpy(), np.asarray(cj.perm))
    np.testing.assert_array_equal(cp.oversized.numpy(), np.asarray(cj.oversized))
    assert int(cp.oversized.sum()) == 4  # ground + light quads
    np.testing.assert_array_equal(cp.cluster_min.numpy(), np.asarray(cj.cluster_min))
    np.testing.assert_array_equal(cp.cluster_max.numpy(), np.asarray(cj.cluster_max))


def test_clustered_tables_match(scenes):
    js, ps = scenes
    outs_j = jt._clustered_tables(js.triangles)
    outs_p = pt._clustered_tables(ps.triangles)
    np.testing.assert_array_equal(outs_p[1].numpy(), np.asarray(outs_j[1]))  # perm
    np.testing.assert_array_equal(outs_p[2].numpy(), np.asarray(outs_j[2]))  # exclude
    np.testing.assert_array_equal(outs_p[3].valid.numpy(), np.asarray(outs_j[3].valid))
    np.testing.assert_array_equal(outs_p[3].v0.numpy(), np.asarray(outs_j[3].v0))
    np.testing.assert_array_equal(outs_p[4].numpy(), np.asarray(outs_j[4]))  # ov_orig


@pytest.mark.parametrize("exclude_oversized", [False, True])
def test_pack_and_prep_match(scenes, exclude_oversized):
    js, ps = scenes
    (tfq_j, ab_j, perm_j), = list(jm._segments(js.triangles, exclude_oversized)[0])
    (tfq_p, ab_p, perm_p), = list(pm._segments(ps.triangles, exclude_oversized)[0])
    np.testing.assert_array_equal(perm_p.numpy(), np.asarray(perm_j))
    np.testing.assert_allclose(tfq_p.numpy(), np.asarray(tfq_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ab_p.numpy(), np.asarray(ab_j), rtol=1e-6)

    o, d = rays(40, 30)  # 1200 rays: not a multiple of 128 (padding path)
    tl = np.random.RandomState(1).uniform(-1.0, 8.0, o.shape[0]).astype(np.float32)
    rf_j, ids_j, cnt_j, tl_j, rp_j, _ = jm._prep_mxu(
        jnp.asarray(o), jnp.asarray(d), ab_j, jnp.asarray(tl), 128, "argsort")
    rf_p, ids_p, cnt_p, tl_p, rp_p, _ = pm._prep_mxu(
        torch.from_numpy(o), torch.from_numpy(d), ab_p, torch.from_numpy(tl), 128)
    assert rp_p == rp_j == 1280
    np.testing.assert_array_equal(cnt_p.numpy(), np.asarray(cnt_j).reshape(-1))
    ids_j = np.asarray(ids_j).reshape(cnt_p.shape[0], -1)
    np.testing.assert_array_equal(ids_p.numpy(), ids_j)
    np.testing.assert_array_equal(rf_p.numpy(), np.asarray(rf_j))
    np.testing.assert_array_equal(tl_p.numpy(), np.asarray(tl_j).reshape(tl_p.shape))


def test_oversized_occlusion_match(scenes):
    js, ps = scenes
    ov_j, ov_p = jt._clustered_tables(js.triangles)[3], pt._clustered_tables(ps.triangles)[3]
    o, d = rays(32, 32)
    o = o + np.asarray([0.0, 0.5, 0.0], np.float32)
    d = -d  # some rays now point at the ground and the light from below
    tl = np.full(o.shape[0], 50.0, np.float32)
    t_j, ok_j = jt._oversized_hits(jnp.asarray(o), jnp.asarray(d), ov_j, EPS)
    t_p, ok_p = pt._oversized_hits(torch.from_numpy(o), torch.from_numpy(d), ov_p, EPS)
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))
    ok = np.asarray(ok_j)
    np.testing.assert_allclose(t_p.numpy()[ok], np.asarray(t_j)[ok], rtol=1e-6)
    occ_j = jt._oversized_occl(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl), ov_j, EPS)
    occ_p = pt._oversized_occl(torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(tl), ov_p, EPS)
    np.testing.assert_array_equal(occ_p.numpy(), np.asarray(occ_j))
    assert occ_p.any()
