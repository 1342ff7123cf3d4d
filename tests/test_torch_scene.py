"""Port vs JAX package: scene builders, scene round trip, RNG, camera.

Tolerances:
* scene tables: exact, leaf by leaf (same numpy builders);
* RNG draws: bit-exact (integer hash);
* camera: origins exact; directions and basis vectors within 2^-22
  absolute (unit-scale vectors, so about 2 ulp). XLA on the CPU contracts
  a*b + c into one FMA in `get_ray` and `cross`; PyTorch rounds the
  product first. The tan is taken as numpy's float32 tan, which matches.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core.camera import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.utils import rng as jrng  # noqa: E402
from esctp1raytracer_tpu_torch.core.camera import Camera as PCamera  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as pb  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import (  # noqa: E402
    DEFAULT_PAD_MULTIPLE, TriangleBuffer, pad_to, scene_from_numpy, scene_to_numpy,
)
from esctp1raytracer_tpu_torch.utils import rng as prng  # noqa: E402


def jax_leaves(scene):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


def assert_same_tables(a, b):
    assert list(a) == list(b)  # same names, same (leaf) order
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _meshes(b):
    return [
        b.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        b.icosphere_mesh(subdivisions=1, radius=0.5, center=(1.3, 1.0, 0.0), smooth=False),
        b._ground_plane(y=-0.5, half=20.0),
        b._area_light(center=(0.0, 6.0, 2.0), half=1.5),
        b._area_light(center=(3.0, 4.0, 0.0), half=0.5, ke=(1.0, 2.0, 3.0)),
    ]


def _spheres(b, types):
    mats = [types.Material.make(ka=(0.1, 0.2, 0.3), kd=(0.4, 0.5, 0.6), ks=(0.3, 0.3, 0.3), ns=32.0),
            types.Material.make(ke=(1.0, 0.0, 0.0), ns=8.0)]
    return b.make_spheres([(0.0, 1.0, 0.0), (2.0, 0.5, -1.0)], [1.0, 0.5], mats)


class TestScene:
    def test_builders_match_jax(self):
        from esctp1raytracer_tpu.scene import types as jt
        from esctp1raytracer_tpu_torch.scene import types as pt

        js = jb.scene_from_mesh(_meshes(jb), spheres=_spheres(jb, jt), pad_multiple=256)
        ps = pb.scene_from_mesh(_meshes(pb), spheres=_spheres(pb, pt), pad_multiple=256)
        assert_same_tables(jax_leaves(js), scene_to_numpy(ps))
        assert ps.num_triangles == js.num_triangles and ps.num_lights == 2

    def test_bench_scene_matches_jax(self):
        js = jb.scene_from_mesh([
            jb.icosphere_mesh(subdivisions=4, radius=1.0, center=(-1.3, 1.0, 0.0)),
            jb.icosphere_mesh(subdivisions=4, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
            jb._ground_plane(),
            jb._area_light(center=(0.0, 6.0, 2.0), half=1.5),
        ])
        ps = pb.bench_scene()
        assert ps.num_triangles == 10_752
        assert int(ps.triangles.valid.sum()) == 10_244
        assert_same_tables(jax_leaves(js), scene_to_numpy(ps))

    def test_numpy_round_trip(self):
        js = jb.scene_from_mesh(_meshes(jb))
        d = jax_leaves(js)
        ps = scene_from_numpy(d)
        assert_same_tables(d, scene_to_numpy(ps))
        assert ps.triangles.valid.dtype == torch.bool
        assert ps.lights.tri_idx.dtype == torch.int32

    def test_empty_and_padding(self):
        assert DEFAULT_PAD_MULTIPLE == 512
        assert [pad_to(n) for n in (0, 1, 512, 513)] == [512, 512, 512, 1024]
        e = TriangleBuffer.empty(128)
        assert e.capacity == 128 and not bool(e.valid.any())
        assert int(e.geom_id.min()) == -1


class TestRng:
    @pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
    def test_draws_bit_exact(self, seed):
        ids = np.arange(0, 4000 * 997, 997, dtype=np.uint32)  # spans the 32-bit range
        streams = np.asarray([0, 1, 2, 4, 4097, 2**32 - 1], np.uint32)
        rid_j, st_j = jnp.asarray(ids)[:, None], jnp.asarray(streams)
        rid_p = torch.from_numpy(ids.astype(np.int64))[:, None]
        st_p = torch.from_numpy(streams.astype(np.int64))
        np.testing.assert_array_equal(
            np.asarray(jrng.hash_u32(seed, rid_j, st_j)).astype(np.int64),
            prng.hash_u32(seed, rid_p, st_p).numpy())
        np.testing.assert_array_equal(np.asarray(jrng.uniform01(seed, rid_j, st_j)),
                                      prng.uniform01(seed, rid_p, st_p).numpy())
        maxval = np.asarray([1, 2, 3, 7, 100, 5], np.int32)
        np.testing.assert_array_equal(
            np.asarray(jrng.randint(seed, rid_j, st_j, jnp.asarray(maxval)[None])),
            prng.randint(seed, rid_p, st_p, torch.from_numpy(maxval)[None]).numpy())


CAMERAS = [
    ((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), 60.0, 1920 / 1080),
    ((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), 60.0, 4 / 3),
    ((2.0, 2.0, 2.0), (0.0, 0.0, 0.0), 30.0, 0.75),
    ((1.0, 3.0, -4.0), (0.0, 0.5, 0.0), 40.0, 1.5),
]


@pytest.mark.parametrize("lookfrom,lookat,vfov,aspect", CAMERAS)
def test_camera_ray_grid(lookfrom, lookat, vfov, aspect):
    jc = JCamera.look_at(lookfrom, lookat, vfov=vfov, aspect=aspect)
    pc = PCamera.look_at(lookfrom, lookat, vfov=vfov, aspect=aspect)
    for f in ("origin", "lower_left_corner", "horizontal", "vertical"):
        np.testing.assert_allclose(getattr(pc, f).numpy(), np.asarray(getattr(jc, f)),
                                   rtol=2**-22, atol=2**-22, err_msg=f)
    jo, jd = jc.ray_grid(48, 36)
    po, pd = pc.ray_grid(48, 36)
    assert pd.shape == (36, 48, 3)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=2**-22)
