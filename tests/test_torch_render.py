"""Port vs JAX package: the whole slice (render, gradients) and routing.

Bars:
* image (tests/test_rt_mxu.py): mean |diff| < 1e-4 and < 0.5% of pixel
  channels off by more than 1e-2 (a near-tie winner flip changes a pixel);
* gradients of sum(color^2) w.r.t. every float scene leaf: first the
  winners must agree on every ray (checked through the images being
  equal to 1e-5); then per leaf |g_port - g_jax| <= 1e-3 * max|g_jax| +
  1e-6. The two packages reduce in other orders (the winner-row
  scatter-add over up to 768 rays, the per-ray sums in shading), each
  step off by ~1e-7 relative; the pow(spec, ns) term multiplies such
  differences by ns <= 32. 1e-3 of the leaf's scale leaves a wide margin
  over that, and is far below any real fault (a wrong term moves
  gradients by O(1) of their scale).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import render as j_render  # noqa: E402
from esctp1raytracer_tpu.core.render import resolve_backend as j_resolve_backend  # noqa: E402
from esctp1raytracer_tpu.core.render import trace_rays as j_trace_rays  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.scene.types import Material  # noqa: E402
from esctp1raytracer_tpu_torch.core import render as pr  # noqa: E402
from esctp1raytracer_tpu_torch.core.camera import Camera as PCamera  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

VIEW = dict(lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0), vfov=60.0)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def meshes():
    return [
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        jb.icosphere_mesh(subdivisions=2, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
        jb._ground_plane(),
        jb._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ]


@pytest.fixture(scope="module")
def scenes():
    js = jb.scene_from_mesh(meshes())  # 644 triangles, capacity 1024
    return js, to_port(js)


def cameras(w, h):
    return (JCamera.look_at(VIEW["lookfrom"], VIEW["lookat"], vfov=VIEW["vfov"], aspect=w / h),
            PCamera.look_at(VIEW["lookfrom"], VIEW["lookat"], vfov=VIEW["vfov"], aspect=w / h,
                            device="cpu"))


def assert_images_agree(a, b):
    diff = np.abs(a - b)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-2).mean() < 5e-3


def test_render_mxtile_matches_jax(scenes):
    js, ps = scenes
    jc, pc = cameras(40, 30)
    cfg = dict(backend="mxtile")
    a = np.asarray(j_render(js, jc, 40, 30, JRenderConfig(**cfg)))
    b = pr.render(ps, pc, 40, 30, pr.RenderConfig(**cfg)).numpy()
    assert b.shape == (30, 40, 3) and np.isfinite(b).all()
    assert b.max() > 0.1
    assert_images_agree(a, b)


def test_render_depth2_spheres_mxu_matches_jax():
    from esctp1raytracer_tpu_torch.core.render import RenderConfig

    spheres = jb.make_spheres(
        [(0.0, 0.6, 1.5)], [0.6], [Material.make(kd=(0.2, 0.6, 0.2), ks=(0.5, 0.5, 0.5), ns=64.0)])
    js = jb.scene_from_mesh(meshes(), spheres=spheres)
    ps = to_port(js)
    jc, pc = cameras(32, 24)
    a = np.asarray(j_render(js, jc, 32, 24, JRenderConfig(backend="mxu", depth=2,
                                                             ray_chunk=300)))
    b = pr.render(ps, pc, 32, 24, RenderConfig(backend="mxu", depth=2, ray_chunk=300)).numpy()
    assert_images_agree(a, b)


def _check_gradients(js, ps, backend):
    """Image and per-leaf gradients of sum(color^2) on a 32x24 frame."""
    w, h = 32, 24
    jc, pc = cameras(w, h)
    o, d = jc.ray_grid(w, h)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    jcfg = JRenderConfig(backend=backend)

    def j_loss(params):
        color = j_trace_rays(o, d, j_merge_params(js, params), ids, jcfg)
        return jnp.sum(color * color), color

    (_, j_color), j_grads = jax.value_and_grad(j_loss, has_aux=True)(j_float_params(js))

    po, pd = pc.ray_grid(w, h)
    params = [p.clone().requires_grad_(True) for p in float_params(ps)]
    color = pr.trace_rays(po.reshape(-1, 3), pd.reshape(-1, 3), merge_params(ps, params),
                          torch.arange(w * h), pr.RenderConfig(backend=backend))
    (color * color).sum().backward()

    np.testing.assert_allclose(color.detach().numpy(), np.asarray(j_color), atol=1e-5)
    assert len(params) == len(j_grads) == 21
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    nonzero = 0
    for name, p, gj in zip(names, params, j_grads):
        gj = np.asarray(gj)
        gp = np.zeros_like(gj) if p.grad is None else p.grad.numpy()  # None: unused leaf
        assert gp.shape == gj.shape and np.isfinite(gp).all(), name
        tol = 1e-3 * np.abs(gj).max() + 1e-6
        assert np.abs(gp - gj).max() <= tol, (name, np.abs(gp - gj).max(), tol)
        nonzero += bool(np.abs(gj).max() > 0)
    assert nonzero >= 8  # geometry, normals and materials all receive gradient


def test_gradients_match_jax(scenes):
    _check_gradients(*scenes, "mxtile")


def test_tile_gradients_match_jax(scenes):
    """The tile route (K5/K6): the search runs under no_grad, the gradient
    flows through the winner gather and the recompute, as on mxtile."""
    _check_gradients(*scenes, "tile")


def _scene_pair(capacity, lights=True, spheres=0):
    ms = meshes() if lights else meshes()[:3]
    sph = None
    if spheres:
        sph = jb.make_spheres([(0.0, 0.0, 0.0)] * spheres, [0.5] * spheres,
                              [Material.make()] * spheres)
    js = jb.scene_from_mesh(ms, spheres=sph, pad_multiple=capacity)
    return js, to_port(js)


ROUTES = [
    # (capacity, lit, spheres, cfg overrides, expected backend)
    (1024, True, 0, dict(backend="auto"), "fused"),
    (2048, True, 0, dict(backend="auto", depth=4), "fused"),
    (1024, True, 0, dict(backend="auto", depth=5), "lane"),
    (1024, True, 0, dict(backend="auto", light_mode="reference_cpp"), "lane"),
    (1024, False, 0, dict(backend="auto"), "lane"),
    (1024, True, 40, dict(backend="auto"), "lane"),
    (2560, True, 0, dict(backend="pallas"), "lane"),
    (4096, True, 0, dict(backend="auto"), "mxtile"),
    (10_752, True, 0, dict(backend="auto"), "mxtile"),
    (32_768, True, 0, dict(backend="auto"), "mxtile"),
    (33_280, True, 0, dict(backend="auto"), "tile"),
    (10_752, True, 0, dict(backend="fused"), "tile"),
    (2048, True, 0, dict(backend="fused", depth=6), "lane"),
    (1024, True, 0, dict(backend="fused"), "fused"),
    (10_752, True, 0, dict(backend="jnp"), "jnp"),
    (10_752, True, 0, dict(backend="mxu"), "mxu"),
]


@pytest.mark.parametrize("capacity,lit,spheres,over,expected", ROUTES)
def test_resolve_backend_matches_jax(capacity, lit, spheres, over, expected):
    js, ps = _scene_pair(capacity, lit, spheres)
    assert ps.num_triangles == capacity
    assert j_resolve_backend(JRenderConfig(**over), js) == expected
    assert pr.resolve_backend(pr.RenderConfig(**over), ps) == expected


def _same_rays_frames(js, ps, w, h, over, eye=VIEW["lookfrom"]):
    """JAX and port traces of the same rays (JAX's camera, as numpy)."""
    cam = JCamera.look_at(eye, VIEW["lookat"], vfov=VIEW["vfov"], aspect=w / h)
    o, d = (np.array(x).reshape(-1, 3) for x in cam.ray_grid(w, h))
    ids = np.arange(o.shape[0])
    a = np.asarray(j_trace_rays(jnp.asarray(o), jnp.asarray(d), js,
                                jnp.asarray(ids, jnp.uint32), JRenderConfig(**over)))
    b = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), ps, torch.from_numpy(ids),
                      pr.RenderConfig(**over)).numpy()
    return a, b


@pytest.mark.parametrize("over,route", [
    (dict(backend="auto"), "fused"),           # lit, <= 2048 triangles, depth 1
    (dict(backend="fused"), "fused"),
    (dict(backend="lane"), "lane"),
    (dict(backend="auto", depth=5), "lane"),  # past the fused depth limit
    (dict(backend="mxtile", light_mode="reference_cpp"), "mxtile"),
    (dict(backend="tile"), "tile"),
])
def test_ported_routes_match_jax(scenes, over, route):
    """The routes that raised before K3-K6 and reference_cpp sampling were
    ported now render, and agree with JAX (tests/test_fused.py's bars)."""
    js, ps = scenes
    assert pr.resolve_backend(pr.RenderConfig(**over), ps) == route
    a, b = _same_rays_frames(js, ps, 16, 12, over)
    assert np.isfinite(b).all() and b.max() > 0.1
    diff = np.abs(a - b).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= 2e-3 and np.abs(a - b)[~flipped].max() <= 3e-5


@pytest.mark.parametrize("capacity,over", [
    (10_752, dict(backend="fused")),  # over 4096 triangles: the gate's fallback
    (33_280, dict(backend="auto")),   # over MXU_TRI_LIMIT
])
def test_tile_routes_match_jax(capacity, over):
    """The normal entry points that resolve to tile render and agree with
    JAX (tests/test_fused.py's bars), on a 300-ray frame."""
    js, ps = _scene_pair(capacity)
    assert pr.resolve_backend(pr.RenderConfig(**over), ps) == "tile"
    a, b = _same_rays_frames(js, ps, 20, 15, over)
    assert np.isfinite(b).all() and b.max() > 0.1
    diff = np.abs(a - b).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= 2e-3 and np.abs(a - b)[~flipped].max() <= 3e-5


@pytest.mark.parametrize("backend", ["jnp", "lane"])
def test_reference_cpp_sampling_matches_jax(backend):
    """light_mode="reference_cpp" (the C++ path's corner sampling, quirk 2)
    on the Cornell box: the image of the reference's golden renders."""
    js = jb.cornell_box()
    ps = to_port(js)
    over = dict(backend=backend, light_mode="reference_cpp")
    a, b = _same_rays_frames(js, ps, 20, 15, over, eye=(0.0, 1.0, 2.0))
    assert_images_agree(a, b)
    area, _ = _same_rays_frames(js, ps, 20, 15, dict(backend=backend), eye=(0.0, 1.0, 2.0))
    assert np.abs(area - b).max() > 1e-2  # corner samples, not area samples
