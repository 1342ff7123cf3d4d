"""Port vs JAX package: scenes with several light sources.

The port's counterpart of tests/test_multilight.py, on the same two-light
scene (a floor and two 1e-4 quads at (+-2, 5, 0)) and on light tables
with unequal face counts (2 and 4: tri_idx padded with repeats of face 0)
and with more faces than the select chain takes (L*F > 16: the gather).

Bars:
* light draws: bit-equal (the counter RNG and the same float operations);
* the shaded floor point: the reference's per-light sum at atol 2e-3
  (tests/test_multilight.py), JAX's `shade` at 1e-6;
* one occluded light: the open - blocked delta at the centre pixel, the
  formula at 0.02 (tests/test_multilight.py), JAX's delta at 1e-5;
* gradients of sum(color^2): per leaf |g_port - g_jax| <= 1e-3 *
  max|g_jax| + 1e-6 (tests/test_torch_render.py);
* images of every route against JAX on the same rays: mean |diff| < 1e-4
  and < 0.5% of channels over 1e-2 (tests/test_rt_mxu.py); the fused
  route against the port's own lane route: <= 0.2% of pixels flipped by
  > 1e-2, atol 3e-5 elsewhere (tests/test_multilight.py:160-176).

The JAX side runs its jnp route (jitted): its lane, tile and fused routes
run Pallas in interpret mode here, tens of seconds per frame.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core import intersect as ji  # noqa: E402
from esctp1raytracer_tpu.core import shading as jsh  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import resolve_backend as j_resolve_backend  # noqa: E402
from esctp1raytracer_tpu.core.render import trace_rays as j_trace_rays  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.scene.types import Material, MeshData  # noqa: E402
from esctp1raytracer_tpu_torch.core import intersect as pi  # noqa: E402
from esctp1raytracer_tpu_torch.core import render as pr  # noqa: E402
from esctp1raytracer_tpu_torch.core import shading as psh  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from test_multilight import _floor, _quad  # noqa: E402
from test_torch_render import assert_images_agree, to_port  # noqa: E402

LIGHT = Material.make(ke=(4, 4, 4))
FLOOR = Material.make(kd=(1.0, 0.5, 0.25), ka=(0.2, 0.2, 0.2))
j_trace = jax.jit(j_trace_rays, static_argnames=("cfg",))


def _strip(cx, cy, cz, quads, half, mat):
    """`quads` two-triangle quads side by side along x, facing down: a light
    of 2 * quads faces."""
    tris = [_quad(cx + 2 * half * (k - (quads - 1) / 2), cy, cz, half, mat).vertices
            for k in range(quads)]
    return MeshData(name="strip", vertices=np.concatenate(tris), normals=None, uv=None,
                    material=mat)


# Light tables: (the two lights' meshes, which sample_lights branch they take).
TABLES = {
    "two_2face": ([_quad(-2.0, 5.0, 0.0, 1e-4, LIGHT), _quad(2.0, 5.0, 0.0, 1e-4, LIGHT)],
                  "select"),  # L*F = 4
    "2face_4face": ([_quad(-2.0, 5.0, 0.0, 0.5, LIGHT), _strip(2.0, 5.0, 0.0, 2, 0.25, LIGHT)],
                    "select"),  # L*F = 8, tri_idx of the first light padded
    "two_10face": ([_strip(-2.0, 5.0, 0.0, 5, 0.1, LIGHT), _strip(2.0, 5.0, 0.5, 6, 0.1, LIGHT)],
                   "gather"),  # 10 and 12 faces: L*F = 24 > 16
}


def table_scene(name, floor=FLOOR):
    js = jb.scene_from_mesh([_floor(floor)] + TABLES[name][0])
    return js, to_port(js)


@pytest.fixture(scope="module")
def two_light():
    return table_scene("two_2face")


@pytest.mark.parametrize("table", list(TABLES))
def test_light_tables(table):
    """The tables take the sample_lights branch they are named for."""
    js, ps = table_scene(table)
    lights = ps.lights
    assert lights.num_lights == 2
    assert (lights.num_lights * lights.max_faces <= 16) == (TABLES[table][1] == "select")
    np.testing.assert_array_equal(lights.face_count.numpy(), np.asarray(js.lights.face_count))
    if table == "2face_4face":
        assert lights.face_count.tolist() == [2, 4]
        assert lights.tri_idx[0, 2:].tolist() == [lights.tri_idx[0, 0].item()] * 2


@pytest.mark.parametrize("mode", ["area", "reference_cpp"])
@pytest.mark.parametrize("table", list(TABLES))
def test_sample_lights_draws_match_jax(table, mode):
    """Two lights' draws (points and light triangles) bit-equal to JAX's, at
    bounce 0 and 2 and at two seeds, on both branches of the port's
    sample_lights."""
    js, ps = table_scene(table)
    ids = np.arange(513, dtype=np.uint32) * 7 + 3
    for seed in (3, 11):
        for bounce in (0, 2):
            pj, tj, lj = jsh.sample_lights(js, seed, jnp.asarray(ids), bounce, mode)
            pp, tp, lp = psh.sample_lights(ps, seed, torch.from_numpy(ids.astype(np.int64)),
                                           bounce, mode)
            assert lj == lp == 2
            np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
            np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
            # Every face of each light is drawn.
            counts = ps.lights.face_count.tolist()
            for li in range(2):
                assert len(np.unique(tp[:, li].numpy())) == counts[li]


@pytest.mark.parametrize("table", ["2face_4face", "two_10face"])
def test_sample_lights_gradients_match_jax(table):
    """The select chain's backward (masked reductions) and the gather's
    (index_add_) give JAX's gradients with respect to the vertices."""
    js, ps = table_scene(table)
    ids = np.arange(300, dtype=np.uint32)
    w = np.random.default_rng(0).standard_normal((300, 2, 3)).astype(np.float32)

    def j_loss(v):
        tris = dataclasses.replace(js.triangles, v0=v[0], v1=v[1], v2=v[2])
        p, _, _ = jsh.sample_lights(dataclasses.replace(js, triangles=tris), 5,
                                    jnp.asarray(ids), 1)
        return jnp.sum(p * w)

    t = js.triangles
    gj = np.asarray(jax.jit(jax.grad(j_loss))(jnp.stack([t.v0, t.v1, t.v2])))
    v = [getattr(ps.triangles, k).clone().requires_grad_(True) for k in ("v0", "v1", "v2")]
    tris = dataclasses.replace(ps.triangles, v0=v[0], v1=v[1], v2=v[2])
    p, _, _ = psh.sample_lights(dataclasses.replace(ps, triangles=tris), 5,
                                torch.from_numpy(ids.astype(np.int64)), 1)
    (p * torch.from_numpy(w)).sum().backward()
    gp = np.stack([x.grad.numpy() for x in v])
    assert np.abs(gj).max() > 1.0
    np.testing.assert_allclose(gp, gj, rtol=0, atol=1e-5 * np.abs(gj).max())


def _floor_hit(js, ps):
    """JAX's and the port's shade() at an unoccluded floor point under the two
    lights (tests/test_multilight.py's ray)."""
    o = np.asarray([[1.0, 3.0, -2.0]], np.float32)
    d = np.asarray([[0.0, -1.0, 0.0]], np.float32)
    ids = np.zeros((1,), np.uint32)

    @jax.jit
    def j_shade(jo, jd, js):
        hit = ji.closest_hit(jo, jd, js, jnp.float32(ji.EPS))

        def j_occl(oo, dd, tl):
            return ji.any_hit(oo, dd, tl, js, jnp.float32(ji.EPS))

        return jsh.shade(jo, jd, hit, js, 0, jnp.asarray(ids), j_occl)[:2]

    jc, jhp = j_shade(jnp.asarray(o), jnp.asarray(d), js)
    po, pd = torch.from_numpy(o), torch.from_numpy(d)
    phit = pi.closest_hit(po, pd, ps)
    assert bool(phit.hit[0])

    def p_occl(oo, dd, tl):
        return pi.any_hit(oo, dd, tl, ps)

    pc, php, pn, _ = psh.shade(po, pd, phit, ps, 0, torch.zeros(1, dtype=torch.int64), p_occl)
    return (np.asarray(jc)[0], np.asarray(jhp)[0]), (pc.numpy()[0], php.numpy()[0], pn.numpy()[0])


def test_shade_matches_reference_formula_and_jax(two_light):
    """The per-light sum (ka*0.5 + ke)/L + kd*max(d, 0)/L over both lights:
    the reference's formula evaluated in numpy, and JAX's shade."""
    (jc, jhp), (pc, php, n) = _floor_hit(*two_light)
    kd, ka = np.asarray([1.0, 0.5, 0.25]), np.asarray([0.2, 0.2, 0.2])
    expected = np.zeros(3)
    for lx in (-2.0, 2.0):
        ldir = np.asarray([lx, 5.0, 0.0]) - php
        dnl = float(n @ (ldir / np.linalg.norm(ldir)))
        assert dnl > 0
        expected += (ka * 0.5) / 2 + kd * dnl / 2  # ks = 0, the floor's ke = 0
    np.testing.assert_allclose(pc, expected, atol=2e-3)
    np.testing.assert_allclose(php, jhp, atol=1e-6)
    np.testing.assert_allclose(pc, jc, atol=1e-6)


def _centre_pixel(js, ps):
    cam = JCamera.look_at((0, 3, 0.01), (0, 0, 0), vfov=30.0, aspect=1.0)
    o, d = (np.array(x).reshape(-1, 3) for x in cam.ray_grid(8, 8))
    ids = np.arange(64)
    a = np.asarray(j_trace(jnp.asarray(o), jnp.asarray(d), js, jnp.asarray(ids, jnp.uint32),
                           JRenderConfig()))
    b = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), ps, torch.from_numpy(ids),
                      pr.RenderConfig()).numpy()
    return a.reshape(8, 8, 3)[4, 4], b.reshape(8, 8, 3)[4, 4]


def test_one_occluded_light_drops_its_term():
    """A blocker between the floor and light B removes exactly B's term
    (the reference `continue`s out of both): the formula, and JAX's delta."""
    blocker = _quad(2.0, 4.0, 0.0, 1.0, Material.make(kd=(0.1, 0.1, 0.1)))
    lights = TABLES["two_2face"][0]
    open_j, open_p = _centre_pixel(*table_scene("two_2face"))
    js = jb.scene_from_mesh([_floor(FLOOR)] + lights + [blocker])
    blk_j, blk_p = _centre_pixel(js, to_port(js))
    ldir = np.asarray([2.0, 5.0, 0.0]) / np.linalg.norm([2.0, 5.0, 0.0])
    kd = np.asarray([1.0, 0.5, 0.25])
    expected = (np.asarray([0.2, 0.2, 0.2]) * 0.5) / 2 + kd * ldir[1] / 2
    np.testing.assert_allclose(open_p - blk_p, expected, atol=0.02)
    np.testing.assert_allclose(open_p - blk_p, open_j - blk_j, atol=1e-5)


_J_GRADS = {}


@pytest.mark.parametrize("backend", ["jnp", "fused"])
@pytest.mark.parametrize("table", ["2face_4face", "two_10face"])
def test_gradients_with_two_lights_match_jax(table, backend):
    """The gradient of sum(color^2) with respect to every float leaf, on the
    select chain's and the gather's light tables; the port's fused route
    (K3's plain version forward, the lane route's re-derivation backward)
    against JAX's jnp route."""
    floor = Material.make(kd=(1.0, 0.5, 0.25), ka=(0.2, 0.2, 0.2), ks=(0.3, 0.3, 0.3), ns=8.0)
    js, ps = table_scene(table, floor)
    cam = JCamera.look_at((0, 3, 3), (0, 0, 0), vfov=45.0, aspect=1.0)
    o, d = (np.array(x).reshape(-1, 3) for x in cam.ray_grid(16, 16))
    ids = np.arange(256)
    if table not in _J_GRADS:
        def j_loss(params):
            color = j_trace_rays(jnp.asarray(o), jnp.asarray(d), j_merge_params(js, params),
                                 jnp.asarray(ids, jnp.uint32), JRenderConfig())
            return jnp.sum(color * color), color

        (_, color), grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
            j_float_params(js))
        _J_GRADS[table] = np.asarray(color), [np.asarray(g) for g in grads]
    j_color, j_grads = _J_GRADS[table]

    cfg = pr.RenderConfig(backend=backend)
    assert pr.resolve_backend(cfg, ps) == backend
    params = [p.clone().requires_grad_(True) for p in float_params(ps)]
    color = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), merge_params(ps, params),
                          torch.from_numpy(ids), cfg)
    (color * color).sum().backward()
    np.testing.assert_allclose(color.detach().numpy(), j_color, atol=1e-5)
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    assert len(params) == len(j_grads) == len(names)
    nonzero = 0
    for name, p, gj in zip(names, params, j_grads):
        gp = np.zeros_like(gj) if p.grad is None else p.grad.numpy()  # None: an unused leaf
        assert gp.shape == gj.shape and np.isfinite(gp).all(), name
        tol = 1e-3 * np.abs(gj).max() + 1e-6
        assert np.abs(gp - gj).max() <= tol, (name, np.abs(gp - gj).max(), tol)
        nonzero += bool(np.abs(gj).max() > 0)
    assert nonzero >= 6  # vertices, normals' absence aside, and materials


def route_scene():
    """The floor (specular), a specular icosphere, and two lights of 2 and 4
    faces: every route's reflections and both lights' shadows."""
    floor = Material.make(kd=(1.0, 0.5, 0.25), ka=(0.2, 0.2, 0.2), ks=(0.4, 0.4, 0.4), ns=16.0)
    ball = Material.make(kd=(0.2, 0.4, 0.8), ks=(0.6, 0.6, 0.6), ns=32.0)
    js = jb.scene_from_mesh([_floor(floor), jb.icosphere_mesh(1, 1.0, (0.0, 1.0, 0.0), ball)]
                            + TABLES["2face_4face"][0])
    return js, to_port(js)


@pytest.fixture(scope="module")
def routes():
    js, ps = route_scene()
    cam = JCamera.look_at((0, 3, 8), (0, 1, 0), vfov=40.0, aspect=4 / 3)
    o, d = (np.array(x).reshape(-1, 3) for x in cam.ray_grid(24, 18))
    return js, ps, o, d, {}


def _route_frames(routes, backend, depth, light_mode="area"):
    js, ps, o, d, cache = routes
    ids = np.arange(o.shape[0])
    key = (depth, light_mode)
    if key not in cache:  # JAX's jnp route, once per (depth, light mode)
        cache[key] = np.asarray(j_trace(jnp.asarray(o), jnp.asarray(d), js,
                                        jnp.asarray(ids, jnp.uint32),
                                        JRenderConfig(depth=depth, light_mode=light_mode)))
    cfg = pr.RenderConfig(backend=backend, depth=depth, light_mode=light_mode)
    b = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), ps, torch.from_numpy(ids),
                      cfg).numpy()
    return cache[key], b


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("backend", ["jnp", "lane", "mxtile", "tile", "fused"])
def test_routes_match_jax_with_two_lights(routes, backend, depth):
    """Every route at L = 2 (faces 2 and 4), depth 1 and 3, against JAX on
    the same rays; the fused route also against the port's lane route."""
    js, ps = routes[:2]
    cfg = pr.RenderConfig(backend=backend, depth=depth)
    assert pr.resolve_backend(cfg, ps) == j_resolve_backend(JRenderConfig(backend=backend,
                                                                          depth=depth), js)
    assert pr.resolve_backend(cfg, ps) == backend
    a, b = _route_frames(routes, backend, depth)
    assert np.isfinite(b).all() and b.max() > 0.1
    assert_images_agree(a, b)
    if backend == "fused":
        _, lane = _route_frames(routes, "lane", depth)
        diff = np.abs(lane - b).max(-1)
        flipped = diff > 1e-2
        assert flipped.mean() <= 2e-3
        assert np.abs(lane[~flipped] - b[~flipped]).max() <= 3e-5


def test_reference_cpp_two_lights_matches_jax(routes):
    """light_mode="reference_cpp" with two lights (the 4-face light's drawn
    face id indexes its corners) on the lane route."""
    a, b = _route_frames(routes, "lane", 1, "reference_cpp")
    assert np.isfinite(b).all() and b.max() > 0.1
    assert_images_agree(a, b)
    area, _ = _route_frames(routes, "lane", 1)
    assert np.abs(area - b).max() > 1e-2  # corner samples, not area samples
