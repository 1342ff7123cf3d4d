"""Port vs JAX package: the Cornell variants, a scene with no light, and the
round-1 corner cases.

The port's counterpart of tests/test_variants.py:32-110 and
tests/test_round2_fixes.py:85-104,121-160:
* each of the ten CORNELL_VARIANTS rendered at 24x24 on the same rays as
  JAX's jnp route: the port's jnp route with the image bars of
  tests/test_rt_mxu.py (mean |diff| < 1e-4, < 0.5% of channels over 1e-2),
  its "auto" route (fused for most, lane for empty_nolight, mxtile for the
  water's 8k triangles) against JAX's search route by the size rule (lane
  or mxtile; JAX's fused route runs Pallas in interpret mode here, ~10 s a
  scene) with the bars that hold the fused route against a search route
  (tests/test_fused.py: <= 0.2% of pixels flipped by > 1e-2, atol 3e-5
  elsewhere; the search routes of both packages flip up to two pixels of
  these frames from their jnp routes, eps-window near-ties), and the JAX
  test's own signature checks;
* empty_nolight (L = 0) on every route: exactly black and finite, routed as
  JAX routes it (the fused gate refuses it: lane), and a backward that runs
  and gives JAX's gradients (all zero);
* reference_cpp sampling of a four-face light: the corners {f0c0, f0c1,
  f0c2, f1c0}, the draws bit-equal to JAX's;
* closest_hit keeps a borderline winner that its recompute rejects.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core import shading as jsh  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import _auto_backend as j_auto_backend  # noqa: E402
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
from esctp1raytracer_tpu_torch.scene.builders import CORNELL_VARIANTS  # noqa: E402
from test_torch_render import assert_images_agree, to_port  # noqa: E402

CAM = JCamera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=1.0)  # tests/test_variants.py's
N = 24
O, D = (np.array(x).reshape(-1, 3) for x in CAM.ray_grid(N, N))
IDS = np.arange(N * N)
j_trace = jax.jit(j_trace_rays, static_argnames=("cfg",))
ROUTES = ["jnp", "lane", "mxtile", "tile", "fused", "auto"]


def frames(name, depth=1):
    """Four [N, N, 3] images of the variant on the same rays: JAX's jnp
    route, the port's jnp route, JAX's search route by the size rule, the
    port's "auto" route."""
    js = jb.cornell_variant(name)
    ps = to_port(js)
    out = []
    for backend in ("jnp", j_auto_backend(js)):
        out.append(np.asarray(j_trace(jnp.asarray(O), jnp.asarray(D), js,
                                      jnp.asarray(IDS, jnp.uint32),
                                      JRenderConfig(backend=backend, depth=depth))))
        out.append(pr.trace_rays(torch.from_numpy(O), torch.from_numpy(D), ps,
                                 torch.from_numpy(IDS),
                                 pr.RenderConfig(backend=backend if backend == "jnp" else "auto",
                                                 depth=depth)).numpy())
    return [x.reshape(N, N, 3) for x in out]


def assert_routes_agree(a, b):
    """One route against another (tests/test_fused.py's bars)."""
    diff = np.abs(a - b).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= 2e-3
    assert np.abs(a[~flipped] - b[~flipped]).max() <= 3e-5


def _signature(name, img):
    """tests/test_variants.py's checks of each variant's image."""
    assert np.isfinite(img).all()
    h = img.shape[0] // 2
    left, right = img[h, 1], img[h, -2]
    if name == "empty_nolight":
        assert img.max() == 0.0
        return
    assert img.max() > 0.1, f"{name} rendered black"
    if name in ("original", "mirror", "glossy", "sphere", "water"):
        # The Cornell signature: red-dominant left wall, green-dominant right.
        assert left[0] > left[1]
        assert right[1] > right[0]
    if name == "empty_co":
        assert left[0] > left[2]          # orange: red over blue
        assert right[2] > right[0] * 0.9  # cyan: blue not dominated by red
        assert right[1] > right[0]        # cyan: green over red


@pytest.mark.parametrize("name", CORNELL_VARIANTS)
def test_variant_renders_as_jax(name):
    a, same, search, auto = frames(name)
    assert_images_agree(a, same)
    assert_routes_agree(search, auto)
    for img in (same, auto):
        _signature(name, img)


def test_mirror_reflects_at_depth2():
    """The mirrored tall box differs from the diffuse one at depth 2, as in
    JAX; both frames agree with JAX's."""
    base_j, base, base_search, base_auto = frames("original", depth=2)
    mirror_j, mirror, mirror_search, mirror_auto = frames("mirror", depth=2)
    for a, same, search, auto in ((base_j, base, base_search, base_auto),
                                  (mirror_j, mirror, mirror_search, mirror_auto)):
        assert_images_agree(a, same)
        assert_routes_agree(search, auto)
    assert float(np.abs(base - mirror).max()) > 0.05
    assert float(np.abs(base_auto - mirror_auto).max()) > 0.05


@pytest.fixture(scope="module")
def nolight():
    """empty_nolight in both packages, and JAX's gradient of sum(color^2)
    with respect to every float leaf on its jnp route."""
    js = jb.cornell_variant("empty_nolight")
    assert int(np.asarray(js.lights.face_count).sum()) == 0

    def j_loss(params):
        color = j_trace_rays(jnp.asarray(O), jnp.asarray(D), j_merge_params(js, params),
                             jnp.asarray(IDS, jnp.uint32), JRenderConfig())
        return jnp.sum(color * color)

    grads = jax.jit(jax.grad(j_loss))(j_float_params(js))
    return js, to_port(js), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("light_mode", ["area", "reference_cpp"])
@pytest.mark.parametrize("backend", ROUTES)
def test_nolight_is_black_on_every_route(nolight, backend, light_mode):
    """No light: the per-light sum is empty, so the image is exactly black,
    with no 0/0; the route is JAX's (the fused gate takes scenes with a
    light only); the backward runs and gives JAX's (zero) gradients."""
    js, ps, j_grads = nolight
    assert ps.num_lights == 0
    cfg = pr.RenderConfig(backend=backend, light_mode=light_mode)
    route = pr.resolve_backend(cfg, ps)
    assert route == j_resolve_backend(JRenderConfig(backend=backend, light_mode=light_mode), js)
    assert route != "fused"
    if backend in ("fused", "auto"):
        assert route == "lane"
    params = [p.clone().requires_grad_(True) for p in float_params(ps)]
    color = pr.trace_rays(torch.from_numpy(O), torch.from_numpy(D), merge_params(ps, params),
                          torch.from_numpy(IDS), cfg)
    assert tuple(color.shape) == (N * N, 3)
    assert torch.isfinite(color).all() and color.max().item() == 0.0
    (color * color).sum().backward()
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    assert len(params) == len(j_grads) == len(names)
    for name, p, gj in zip(names, params, j_grads):
        gp = np.zeros_like(gj) if p.grad is None else p.grad.numpy()
        assert gp.shape == gj.shape and np.isfinite(gp).all(), name
        np.testing.assert_array_equal(gp, gj, err_msg=name)


def test_four_face_reference_cpp_corners_match_jax():
    """A light of 4 faces (12 corners): the reference reads corner
    `face % 3` of face `face // 3`, so the draws land on exactly {f0c0, f0c1,
    f0c2, f1c0}; the port's draws are JAX's, bit for bit."""
    quad = np.asarray(
        [
            [[0.0, 5.0, 0.0], [1.0, 5.0, 0.0], [0.0, 5.0, 1.0]],
            [[9.0, 5.0, 9.0], [8.0, 5.0, 9.0], [9.0, 5.0, 8.0]],
            [[4.0, 5.0, 4.0], [5.0, 5.0, 4.0], [4.0, 5.0, 5.0]],
            [[7.0, 5.0, 1.0], [6.0, 5.0, 1.0], [7.0, 5.0, 2.0]],
        ],
        np.float32,
    )
    light = MeshData(name="light", vertices=quad, normals=None, uv=None,
                     material=Material.make(ke=(10, 10, 10)))
    floor = MeshData(name="floor", vertices=np.asarray([[[-9, 0, -9], [9, 0, -9], [0, 0, 9]]],
                                                       np.float32),
                     normals=None, uv=None, material=Material.make(kd=(1, 1, 1)))
    js = jb.scene_from_mesh([floor, light])
    ids = np.arange(4096, dtype=np.uint32)
    pj, tj, lj = jsh.sample_lights(js, 0, jnp.asarray(ids), mode="reference_cpp")
    pp, tp, lp = psh.sample_lights(to_port(js), 0, torch.from_numpy(ids.astype(np.int64)),
                                   mode="reference_cpp")
    assert lj == lp == 1
    np.testing.assert_array_equal(pp.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tj))
    pts = np.unique(pp.numpy().reshape(-1, 3), axis=0)
    expected = np.unique(np.asarray([quad[0, 0], quad[0, 1], quad[0, 2], quad[1, 0]]), axis=0)
    np.testing.assert_array_equal(pts, expected)


def test_borderline_winner_keeps_search_t():
    """A search that accepts a winner the recompute rejects (a borderline
    rounding disagreement, faked here for a ray that misses): closest_hit
    keeps the hit at the search's t rather than leaving it at BIG."""
    tri = MeshData(name="t", vertices=np.asarray([[[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
                                                   [0.0, 2.0, 0.0]]], np.float32),
                   normals=None, uv=None, material=Material.make(kd=(1, 1, 1)))
    ps = to_port(jb.scene_from_mesh([tri]))
    o = torch.tensor([[5.0, 5.0, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])

    def fake_search(oo, dd, tris, eps, t_limit=None):
        return torch.full((1,), 2.5), torch.zeros((1,), dtype=torch.int32)

    hit = pi.closest_hit(o, d, ps, tri_search=fake_search)
    assert bool(hit.hit[0])
    assert hit.t[0].item() == 2.5 < pi.BIG
