"""Port vs JAX package: the ray-lane search K4 (kernels/lane_pallas.py).

The JAX search runs its Pallas kernel in interpret mode on the CPU; the
port's wrapper, given CPU tensors, runs its plain PyTorch version. Both
get the same rays (made with numpy). Bars:
* constants: max abs difference <= 1e-6 of each column's scale (the two
  packages round the cross products alike; XLA may contract a*b + c);
* search (tests/test_pallas.py:37-60): winners agree on > 99.5% of rays,
  and where they agree t is within 2e-6 of max(|t|, 1). Shadow rays hit
  their own surface at t ~ 1e-4, where o.n - n.v0 cancels: XLA on the
  CPU contracts a*b + c into FMAs and PyTorch does not, which leaves
  ~1e-7 absolute there (4e-4 relative), so the bar is absolute below 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.kernels import lane_pallas as jl  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu_torch.core import render as pr  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import lane_pallas as pl  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer, scene_from_numpy  # noqa: E402

EPS = float(np.finfo(np.float32).eps)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def icosphere_scene():
    """~2k triangles: a subdivision-4 icosphere would be 5,120; two of
    subdivision 3 plus a plane and a light are 2,564 (capacity 3,072)."""
    return jb.scene_from_mesh([
        jb.icosphere_mesh(subdivisions=3, radius=1.0, center=(-1.1, 1.0, 0.0)),
        jb.icosphere_mesh(subdivisions=3, radius=0.8, center=(1.1, 0.8, 0.3), smooth=False),
        jb._ground_plane(),
        jb._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ])


SCENES = {
    "cornell": (jb.cornell_box, (0.0, 1.0, 2.0), (0.0, 1.0, 0.0)),
    "icospheres": (icosphere_scene, (0.0, 2.0, 6.0), (0.0, 1.0, 0.0)),
}


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    build, eye, at = SCENES[request.param]
    js = build()
    return js, to_port(js), Camera.look_at(eye, at, vfov=60.0, aspect=4 / 3)


def rays(cam, w, h):
    o, d = cam.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def assert_search_agrees(tj, ij, tp, ip, min_hits=0.3):
    tj, ij, tp, ip = np.asarray(tj), np.asarray(ij), tp.numpy(), ip.numpy()
    same = ij == ip
    assert same.mean() > 0.995, f"winner mismatch {1 - same.mean():.4f}"
    hit = same & (ij >= 0)
    assert (np.abs(tp[hit] - tj[hit]) <= 2e-6 * np.maximum(np.abs(tj[hit]), 1.0)).all()
    np.testing.assert_array_equal(tp[ip < 0], np.float32(1e30))
    assert (ip >= 0).mean() > min_hits


def test_constants_match_jax(case):
    js, ps, _ = case
    a = np.asarray(jl.lane_tri_constants(js.triangles)).reshape(-1, 13)
    b = pl.lane_tri_constants(ps.triangles).numpy().reshape(-1, 13)
    assert b.shape == a.shape
    scale = np.maximum(np.abs(a).max(axis=0), 1e-30)
    assert (np.abs(a - b).max(axis=0) <= 1e-6 * scale).all()
    # Invalid rows: zero normal, valid flag 0.
    inv = ~np.asarray(js.triangles.valid)
    assert (b[inv][:, [0, 1, 2, 12]] == 0).all()


@pytest.mark.parametrize("w,h", [(40, 30), (33, 17)])  # 1200 and 561 rays: no tile multiple
def test_search_matches_jax(case, w, h):
    js, ps, cam = case
    o, d = rays(cam, w, h)
    tj, ij = jl.lane_tri_search(jnp.asarray(o), jnp.asarray(d), js.triangles, EPS)
    tp, ip = pl.lane_tri_search(torch.from_numpy(o), torch.from_numpy(d), ps.triangles, EPS)
    assert tp.shape == (w * h,) and tp.dtype == torch.float32 and ip.dtype == torch.int32
    assert_search_agrees(tj, ij, tp, ip)


def test_shadow_wavefront_matches_jax():
    """Shadow rays from the Cornell camera hits toward the light, closest
    hit then compare (the lane hook has no dedicated any-hit)."""
    js = jb.cornell_box()
    ps = to_port(js)
    o, d = rays(Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3),
                32, 24)
    t, _ = jl.lane_tri_search(jnp.asarray(o), jnp.asarray(d), js.triangles, EPS)
    t = np.asarray(t)
    hp = np.where((t < 1e29)[:, None], o + d * (t - 1e-4)[:, None], 0.0).astype(np.float32)
    lv = np.asarray([0.0, 1.98, -0.03], np.float32) - hp
    dist = np.linalg.norm(lv, axis=1).astype(np.float32)
    sd = (lv / dist[:, None]).astype(np.float32)
    tj, ij = jl.lane_tri_search(jnp.asarray(hp), jnp.asarray(sd), js.triangles, EPS)
    tp, ip = pl.lane_tri_search(torch.from_numpy(hp), torch.from_numpy(sd), ps.triangles, EPS)
    assert_search_agrees(tj, ij, tp, ip)
    lim = dist - 1e-4
    occ_j, occ_p = np.asarray(tj) < lim, tp.numpy() < lim
    assert (occ_j == occ_p).mean() > 0.999 and 0.01 < occ_p.mean() < 0.99


def test_capacity_limit():
    assert pl.LANE_TRI_LIMIT == jl.LANE_TRI_LIMIT == 4096
    tris = TriangleBuffer.empty(pl.LANE_TRI_LIMIT + 512, device="cpu")
    with pytest.raises(ValueError, match="4096"):
        pl.lane_tri_search(torch.zeros((8, 3)), torch.zeros((8, 3)), tris, EPS)
    ok = TriangleBuffer.empty(pl.LANE_TRI_LIMIT, device="cpu")  # at the limit: runs, all misses
    t, i = pl.lane_tri_search(torch.zeros((8, 3)), torch.ones((8, 3)), ok, EPS)
    assert bool((i == -1).all()) and bool((t == 1e30).all())


def test_plain_version_tie_rule_and_bound():
    """Two identical triangles: the lower index wins. A triangle at or
    beyond n_tris is never visited. CPU tensors launch nothing."""
    floor = to_port(jb.cornell_box()).triangles  # rows 0 and 1: the floor quad
    tris = floor.map(lambda _, a: torch.cat([a[0:1], a[0:1], a[1:2]]))
    o = torch.tensor([[0.5, 1.0, 0.5], [-0.5, 1.0, -0.5]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]])
    tcs = pl.lane_tri_constants(tris)
    eps = torch.tensor([EPS])
    before = pl.lane_kernel.launches
    t, i = pl.lane_kernel(eps, torch.tensor([3], dtype=torch.int32), tcs, o, d)
    assert i.tolist() == [0, 2] and torch.allclose(t, torch.ones(2))
    t, i = pl.lane_kernel(eps, torch.tensor([2], dtype=torch.int32), tcs, o, d)
    assert i.tolist() == [0, -1] and float(t[1]) == float(np.float32(1e30))
    assert pl.lane_kernel.launches == before
    assert pl.valid_prefix(to_port(jb.cornell_box()).triangles.valid).tolist() == [36]


@pytest.mark.parametrize("over", [dict(backend="lane"), dict(backend="auto", depth=5),
                                  dict(backend="fused", light_mode="reference_cpp")])
def test_lane_routes_render_like_jax(over):
    """Routes that resolve to the lane kernel render as JAX's do."""
    from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig
    from esctp1raytracer_tpu.core.render import trace_rays as j_trace_rays

    js = jb.cornell_variant("mirror")
    ps = to_port(js)
    o, d = rays(Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3),
                24, 18)
    ids = np.arange(o.shape[0])
    a = np.asarray(j_trace_rays(jnp.asarray(o), jnp.asarray(d), js, jnp.asarray(ids, jnp.uint32),
                                JRenderConfig(**over)))
    assert pr.resolve_backend(pr.RenderConfig(**over), ps) == "lane"
    b = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), ps, torch.from_numpy(ids),
                      pr.RenderConfig(**over)).numpy()
    diff = np.abs(a - b).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= 2e-3 and np.abs(a - b)[~flipped].max() <= 3e-5
    assert b.sum() > 1.0
