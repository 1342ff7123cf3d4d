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
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

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
    before = pl.lane_kernel.launches
    t, i = pl.lane_kernel(EPS, tris.v0, tris.v1, tris.v2, tris.valid, o, d)
    assert i.tolist() == [0, 2] and torch.allclose(t, torch.ones(2))
    # Row 2 invalid: the valid prefix ends at 2, and so does the sweep.
    valid = torch.tensor([True, True, False])
    t, i = pl.lane_kernel(EPS, tris.v0, tris.v1, tris.v2, valid, o, d)
    assert i.tolist() == [0, -1] and float(t[1]) == float(np.float32(1e30))
    tcs = pl.lane_tri_constants(tris)
    t, i = pl._lane_search_plain(EPS, torch.tensor([2], dtype=torch.int32), tcs, o, d)
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


# --------------------------------------------------------------------------
# The exact division skip (lane_plane.cuh:plane_skip, lane_pallas.plane_skip)
# --------------------------------------------------------------------------


def test_skip_predicate_edge_cases():
    """Where plane_skip holds, t = num * (1 / det) can never pass t >= eps,
    or |det| < eps already rejects: numerators of +-0, NaN and +-inf,
    |det| exactly eps and one ulp below it, infinite and NaN dets."""
    eps = np.float32(EPS)
    below = np.nextafter(eps, np.float32(0))
    vals = np.array([0.0, -0.0, 1.0, -1.0, 3e-8, -3e-8, 1e30, -1e30, np.inf, -np.inf, np.nan,
                     eps, -eps, below, -below], np.float32)
    det, num = (torch.from_numpy(x) for x in np.meshgrid(vals, vals, indexing="ij"))
    skip = pl.plane_skip(det, num, EPS)
    ok_det = torch.abs(det) >= EPS
    t = num * (1.0 / torch.where(ok_det, det, 1.0))
    assert not bool((skip & ok_det & (t >= EPS)).any())
    assert bool(skip[~ok_det].all())  # |det| < eps (and NaN) always skips
    for n in (0.0, -0.0):  # a zero numerator skips whatever det's sign
        assert bool(pl.plane_skip(torch.tensor([eps, -eps, np.inf]), torch.tensor([n] * 3),
                                  EPS).all())
    assert not bool(pl.plane_skip(torch.tensor([eps, -eps]), torch.tensor([2.0, -2.0]),
                                  EPS).any())
    # eps <= 0: only |det| < eps skips (a t of 0 could then pass t >= eps).
    assert torch.equal(pl.plane_skip(det, num, 0.0), ~(torch.abs(det) >= 0.0))


def _skip_case(seed=0, n_tri=300, n_ray=400):
    """Random triangles (one degenerate, 20 invalid: zero normals), rays
    from random origins, and rays that start on a triangle's plane (a zero
    numerator) or run parallel to it (det 0)."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-2, 2, (n_tri, 3, 3)).astype(np.float32)
    v[0, 2] = v[0, 0]  # degenerate: a zero normal although valid
    valid = np.ones(n_tri, bool)
    valid[rng.choice(n_tri, 20, replace=False)] = False
    o = rng.uniform(-3, 3, (n_ray, 3)).astype(np.float32)
    d = rng.normal(size=(n_ray, 3)).astype(np.float32)
    o[:50] = v[:50, 0]  # on triangle k's plane: its numerator is exactly 0
    o[50:100] *= -1.0
    e1 = v[100:150, 1] - v[100:150, 0]
    d[100:150] = e1  # parallel to triangle k's plane
    d[150:160, 1:] = 0.0  # axis-aligned, with zero components
    d[160:170] = np.inf
    d[170:175, 0] = np.nan
    tris = [torch.from_numpy(v[:, k].copy()) for k in range(3)]
    return tris, torch.from_numpy(valid), torch.from_numpy(o), torch.from_numpy(d)


def test_skip_rejects_only_rejected_pairs():
    """Over seeded random pairs and the edge cases of `_skip_case`, no pair
    that the skip rejects is accepted by plane_pair; with the skip, plane_pair
    accepts the same pairs with the same t."""
    (v0, v1, v2), valid, o, d = _skip_case()
    c = pl._constants(v0, v1, v2, valid)
    skip = pl.lane_plane_skips(o, d, c, EPS)
    t, ok = pl.lane_plane_hits(o, d, c, EPS)
    ts, oks = pl.lane_plane_hits(o, d, c, EPS, skip=True)
    assert not bool((skip & ok).any())
    assert torch.equal(ok, oks) and torch.equal(t, ts)
    assert bool(skip[:, ~valid].all())  # zero-normal rows: det == 0
    assert 0.2 < skip.float().mean().item() < 0.9 and ok.any()
    assert bool(skip[torch.arange(50), torch.arange(50)].all())  # zero numerators


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_search_same_without_skip(name, monkeypatch):
    """The plain K4 (`_lane_plain`, the sweep of `_lane_search_plain`) gives
    identical outputs with the skip and without it."""
    js, eye, at = SCENES[name]
    tris = to_port(js()).triangles
    o, d = rays(Camera.look_at(eye, at, vfov=60.0, aspect=4 / 3), 40, 30)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    args = (EPS, tris.v0, tris.v1, tris.v2, tris.valid, o, d)
    with_skip = pl._lane_plain(*args)
    monkeypatch.setattr(pl, "plane_skip", lambda det, num, eps: torch.zeros_like(det, dtype=bool))
    without = pl._lane_plain(*args)
    assert torch.equal(with_skip[0], without[0]) and torch.equal(with_skip[1], without[1])
    assert (with_skip[1] >= 0).float().mean().item() > 0.3


# --------------------------------------------------------------------------
# The rounding that the kernels' constants copy (lane_plane.cuh:tri_constants)
# --------------------------------------------------------------------------


def _fmaf(a, b, c):
    """fmaf on float32 arrays, exactly, in float64: the product is exact
    (24 + 24 bits), TwoSum gives the sum's rounding error e, and the one
    case where rounding twice differs from rounding once (the float64 sum
    on a float32 midpoint, with e != 0) is settled by e's sign."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bp = s - p
    e = (p - (s - bp)) + (c64 - bp)
    r = s.astype(np.float32)
    other = np.where(s > r, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    tie = (s == (r.astype(np.float64) + other.astype(np.float64)) / 2) & (e != 0)
    toward = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie, toward, r)


def _ref_constants(v0, v1, v2, valid):
    """lane_tri_constants in numpy float32, each cross-product component
    fmaf(a_i, b_j, -(a_j * b_i)), each 3-term sum ((0 + x) + y) + z: the
    reduction starts from +0, which turns a sum of three -0 into +0."""
    def cross(a, b):
        return np.stack([_fmaf(a[:, 1], b[:, 2], -(a[:, 2] * b[:, 1])),
                         _fmaf(a[:, 2], b[:, 0], -(a[:, 0] * b[:, 2])),
                         _fmaf(a[:, 0], b[:, 1], -(a[:, 1] * b[:, 0]))], axis=1)

    def dot(a, b):
        return ((np.float32(0.0) + a[:, 0] * b[:, 0]) + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    e1, e2 = v1 - v0, v2 - v0
    n = np.where(valid[:, None], cross(e1, e2), np.float32(0.0))
    nn = dot(n, n)
    nn = np.where(nn > 0, nn, np.float32(1.0))[:, None]
    wu, wv = cross(e2, n) / nn, cross(n, e1) / nn
    return np.stack([n[:, 0], n[:, 1], n[:, 2], dot(n, v0), wu[:, 0], wu[:, 1], wu[:, 2],
                     -dot(wu, v0), wv[:, 0], wv[:, 1], wv[:, 2], -dot(wv, v0),
                     valid.astype(np.float32)], axis=1)


def test_fmaf_reference_is_exact():
    """The reference fmaf against exact rational arithmetic, on seeded values
    and on constructed double-rounding ties."""
    from fractions import Fraction

    rng = np.random.RandomState(3)
    a, b = (rng.normal(size=400) * 10 ** rng.uniform(-3, 3, 400)).astype(np.float32), \
        rng.normal(size=400).astype(np.float32)
    c = (-(a * b) * (1 + rng.normal(size=400) * 1e-3)).astype(np.float32)
    # Ties: a*b = 1 + 2^-24 + 2^-60-ish cases, c = 2^-80 pushes off the midpoint.
    a = np.concatenate([a, np.float32([1 + 2 ** -12, 1 + 2 ** -12])])
    b = np.concatenate([b, np.float32([1 + 2 ** -12, 1 + 2 ** -12])])
    c = np.concatenate([c, np.float32([2.0 ** -80, -(2.0 ** -80)])])
    got = _fmaf(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))  # within an ulp; pick the nearer neighbour exactly
        cands = [lo, np.nextafter(lo, np.float32(np.inf)), np.nextafter(lo, np.float32(-np.inf))]
        dist = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(dist)
        near = [v for v, dd in zip(cands, dist) if dd == best]
        want = near[0] if len(near) == 1 else [v for v in near
                                               if not (np.float32(v).view(np.int32) & 1)][0]
        assert np.float32(g).view(np.int32) == np.float32(want).view(np.int32), (x, y, z)


@pytest.mark.parametrize("name", ["random", "cornell", "icospheres"])
def test_constants_round_as_fmaf(name):
    """lane_tri_constants (PyTorch on the CPU) equals the numpy float64 ->
    float32 reference of the fmaf form, bit for bit: the rounding that
    csrc/lane_plane.cuh:tri_constants reproduces on the card."""
    if name == "random":
        rng = np.random.RandomState(7)
        v = (rng.normal(size=(5000, 3, 3)) * 10 ** rng.uniform(-2, 2, (5000, 1, 1)))
        v = v.astype(np.float32)
        v[:10, 1] = v[:10, 0]  # degenerate
        valid = rng.rand(5000) > 0.05
        v0, v1, v2 = (v[:, k].copy() for k in range(3))
    else:
        tris = to_port(SCENES[name][0]()).triangles
        v0, v1, v2 = (x.numpy() for x in (tris.v0, tris.v1, tris.v2))
        valid = tris.valid.numpy()
    got = pl.lane_tri_constants(TriangleBuffer.empty(len(valid), device="cpu").map(
        lambda n, a: {"v0": torch.from_numpy(v0), "v1": torch.from_numpy(v1),
                      "v2": torch.from_numpy(v2), "valid": torch.from_numpy(valid)}.get(n, a)))
    want = _ref_constants(v0, v1, v2, valid)
    np.testing.assert_array_equal(got.numpy().reshape(-1, 13).view(np.int32), want.view(np.int32))
