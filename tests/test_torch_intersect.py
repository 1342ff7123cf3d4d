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
from esctp1raytracer_tpu_torch.kernels import winner  # noqa: E402
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


# The columns of the packed row that closest_hit and surface_attributes
# sliced before `winner_fields`: an int is one column, read as [R].
ROW_SLICES = {"v0": (0, 3), "v1": (3, 6), "v2": (6, 9), "n0": (9, 12), "n1": (12, 15),
              "n2": (15, 18), "ka": (18, 21), "kd": (21, 24), "ks": (24, 27), "ke": (27, 30),
              "ns": 30, "has_normals": 31}


def _winner_case(ps, case):
    """(prim [R] int64, the fields the loss differentiates) of a case of
    `test_winner_fields_equal_take_rows`."""
    n = ps.triangles.capacity
    g = torch.Generator().manual_seed(7)
    every = [name for name in ROW_SLICES if name != "has_normals"]
    if case == "one_row":
        return torch.full((300,), 5, dtype=torch.int64), every
    if case == "random":
        return torch.randint(0, n, (300,), generator=g), every
    if case == "r1":
        return torch.tensor([n - 1]), every
    if case == "r45":  # not a multiple of the kernel's 32-ray warps
        return torch.randint(0, 3, (45,), generator=g), every
    if case == "some_fields":
        return torch.randint(0, n, (300,), generator=g), ["v1", "ks", "ns"]
    o, d = rays(24, 24)
    _, prim, is_sphere = pi.argmin_hit(torch.from_numpy(o), torch.from_numpy(d), ps,
                                       float(EPS))
    if case == "missed":  # missed rays clamped to row 0, as closest_hit does
        assert (prim < 0).any()
    else:  # "spheres": sphere winners index the triangle table too, masked later
        assert is_sphere.any()
    return torch.clamp(prim, min=0).long(), every


@pytest.mark.parametrize("case", ["one_row", "random", "missed", "some_fields", "spheres",
                                  "r1", "r45"])
def test_winner_fields_equal_take_rows(scenes, case):
    """`winner_fields` against `take_rows` and slices (the path it replaces)
    on the CPU: every field bit-equal, and the gradients of the triangle
    leaves of a loss over the fields (has_normals only as a mask: it gets no
    gradient) bit-equal too: each element's additions come in the same order."""
    _, ps = scenes
    prim, diff = _winner_case(ps, case)
    gen = torch.Generator().manual_seed(5)
    w = {name: torch.randn((prim.shape[0],) if isinstance(cols, int) else
                           (prim.shape[0], cols[1] - cols[0]), generator=gen)
         for name, cols in ROW_SLICES.items()}

    def grads(fetch):
        tris = ps.triangles.map(lambda _, t: t.detach().clone().requires_grad_()
                                if t.is_floating_point() else t)
        row = fetch(pi.packed_tri_table(tris))
        mask = row["has_normals"] > 0.5
        loss = sum(torch.sum(torch.where(mask if w[k].dim() == 1 else mask[:, None],
                                         row[k], 0.5 * row[k]) * w[k]) for k in diff)
        leaves = [t for _, t in tris.leaves() if t.requires_grad]
        return row, torch.autograd.grad(loss, leaves, allow_unused=True)

    def sliced(table):
        rows = pi.take_rows(table, prim)
        return {k: rows[:, c] if isinstance(c, int) else rows[:, c[0]:c[1]]
                for k, c in ROW_SLICES.items()}

    got, g_got = grads(lambda t: winner.winner_fields(t, prim)._asdict())
    want, g_want = grads(sliced)
    assert list(got) == list(want)
    for k in want:
        assert got[k].is_contiguous() and torch.equal(got[k], want[k]), k
    for a, b in zip(g_got, g_want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert any(a is not None and a.abs().sum() > 0 for a in g_got)


def test_warp_groups_counts_distinct_rows_per_warp():
    """The scatter kernel's count, as its plain version gives it: the
    distinct rows among each 32 consecutive rays; the last warp's missing
    lanes add none."""
    prim = torch.cat([torch.full((32,), 4), torch.arange(32), torch.tensor([1, 1, 2])])
    assert winner.warp_groups(prim).tolist() == [1, 32, 2]
    assert winner.warp_groups(torch.tensor([9])).tolist() == [1]
    cnt = torch.empty(3, dtype=torch.int32)
    gtab = winner.winner_scatter([None] * len(winner.FIELDS), prim, 40, cnt_out=cnt)
    assert cnt.tolist() == [1, 32, 2] and not gtab.any()


def _sphere_grid(pad):
    """The ground plane and an area light (4 triangles, padded to `pad` rows)
    under a 4 x 4 grid of spheres."""
    from esctp1raytracer_tpu_torch.scene import builders as pb
    from esctp1raytracer_tpu_torch.scene.types import Material as PortMaterial

    centers = [(-1.5 + x, 0.3, -1.5 + z) for x in range(4) for z in range(4)]
    mat = PortMaterial.make(kd=(0.6, 0.3, 0.2), ks=(0.3, 0.3, 0.3), ns=16.0)
    spheres = pb.make_spheres(centers, [0.3] * 16, [mat] * 16, device="cpu")
    return pb.scene_from_mesh([pb._ground_plane(), pb._area_light(center=(0.0, 6.0, 2.0),
                                                                  half=1.5)],
                              spheres=spheres, pad_multiple=pad, device="cpu")


def test_sphere_winners_beyond_the_triangle_rows():
    """A sphere winner's index is a row of the sphere table: with more spheres
    than triangle rows the winner fetch must not read it as a triangle row.
    The frame and every leaf's gradient with 8 triangle rows equal those with
    512 (rows 8 on zero)."""
    from esctp1raytracer_tpu_torch.core.camera import Camera as PortCamera
    from esctp1raytracer_tpu_torch.core.render import RenderConfig, render
    from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params

    cam = PortCamera.look_at((0.0, 3.0, 5.0), (0.0, 0.3, -0.5), vfov=50.0, aspect=4 / 3,
                             device="cpu")

    def run(pad):
        sc = _sphere_grid(pad)
        params = [p.detach().requires_grad_() for p in float_params(sc)]
        img = render(merge_params(sc, params), cam, 48, 36, RenderConfig(backend="jnp"))
        return sc, img, torch.autograd.grad((img * img).sum(), params, allow_unused=True)

    small, img, grads = run(8)
    o, d = (x.reshape(-1, 3) for x in cam.ray_grid(48, 36))
    hit = pi.closest_hit(o, d, small, float(EPS))
    assert small.triangles.capacity == 8 and bool((hit.is_sphere & (hit.prim >= 8)).any())
    _, img_512, grads_512 = run(512)
    assert torch.equal(img, img_512)
    for g, g512 in zip(grads, grads_512):
        assert (g is None) == (g512 is None)
        if g is not None:
            assert torch.equal(g, g512[:g.shape[0]]) and not g512[g.shape[0]:].any()
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("name", ["EPS", "T_MAX", "BIG", "NO_HIT", "aabb.BIG"])
def test_constants_match_jax(name):
    """The module constants, by name, equal the JAX package's as float32."""
    from esctp1raytracer_tpu.accel import aabb as ja
    from esctp1raytracer_tpu_torch.accel import aabb as pa

    j, p = (ja.BIG, pa.BIG) if name == "aabb.BIG" else (getattr(ji, name), getattr(pi, name))
    assert np.float32(p) == np.float32(np.asarray(j))
