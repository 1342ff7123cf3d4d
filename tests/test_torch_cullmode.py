"""Port vs JAX package: the selectable cull pre-pass modes.

Counterparts of tests/test_cullmode.py. The same inputs (JAX's camera
rays and boxes, as numpy; seeded scattered rays) go through the JAX
package's jnp pre-pass functions and the port's: `group_cull_mask`,
`extract_lists` and `block_cull_mask(return_entry=True)` must be
bit-equal, and so must the block lists of every mode ("argsort",
"exact", "interval", "hier", "entry") from `rt_tile._cull_lists` /
`_prep` and `rt_mxu._prep_mxu`. The port's winners and occlusion under
every mode (and the any-hit early exit) must be bit-equal to its
"argsort" ones, and `_resolve_cull_mode` must resolve as JAX's does. The
JAX interpret-mode kernels are not run here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import esctp1raytracer_tpu.kernels.cull as jc  # noqa: E402
import esctp1raytracer_tpu.kernels.rt_mxu as jm  # noqa: E402
import esctp1raytracer_tpu.kernels.rt_tile as jt  # noqa: E402
from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.scene.types import TriangleBuffer as JTriangleBuffer  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.cull as pc  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_mxu as pm  # noqa: E402
import esctp1raytracer_tpu_torch.kernels.rt_tile as pt  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import tables  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

EPS = np.float32(np.finfo(np.float32).eps)
CAM = Camera.look_at((0, 2, 6), (0, 1, 0), vfov=60.0, aspect=1.0)
MODES = ["argsort", "exact", "interval", "hier", "entry"]


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def T(a):
    return torch.from_numpy(np.array(a))


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def mesh():
    js = jb.mesh_scene(3)  # 1280 + 2 + 2 triangles: 16 sub-blocks
    return js, to_port(js)


@pytest.fixture(scope="module")
def aabbs(mesh):
    return np.asarray(jt.tri_constants_sub(mesh[0].triangles)[1])


def camera_rays(w=32, h=16):
    o, d = CAM.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def scattered_rays(n=128, seed=0, spread=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def t_limit(n):
    return np.where(np.arange(n) % 3 == 0, -1.0, 4.0).astype(np.float32)


RAYS = {"camera": lambda: (*camera_rays(), None),
        "camera-t-limit": lambda: (*camera_rays(), t_limit(512)),
        "scattered": lambda: (*scattered_rays(seed=7), None),
        "scattered-t-limit": lambda: (*scattered_rays(seed=7), t_limit(128))}


def both(fn_j, fn_p, *args):
    """fn_j on jnp arrays and fn_p on tensors of the same numpy args (None kept)."""
    return (fn_j(*(None if a is None else jnp.asarray(a) for a in args)),
            fn_p(*(None if a is None else T(a) for a in args)))


# --------------------------------------------------------------------------
# cull.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rays", list(RAYS))
@pytest.mark.parametrize("group", [8, 128])
def test_group_cull_mask_bit_equal_and_conservative(aabbs, rays, group):
    o, d, tl = RAYS[rays]()
    mj, mp = both(lambda *a: jc.group_cull_mask(*a, group=group),
                  lambda *a: pc.group_cull_mask(*a, group=group), o, d, aabbs, tl)
    np.testing.assert_array_equal(N(mp), N(mj))
    ns = aabbs.shape[1]
    exact = N(pc.block_cull_mask(T(o), T(d), T(aabbs), None if tl is None else T(tl)))
    assert not (exact.reshape(-1, group, ns).any(1) & ~N(mp)).any(), "interval mask dropped a block"


@pytest.mark.parametrize("rays", list(RAYS))
def test_block_cull_mask_entry_bit_equal(aabbs, rays):
    o, d, tl = RAYS[rays]()
    (mj, tj), (mp, tp) = both(lambda *a: jc.block_cull_mask(*a, return_entry=True),
                              lambda *a: pc.block_cull_mask(*a, return_entry=True),
                              o, d, aabbs, tl)
    np.testing.assert_array_equal(N(mp), N(mj))
    np.testing.assert_array_equal(N(tp), N(tj))  # NaN where JAX's is NaN


def test_block_cull_mask_entry_nan_on_slab_planes(aabbs):
    """Axis rays from a box plane: 0 * inf = NaN entries, kept, as in JAX."""
    o = np.repeat(aabbs[0:3, :1].T, 8, 0).astype(np.float32)  # box 0's min corner
    d = np.tile(np.eye(3, dtype=np.float32), (3, 1))[:8]
    (mj, tj), (mp, tp) = both(lambda *a: jc.block_cull_mask(*a, return_entry=True),
                              lambda *a: pc.block_cull_mask(*a, return_entry=True), o, d, aabbs)
    assert np.isnan(N(tp)).any()
    np.testing.assert_array_equal(N(tp), N(tj))
    np.testing.assert_array_equal(N(mp), N(mj))


@pytest.mark.parametrize("case", ["random", "overflow", "k-clamp"])
def test_extract_lists_bit_equal(case):
    rng = np.random.default_rng(1)
    gm, k = {"random": (rng.random((40, 96)) < 0.1, 32),
             "overflow": (np.ones((3, 64), bool), 8),
             "k-clamp": (np.eye(4, dtype=bool), 32)}[case]
    (ij, cj), (ip, cp) = jc.extract_lists(jnp.asarray(gm), k=k), pc.extract_lists(T(gm), k=k)
    np.testing.assert_array_equal(N(ip), N(ij))
    np.testing.assert_array_equal(N(cp), N(cj))
    assert ip.dtype == cp.dtype == torch.int32
    if case == "overflow":
        assert (N(cp) == 64).all() and (N(ip) == np.arange(64)).all()
    ref = np.argsort(~gm, axis=1, kind="stable")
    for r, c in enumerate(N(cp)):
        if c <= k:
            np.testing.assert_array_equal(N(ip)[r, :c], ref[r, :c])


# --------------------------------------------------------------------------
# The lists of every mode
# --------------------------------------------------------------------------


def assert_lists_equal(got, want):
    (ip, cp), (ij, cj) = got, want
    np.testing.assert_array_equal(N(cp), N(cj))
    np.testing.assert_array_equal(N(ip), N(ij))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rays", list(RAYS))
def test_tile_lists_match_jax(aabbs, mode, rays):
    o, d, tl = RAYS[rays]()
    want, got = both(lambda *a: jt._cull_lists(*a, mode), lambda *a: pt._cull_lists(*a, mode),
                     o, d, tl, aabbs)
    assert_lists_equal(got, want)


def test_hier_lists_nsub_not_multiple_of_group():
    """mesh_scene(4): a sub-block count that is not a multiple of HIER_GROUP."""
    _, boxes, *_ = jt.tri_constants_sub(jb.mesh_scene(4).triangles)
    boxes = np.asarray(boxes)
    assert boxes.shape[1] % pt.HIER_GROUP != 0
    o, d = camera_rays(16, 16)
    for tl in (None, np.full(256, 5.0, np.float32)):
        want, got = both(lambda *a: jt._cull_lists(*a, "hier"),
                         lambda *a: pt._cull_lists(*a, "hier"), o, d, tl, boxes)
        assert_lists_equal(got, want)
        nsub = boxes.shape[1]
        assert (N(got[0])[np.arange(nsub) < N(got[1])[:, None]] < nsub).all()


def test_hier_lists_padding_and_overflow(mesh, monkeypatch):
    """Padding-heavy tables mask their empty sub-blocks at both levels, and
    HIER_K = 1 sends every multi-superblock bundle to the dense list: the
    same lists as JAX's in both."""
    js, _ = mesh
    padded = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), js.triangles,
                          JTriangleBuffer.empty(512))
    boxes = np.asarray(jt.tri_constants_sub(padded)[1])
    o, d = camera_rays()
    want, got = both(lambda *a: jt._cull_lists(*a, "hier"), lambda *a: pt._cull_lists(*a, "hier"),
                     o, d, None, boxes)
    assert_lists_equal(got, want)
    assert (N(got[1]) < boxes.shape[1]).all()
    monkeypatch.setattr(jt, "HIER_K", 1)
    monkeypatch.setattr(pt, "HIER_K", 1)
    want, got = both(lambda *a: jt._cull_lists(*a, "hier"), lambda *a: pt._cull_lists(*a, "hier"),
                     o, d, None, boxes)
    assert_lists_equal(got, want)
    assert (N(got[1]) == boxes.shape[1]).any(), "HIER_K = 1 never overflowed"


def _jax_prep_lists(o, d, aabbs, tl, mode):
    """JAX `_prep`'s lists as [Rp / 8, NSUB] ids and [Rp / 8] cnt."""
    _, ids, cnt, rp, nsub, _ = jt._prep(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabbs),
                                        None if tl is None else jnp.asarray(tl), mode)
    return np.asarray(ids).reshape(rp // 8, nsub), np.asarray(cnt).reshape(-1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rays", ["camera", "scattered"])
def test_prep_lists_match_jax(aabbs, mode, rays):
    """`_lists` on the port's padded rays against JAX's `_prep` (its ray
    padding: 510 rays go to 512)."""
    o, d = camera_rays(30, 17) if rays == "camera" else scattered_rays(n=510, seed=11)
    tl = np.random.RandomState(5).uniform(1.0, 8.0, o.shape[0]).astype(np.float32)
    for limit in (None, tl):
        want = _jax_prep_lists(o, d, aabbs, limit, mode)
        rays = tables.pad_rays(T(o), T(d), None if limit is None else T(limit))
        assert_lists_equal(pt._lists(rays, T(aabbs), mode), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rays", ["camera", "camera-t-limit", "scattered-t-limit"])
def test_mxu_lists_match_jax(mesh, mode, rays):
    """`_prep_mxu` in every mode ("hier" and "entry" fall through to argsort
    in both packages): rows, lists and counts."""
    js, _ = mesh
    boxes = np.asarray(jm._pack_mxu(jt._clustered_tables(js.triangles)[0])[1])
    o, d, tl = RAYS[rays]()
    want, got = both(lambda *a: jm._prep_mxu(*a, m=64, cull_mode=mode),
                     lambda *a: pm._prep_mxu(*a, m=64, cull_mode=mode), o, d, boxes, tl)
    np.testing.assert_array_equal(N(got[2]), np.asarray(want[2]).reshape(-1))
    np.testing.assert_array_equal(N(got[1]), np.asarray(want[1]).reshape(got[1].shape))
    np.testing.assert_allclose(N(got[0]), np.asarray(want[0]), rtol=0, atol=0)


# --------------------------------------------------------------------------
# Winners under every mode
# --------------------------------------------------------------------------


@pytest.fixture
def switches(monkeypatch):
    """Set the port's switches for one test; restored after."""
    def set_(**kw):
        for name, value in kw.items():
            mod, attr = (pm, name[4:]) if name.startswith("mxu_") else (pt, name)
            monkeypatch.setattr(mod, attr, value)
    return set_


def _tile_search(ps, o, d, tl=None):
    return pt.tile_tri_search(T(o), T(d), ps.triangles, float(EPS),
                              None if tl is None else T(tl))


@pytest.mark.parametrize("mode", ["exact", "interval", "hier"])
def test_tile_winners_equal_argsort(mesh, switches, mode):
    _, ps = mesh
    o, d = camera_rays()
    tl = np.random.RandomState(2).uniform(2.0, 9.0, o.shape[0]).astype(np.float32)
    ref = [_tile_search(ps, o, d), _tile_search(ps, o, d, tl)]
    switches(CULL_MODE=mode)
    for (tr, ir), limit in zip(ref, (None, tl)):
        tm, im = _tile_search(ps, o, d, limit)
        assert torch.equal(im, ir) and torch.equal(tm, tr)
    assert (N(ref[0][1]) >= 0).mean() > 0.3


def _occl_rays(seed=3, n=128):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.where(rng.random(n) < 0.2, -1.0, rng.uniform(0.5, 6.0, n)).astype(np.float32)
    return T(o), T(d), T(tl)


@pytest.mark.parametrize("mode,period", [("exact", 0), ("interval", 0), ("hier", 0),
                                         ("entry", 0), (None, 1), (None, 8), ("argsort", 8)])
def test_tile_occlusion_equal_argsort(mesh, switches, mode, period):
    """Every mode, and the early exit E in {1, 8} (on "entry" lists, or on
    CULL_MODE's when set), against the default; the seeded random rays of
    test_occl_early_exit_parity."""
    _, ps = mesh
    o, d, tl = _occl_rays()
    ref = pt.tile_occlusion(o, d, tl, ps.triangles, float(EPS))
    switches(CULL_MODE=mode, OCCL_EARLY_EXIT=period)
    got = pt.tile_occlusion(o, d, tl, ps.triangles, float(EPS))
    assert torch.equal(got, ref)
    assert 0.05 < ref.float().mean().item() < 0.95


@pytest.mark.parametrize("mode", ["exact", "interval", "hier", "entry"])
def test_mxu_winners_and_occlusion_equal_argsort(mesh, switches, mode):
    _, ps = mesh
    o, d = camera_rays()
    t0, i0 = pm.mxu_tile_search(T(o), T(d), ps.triangles, float(EPS))
    tl = T(np.full(o.shape[0], 4.0, np.float32))
    occ0 = pm.mxu_tile_occlusion(T(o), T(d), tl, ps.triangles, float(EPS))
    switches(mxu_CULL_MODE=mode)
    t1, i1 = pm.mxu_tile_search(T(o), T(d), ps.triangles, float(EPS))
    assert torch.equal(i1, i0) and torch.equal(t1, t0)
    assert torch.equal(pm.mxu_tile_occlusion(T(o), T(d), tl, ps.triangles, float(EPS)), occ0)


def test_search_refuses_entry_lists(mesh, switches):
    """K5's tie rule needs ascending lists: the tile search takes no
    "entry" mode (the any-hit search does), on the CPU as on the card."""
    _, ps = mesh
    o, d = camera_rays(8, 16)
    switches(CULL_MODE="entry")
    with pytest.raises(ValueError, match="entry"):
        _tile_search(ps, o, d)


# --------------------------------------------------------------------------
# Resolution
# --------------------------------------------------------------------------


@pytest.mark.parametrize("override", [None, "interval", "hier"])
@pytest.mark.parametrize("coherent,nsub", [(True, 784), (False, 784), (True, 84), (False, 255),
                                           (False, 256)])
def test_resolve_cull_mode_matches_jax(monkeypatch, override, coherent, nsub):
    """JAX's cases (tests/test_cullmode.py): its `_resolve_cull_mode(coherent,
    nsub)` reads neither argument, and the port's takes none."""
    for mod in (jt, pt, jm, pm):
        monkeypatch.setattr(mod, "CULL_MODE", override)
    assert pt._resolve_cull_mode() == jt._resolve_cull_mode(coherent, nsub)
    assert pm._resolve_cull_mode() == jm._resolve_cull_mode(coherent, nsub)
    assert pt._resolve_cull_mode() == (override or "argsort")
    monkeypatch.setattr(pt, "OCCL_EARLY_EXIT", 4)
    assert pt._occl_mode() == (override or "entry")
