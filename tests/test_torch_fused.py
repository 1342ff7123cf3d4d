"""Port vs JAX package: the fused whole-frame kernel K3 (kernels/fused_pallas.py).

JAX runs its Pallas kernels in interpret mode on the CPU; the port's
wrappers, given CPU tensors, run their plain PyTorch versions. Both get
the same rays (JAX's camera, as numpy), so the comparison holds the kernel
path and not the camera. Bars:
* tables: every output of `fused_tables` equal to JAX's, exactly;
* images (tests/test_fused.py:38-46): at most 0.2% of pixels differ by
  more than 1e-2 (an eps-window winner or a shadow test flipped on a
  near-tie), and the rest agree within 3e-5;
* gradients of sum(color^2) w.r.t. every float scene leaf: per leaf
  |g_port - g_jax| <= 1e-3 * max|g_jax| + 1e-6, the bar of
  tests/test_torch_render.py (sums reduced in other orders, each step off
  by ~1e-7 relative; pow(spec, ns) scales that by ns <= 128);
* the chunked-mxtile backward vs the unchunked lane-route backward: the
  same bar; against central finite differences of material leaves (the
  image is polynomial in them): 1e-2 relative + 1e-3 absolute, well above
  the float32 rounding of a loss of ~1e2 at step 1e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import trace_rays as j_trace_rays  # noqa: E402
from esctp1raytracer_tpu.kernels import fused_pallas as jf  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu_torch.accel import clusters  # noqa: E402
from esctp1raytracer_tpu_torch.core import render as pr  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas as pf  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402

CORNELL_EYE = (0.0, 1.0, 2.0)
MIXED_EYE = (0.0, 2.5, 7.0)  # BASELINE config 4's camera (scripts/bench_configs.py)


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def rays(eye, w, h):
    cam = Camera.look_at(eye, (0.0, 1.0, 0.0), vfov=60.0, aspect=w / h)
    o, d = cam.ray_grid(w, h)
    return np.array(o).reshape(-1, 3), np.array(d).reshape(-1, 3)


def j_trace(js, o, d, ids, **cfg):
    return np.asarray(j_trace_rays(jnp.asarray(o), jnp.asarray(d), js,
                                   jnp.asarray(ids, jnp.uint32), JRenderConfig(**cfg)))


def p_trace(ps, o, d, ids, **cfg):
    return pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), ps,
                         torch.from_numpy(np.asarray(ids, np.int64)), pr.RenderConfig(**cfg))


def assert_close(a, b, atol=3e-5, flip_frac=2e-3):
    diff = np.abs(a - b).max(axis=-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= flip_frac, f"{flipped.mean():.4f} pixels flipped"
    assert np.abs(a[~flipped] - b[~flipped]).max() <= atol


SCENES = {
    "cornell_g1": lambda: jb.cornell_box(pad_multiple=128),  # one chunk: the flat sweep
    "cornell": jb.cornell_box,  # 512 slots, G = 4, three all-invalid chunks
    "mixed": jb.mixed_scene,  # G = 12, 3 spheres (8 slots), smooth normals
    "mirror": lambda: jb.cornell_variant("mirror"),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_fused_tables_equal_jax(name):
    js = SCENES[name]()
    ps = to_port(js)
    names = ("tcs", "shad", "sph", "lc", "cab", "counts", "n_tris")
    for k, a, b in zip(names, jf.fused_tables(js), pf.fused_tables(ps)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert int(pf.fused_tables(ps)[-1][0]) == int(np.asarray(js.triangles.valid).sum())


def test_chunk_size_is_tied_to_clusters(monkeypatch):
    assert clusters.CLUSTER == pf.FUSED_CHUNK == jf.FUSED_CHUNK
    monkeypatch.setattr(clusters, "CLUSTER", 64)
    with pytest.raises(AssertionError, match="clusters"):
        pf.fused_tables(to_port(jb.cornell_box()))


def test_stream_and_limits_match_jax():
    for s in (0, 1, 2, 4, 4097, 3 * 1024 * 4 + 2, 2**32 - 1):
        assert pf._stream_const(s) == int(jf._stream_const(s))
    for k in ("RAYS_PER_STEP", "FUSED_TRI_LIMIT", "FUSED_CHUNK", "FUSED_DEPTH_LIMIT",
              "FUSED_SPHERE_LIMIT", "FUSED_LIGHT_FACE_LIMIT"):
        assert getattr(pf, k) == getattr(jf, k), k


FRAMES = [
    # (scene, eye, w, h, cfg overrides, ray-id shift)
    ("cornell_g1", CORNELL_EYE, 32, 24, {}, 0),
    ("cornell", CORNELL_EYE, 32, 24, {}, 0),
    ("mixed", MIXED_EYE, 32, 24, {}, 0),
    ("mirror", CORNELL_EYE, 32, 24, dict(depth=2), 0),
    ("cornell", CORNELL_EYE, 33, 17, dict(seed=3), 7),  # 561 rays, other draws
]


@pytest.mark.parametrize("name,eye,w,h,over,shift", FRAMES,
                         ids=["cornell_g1", "cornell", "mixed", "mirror_d2", "seed_shift"])
def test_fused_frame_matches_jax(name, eye, w, h, over, shift):
    js = SCENES[name]()
    ps = to_port(js)
    o, d = rays(eye, w, h)
    ids = np.arange(o.shape[0]) + shift
    a = j_trace(js, o, d, ids, backend="fused", **over)
    before = pf.fused_kernel.launches
    b = p_trace(ps, o, d, ids, backend="fused", **over).numpy()
    assert pf.fused_kernel.launches == before  # CPU tensors: the plain version
    assert b.shape == (w * h, 3) and np.isfinite(b).all() and b.sum() > 1.0
    assert_close(a, b)
    # "auto" takes the same route: the same image, bit for bit.
    c = p_trace(ps, o, d, ids, backend="auto", **over).numpy()
    np.testing.assert_array_equal(b, c)


def test_depth4_mixed_matches_jax_lane():
    """The in-kernel depth-4 unroll vs the JAX lane path's bounce loop."""
    js = jb.mixed_scene()
    ps = to_port(js)
    o, d = rays(MIXED_EYE, 32, 24)
    ids = np.arange(o.shape[0])
    a = j_trace(js, o, d, ids, backend="lane", depth=4)
    b = p_trace(ps, o, d, ids, backend="fused", depth=4).numpy()
    assert_close(a, b)
    b1 = p_trace(ps, o, d, ids, backend="fused", depth=1).numpy()
    assert np.abs(b - b1).max() > 1e-3  # the reflections add light


def test_plain_version_ignores_culled_chunks():
    """The plain version sweeps every triangle (no chunk cull) with the
    lane constants, so it renders the port's own lane route's image, to
    the image bars."""
    ps = to_port(jb.mixed_scene())
    o, d = rays(MIXED_EYE, 24, 18)
    ids = np.arange(o.shape[0])
    assert_close(p_trace(ps, o, d, ids, backend="lane").numpy(),
                 p_trace(ps, o, d, ids, backend="fused").numpy())


def _grads(js, ps, o, d, ids, depth):
    jcfg = JRenderConfig(backend="fused", depth=depth)
    jo, jd, jids = jnp.asarray(o), jnp.asarray(d), jnp.asarray(ids, jnp.uint32)

    def j_loss(params):
        c = jf.fused_trace_diff(jo, jd, j_merge_params(js, params), jids, jcfg)
        return jnp.sum(c * c), c

    (_, j_color), j_grads = jax.value_and_grad(j_loss, has_aux=True)(j_float_params(js))
    params = [p.clone().requires_grad_(True) for p in float_params(ps)]
    color = pf.fused_trace_diff(torch.from_numpy(o), torch.from_numpy(d),
                                merge_params(ps, params), torch.from_numpy(ids),
                                pr.RenderConfig(backend="fused", depth=depth))
    grads = torch.autograd.grad((color * color).sum(), params)
    return np.asarray(j_color), [np.asarray(g) for g in j_grads], color.detach().numpy(), grads


@pytest.mark.parametrize("name,eye,depth,min_nonzero", [
    ("cornell", CORNELL_EYE, 1, 6),  # no spheres, no normals: v0-2, ka, kd, ks, ke
    ("mixed", MIXED_EYE, 2, 12),
])
def test_gradients_match_jax_fused_trace_diff(name, eye, depth, min_nonzero):
    js = SCENES[name]()
    ps = to_port(js)
    o, d = rays(eye, 16, 12)
    ids = np.arange(o.shape[0])
    j_color, j_grads, p_color, p_grads = _grads(js, ps, o, d, ids, depth)
    assert_close(j_color, p_color)
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    assert len(names) == len(j_grads) == len(p_grads) == 21
    nonzero = 0
    for name_, gp, gj in zip(names, p_grads, j_grads):
        gp = gp.numpy()
        assert gp.shape == gj.shape and np.isfinite(gp).all(), name_
        tol = 1e-3 * np.abs(gj).max() + 1e-6
        assert np.abs(gp - gj).max() <= tol, (name_, np.abs(gp - gj).max(), tol)
        nonzero += bool(np.abs(gj).max() > 0)
    assert nonzero >= min_nonzero


@pytest.mark.parametrize("rays_,depth,backend,chunk", [
    (2_073_600, 4, "mxtile", 262_144),
    (262_144, 4, "lane", 0),
    (2_073_600, 1, "lane", 0),
])
def test_bwd_cfg_routing_matches_jax(rays_, depth, backend, chunk):
    js = jb.cornell_box()
    ps = to_port(js)
    a = jf._bwd_cfg(js, JRenderConfig(depth=depth), rays_)
    b = pf._bwd_cfg(ps, pr.RenderConfig(depth=depth), rays_)
    assert (a.backend, a.ray_chunk) == (b.backend, b.ray_chunk) == (backend, chunk)
    big = to_port(jb.scene_from_mesh([jb.icosphere_mesh(subdivisions=3)], pad_multiple=4608))
    assert pf._fallback_cfg(big, pr.RenderConfig()).backend == "tile"


def _mixed_loss_grads(ps, o, d, ids):
    params = [p.clone().requires_grad_(True) for p in float_params(ps)]
    cfg = pr.RenderConfig(backend="auto", depth=2)
    color = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), merge_params(ps, params),
                          torch.from_numpy(ids), cfg)
    grads = torch.autograd.grad((color * color).sum(), params)
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    return dict(zip(names, grads)), cfg


def test_chunked_mxtile_backward(monkeypatch):
    """The backward's chunked-mxtile route (config 4's: >= 1M rays at depth
    >= 2), with its thresholds shrunk to this frame: gradients equal the
    unchunked lane route's, and material leaves match central finite
    differences of the fused forward."""
    from esctp1raytracer_tpu_torch.kernels import rt_mxu

    ps = to_port(jb.mixed_scene())
    o, d = rays(MIXED_EYE, 20, 15)  # 300 rays
    ids = np.arange(o.shape[0])
    lane, cfg = _mixed_loss_grads(ps, o, d, ids)
    assert pf._bwd_cfg(ps, cfg, o.shape[0]).backend == "lane"
    monkeypatch.setattr(pf, "BWD_MIN_RAYS", 256)
    monkeypatch.setattr(pf, "BWD_RAY_CHUNK", 64)
    assert (pf._bwd_cfg(ps, cfg, o.shape[0]).backend, pf._bwd_cfg(ps, cfg, 300).ray_chunk) \
        == ("mxtile", 64)
    seen = []
    monkeypatch.setattr(rt_mxu, "mxu_tile_search",
                        _spy(rt_mxu.mxu_tile_search, seen), raising=True)
    chunked, _ = _mixed_loss_grads(ps, o, d, ids)
    # 5 chunks (4 x 64 + 44 rays) x 2 bounces, each searched by mxtile.
    assert sorted(set(seen)) == [44, 64] and len(seen) == 10
    for name, g in lane.items():
        tol = 1e-3 * float(g.abs().max()) + 1e-6
        assert float((chunked[name] - g).abs().max()) <= tol, name

    # Central finite differences through the fused forward (no gradient).
    def loss(leaf, idx, value):
        sc = ps.map(lambda n, t: t.clone() if n == leaf else t)
        getattr(getattr(sc, leaf.split(".")[0]), leaf.split(".")[1])[idx] = value
        c = pr.trace_rays(torch.from_numpy(o), torch.from_numpy(d), sc, torch.from_numpy(ids),
                          cfg)
        return float((c.double() ** 2).sum())

    h = 1e-2
    for leaf, idx in (("spheres.kd", (0, 0)), ("spheres.ks", (0, 1)),
                      ("triangles.kd", (1280, 1)), ("spheres.ka", (2, 1))):
        base = float(getattr(getattr(ps, leaf.split(".")[0]), leaf.split(".")[1])[idx])
        fd = (loss(leaf, idx, base + h) - loss(leaf, idx, base - h)) / (2 * h)
        g = float(chunked[leaf][idx])
        assert abs(g - fd) <= 1e-2 * abs(fd) + 1e-3, (leaf, g, fd)
        assert g != 0.0, leaf


def _spy(fn, seen):
    def search(o, d, tris, eps, t_limit=None):
        seen.append(o.shape[0])
        return fn(o, d, tris, eps, t_limit)

    search.occlusion = fn.occlusion
    return search


@pytest.mark.parametrize("name,eye,depth", [("cornell", CORNELL_EYE, 1), ("mixed", MIXED_EYE, 2)])
def test_plain_frame_same_without_skip(name, eye, depth, monkeypatch):
    """The plain K3 (its closest-hit sweep and its shadow sweep) gives
    identical colors with the exact division skip and without it."""
    from esctp1raytracer_tpu_torch.kernels import lane_pallas as pl

    ps = to_port(SCENES[name]())
    o, d = rays(eye, 24, 18)
    ids = torch.arange(o.shape[0])
    kw = dict(seed=0, eps=pr.RenderConfig().eps, shadow_eps=pr.RenderConfig().shadow_eps,
              depth=depth, lights=ps.lights.num_lights, faces=ps.lights.max_faces)
    tables = pf.fused_tables(ps)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    with_skip = pf._fused_plain(o, d, ids, *tables, **kw)
    monkeypatch.setattr(pl, "plane_skip", lambda det, num, eps: torch.zeros_like(det, dtype=bool))
    assert torch.equal(pf._fused_plain(o, d, ids, *tables, **kw), with_skip)
    assert with_skip.sum().item() > 1.0
