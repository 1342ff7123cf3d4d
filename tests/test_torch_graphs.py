"""Port: `utils/graphs.py`, the CUDA-graph counterpart of `jax.jit`, on the CPU.

The CPU has no graphs, so here a graphed function runs directly. These
tests hold what can be held without the card (the card's checks are in
tests/test_torch_cuda.py and `chip_smoke.py` path M):

* the cache key: a new entry for a new width, `cfg`, shape, dtype,
  `requires_grad` or debug level, none for new values;
* the CPU path: the function called directly, bit-equal to the unwrapped one;
* parity with the JAX package's jitted steps: `render` (the image bars of
  tests/test_rt_mxu.py) and `fit_scene`'s step (the bars of
  tests/test_torch_optimize.py);
* host reads: one step of every route that is captured on the card, under
  a `TorchDispatchMode` that fails on any operation reading a value to the
  host or making a tensor from host data (a CUDA graph can capture neither):
  `aten._local_scalar_dense` (`.item()`, `int(t)`), `aten.nonzero`,
  `aten.masked_select` and `aten.lift_fresh` (`torch.tensor`,
  `torch.as_tensor` of host data). The kernels' plain versions, which run
  on CPU tensors only and never on the card, are excluded: the test wraps
  each one so that the recorder ignores the operations inside it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from esctp1raytracer_tpu.core.camera import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import render as j_render  # noqa: E402
from esctp1raytracer_tpu.grad import fit_scene as j_fit_scene  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, trace_rays  # noqa: E402
from esctp1raytracer_tpu_torch.grad import fit_scene, optimize  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas, lane_pallas, rt_mxu, rt_tile  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import (  # noqa: E402
    float_params, merge_params, scene_from_numpy,
)
from esctp1raytracer_tpu_torch.utils import debug, graphs  # noqa: E402

W, H = 24, 18
VIEW = ((0.0, 2.0, 6.0), (0.0, 1.0, 0.0))


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def cam(w=W, h=H, view=VIEW):
    return Camera.look_at(*view, vfov=60.0, aspect=w / h, device="cpu")


@pytest.fixture(scope="module")
def soup():
    """A 300-triangle soup from a numpy seed, in both packages (JAX's builder)."""
    js = jb.random_scene(300, seed=3, extent=4.0)
    return js, to_port(js)


# --------------------------------------------------------------------------
# Keys and the CPU path
# --------------------------------------------------------------------------


def scaled(scene, k):
    """The scene with every float leaf times k: new values, the same shapes."""
    return scene.map(lambda _, t: t * k if t.is_floating_point() else t)


@pytest.mark.parametrize("change,new_entry", [
    ("values", False),
    ("camera values", False),
    ("width", True),
    ("height", True),
    ("cfg", True),
    ("shape", True),
    ("dtype", True),
    ("requires_grad", True),
    ("debug level", True),
])
def test_key(soup, change, new_entry):
    _, scene = soup
    base = (scene, cam(), W, H, RenderConfig())
    args = list(base)
    level = debug.current_level()
    if change == "values":
        args[0] = scaled(scene, 0.5)
    elif change == "camera values":
        args[1] = cam(view=((1.0, 3.0, 5.0), (0.0, 0.5, 0.0)))
    elif change == "width":
        args[2] = W + 8
    elif change == "height":
        args[3] = H + 8
    elif change == "cfg":
        args[4] = RenderConfig(depth=2)
    elif change == "shape":
        args[0] = builders.random_scene(600, seed=3, extent=4.0, device="cpu")  # 1,024 slots
    elif change == "dtype":
        args[1] = dataclasses.replace(args[1], origin=args[1].origin.double())
    elif change == "requires_grad":
        args[0] = merge_params(scene, [p.detach().requires_grad_(True)
                                       for p in float_params(scene)])
    want = render.key(*base)
    try:
        if change == "debug level":
            debug.set_level(debug.DEBUG if level != debug.DEBUG else debug.INFO)
        assert (render.key(*args) != want) == new_entry
    finally:
        debug.set_level(level)


def test_static_argument_keys_by_value_and_others_by_structure():
    g = graphs.graphed(lambda x, n, cfg=None: x * n, static_argnames=("n",))
    x = torch.ones(3)
    assert g.key(x, 2) == g.key(torch.zeros(3), 2)
    assert g.key(x, 2) != g.key(x, 3)
    assert g.key(x, 2) != g.key(torch.ones(4), 2)
    assert g.key(x, 2) == g.key(x, n=2, cfg=None)  # defaults and keywords bound alike
    assert g.key(x, 2, cfg=RenderConfig()) != g.key(x, 2, cfg=RenderConfig(depth=2))


def test_cpu_runs_fn_directly():
    calls = []

    def f(x, n):
        calls.append(n)
        return x * n

    g = graphs.graphed(f, static_argnames=("n",))
    x = torch.arange(5.0)
    for _ in range(3):
        assert torch.equal(g(x, 2), f(x, 2))
    with graphs.disabled():
        assert torch.equal(g(x, 3), x * 3)
    assert calls == [2, 2, 2, 2, 2, 2, 3] and not g.cache
    graphs.clear()


def test_render_on_cpu_is_bit_equal_to_the_unwrapped(soup):
    _, scene = soup
    for cfg in (RenderConfig(backend="auto"), RenderConfig(backend="mxtile", depth=2)):
        got = render(scene, cam(), W, H, cfg)
        want = render.__wrapped__(scene, cam(), W, H, cfg)
        assert torch.equal(got, want)
    assert not render.cache


# --------------------------------------------------------------------------
# Parity with the JAX package's jitted steps
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["auto", "mxtile"])
def test_render_matches_jax_jit(soup, backend):
    """tests/test_rt_mxu.py's image bars: mean |diff| < 1e-4, < 0.5% of pixel
    channels off by more than 1e-2 (the two cameras differ by a few ulp)."""
    js, ps = soup
    jc = JCamera.look_at(*VIEW, vfov=60.0, aspect=W / H)
    a = np.asarray(jax.jit(j_render, static_argnames=("width", "height", "cfg"))(
        js, jc, width=W, height=H, cfg=JRenderConfig(backend=backend)))
    b = render(ps, cam(), W, H, RenderConfig(backend=backend)).numpy()
    assert b.shape == (H, W, 3) and np.isfinite(b).all() and b.max() > 0.05
    diff = np.abs(a - b)
    assert diff.mean() < 1e-4 and (diff > 1e-2).mean() < 5e-3


PN = 16


@pytest.fixture(scope="module")
def fit_case():
    """The sphere and plane, its kd and ks halved, and JAX's target at 16x16."""
    js = jb.sphere_plane_scene()
    jc = JCamera.look_at(*VIEW, vfov=60.0, aspect=1.0)
    target = np.asarray(j_render(js, jc, PN, PN, JRenderConfig()))
    j_start = dataclasses.replace(js, spheres=dataclasses.replace(
        js.spheres, kd=js.spheres.kd * 0.5, ks=js.spheres.ks * 0.5))
    return j_start, jc, target


def test_loss_and_grad_matches_jax_jit(fit_case):
    """The graphed step's loss and gradients against `jax.jit(jax.value_and_grad)`:
    the loss within 1e-5 relative; exact zeros where JAX has them, elsewhere
    |g - g_jax| <= 1e-3 * max|g_jax| + 1e-9 (tests/test_torch_optimize.py)."""
    j_start, jc, target = fit_case
    tgt = target * np.float32(0.8)  # no pixel's residual 0 by coincidence

    @jax.jit
    def j_step(ps):
        img = j_render(j_merge_params(j_start, ps), jc, PN, PN, JRenderConfig())
        return jnp.mean((img - tgt) ** 2)

    j_loss, j_grads = jax.value_and_grad(j_step)(j_float_params(j_start))
    p_start = to_port(j_start)
    frozen = (False,) * len(float_params(p_start))
    loss, grads = optimize.loss_and_grad(p_start, torch.from_numpy(tgt), cam(PN, PN), PN, PN,
                                         RenderConfig(), frozen)
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert len(grads) == len(j_grads)
    for i, (gj, gp) in enumerate(zip(j_grads, grads)):
        gj = np.asarray(gj)
        gp = np.zeros_like(gj) if gp is None else gp.numpy()
        np.testing.assert_array_equal(gp == 0, gj == 0, err_msg=f"leaf {i}")
        assert np.abs(gp - gj).max() <= 1e-3 * np.abs(gj).max() + 1e-9, i


def test_fit_scene_steps_match_jax(fit_case):
    """Two wrapped fit_scene steps (the warm-up and, on the card, the capture)
    against JAX's: losses within 1e-4 relative, the fitted kd and ks within
    5e-5 (tests/test_torch_optimize.py)."""
    j_start, jc, target = fit_case
    names = [n for n, t in to_port(j_start).leaves() if t.is_floating_point()]
    fit = [i for i, n in enumerate(names) if n in ("spheres.kd", "spheres.ks")]
    j_result = j_fit_scene(j_start, target, jc, steps=2, lr=0.05, cfg=JRenderConfig(),
                           log_every=0, param_filter=lambda i, p: i in fit)
    result = fit_scene(to_port(j_start), torch.tensor(target), cam(PN, PN), steps=2,
                       lr=0.05, cfg=RenderConfig(), log_every=0,
                       param_filter=lambda i, p: i in fit)
    np.testing.assert_allclose(result.losses, j_result.losses, rtol=1e-4)
    for field in ("kd", "ks"):
        np.testing.assert_allclose(getattr(result.scene.spheres, field).numpy(),
                                   np.asarray(getattr(j_result.scene.spheres, field)), atol=5e-5)


# --------------------------------------------------------------------------
# Host reads on every captured route
# --------------------------------------------------------------------------

HOST_READS = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
              "aten.lift_fresh"}
# Each wrapper's plain version (CPU tensors only), by module.
PLAIN = [(rt_mxu, "_mxu_search_plain"), (rt_mxu, "_mxu_occl_plain"),
         (rt_tile, "_tile_search_plain"), (rt_tile, "_tile_occl_plain"),
         (lane_pallas, "_lane_plain"), (fused_pallas, "_fused_plain"),
         (fused_pallas, "_fused_tables_plain")]


class HostReads(TorchDispatchMode):
    """Records every operation that reads the host or makes a tensor from
    host data, outside the kernels' plain versions; counts the plain calls."""

    def __init__(self):
        super().__init__()
        self.found, self.plain_calls, self.inside_plain = [], 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in HOST_READS and not self.inside_plain:
            self.found.append(name)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_reads(monkeypatch):
    mode = HostReads()
    for mod, name in PLAIN:
        real = getattr(mod, name)

        def plain(*a, _real=real, **kw):
            mode.plain_calls += 1
            mode.inside_plain += 1
            try:
                return _real(*a, **kw)
            finally:
                mode.inside_plain -= 1

        monkeypatch.setattr(mod, name, plain)
    return mode


def test_the_recorder_sees_host_reads(host_reads):
    x = torch.arange(4.0)
    with host_reads:
        int(x.max())
        torch.nonzero(x)
        torch.masked_select(x, x > 1.0)
        torch.as_tensor(0.5)
    assert set(host_reads.found) == HOST_READS


def bench_meshes_small():
    return builders.scene_from_mesh([
        builders.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        builders.icosphere_mesh(subdivisions=2, radius=1.0, center=(1.3, 1.0, 0.0),
                                smooth=False),
        builders._ground_plane(),
        builders._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ], device="cpu")


def fwd_bwd(scene, camera, cfg):
    """One step as the graphed entry points run it, on rays and ids made
    beforehand: the frame, sum(color^2) and its gradients with respect to
    every float leaf."""
    o, d = (x.reshape(-1, 3) for x in camera.ray_grid(W, H))
    ids = torch.arange(o.shape[0], dtype=torch.int64) + 7 * o.shape[0]
    params = [p.detach().requires_grad_(True) for p in float_params(scene)]

    def step():
        color = trace_rays(o, d, merge_params(scene, params), ids, cfg)
        return torch.autograd.grad(torch.sum(color * color), params, allow_unused=True)

    return step


def fit_step(scene):
    target, camera = torch.full((H, W, 3), 0.25), cam()
    frozen = (False,) * len(float_params(scene))
    return lambda: optimize.loss_and_grad(scene, target, camera, W, H,
                                          RenderConfig(backend="auto"), frozen)


CORNELL_VIEW = ((0.0, 1.0, 2.0), (0.0, 1.0, 0.0))
# Each route's step, its inputs made outside the recorder (the scene builders
# and the camera make their tables from host data).
ROUTES = {
    "mxtile": lambda: fwd_bwd(bench_meshes_small(), cam(), RenderConfig(backend="mxtile")),
    "tile": lambda: fwd_bwd(bench_meshes_small(), cam(), RenderConfig(backend="tile")),
    "lane": lambda: fwd_bwd(bench_meshes_small(), cam(), RenderConfig(backend="lane")),
    "fused, lane re-derivation": lambda: fwd_bwd(
        builders.cornell_box(device="cpu"), cam(view=CORNELL_VIEW), RenderConfig(backend="auto")),
    "fused depth 3, chunked mxtile re-derivation": lambda: fwd_bwd(
        builders.cornell_box(device="cpu"), cam(view=CORNELL_VIEW),
        RenderConfig(backend="auto", depth=3)),
    "render": lambda: (lambda scene, camera: lambda: render(
        scene, camera, W, H, RenderConfig(backend="auto")))(bench_meshes_small(), cam()),
    "fit step": lambda: fit_step(bench_meshes_small()),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_host_reads_on_captured_routes(route, host_reads, monkeypatch):
    if "chunked" in route:  # the 2M-ray rule of the fused backward, at this size
        monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
        monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", 128)
    step = ROUTES[route]()
    with torch.no_grad() if route == "render" else torch.enable_grad(), host_reads:
        step()
    assert host_reads.plain_calls > 0, "the route ran no kernel wrapper"
    assert not host_reads.found, f"{route}: host reads {sorted(set(host_reads.found))}"
