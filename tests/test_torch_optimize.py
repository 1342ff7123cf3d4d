"""Port vs JAX package: inverse rendering (`grad/optimize.py`) and the
checkpoint file (`utils/checkpoint.py`).

The first two classes mirror tests/test_optimize.py on the port alone;
the rest hold the port against the JAX package on the same scene:

* one step's gradients of every float leaf toward a dimmed target: exactly
  zero where JAX's are, elsewhere |g_port - g_jax| <= 1e-3 * max|g_jax| +
  1e-9 (the bar of tests/test_torch_render.py);
* `fit_scene` for 5 steps at 16x16, fitting the sphere's kd and ks: the
  losses within 1e-4 relative, the fitted leaves within 5e-5. The two
  packages' camera rays differ by up to a few ulp (XLA contracts FMAs),
  which moves shaded pixels by up to ~1.2e-5 and the losses by ~3e-5
  relative; the fit moves the leaves by ~0.2. The parity fits only
  materials, as the JAX package's own tests do. Toward JAX's own render
  of the true scene, JAX's residual is exactly 0 on every pixel the
  perturbation leaves alone (the ground plane), and so are the plane's
  gradients; the port's rays, a few ulp off, leave residuals of ~1e-8
  there and plane gradients of ~1e-10. Adam divides each gradient by its
  own running magnitude and turns those into full `lr` steps: fitting
  every leaf, the two trajectories part after two steps;
* Adam's update: within 2 ulp of JAX's (the bias corrections' float32
  pow may round differently), the step counter equal;
* a checkpoint written by either package loads in the other, key for
  key and bit for bit, Adam t, m and v included, and resumes there.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from esctp1raytracer_tpu import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu import render as j_render  # noqa: E402
from esctp1raytracer_tpu import sphere_plane_scene as j_sphere_plane_scene  # noqa: E402
from esctp1raytracer_tpu.grad import adam_init as j_adam_init  # noqa: E402
from esctp1raytracer_tpu.grad import adam_update as j_adam_update  # noqa: E402
from esctp1raytracer_tpu.grad import fit_scene as j_fit_scene  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu.utils.checkpoint import load_checkpoint as j_load  # noqa: E402
from esctp1raytracer_tpu_torch import Camera, RenderConfig, render, sphere_plane_scene  # noqa: E402
from esctp1raytracer_tpu_torch.grad import adam_init, adam_update, fit_scene  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import (  # noqa: E402
    SphereBuffer, float_params, merge_params, scene_from_numpy, scene_to_numpy,
)
from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from test_torch_cuda import adam_leaves  # noqa: E402

CAM = Camera.look_at((0, 2, 6), (0, 1, 0), aspect=1.0, device="cpu")
J_CAM = JCamera.look_at((0, 2, 6), (0, 1, 0), aspect=1.0)
CFG = RenderConfig()
N = 32
PN = 16  # parity frames


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def perturbed(scene, kd=0.4, ks=1.0):
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, kd=scene.spheres.kd * kd, ks=scene.spheres.ks * ks))


def materials(scene):
    """param_filter: fit the sphere's kd and ks, freeze the rest (by identity)."""
    return lambda i, p: p is scene.spheres.kd or p is scene.spheres.ks


# The float-leaf indices of spheres.kd and spheres.ks: a filter by index
# holds in both packages on resume (the JAX package filters the loaded
# leaves, which an identity test never matches).
KD_KS = [i for i, (name, t) in enumerate(
    (n, t) for n, t in sphere_plane_scene(device="cpu").leaves() if t.is_floating_point())
    if name in ("spheres.kd", "spheres.ks")]


def by_index(i, p):
    return i in KD_KS


@pytest.fixture(scope="module")
def scene():
    return sphere_plane_scene(device="cpu")


@pytest.fixture(scope="module")
def target(scene):
    return render(scene, CAM, N, N, CFG)


class TestCheckpoint:
    def test_roundtrip(self, scene, tmp_path):
        path = str(tmp_path / "ck.npz")
        save_checkpoint(path, scene, step=7, extra={"lr": np.float32(0.1),
                                                    "t": torch.tensor(3, dtype=torch.int32)})
        restored, step, extra = load_checkpoint(path, scene)
        assert step == 7
        assert float(extra["lr"]) == pytest.approx(0.1)
        assert extra["t"].dtype == np.int32 and int(extra["t"]) == 3
        for (name, a), (_, b) in zip(scene.leaves(), restored.leaves()):
            assert a.dtype == b.dtype and a.device == b.device, name
            assert torch.equal(a, b), name
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    def test_shape_mismatch_rejected(self, scene, tmp_path):
        path = str(tmp_path / "ck.npz")
        save_checkpoint(path, scene)
        other = dataclasses.replace(scene, spheres=SphereBuffer.empty(16, device="cpu"))
        with pytest.raises(ValueError):
            load_checkpoint(path, other)

    def test_missing_file_raises(self, scene, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_checkpoint(str(tmp_path / "nope.npz"), scene)

    @pytest.mark.parametrize("key,value,match", [("__version__", 2, "version"),
                                                 ("__num_leaves__", 3, "leaves")])
    def test_version_and_structure_rejected(self, scene, tmp_path, key, value, match):
        path = str(tmp_path / "ck.npz")
        save_checkpoint(path, scene)
        with np.load(path) as data:
            payload = dict(data)
        payload[key] = np.int64(value)
        np.savez_compressed(path, **payload)
        with pytest.raises(ValueError, match=match):
            load_checkpoint(path, scene)


class TestFit:
    def test_recovers_material(self, scene, target):
        start = perturbed(scene)
        result = fit_scene(
            start, target, CAM, steps=60, lr=0.08, cfg=CFG, log_every=0,
            # fit only the sphere diffuse color; freeze everything else
            param_filter=lambda i, p: p is start.spheres.kd,
        )
        assert result.losses[-1] < result.losses[0] * 0.25
        got = result.scene.spheres.kd[0].numpy()
        want = scene.spheres.kd[0].numpy()
        first = start.spheres.kd[0].numpy()
        assert np.abs(got - want).max() < np.abs(first - want).max() * 0.25

    def test_param_filter_freezes(self, scene, target):
        start = perturbed(scene)
        result = fit_scene(start, target, CAM, steps=3, lr=0.05, cfg=CFG, log_every=0,
                           param_filter=lambda i, p: False)  # everything frozen
        for (name, a), (_, b) in zip(start.leaves(), result.scene.leaves()):
            assert torch.equal(a, b), name

    def test_checkpoint_resume(self, scene, target, tmp_path):
        path = str(tmp_path / "fit.npz")
        start = perturbed(scene, kd=0.5)
        fit_scene(start, target, CAM, steps=4, lr=0.05, cfg=CFG,
                  checkpoint_path=path, checkpoint_every=2, log_every=0)
        assert os.path.exists(path)
        _, step, _ = load_checkpoint(path, start)
        assert step == 4
        # Resuming starts from the saved step.
        result = fit_scene(start, target, CAM, steps=6, lr=0.05, cfg=CFG,
                           checkpoint_path=path, checkpoint_every=10, log_every=0)
        assert result.steps == 2

    def test_resume_equals_uninterrupted(self, scene, target, tmp_path):
        """Stopping at a checkpoint and resuming takes the same steps as one run:
        the Adam moments and the step counter come back with the scene."""
        start = perturbed(scene, kd=0.5, ks=0.5)
        kw = dict(lr=0.05, cfg=CFG, log_every=0, param_filter=materials(start))
        whole = fit_scene(start, target, CAM, steps=4, **kw)
        path = str(tmp_path / "fit.npz")
        fit_scene(start, target, CAM, steps=2, checkpoint_path=path, **kw)
        rest = fit_scene(start, target, CAM, steps=4, checkpoint_path=path, **kw)
        assert rest.steps == 2 and rest.losses == whole.losses[2:]
        for (name, a), (_, b) in zip(whole.scene.leaves(), rest.scene.leaves()):
            assert torch.equal(a, b), name


# --------------------------------------------------------------------------
# Parity with the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def j_scene():
    return j_sphere_plane_scene()


@pytest.fixture(scope="module", params=["jnp", "auto"])
def parity(request, j_scene):
    """(backend, JAX target, JAX start, port start, JAX 5-step fit)."""
    backend = request.param
    target = j_render(j_scene, J_CAM, PN, PN, JRenderConfig(backend=backend))
    j_start = perturbed(j_scene, kd=0.5, ks=0.3)
    j_result = j_fit_scene(j_start, target, J_CAM, steps=5, lr=0.05,
                           cfg=JRenderConfig(backend=backend), log_every=0,
                           param_filter=by_index)
    return backend, target, j_start, to_port(j_start), j_result


def assert_fits_agree(j_losses, j_scene_out, p_losses, p_scene_out):
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-4)
    for field in ("kd", "ks"):
        np.testing.assert_allclose(getattr(p_scene_out.spheres, field).numpy(),
                                   np.asarray(getattr(j_scene_out.spheres, field)), atol=5e-5)


def test_fit_scene_matches_jax(parity):
    backend, target, _, p_start, j_result = parity
    result = fit_scene(p_start, torch.tensor(np.asarray(target)), CAM, steps=5, lr=0.05,
                       cfg=RenderConfig(backend=backend), log_every=0,
                       param_filter=by_index)
    assert result.steps == 5 and result.losses[-1] < result.losses[0] * 0.5
    assert_fits_agree(j_result.losses, j_result.scene, result.losses, result.scene)


def test_gradients_zero_where_jax_zero(parity):
    """Every float leaf's gradient, one step: exact zeros where JAX has them.
    The target is dimmed so that no pixel's residual is 0 by coincidence."""
    backend, target, j_start, p_start, _ = parity
    tgt = np.asarray(target) * np.float32(0.8)
    cfg = JRenderConfig(backend=backend)

    def j_loss(ps):
        return jnp.mean((j_render(j_merge_params(j_start, ps), J_CAM, PN, PN, cfg) - tgt) ** 2)

    j_grads = jax.grad(j_loss)(j_float_params(j_start))
    ps = [p.detach().requires_grad_(True) for p in float_params(p_start)]
    img = render(merge_params(p_start, ps), CAM, PN, PN, RenderConfig(backend=backend))
    p_grads = torch.autograd.grad(torch.mean((img - torch.from_numpy(tgt)) ** 2), ps,
                                  allow_unused=True)
    assert len(p_grads) == len(j_grads)
    for i, (gj, gp) in enumerate(zip(j_grads, p_grads)):
        gj = np.asarray(gj)
        gp = np.zeros_like(gj) if gp is None else gp.numpy()
        np.testing.assert_array_equal(gp == 0, gj == 0, err_msg=f"leaf {i}")
        assert np.abs(gp - gj).max() <= 1e-3 * np.abs(gj).max() + 1e-9, i


def test_adam_update_matches_jax():
    rng = np.random.default_rng(0)
    shapes = [(7, 3), (5,), ()]
    params = [np.asarray(rng.standard_normal(s), np.float32) for s in shapes]
    j_p, j_state = [jnp.asarray(p) for p in params], j_adam_init([jnp.asarray(p) for p in params])
    p_p, p_state = [torch.from_numpy(p) for p in params], adam_init(
        [torch.from_numpy(p) for p in params])
    for _ in range(3):
        grads = [np.asarray(rng.standard_normal(s) * 1e-2, np.float32) for s in shapes]
        j_p, j_state = j_adam_update(j_p, [jnp.asarray(g) for g in grads], j_state, lr=0.05)
        p_p, p_state = adam_update(p_p, [torch.from_numpy(g) for g in grads], p_state, lr=0.05)
        assert int(p_state["t"]) == int(j_state["t"]) and p_state["t"].dtype == torch.int32
        for a, b in zip(p_p + p_state["m"] + p_state["v"],
                        j_p + j_state["m"] + j_state["v"]):
            np.testing.assert_array_max_ulp(a.numpy(), np.asarray(b), maxulp=2)


def _eager_adam(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The update's tensor operations as adam_update ran them before the kernel."""
    t = state["t"] + 1
    m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], grads)]
    v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], grads)]
    tf = t.to(torch.float32)
    c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf
    mhat = [m_ / c1 for m_ in m]
    vhat = [v_ / c2 for v_ in v]
    new_params = [p - lr * mh / (torch.sqrt(vh) + eps) for p, mh, vh in zip(params, mhat, vhat)]
    return new_params, {"m": m, "v": v, "t": t}


@pytest.mark.parametrize("lr", [0.05, 1e-2])
def test_adam_update_on_the_cpu_takes_the_tensor_ops(scene, monkeypatch, lr):
    """CPU leaves never reach the kernel (no launch counted, the kernel path not
    called) and stay bit-equal to the tensor operations, five steps running, on
    the scene's 21 leaves plus one element, a 0-d leaf and an empty one."""
    from esctp1raytracer_tpu_torch.kernels import adam

    def refused(*a, **kw):
        raise AssertionError("the kernel path ran on CPU tensors")

    monkeypatch.setattr(adam, "_adam_kernel", refused)
    rng = np.random.default_rng(7)
    odd = adam_leaves([(1,), (), (0, 3)], rng, "cpu")
    params = [p.clone() for p in float_params(scene)] + odd
    shapes = [tuple(p.shape) for p in params]
    assert len(shapes) == 24
    state = ref_state = adam_init(params)
    ref = params
    before = adam.adam_step.launches
    for _ in range(5):
        grads = adam_leaves(shapes, rng, "cpu")
        params, state = adam_update(params, grads, state, lr=lr)
        ref, ref_state = _eager_adam(ref, grads, ref_state, lr)
        assert torch.equal(state["t"], ref_state["t"]) and state["t"].dtype == torch.int32
        for a, b in zip(params + state["m"] + state["v"], ref + ref_state["m"] + ref_state["v"]):
            assert a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert adam.adam_step.launches == before


class _Built(Exception):
    pass


@pytest.mark.parametrize("odd, raised, match", [
    ("strided", _Built, None), ("float64", ValueError, "g0: want torch.float32"),
    ("shape", ValueError, r"g1: want torch.float32 \(5,\)"), ("leaves", ValueError, "1 to 32")])
def test_adam_kernel_path_checks_its_leaves(monkeypatch, odd, raised, match):
    """The kernel's wrapper checks its leaves before it builds or launches
    anything: strided ones are made contiguous and pass; a leaf not float32
    or not of its parameter's shape, or more leaves than one launch takes,
    raises (on the card there is no second path). Held here on CPU tensors,
    the build replaced by a marker."""
    from esctp1raytracer_tpu_torch.kernels import adam

    def built():
        raise _Built

    monkeypatch.setattr(adam, "_lib", built)
    shapes = [(8, 3), (5,)] * (adam.MAX_LEAVES // 2 + 1 if odd == "leaves" else 1)
    params = adam_leaves(shapes, np.random.default_rng(3), "cpu")
    grads = adam_leaves(shapes, np.random.default_rng(4), "cpu")
    if odd == "strided":
        table = adam_leaves([(8, 32), (5, 4)], np.random.default_rng(5), "cpu")
        grads = [table[0][:, 3:6], table[1][:, 2]]
    elif odd == "float64":
        grads[0] = grads[0].double()
    elif odd == "shape":
        grads[1] = grads[1][None]
    m, v = [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params]
    c = torch.tensor(0.5)
    with pytest.raises(raised, match=match):
        adam._adam_kernel(params, grads, m, v, 0.01, 0.9, 0.999, 1e-8, c, c)


def test_adam_outputs_are_views_of_one_buffer(scene):
    """The kernel's outputs: three new tensors per leaf (p, then m, then v),
    each shaped as its leaf, contiguous views of one buffer that they tile
    without overlap, the odd leaves (one element, 0-d, empty) included."""
    from esctp1raytracer_tpu_torch.kernels import adam

    params = float_params(scene) + [torch.zeros(1), torch.zeros(()), torch.zeros((0, 3))]
    outs = adam._outputs(params)
    n = len(params)
    assert len(outs) == 3 * n
    for i, t in enumerate(outs):
        assert t.shape == params[i % n].shape and t.dtype == torch.float32 and t.is_contiguous()
    (base,) = {t.untyped_storage().data_ptr() for t in outs}
    spans = sorted((t.storage_offset(), t.storage_offset() + t.numel()) for t in outs if t.numel())
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    total = 3 * sum(p.numel() for p in params)
    assert spans[-1][1] == total == outs[0].untyped_storage().nbytes() // 4
    assert base not in {p.untyped_storage().data_ptr() for p in params}


def test_adam_inverse_is_float32_division():
    """The kernel's 1/c1 and 1/c2 are float32 reciprocals of the host's bias
    corrections, as PyTorch takes a CPU scalar divisor's on the card."""
    from esctp1raytracer_tpu_torch.kernels import adam

    for t in (1, 2, 3, 7, 100, 1000, 65_536):
        tf = torch.tensor(t, dtype=torch.int32).to(torch.float32)
        for b in (0.9, 0.999):
            c = 1 - b ** tf
            assert adam._inverse(c) == float(torch.ones((), dtype=torch.float32) / c)


def same_checkpoint_files(a, b):
    """Two checkpoints with the same keys, dtypes and values."""
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.files) == sorted(y.files)
        for key in x.files:
            assert x[key].dtype == y[key].dtype, key
            np.testing.assert_array_equal(x[key], y[key], err_msg=key)


def test_jax_checkpoint_resumes_in_port(parity, tmp_path):
    backend, target, j_start, p_start, j_result = parity
    kw = dict(lr=0.05, log_every=0)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_fit_scene(j_start, target, J_CAM, steps=2, cfg=JRenderConfig(backend=backend),
                checkpoint_path=j_path, param_filter=by_index, **kw)
    # The scene arrives bit for bit, on the template's device and dtypes.
    loaded, step, extra = load_checkpoint(j_path, p_start)
    j_loaded, _, _ = j_load(j_path, j_start)
    assert step == 2 and int(extra["adam_t"]) == 2
    for (name, a), b in zip(loaded.leaves(), jax.tree.leaves(j_loaded)):
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype)), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # Resuming at its own step runs nothing and writes the restored Adam
    # state back: the same file, t, m and v included.
    shutil.copy(j_path, p_path)
    cfg = RenderConfig(backend=backend)
    assert fit_scene(p_start, torch.tensor(np.asarray(target)), CAM, steps=2, cfg=cfg,
                     checkpoint_path=p_path, param_filter=by_index,
                     **kw).steps == 0
    same_checkpoint_files(p_path, j_path)
    rest = fit_scene(p_start, torch.tensor(np.asarray(target)), CAM, steps=5, cfg=cfg,
                     checkpoint_path=p_path, param_filter=by_index, **kw)
    assert rest.steps == 3
    assert_fits_agree(j_result.losses[2:], j_result.scene, rest.losses, rest.scene)


def test_port_checkpoint_resumes_in_jax(parity, tmp_path):
    backend, target, j_start, p_start, j_result = parity
    kw = dict(lr=0.05, log_every=0)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    tgt = torch.tensor(np.asarray(target))
    p_result = fit_scene(p_start, tgt, CAM, steps=2, cfg=RenderConfig(backend=backend),
                         checkpoint_path=p_path, param_filter=by_index, **kw)
    j_loaded, step, extra = j_load(p_path, j_start)
    assert step == 2 and extra["adam_t"].dtype == np.int32 and int(extra["adam_t"]) == 2
    for (name, a), b in zip(p_result.scene.leaves(), jax.tree.leaves(j_loaded)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=name)
    shutil.copy(p_path, j_path)
    cfg = JRenderConfig(backend=backend)
    assert j_fit_scene(j_start, target, J_CAM, steps=2, cfg=cfg, checkpoint_path=j_path,
                       param_filter=by_index, **kw).steps == 0
    same_checkpoint_files(j_path, p_path)
    rest = j_fit_scene(j_start, target, J_CAM, steps=5, cfg=cfg, checkpoint_path=j_path,
                       param_filter=by_index, **kw)
    assert rest.steps == 3
    whole = fit_scene(p_start, tgt, CAM, steps=5, cfg=RenderConfig(backend=backend),
                      param_filter=by_index, **kw)
    assert_fits_agree(rest.losses, rest.scene, whole.losses[2:], whole.scene)


def test_scene_to_numpy_matches_checkpoint_leaves(scene, tmp_path):
    """The checkpoint's leaf_{i} are scene_to_numpy's arrays in leaf order."""
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, scene, step=1)
    arrays = scene_to_numpy(scene)
    with np.load(path) as data:
        assert int(data["__num_leaves__"]) == len(arrays)
        for i, name in enumerate(arrays):
            np.testing.assert_array_equal(data[f"leaf_{i}"], arrays[name], err_msg=name)
