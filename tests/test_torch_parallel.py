"""Port vs JAX package: the sharded renderer and trainer (`parallel/`).

Mirrors tests/test_sharding.py and tests/test_distributed.py. The port's
ranks are real processes: this file is its own worker (see the bottom),
spawned as a gloo group on the CPU through `init_distributed` with the
environment `torchrun` sets; rank 0 writes its results as npz, and the
parent test holds them against the JAX package's sharded functions on
its virtual CPU devices and against the port's unsharded ones. Its
"dryrun" scenario (`entry_torch.dryrun_multichip`) serves
tests/test_torch_entry.py.

Bars: images, tests/test_sharding.py's `assert_images_match` (at most
0.5% of pixels off by more than 1e-3, the median within 1e-5: the two
packages' camera rays differ by a few ulp, which can flip hits sitting
on the eps window); the sharded loss within 1e-5 relative and the
gradients within rtol 1e-3, atol 1e-5 (tests/test_sharding.py:120-122);
through the fused route, whose backward takes the lane route, its
:150-155 bars (atol 3e-4 of the leaf's scale, rtol 3e-3). The rays
split on the port's own `jnp` route traces each ray exactly as the
unsharded call does: its image is equal bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import torch.distributed as dist  # noqa: E402

from esctp1raytracer_tpu_torch import (  # noqa: E402
    Camera, RenderConfig, cornell_box, render, sphere_plane_scene,
)
from esctp1raytracer_tpu_torch.grad import fit_scene  # noqa: E402
from esctp1raytracer_tpu_torch.parallel import (  # noqa: E402
    float_params, init_distributed, loss_and_grad_sharded, make_mesh, merge_params,
    render_sharded, train_step_sharded,
)
from esctp1raytracer_tpu_torch.parallel import distributed, sharding  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL_EYE = ((0, 1, 2), (0, 1, 0))
SPHERE_EYE = ((0, 2, 6), (0, 1, 0))
CHILD_TIMEOUT = 180
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")


def cam(eye):
    return Camera.look_at(*eye, aspect=1.0, device="cpu")


def grid_target():
    """A target both packages see bit for bit: uniform in [0, 0.5), seed 0."""
    return np.random.default_rng(0).uniform(0.0, 0.5, (32, 32, 3)).astype(np.float32)


def perturbed(scene):
    import dataclasses

    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, kd=scene.spheres.kd * 0.5, ks=scene.spheres.ks * 0.5))


def materials(scene):
    return lambda i, p: p is scene.spheres.kd or p is scene.spheres.ks


def assert_images_match(a, b, flip_frac=0.005):
    diff = np.abs(a - b).max(-1)
    assert (diff > 1e-3).mean() < flip_frac, f"{(diff > 1e-3).mean():.4f} flipped"
    assert np.median(diff) < 1e-5


def assert_grads_match(loss_a, grads_a, loss_b, grads_b, rtol=1e-3, atol=1e-5):
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-5)
    assert len(grads_a) == len(grads_b)
    for i, (ga, gb) in enumerate(zip(grads_a, grads_b)):
        np.testing.assert_allclose(np.asarray(ga), np.asarray(gb), rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


def assert_fused_grads_match(loss_a, grads_a, loss_b, grads_b):
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-5)
    for i, (ga, gb) in enumerate(zip(grads_a, grads_b)):
        ga, gb = np.asarray(ga), np.asarray(gb)
        scale = max(np.abs(gb).max(), 1e-6)
        np.testing.assert_allclose(ga, gb, atol=3e-4 * scale, rtol=3e-3, err_msg=f"leaf {i}")


def unsharded_loss_and_grad(scene, target, camera, cfg):
    """mean((render - target)^2) and its gradients, single device."""
    params = [p.detach().requires_grad_(True) for p in float_params(scene)]
    h, w = target.shape[:2]
    loss = torch.mean((render(merge_params(scene, params), camera, w, h, cfg) - target) ** 2)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(params, grads)]


def grads_npz(prefix, loss, grads):
    out = {f"{prefix}_loss": loss.detach().numpy()}
    out.update({f"{prefix}_g{i}": g.numpy() for i, g in enumerate(grads)})
    return out


def grads_of(res, prefix):
    n = len([k for k in res if k.startswith(f"{prefix}_g")])
    return res[f"{prefix}_loss"], [res[f"{prefix}_g{i}"] for i in range(n)]


# --------------------------------------------------------------------------
# The worker: one rank of a spawned gloo group
# --------------------------------------------------------------------------


def work_rays4(mesh, out_dir):
    """rays = 4 on Cornell: the jnp image, a ray count not divisible by 4,
    and the fused route ("auto") forward and loss/gradients."""
    corn, c = cornell_box(device="cpu"), cam(CORNELL_EYE)
    out = {
        "jnp": render_sharded(corn, c, 32, 32, RenderConfig(), mesh).numpy(),
        "pad": render_sharded(corn, c, 30, 25, RenderConfig(), mesh).numpy(),
        "auto": render_sharded(corn, c, 32, 32, RenderConfig(backend="auto"), mesh).numpy(),
    }
    loss, grads = loss_and_grad_sharded(corn, torch.zeros((16, 16, 3)), c,
                                        RenderConfig(backend="auto"), mesh)
    out.update(grads_npz("auto", loss, grads))
    return out


def work_grid(mesh, out_dir):
    """rays = 2 x prims = 2: the Cornell image (jnp, and "fused", which
    falls back with the prims search injected) and the sphere-plane
    loss/gradients on the jnp and mxu routes."""
    corn, c = cornell_box(device="cpu"), cam(CORNELL_EYE)
    out = {
        "jnp": render_sharded(corn, c, 32, 32, RenderConfig(), mesh).numpy(),
        "fused": render_sharded(corn, c, 32, 32, RenderConfig(backend="fused"), mesh).numpy(),
    }
    scene, target = sphere_plane_scene(device="cpu"), torch.from_numpy(grid_target())
    for backend in ("jnp", "mxu"):
        loss, grads = loss_and_grad_sharded(scene, target, cam(SPHERE_EYE),
                                            RenderConfig(backend=backend), mesh)
        out.update(grads_npz(backend, loss, grads))
    return out


def work_train2(mesh, out_dir):
    """rays = 2: one train_step_sharded, and fit_scene over the mesh with a
    checkpoint (written by rank 0 alone)."""
    scene, s = sphere_plane_scene(device="cpu"), cam(SPHERE_EYE)
    new, loss = train_step_sharded(scene, torch.zeros((8, 8, 3)), s, lr=1e-3,
                                   cfg=RenderConfig(backend="jnp"), mesh=mesh)
    moved = any(not torch.equal(a, b) for (_, a), (_, b) in zip(scene.leaves(), new.leaves()))
    start, target = perturbed(scene), render(scene, s, 16, 16, RenderConfig())
    fit = fit_scene(start, target, s, steps=3, lr=0.05, mesh=mesh, log_every=0,
                    param_filter=materials(start), checkpoint_every=2,
                    checkpoint_path=os.path.join(out_dir, "fit.npz"))
    return {"loss": loss.numpy(), "moved": np.asarray(moved),
            "fit_losses": np.asarray(fit.losses), "fit_steps": np.asarray(fit.steps),
            "fit_kd": fit.scene.spheres.kd.numpy(), "fit_ks": fit.scene.spheres.ks.numpy()}


def work_dryrun(mesh, out_dir):
    """entry_torch.dryrun_multichip on the world's ranks (it makes its own
    meshes): each backend's loss and its updated scene's float leaves."""
    import entry_torch

    out = {}
    for backend, res in entry_torch.dryrun_multichip(mesh.devices.size, device="cpu").items():
        out[f"{backend}_loss"] = np.float32(res["loss"])
        out[f"{backend}_launched"] = np.int64(sum(res["launches"].values()))
        out.update({f"{backend}_p{i}": p.numpy() for i, p in enumerate(float_params(res["scene"]))})
    return out


WORK = {"rays4": (work_rays4, dict(rays=4)), "grid": (work_grid, dict(rays=2, prims=2)),
        "train2": (work_train2, dict(rays=2)), "dryrun": (work_dryrun, dict())}


def worker(scenario, out_dir):
    """Join the group from the torchrun-style environment, run, write npz."""
    world = init_distributed()
    assert world == int(os.environ["WORLD_SIZE"]) and dist.get_backend() == "gloo"
    fn, shape = WORK[scenario]
    try:
        out = fn(make_mesh(**shape), out_dir)
        np.savez(os.path.join(out_dir, f"{scenario}_rank{dist.get_rank()}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(scenario, world, out_dir):
    """Run `scenario` on `world` gloo ranks; every rank's npz, by rank."""
    port = _free_port()
    procs = []
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                       PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), scenario, str(out_dir)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                cwd=REPO))
        outs = [p.communicate(timeout=CHILD_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} of {scenario} failed:\n{out[-4000:]}"
    return [dict(np.load(os.path.join(out_dir, f"{scenario}_rank{r}.npz")))
            for r in range(world)]


# --------------------------------------------------------------------------
# One process, no process group
# --------------------------------------------------------------------------


@pytest.fixture
def no_torchrun_env(monkeypatch):
    for key in TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)


def test_no_process_group_is_a_one_rank_mesh(no_torchrun_env):
    assert init_distributed() == 1 and not dist.is_initialized()
    mesh = make_mesh()
    assert mesh.devices.size == 1 and mesh.shape == {"rays": 1, "prims": 1}
    assert mesh.groups == {"rays": None, "prims": None} and mesh.rank == 0
    x = torch.arange(3.0)
    assert mesh.all_reduce(x, "rays") is x and x.tolist() == [0.0, 1.0, 2.0]


@pytest.mark.parametrize("rays,prims", [(3, 3), (2, 1), (None, 2)])
def test_bad_factorization_raises(no_torchrun_env, rays, prims):
    with pytest.raises(ValueError):
        make_mesh(rays=rays, prims=prims)


def test_mesh_ranks_must_be_the_world(no_torchrun_env):
    with pytest.raises(ValueError):
        make_mesh(devices=[1])


@pytest.mark.parametrize("available,count,local_world,want", [
    (False, 0, 1, "gloo"),  # the CPU
    (True, 1, 1, "nccl"),  # one rank, one card
    (True, 1, 2, "gloo"),  # two ranks share one card
    (True, 4, 4, "nccl"),  # a card each
])
def test_backend_rule(monkeypatch, available, count, local_world, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert distributed.choose_backend(local_world) == want


def test_prims_capacity_not_divisible_raises():
    mesh = sharding.Mesh(devices=np.zeros((1, 3), np.int64), rank=0,
                         coords={"rays": 0, "prims": 0}, groups={"rays": None, "prims": None})
    corn = cornell_box(device="cpu")
    search = sharding._prim_sharded_search(RenderConfig(), mesh)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    with pytest.raises(ValueError, match="not divisible"):
        search(o, d, corn.triangles, 1e-7)


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_one_rank_sharded_equals_unsharded(no_torchrun_env, backend):
    corn, c, cfg = cornell_box(device="cpu"), cam(CORNELL_EYE), RenderConfig(backend=backend)
    assert torch.equal(render_sharded(corn, c, 20, 15, cfg), render(corn, c, 20, 15, cfg))
    target = torch.from_numpy(grid_target())[:15, :20]
    loss, grads = loss_and_grad_sharded(corn, target, c, cfg)
    assert_grads_match(loss, grads, *unsharded_loss_and_grad(corn, target, c, cfg))


# --------------------------------------------------------------------------
# Spawned gloo groups against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side, imported only where a test compares with it."""
    import jax
    import jax.numpy as jnp

    from esctp1raytracer_tpu import Camera as JCamera
    from esctp1raytracer_tpu import RenderConfig as JRenderConfig
    from esctp1raytracer_tpu import cornell_box as j_cornell_box
    from esctp1raytracer_tpu import sphere_plane_scene as j_sphere_plane_scene
    from esctp1raytracer_tpu.parallel import loss_and_grad_sharded as j_loss_and_grad_sharded
    from esctp1raytracer_tpu.parallel import make_mesh as j_make_mesh
    from esctp1raytracer_tpu.parallel import render_sharded as j_render_sharded

    return dict(jax=jax, jnp=jnp, Camera=JCamera, RenderConfig=JRenderConfig,
                cornell=j_cornell_box(), sphere_plane=j_sphere_plane_scene(),
                loss_and_grad_sharded=j_loss_and_grad_sharded, make_mesh=j_make_mesh,
                render_sharded=j_render_sharded)


def j_cam(jx, eye):
    return jx["Camera"].look_at(*eye, aspect=1.0)


@pytest.fixture(scope="module")
def rays4(tmp_path_factory):
    return spawn("rays4", 4, tmp_path_factory.mktemp("rays4"))[0]


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return spawn("grid", 4, tmp_path_factory.mktemp("grid"))[0]


@pytest.fixture(scope="module")
def train2(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("train2")
    return spawn("train2", 2, out_dir), out_dir


def test_rays_split_matches_jax(rays4, jx, eight_devices):
    mesh = jx["make_mesh"](eight_devices[:4], rays=4)
    want = jx["render_sharded"](jx["cornell"], j_cam(jx, CORNELL_EYE), 32, 32,
                                jx["RenderConfig"](), mesh)
    assert_images_match(rays4["jnp"], np.asarray(want))


@pytest.mark.parametrize("name,w,h,backend", [("jnp", 32, 32, "jnp"), ("pad", 30, 25, "jnp"),
                                              ("auto", 32, 32, "auto")])
def test_rays_split_equals_port_render(rays4, name, w, h, backend):
    want = render(cornell_box(device="cpu"), cam(CORNELL_EYE), w, h,
                  RenderConfig(backend=backend)).numpy()
    assert rays4[name].shape == (h, w, 3)
    if backend == "jnp":
        np.testing.assert_array_equal(rays4[name], want)
    else:
        assert_images_match(rays4[name], want)


def test_rays_split_fused_grads_match_unsharded(rays4):
    corn, cfg = cornell_box(device="cpu"), RenderConfig(backend="auto")
    want = unsharded_loss_and_grad(corn, torch.zeros((16, 16, 3)), cam(CORNELL_EYE), cfg)
    assert_fused_grads_match(*grads_of(rays4, "auto"), *want)


def test_prims_split_image_matches(grid, jx, eight_devices):
    mesh = jx["make_mesh"](eight_devices[:4], rays=2, prims=2)
    want = jx["render_sharded"](jx["cornell"], j_cam(jx, CORNELL_EYE), 32, 32,
                                jx["RenderConfig"](), mesh)
    assert_images_match(grid["jnp"], np.asarray(want))
    mine = render(cornell_box(device="cpu"), cam(CORNELL_EYE), 32, 32, RenderConfig())
    assert_images_match(grid["jnp"], mine.numpy())


def test_fused_on_prims_mesh_falls_back(grid):
    """backend="fused" with the prims search injected resolves to the fallback
    route, and matches the unsharded fused image."""
    want = render(cornell_box(device="cpu"), cam(CORNELL_EYE), 32, 32,
                  RenderConfig(backend="fused")).numpy()
    assert_images_match(grid["fused"], want)


@pytest.mark.parametrize("backend", ["jnp", "mxu"])
def test_prims_split_grads_match_jax(grid, jx, eight_devices, backend):
    mesh = jx["make_mesh"](eight_devices[:4], rays=2, prims=2)
    loss, grads = jx["loss_and_grad_sharded"](
        jx["sphere_plane"], jx["jnp"].asarray(grid_target()), j_cam(jx, SPHERE_EYE),
        jx["RenderConfig"](backend=backend), mesh)
    assert_grads_match(*grads_of(grid, backend), loss, grads)


@pytest.mark.parametrize("backend", ["jnp", "mxu"])
def test_prims_split_grads_match_unsharded(grid, backend):
    want = unsharded_loss_and_grad(sphere_plane_scene(device="cpu"),
                                   torch.from_numpy(grid_target()), cam(SPHERE_EYE),
                                   RenderConfig(backend=backend))
    assert_grads_match(*grads_of(grid, backend), *want)


def test_train_step_loss_equal_across_ranks(train2):
    ranks, _ = train2
    assert np.isfinite(ranks[0]["loss"])
    assert ranks[0]["loss"].tobytes() == ranks[1]["loss"].tobytes()
    assert all(bool(r["moved"]) for r in ranks), "the SGD step changed no parameter"


def test_fit_scene_on_mesh_matches_one_process(train2):
    ranks, out_dir = train2
    scene, s = sphere_plane_scene(device="cpu"), cam(SPHERE_EYE)
    start, target = perturbed(scene), render(scene, s, 16, 16, RenderConfig())
    want = fit_scene(start, target, s, steps=3, lr=0.05, log_every=0,
                     param_filter=materials(start))
    for r in ranks:
        assert int(r["fit_steps"]) == 3
        np.testing.assert_array_equal(r["fit_losses"], ranks[0]["fit_losses"])
        np.testing.assert_allclose(r["fit_losses"], want.losses, rtol=1e-5)
        np.testing.assert_allclose(r["fit_kd"], want.scene.spheres.kd.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["fit_ks"], want.scene.spheres.ks.numpy(), atol=1e-6)
    # Rank 0 alone wrote the checkpoint: one file, at the last step, no
    # temporary left behind.
    files = sorted(f for f in os.listdir(out_dir) if not f.startswith("train2_rank"))
    assert files == ["fit.npz"]
    with np.load(os.path.join(out_dir, "fit.npz")) as data:
        assert int(data["__step__"]) == 3 and int(data["extra_adam_t"]) == 3


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2])
