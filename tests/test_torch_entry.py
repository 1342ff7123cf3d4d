"""Port vs JAX package: the root entry points (`entry_torch.py` against
`__graft_entry__.py`).

* `entry("cpu")`'s forward (mxtile, the kernel wrappers' plain versions
  on the CPU) against the JAX `entry()`'s jitted forward on the same
  rays, 128x128: the image bar of tests/test_rt_mxu.py
  (`test_render_matches_tile_backend`: mean difference < 1e-4, < 0.5% of
  values off by more than 1e-2);
* `dryrun_multichip` on 1, 2 and 4 gloo ranks of the CPU (spawned through
  tests/test_torch_parallel.py's worker) against the JAX package's
  `train_step_sharded` on the matching meshes of virtual CPU devices, for
  each of the five backends: the losses within 1e-5 relative and equal
  bit for bit on every rank, and each float leaf's SGD step (the leaf
  before minus after, lr 1e-3 times the all-reduced gradient) within the
  gradient bars of tests/test_sharding.py:150-155 (atol 3e-4 of the
  leaf's largest step, rtol 3e-3), plus one float32 spacing of the larger
  updated value for the updates' own rounding. The JAX side runs its
  lane, tile and fused kernels in interpret mode (the tile step alone
  takes ~40 s), at the JAX function's own 16x16 target.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import __graft_entry__  # noqa: E402
import entry_torch  # noqa: E402
from test_torch_parallel import spawn  # noqa: E402

from esctp1raytracer_tpu import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from esctp1raytracer_tpu.parallel import train_step_sharded as j_train_step_sharded  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.scene.builders import sphere_plane_scene as j_sphere_plane  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_to_numpy  # noqa: E402

BACKENDS = [b for b, _ in entry_torch.DRYRUN_BACKENDS]


def to_numpy_tables(scene):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


def test_entry_matches_jax():
    j_fn, j_args = __graft_entry__.entry()
    want = np.asarray(jax.jit(j_fn)(*j_args))
    fn, (scene, o, d, ids) = entry_torch.entry("cpu")
    tables = to_numpy_tables(j_args[0])
    got_tables = scene_to_numpy(scene)
    assert set(got_tables) == set(tables)
    for key, arr in tables.items():
        np.testing.assert_array_equal(got_tables[key], arr, err_msg=key)
    assert o.shape == d.shape == (128 * 128, 3) and torch.equal(ids, torch.arange(128 * 128))
    launches.reset()
    with torch.no_grad():  # JAX's rays: the two cameras may differ by a few ulp
        got = fn(scene, torch.tensor(np.asarray(j_args[1])), torch.tensor(np.asarray(j_args[2])),
                 ids).numpy()
    assert not any(launches.read().values())  # the CPU runs the plain versions
    assert got.shape == want.shape == (128 * 128, 3) and float(got.max()) > 0
    diff = np.abs(got - want)
    assert diff.mean() < 1e-4
    assert (diff > 1e-2).mean() < 5e-3


def jax_dryrun(n):
    """{backend: (loss, [float leaves of the updated scene])} of the JAX
    package's dryrun_multichip step, on the first n virtual devices."""
    devices = jax.devices()[:n]
    prims = 2 if (n >= 4 and n % 2 == 0) else 1
    meshes = {"mesh": j_make_mesh(devices, rays=n // prims, prims=prims),
              "rays": j_make_mesh(devices, rays=n, prims=1)}
    scene = j_sphere_plane()
    cam = JCamera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)
    target = jnp.zeros((16, 16, 3), jnp.float32)
    out = {}
    for backend, mesh in entry_torch.DRYRUN_BACKENDS:
        step = jax.jit(lambda sc, tgt, cfg=JRenderConfig(backend=backend), m=meshes[mesh]:
                       j_train_step_sharded(sc, tgt, cam, lr=1e-3, cfg=cfg, mesh=m))
        new, loss = step(scene, target)
        out[backend] = (np.float32(loss), [np.asarray(p) for p in j_float_params(new)])
    return out, [np.asarray(p) for p in j_float_params(scene)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_matches_jax(n, tmp_path, eight_devices):
    ranks = spawn("dryrun", n, tmp_path)
    want, before = jax_dryrun(n)
    for backend in BACKENDS:
        leaves = len([k for k in ranks[0] if k.startswith(f"{backend}_p")])
        assert leaves == len(before)
        for r in ranks[1:]:  # every rank: the same loss and the same updated scene, bit for bit
            assert r[f"{backend}_loss"].tobytes() == ranks[0][f"{backend}_loss"].tobytes()
            for i in range(leaves):
                np.testing.assert_array_equal(r[f"{backend}_p{i}"], ranks[0][f"{backend}_p{i}"])
        assert int(ranks[0][f"{backend}_launched"]) == 0  # the CPU runs the plain versions
        loss, new = ranks[0][f"{backend}_loss"], [ranks[0][f"{backend}_p{i}"]
                                                  for i in range(leaves)]
        j_loss, j_new = want[backend]
        assert np.isfinite(loss)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, err_msg=backend)
        for i, (p0, got, ref) in enumerate(zip(before, new, j_new)):
            step = p0.astype(np.float64) - got
            j_step = p0.astype(np.float64) - ref
            bar = (3e-4 * max(np.abs(j_step).max(), 1e-9) + 3e-3 * np.abs(j_step)
                   + np.spacing(np.maximum(np.abs(got), np.abs(ref))).astype(np.float64))
            worst = np.abs(step - j_step) - bar
            assert (worst <= 0).all(), f"{backend} leaf {i}: worst excess {worst.max():.3e}"


def test_dryrun_world_must_match():
    with pytest.raises(ValueError, match="world of 1"):
        entry_torch.dryrun_multichip(2, device="cpu")


@pytest.mark.parametrize("call", [lambda: entry_torch.entry(),
                                  lambda: entry_torch.dryrun_multichip(1)])
def test_entry_points_need_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="No CUDA device"):
        call()
