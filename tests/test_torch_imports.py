"""The port stands alone: it imports no JAX and no JAX package.

Runs in a fresh interpreter, so nothing the test process imported (the
JAX package, for the parity tests) can hide an import.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import pkgutil, sys
import torch
import esctp1raytracer_tpu_torch as rt

mods = [m.name for m in pkgutil.walk_packages(rt.__path__, rt.__name__ + ".")]
for name in mods:
    __import__(name)
new = {"cli", "__main__", "io.ppm", "io.native_ppm", "scene.objloader", "scene.native_loader",
       "scene.matjson", "accel.bvh", "accel.native_bvh", "utils.debug", "utils.timing",
       "utils.nativebuild", "utils.profiling", "grad", "grad.optimize", "utils.checkpoint",
       "parallel.distributed", "parallel.sharding", "testing", "testing.oracle",
       "kernels.launches", "utils.device"}
assert {rt.__name__ + "." + m for m in new} <= set(mods), sorted(mods)
assert len(mods) >= 40, mods

from esctp1raytracer_tpu_torch.kernels import rt_mxu
from esctp1raytracer_tpu_torch.scene import builders as b

scene = b.scene_from_mesh([b.icosphere_mesh(1, 1.0, (0.0, 1.0, 0.0)), b._ground_plane(),
                           b._area_light((0.0, 6.0, 2.0), 1.5)], device="cpu")
cam = rt.Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0, device="cpu")
img = rt.render(scene, cam, 16, 12, rt.RenderConfig(backend="mxtile"))
assert img.shape == (12, 16, 3) and bool(torch.isfinite(img).all()) and float(img.max()) > 0
# The fused route (auto), differentiated: its backward takes the lane route.
from esctp1raytracer_tpu_torch.kernels import fused_pallas, lane_pallas
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params

corn = rt.cornell_box(device="cpu")
params = [p.clone().requires_grad_(True) for p in float_params(corn)]
ccam = rt.Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3,
                        device="cpu")
cimg = rt.render(merge_params(corn, params), ccam, 16, 12, rt.RenderConfig(backend="auto"))
(cimg * cimg).sum().backward()
assert float(cimg.max()) > 0 and all(bool(torch.isfinite(p.grad).all())
                                     for p in params if p.grad is not None)
# The renders went through the kernel wrappers' CPU path: no launch counted.
assert rt_mxu.mxu_kernel.launches == 0 and rt_mxu.mxu_occl_kernel.launches == 0
assert fused_pallas.fused_kernel.launches == 0 and lane_pallas.lane_kernel.launches == 0
assert rt_mxu._LIB is None and fused_pallas._LIB is None and lane_pallas._LIB is None

# The host I/O and the CLI: OBJ written, loaded (Python and C++), rendered, saved.
import os, tempfile
from esctp1raytracer_tpu_torch import cli
from esctp1raytracer_tpu_torch.accel.bvh import build_bvh
from esctp1raytracer_tpu_torch.scene.native_loader import load_obj_native

with tempfile.TemporaryDirectory() as tmp:
    obj, out = os.path.join(tmp, "c.obj"), os.path.join(tmp, "c.ppm")
    b.write_cornell_obj(obj)
    assert sum(m.num_faces for m in rt.load_obj(obj)) == sum(
        m.num_faces for m in load_obj_native(obj)) == 36
    assert cli.main(["-m", obj, "-w", "16,12", "--ispc", "--device", "cpu", "-o", out]) == 0
    assert rt.read_ppm(out).shape == (12, 16, 3)
    assert build_bvh(corn.triangles).num_nodes > 1

# Training and the sharded renderer: one Adam step with a checkpoint, and
# a one-rank mesh (no process group).
from esctp1raytracer_tpu_torch.grad import fit_scene
from esctp1raytracer_tpu_torch.parallel import make_mesh, render_sharded
from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint

with tempfile.TemporaryDirectory() as tmp:
    ck = os.path.join(tmp, "fit.npz")
    fit = fit_scene(corn, torch.zeros((12, 16, 3)), ccam, steps=1, cfg=rt.RenderConfig(),
                    checkpoint_path=ck, log_every=0)
    assert len(fit.losses) == 1 and load_checkpoint(ck, corn)[1] == 1
assert torch.equal(render_sharded(corn, ccam, 16, 12, rt.RenderConfig(), make_mesh()),
                   rt.render(corn, ccam, 16, 12, rt.RenderConfig()))

# The benchmark and matrix scripts and the example, imported (not run): each imports the
# port alone.
import importlib.util
for path in ("scripts/bench_configs_torch.py", "scripts/probe_device_loop_torch.py",
             "scripts/run_matrix_torch.py", "scripts/make_golden_pixels_torch.py",
             "scripts/bench_scaling_torch.py", "examples/render_cornell_torch.py"):
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from esctp1raytracer_tpu_torch.testing import oracle_render
assert oracle_render(corn, (0, 1, 2), (0, 1, 0), 4, 3).shape == (3, 4, 3)

leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "jaxlib", "esctp1raytracer_tpu.")))
leaked += [m for m in sys.modules if m == "esctp1raytracer_tpu"]
assert not leaked, leaked
print("port-ok", len(mods))
"""


def test_port_imports_no_jax_and_renders_on_cpu():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "port-ok" in proc.stdout


def test_wrapper_on_cpu_tensor_runs_plain_version_without_launch():
    import torch

    from esctp1raytracer_tpu_torch.kernels import rt_mxu, rt_tile

    gen = torch.Generator().manual_seed(0)
    tfq = torch.randn(3, 16, 512, generator=gen)
    # Block boxes: 0 and 1 ahead of the origins along +z, 2 behind them.
    lo = torch.tensor([[-1.0, -1.0, 1.0], [-1.0, -1.0, 3.0], [-1.0, -1.0, -2.0]])
    aabbs = torch.cat([lo.T, (lo + torch.tensor([2.0, 2.0, 1.0])).T, torch.zeros(2, 3)])
    # Group 0 looks along +z, group 1 along -z.
    o = torch.cat([torch.rand(256, 2, generator=gen) - 0.5, torch.zeros(256, 1)], 1)
    d = torch.tensor([0.0, 0.0, 1.0]).repeat(256, 1)
    d[128:, 2] = -1.0
    rays = rt_tile._pad_rays(o, d)
    rays_tl = rt_tile._pad_rays(o, d, torch.full((256,), 50.0))
    eps = torch.tensor([1e-7])
    cnt, cnt2 = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    before = (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches)
    t, idx = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq, cnt_out=cnt)
    occ = rt_mxu.mxu_occl_kernel(eps, rays_tl, aabbs, tfq, cnt_out=cnt2)
    assert (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches) == before
    t2, idx2 = rt_mxu._mxu_search_plain(eps, rays, aabbs, tfq)
    assert torch.equal(t, t2) and torch.equal(idx, idx2)
    assert torch.equal(occ, rt_mxu._mxu_occl_plain(eps, rays_tl, aabbs, tfq))
    assert t.shape == idx.shape == occ.shape == (256,)
    assert t.dtype == torch.float32 and idx.dtype == occ.dtype == torch.int32
    assert cnt.tolist() == cnt2.tolist() == [2, 1]
    # Group 1 only visits block 2: every winner lies in 256..383.
    hit = idx[128:] >= 0
    assert bool(hit.any()) and bool(((idx[128:][hit] >= 256) & (idx[128:][hit] < 384)).all())
    assert bool(occ[128:].any())
