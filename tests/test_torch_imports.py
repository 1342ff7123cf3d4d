"""The port stands alone: it imports no JAX and no JAX package.

Runs in a fresh interpreter, so nothing the test process imported (the
JAX package, for the parity tests) can hide an import.
"""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import pkgutil, sys
import torch
import esctp1raytracer_tpu_torch as rt

mods = [m.name for m in pkgutil.walk_packages(rt.__path__, rt.__name__ + ".")]
for name in mods:
    __import__(name)
assert len(mods) >= 16, mods

from esctp1raytracer_tpu_torch.kernels import rt_mxu
from esctp1raytracer_tpu_torch.scene import builders as b

scene = b.scene_from_mesh([b.icosphere_mesh(1, 1.0, (0.0, 1.0, 0.0)), b._ground_plane(),
                           b._area_light((0.0, 6.0, 2.0), 1.5)])
cam = rt.Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1.0)
img = rt.render(scene, cam, 16, 12, rt.RenderConfig(backend="mxtile"))
assert img.shape == (12, 16, 3) and bool(torch.isfinite(img).all()) and float(img.max()) > 0
# The render went through the kernel wrappers' CPU path: no launch counted.
assert rt_mxu.mxu_kernel.launches == 0 and rt_mxu.mxu_occl_kernel.launches == 0
assert rt_mxu._LIB is None  # nothing was built or loaded

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

    from esctp1raytracer_tpu_torch.kernels import rt_mxu

    g, nsub = 2, 3
    gen = torch.Generator().manual_seed(0)
    rf = torch.randn(g, 128, 16, generator=gen)
    tfq = torch.randn(nsub, 16, 512, generator=gen)
    ids = torch.tensor([[0, 1, 2], [2, 0, 1]], dtype=torch.int32)
    cnt = torch.tensor([3, 1], dtype=torch.int32)
    tl = torch.full((g, 128), 0.5)
    eps = torch.tensor([1e-7])
    before = (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches)
    t, idx = rt_mxu.mxu_kernel(eps, ids, cnt, rf, tfq)
    occ = rt_mxu.mxu_occl_kernel(eps, ids, cnt, rf, tl, tfq)
    assert (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches) == before
    t2, idx2 = rt_mxu._mxu_search_plain(eps, ids, cnt, rf, tfq)
    assert torch.equal(t, t2) and torch.equal(idx, idx2)
    assert torch.equal(occ, rt_mxu._mxu_occl_plain(eps, ids, cnt, rf, tl, tfq))
    assert t.shape == idx.shape == occ.shape == (g, 128)
    assert t.dtype == torch.float32 and idx.dtype == occ.dtype == torch.int32
    # Group 1 only visits block 2: every winner lies in 256..383.
    hit = idx[1] >= 0
    assert bool(hit.any()) and bool(((idx[1][hit] >= 256) & (idx[1][hit] < 384)).all())
