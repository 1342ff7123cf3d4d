"""Finite-difference gradient checks of the port, mirroring tests/test_grad.py.

Pixel gradients with respect to a sphere's center and radius, its
albedo and specular, and a triangle vertex must match central finite
differences on the port's `jnp` route (away from visibility
discontinuities), with the JAX package's eps and tolerances; the light
triangle's vertices receive finite gradients, and no float leaf of a
depth-3 scene with spheres, triangles and mirrors gets a non-finite one.
These are the gradients `fit_scene` descends.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch import Camera, RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.scene.builders import mixed_scene, sphere_plane_scene  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import float_params, merge_params  # noqa: E402

CAM = Camera.look_at((0, 2, 6), (0, 1, 0), aspect=1.0, device="cpu")
CFG = RenderConfig()
N = 48


def _loss_fn(scene):
    # A smooth scalar of the image; masks out nothing so every parameter
    # can influence it.
    img = render(scene, CAM, N, N, CFG)
    weights = torch.cos(0.1 * torch.arange(img.numel(), dtype=torch.float32)).reshape(img.shape)
    return torch.sum(img * weights)


def _leaf(scene, name):
    return dict(scene.leaves())[name]


def _with_value(scene, name, idx, value):
    """The scene with leaf `name`[idx] = value (a new tensor; the rest shared)."""
    def put(leaf_name, t):
        if leaf_name != name:
            return t
        t = t.clone()
        t[idx] = value
        return t

    return scene.map(put)


def _autodiff(scene, name):
    """d loss / d leaf `name`, through torch.autograd."""
    names = [n for n, t in scene.leaves() if t.is_floating_point()]
    params = [p.detach().requires_grad_(n == name) for n, p in zip(names, float_params(scene))]
    loss = _loss_fn(merge_params(scene, params))
    (grad,) = torch.autograd.grad(loss, [params[names.index(name)]])
    return grad


def _fd_check(scene, name, idx, eps, rtol, atol):
    """Central finite difference on one scalar parameter vs autodiff."""
    g_auto = float(_autodiff(scene, name)[idx])
    with torch.no_grad():
        base = float(_leaf(scene, name)[idx])
        lo = _loss_fn(_with_value(scene, name, idx, base - eps))
        hi = _loss_fn(_with_value(scene, name, idx, base + eps))
    g_fd = float((hi - lo) / (2 * eps))
    assert np.isfinite(g_auto)
    np.testing.assert_allclose(g_auto, g_fd, rtol=rtol, atol=atol)
    return g_auto


@pytest.fixture(scope="module")
def scene():
    return sphere_plane_scene(device="cpu")


class TestGradients:
    def test_sphere_center(self, scene):
        # y of the sphere center
        g = _fd_check(scene, "spheres.center", (0, 1), eps=2e-3, rtol=0.08, atol=2e-2)
        assert g != 0.0

    def test_sphere_radius(self, scene):
        g = _fd_check(scene, "spheres.radius", 0, eps=2e-3, rtol=0.08, atol=2e-2)
        assert g != 0.0

    def test_material_diffuse(self, scene):
        _fd_check(scene, "spheres.kd", (0, 0), eps=1e-3, rtol=0.02, atol=1e-3)

    def test_material_specular(self, scene):
        _fd_check(scene, "spheres.ks", (0, 0), eps=1e-3, rtol=0.05, atol=1e-3)

    def test_triangle_vertex(self, scene):
        # Ground-plane vertex y: moves shading positions smoothly.
        g = _fd_check(scene, "triangles.v0", (0, 1), eps=2e-3, rtol=0.15, atol=5e-2)
        assert np.isfinite(g)

    def test_light_vertex_grad_flows(self, scene):
        # The sampled light point P depends on light-triangle vertices;
        # gradient must flow into them.
        light_tri = int(scene.lights.tri_idx[0, 0])
        gv = _autodiff(scene, "triangles.v0")[light_tri]
        assert bool(torch.isfinite(gv).all())

    def test_no_nan_grads_anywhere(self):
        scene = mixed_scene(device="cpu")
        cam = Camera.look_at((0, 2.5, 7), (0, 1, 0), aspect=1.0, device="cpu")
        params = [p.detach().requires_grad_(True) for p in float_params(scene)]
        img = render(merge_params(scene, params), cam, 32, 32, RenderConfig(depth=3))
        grads = torch.autograd.grad(torch.sum(img), params, allow_unused=True)
        for (name, _), g in zip([(n, t) for n, t in scene.leaves() if t.is_floating_point()],
                                grads):
            assert g is None or bool(torch.isfinite(g).all()), f"non-finite gradient: {name}"
