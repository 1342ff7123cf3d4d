"""Port vs oracle: pixel-level parity, and the pinned golden pixels.

Mirrors tests/test_oracle.py on the port. The port's NumPy oracle
(esctp1raytracer_tpu_torch/testing/oracle.py) is its own copy of the JAX
package's; it must agree with that one on the same tables (one scene,
built once and passed to each package through `scene_from_numpy`) bit for
bit or within 1e-7. Then the JAX test's bars, unchanged: each port route
(`jnp`, `mxu`, `lane`, and `auto`, which takes the fused route: K3's
plain version on the CPU) has >= 99% of pixels within 1e-3 of the oracle
and a mean difference < 5e-3; the sphere scene at 40x40; the 6 inline
golden constants at atol 2e-6 and the committed 196-pixel grid
(tests/golden/cornell_pixels_48x36.npz) at 5e-6 for the port's `jnp`
render and at 2e-6 for its oracle.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402

from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.testing import oracle_render as j_oracle_render  # noqa: E402
from esctp1raytracer_tpu_torch import (  # noqa: E402
    Camera, RenderConfig, cornell_box, render, sphere_plane_scene,
)
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy  # noqa: E402
from esctp1raytracer_tpu_torch.testing import oracle_render  # noqa: E402

CORNELL = ((0, 1, 2), (0, 1, 0))
GRID = os.path.join(os.path.dirname(__file__), "golden", "cornell_pixels_48x36.npz")

# tests/test_oracle.py's golden constants: (row, col, (r, g, b)) of the
# canonical Cornell view at 48x36, seed 0.
GOLDEN_PIXELS = [
    (2, 27, (0.0, 0.0, 0.0)),
    (32, 22, (0.0, 0.0, 0.0)),
    (23, 7, (0.828039, 0.08543259, 0.065717384)),
    (23, 2, (0.78562057, 0.08105609, 0.06235084)),
    (8, 2, (0.64704645, 0.06675875, 0.051352892)),
    (11, 37, (0.15261026, 0.49053296, 0.09919667)),
]


def to_port(scene):
    return scene_from_numpy({jax.tree_util.keystr(p)[1:]: np.asarray(v)
                             for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]},
                            device="cpu")


def port_render(scene, eye, w, h, backend):
    cam = Camera.look_at(*eye, vfov=60.0, aspect=w / h, device="cpu")
    return render(scene, cam, w, h, RenderConfig(backend=backend, seed=0)).numpy()


@pytest.fixture(scope="module")
def cornell_ref():
    return oracle_render(cornell_box(device="cpu"), *CORNELL, 48, 36)


@pytest.fixture(scope="module")
def cornell_jnp():
    return port_render(cornell_box(device="cpu"), CORNELL, 48, 36, "jnp")


@pytest.fixture(scope="module")
def grid():
    data = np.load(GRID)
    return data["rows"], data["cols"], data["rgb"]


class TestOracleCopy:
    @pytest.mark.parametrize("name,eye,w,h", [("cornell", CORNELL, 48, 36),
                                              ("sphere_plane", ((0, 2, 6), (0, 1, 0)), 20, 20)])
    def test_port_oracle_equals_jax_oracle(self, name, eye, w, h):
        js = {"cornell": jb.cornell_box, "sphere_plane": jb.sphere_plane_scene}[name]()
        want = j_oracle_render(js, *eye, w, h)
        got = oracle_render(to_port(js), *eye, w, h)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)

    def test_oracle_reads_the_port_builders_tables(self, cornell_ref):
        # The port's own builder gives the JAX builder's tables: the same frame.
        want = oracle_render(to_port(jb.cornell_box()), *CORNELL, 48, 36)
        np.testing.assert_array_equal(cornell_ref, want)


class TestOracleParity:
    @pytest.mark.parametrize("backend", ["jnp", "mxu", "lane", "auto"])
    def test_cornell_pixels(self, cornell_ref, backend):
        img = port_render(cornell_box(device="cpu"), CORNELL, 48, 36, backend)
        diff = np.abs(img - cornell_ref).max(axis=-1)
        frac = float(np.mean(diff <= 1e-3))
        assert frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3"
        assert float(np.mean(diff)) < 5e-3

    def test_sphere_scene_pixels(self):
        scene = sphere_plane_scene(device="cpu")
        eye = ((0, 2, 6), (0, 1, 0))
        img = port_render(scene, eye, 40, 40, "jnp")
        ref = oracle_render(scene, *eye, 40, 40)
        frac = float(np.mean(np.abs(img - ref).max(axis=-1) <= 1e-3))
        assert frac >= 0.99, f"only {frac:.4f} of pixels within 1e-3"

    def test_oracle_sees_the_scene(self):
        ref = oracle_render(cornell_box(device="cpu"), *CORNELL, 32, 24)
        assert ref.max() > 0.2
        assert float((ref.max(axis=-1) > 0.01).mean()) > 0.5


class TestGoldenPixels:
    def test_port_matches_golden_constants(self, cornell_jnp):
        for row, col, rgb in GOLDEN_PIXELS:
            np.testing.assert_allclose(
                cornell_jnp[row, col], np.asarray(rgb, np.float32), atol=2e-6, rtol=0,
                err_msg=f"pixel ({row},{col}) drifted from the committed oracle value")

    def test_oracle_still_produces_golden_constants(self, cornell_ref):
        for row, col, rgb in GOLDEN_PIXELS:
            np.testing.assert_allclose(
                cornell_ref[row, col], np.asarray(rgb, np.float32), atol=2e-6, rtol=0,
                err_msg=f"oracle pixel ({row},{col}) drifted")

    def test_port_matches_golden_grid(self, cornell_jnp, grid):
        rows, cols, rgb = grid
        assert len(rows) >= 64
        bad = np.abs(cornell_jnp[rows, cols] - rgb).max(-1) > 5e-6
        assert not bad.any(), (
            f"{bad.sum()} of {len(rows)} pinned pixels drifted; first at "
            f"({rows[bad][0]},{cols[bad][0]})")

    def test_oracle_matches_golden_grid(self, cornell_ref, grid):
        rows, cols, rgb = grid
        bad = np.abs(cornell_ref[rows, cols] - rgb).max(-1) > 2e-6
        assert not bad.any(), (
            f"{bad.sum()} of {len(rows)} pinned oracle pixels drifted; "
            f"first at ({rows[bad][0]},{cols[bad][0]})")
