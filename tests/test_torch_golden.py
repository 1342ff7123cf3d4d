"""The port against the reference C++ binary itself: golden-image parity.

The same bars as tests/test_golden.py, on the same fixture
(tests/golden/cornell_cpp_mean.npz: the pixel mean of 6 runs of the
reference on CornellBox-Original, 1024x768, eye (0,1,2), look (0,1,0),
vfov 60), with the port rendering on the CPU through backend "auto", as
the CLI's --ispc does (lane: K4's plain version): the mean of 4 seeds of
light_mode="reference_cpp" (shadow_eps = float epsilon, as the C++ backs
its shadow rays off), each frame clamped at 1, at 256x192 against the
golden box-averaged by 4.

Bars: |mean difference| < 0.02; the median of the 8x8 patch-mean maximum
differences < 0.03 with > 90% of them < 0.12; each region colour within
atol 0.08; the default area sampling within 0.06 of the golden's mean.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch import Camera, RenderConfig, cornell_box, render  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_cpp_mean.npz")
SCALE = 4  # 256x192


def box(img, k):
    h, w, c = img.shape
    return img.reshape(h // k, k, w // k, k, c).mean((1, 3))


@pytest.fixture(scope="module")
def golden():
    return box(np.load(GOLDEN)["image"].astype(np.float32) / 255.0, SCALE)


@pytest.fixture(scope="module")
def scene_and_camera():
    cam = Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=1024 / 768, device="cpu")
    return cornell_box(device="cpu"), cam


@pytest.fixture(scope="module")
def mine(scene_and_camera):
    scene, cam = scene_and_camera
    acc = []
    for seed in range(4):
        cfg = RenderConfig(backend="auto", light_mode="reference_cpp", seed=seed,
                           shadow_eps=1.1920929e-07)
        img = render(scene, cam, 1024 // SCALE, 768 // SCALE, cfg).numpy()
        acc.append(np.minimum(img, 1.0))
    return np.mean(acc, axis=0)


def test_global_statistics_match(golden, mine):
    assert abs(mine.mean() - golden.mean()) < 0.02


def test_patch_means_match(golden, mine):
    d = np.abs(box(golden, 8) - box(mine, 8)).max(-1)
    assert np.median(d) < 0.03
    assert (d < 0.12).mean() > 0.9


@pytest.mark.parametrize("region", ["left wall", "right wall", "back wall top"])
def test_wall_colors_match(golden, mine, region):
    h, w, _ = golden.shape
    rs, cs = {
        "left wall": (slice(h // 3, h // 2), slice(0, w // 12)),
        "right wall": (slice(h // 3, h // 2), slice(w - w // 12, w)),
        "back wall top": (slice(2 * h // 3, 3 * h // 4), slice(w // 3, 2 * w // 3)),
    }[region]
    np.testing.assert_allclose(mine[rs, cs].mean((0, 1)), golden[rs, cs].mean((0, 1)),
                               atol=0.08, err_msg=region)


def test_area_sampling_close_but_smoother(golden, scene_and_camera):
    scene, cam = scene_and_camera
    img = render(scene, cam, 1024 // SCALE, 768 // SCALE, RenderConfig(backend="auto"))
    img = np.minimum(img.numpy(), 1.0)
    assert abs(img.mean() - golden.mean()) < 0.06
