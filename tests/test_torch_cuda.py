"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where
`torch.cuda.is_available()` is false. On a machine with the card:
`python -m pytest tests/test_torch_cuda.py -q` (builds the kernels with
nvcc at first use). Bars as in tests/test_torch_rt_mxu.py: winner
agreement >= 99.9% and relative t error < 1e-5 where winners agree
(CUDA-core FMAs vs a float32 bmm sum in other orders); occlusion
agreement >= 99.9%; the rendered image within the test_rt_mxu.py image
bars of the CPU port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.intersect import EPS, closest_hit  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import rt_mxu  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as b  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    return b.scene_from_mesh([
        b.icosphere_mesh(subdivisions=3, radius=1.0, center=(-1.3, 1.0, 0.0)),
        b.icosphere_mesh(subdivisions=3, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
        b._ground_plane(),
        b._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ])


CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3)


def _inputs(scene, dev, exclude_oversized, o, d, tl):
    (tfq, aabbs, _), = list(rt_mxu._segments(scene.to(dev).triangles, exclude_oversized)[0])
    rf, ids, cnt, tl, _, _ = rt_mxu._prep_mxu(o, d, aabbs, tl)
    return torch.tensor([EPS], device=dev), ids, cnt, rf, tl, tfq


def test_search_kernel_matches_plain(dev, scene):
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(160, 120))
    eps, ids, cnt, rf, _, tfq = _inputs(scene, dev, False, o, d, None)
    n0 = rt_mxu.mxu_kernel.launches
    t, idx = rt_mxu.mxu_kernel(eps, ids, cnt, rf, tfq)
    torch.cuda.synchronize()
    assert rt_mxu.mxu_kernel.launches == n0 + 1
    t2, idx2 = rt_mxu._mxu_search_plain(eps, ids, cnt, rf, tfq)
    same = idx == idx2
    assert same.float().mean().item() >= 0.999
    rel = (t - t2).abs()[same] / t2.abs()[same].clamp(min=1.0)
    assert rel.max().item() < 1e-5
    assert (idx >= 0).float().mean().item() > 0.3


def test_occl_kernel_matches_plain(dev, scene):
    sc = scene.to(dev)
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(160, 120))
    hit = closest_hit(o, d, sc, EPS, tri_search=rt_mxu.mxu_tile_search)
    hp = o + d * (torch.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
    lv = torch.tensor([0.3, 5.9, 2.2], device=dev) - hp
    dist = lv.norm(dim=-1)
    tl = torch.where(hit.hit, dist - 1e-4, -1.0)
    eps, ids, cnt, rf, tl, tfq = _inputs(scene, dev, True, hp, lv / dist[:, None], tl)
    n0 = rt_mxu.mxu_occl_kernel.launches
    occ = rt_mxu.mxu_occl_kernel(eps, ids, cnt, rf, tl, tfq)
    torch.cuda.synchronize()
    assert rt_mxu.mxu_occl_kernel.launches == n0 + 1
    occ2 = rt_mxu._mxu_occl_plain(eps, ids, cnt, rf, tl, tfq)
    assert (occ == occ2).float().mean().item() >= 0.999
    assert 0.01 < occ.float().mean().item() < 0.99


def test_render_on_card_matches_cpu(dev, scene):
    cfg = RenderConfig(backend="mxtile")
    a = render(scene, CAM, 64, 48, cfg).numpy()
    n0 = (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches)
    img = render(scene.to(dev), CAM.to(dev), 64, 48, cfg)
    assert rt_mxu.mxu_kernel.launches > n0[0] and rt_mxu.mxu_occl_kernel.launches > n0[1]
    diff = np.abs(img.cpu().numpy() - a)
    assert diff.mean() < 1e-4 and (diff > 1e-2).mean() < 5e-3


def test_wrapper_rejects_bad_inputs(dev, scene):
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(16, 16))
    eps, ids, cnt, rf, _, tfq = _inputs(scene, dev, False, o, d, None)
    with pytest.raises(ValueError, match="ids"):
        rt_mxu.mxu_kernel(eps, ids.long(), cnt, rf, tfq)
    with pytest.raises(ValueError, match="contiguous"):
        rt_mxu.mxu_kernel(eps, ids, cnt, rf, tfq.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="tfq"):
        rt_mxu.mxu_kernel(eps, ids, cnt, rf, tfq.cpu())
