"""The port's CUDA kernels on the card, against their plain versions.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip where
`torch.cuda.is_available()` is false. On a machine with the card:
`python -m pytest --noconftest tests/test_torch_cuda.py -q` (builds the
kernels with nvcc at first use). Bars:
* K1 (tests/test_torch_rt_mxu.py): winner agreement >= 99.9% and t
  within 1e-5 of max(|t|, 1) where winners agree (FMA-contracted sums vs
  the plain version's separately rounded ones); K2: occlusion agreement
  >= 99.9%; K1, K2: their kept count per group equal to `_prep_mxu`'s,
  and K2's oversized sub-block equal to `_oversized_occl`, exactly;
  K5, K6 (built with -fmad=false): equal to their plain versions bit for
  bit, and so is their kept count per bundle;
* K3 (tests/test_fused.py:38-46): at most 0.2% of pixels off by more than
  1e-2, the rest within 3e-5; its table build and K4 (built with
  -fmad=false, constants rounded as PyTorch on the CPU): equal to their
  plain versions on a CPU copy, bit for bit;
* rendered images within the test_rt_mxu.py image bars of the CPU port;
* the winner-row gather (csrc/winner.cu) equal to index_select bit for
  bit; its scatter within 1e-5 of a float64 index_add_, relative to the
  sum of the gradients' magnitudes (its atomics add in another order),
  and its group count equal to its plain version's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.intersect import EPS, closest_hit  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import (  # noqa: E402
    fused_pallas, lane_pallas, rt_mxu, rt_tile, tables,
)
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as b  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import MeshData, TriangleBuffer  # noqa: E402

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
    ], device="cpu")


# Built on the CPU (this module is imported where there is no card), moved per test.
CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3, device="cpu")


def _mxu_segments(tris, exclude_oversized):
    return tables.Tables(tris).segments(rt_mxu._pack_mxu, rt_mxu.MXU_TRI_LIMIT, exclude_oversized)


def _mxu_args(tris, o, d, tl, exclude_oversized):
    (tfq, aabbs, _), = _mxu_segments(tris, exclude_oversized)
    return torch.tensor([EPS], device=o.device), tables.pad_rays(o, d, tl), aabbs, tfq


def _mxu_cnt(rays, aabbs):
    """The JAX package's list lengths (`_prep_mxu`) on padded rays."""
    return rt_mxu._prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6])[2]


def _mxu_tris(scene, dev, name):
    """The icospheres' table; "padded": followed by 64 padding-only blocks."""
    tris = scene.to(dev).triangles
    if name == "padded":
        filler = TriangleBuffer.empty(64 * 128, device=dev)
        tris = tris.map(lambda leaf, a: torch.cat([a, getattr(filler, leaf)]))
    return tris


@pytest.mark.parametrize("name", ["icospheres", "axis", "padded"])
def test_search_kernel_matches_plain(dev, scene, name):
    """K1 against its plain version without and with a t-limit cull, with
    and without cnt_out, and cnt_out equal to `_prep_mxu`'s list lengths.
    "axis": axis-aligned rays whose origins lie on block-box planes;
    "padded": 64 padding-only blocks, which every ray keeps and K1 skips."""
    tris = _mxu_tris(scene, dev, name)
    if name == "axis":
        (_, aabbs, _), = _mxu_segments(tris, False)
        o, d = (x.to(dev) for x in _axis_rays(aabbs))
    else:
        o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(160, 117))
    r = o.shape[0]
    for limit in (None, torch.full((r,), 9.0, device=dev)):
        eps, rays, aabbs, tfq = _mxu_args(tris, o, d, limit, False)
        cnt = torch.full((rays.shape[0] // 128,), -1, dtype=torch.int32, device=dev)
        n0 = rt_mxu.mxu_kernel.launches
        t, idx = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq, cnt)
        t1, idx1 = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq)
        torch.cuda.synchronize()
        assert rt_mxu.mxu_kernel.launches == n0 + 2
        assert torch.equal(cnt, _mxu_cnt(rays, aabbs))
        assert torch.equal(t, t1) and torch.equal(idx, idx1)
        t2, idx2 = rt_mxu._mxu_search_plain(eps, rays, aabbs, tfq)
        same = idx == idx2
        assert same.float().mean().item() >= 0.999
        rel = (t - t2).abs()[same] / t2.abs()[same].clamp(min=1.0)
        assert rel.max().item() < 1e-5
        assert (idx[:r] >= 0).float().mean().item() > (0.0 if name == "axis" else 0.3)
    if name == "padded":
        assert int(cnt.min()) >= 64


@pytest.mark.parametrize("name", ["icospheres", "axis", "padded"])
def test_occl_kernel_matches_plain(dev, scene, name):
    """K2 with the oversized sub-block against its plain version, with and
    without cnt_out (equal to `_prep_mxu`'s list lengths); K2 with the
    sub-block equal to K2 without it ORed with `_oversized_occl`. The light
    sits above the area light, so the oversized triangles occlude."""
    tris = _mxu_tris(scene, dev, name)
    if name == "axis":
        (_, aabbs, _), = _mxu_segments(tris, True)
        hp, sd = (x.to(dev) for x in _axis_rays(aabbs))
        tl = torch.from_numpy(np.random.RandomState(1).uniform(
            -1.0, 6.0, hp.shape[0]).astype(np.float32)).to(dev)
    else:
        o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(160, 117))
        sc = scene.to(dev)
        hit = closest_hit(o, d, sc, EPS, tri_search=rt_mxu.mxu_tile_search)
        hp = o + d * (torch.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
        lv = torch.tensor([0.3, 8.0, 2.2], device=dev) - hp
        dist = lv.norm(dim=-1)
        sd, tl = lv / dist[:, None], torch.where(hit.hit, dist - 1e-4, -1.0)
    r = hp.shape[0]
    eps, rays, aabbs, tfq = _mxu_args(tris, hp, sd, tl, True)
    ov_buf = tables.cluster_sort(tris)[3]
    ov, _ = tables.pack_planes(ov_buf)
    cnt = torch.full((rays.shape[0] // 128,), -1, dtype=torch.int32, device=dev)
    n0 = rt_mxu.mxu_occl_kernel.launches
    occ = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, ov, cnt)
    occ1 = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, ov)
    occ0 = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq)
    torch.cuda.synchronize()
    assert rt_mxu.mxu_occl_kernel.launches == n0 + 3
    assert torch.equal(cnt, _mxu_cnt(rays, aabbs)) and torch.equal(occ, occ1)
    occ2 = rt_mxu._mxu_occl_plain(eps, rays, aabbs, tfq, ov)
    assert (occ == occ2).float().mean().item() >= 0.999
    split = (occ0[:r] > 0) | rt_tile._oversized_occl(hp, sd, tl, ov_buf, EPS)
    assert torch.equal(occ[:r] > 0, split)
    assert 0.01 < occ[:r].float().mean().item() < 0.99


def test_occl_kernel_two_light_shadow_wavefront(dev):
    """K2 on the shadow wavefront of a two-light frame as `shade` builds it
    (R x 2 rays, ray-major: each ray's lights in order), with the oversized
    sub-block, against its plain version and the oversized sweep."""
    from esctp1raytracer_tpu_torch.core.render import trace_rays

    sc = b.scene_from_mesh([
        b.icosphere_mesh(subdivisions=3, radius=1.0, center=(-1.3, 1.0, 0.0)),
        b._ground_plane(),
        b._area_light(center=(0.0, 6.0, 2.0), half=1.5),
        b._area_light(center=(-3.0, 4.0, -1.0), half=0.5),
    ], device="cpu").to(dev)
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(96, 72))
    seen = []

    def occl(oo, dd, t_limit, tris, eps):
        seen.append((oo, dd, t_limit, tris))
        return rt_mxu.mxu_tile_occlusion(oo, dd, t_limit, tris, eps)

    search = lambda *a, **k: rt_mxu.mxu_tile_search(*a, **k)  # noqa: E731
    search.occlusion = occl
    with torch.no_grad():
        trace_rays(o, d, sc, torch.arange(o.shape[0], device=dev), RenderConfig(backend="mxtile"),
                   tri_search=search)
    (hp, sd, tl, tris), = seen
    r = hp.shape[0]
    assert r == 2 * o.shape[0] and torch.equal(hp[0::2], hp[1::2])
    eps, rays, aabbs, tfq = _mxu_args(tris, hp, sd, tl, True)
    ov_buf = tables.cluster_sort(tris)[3]
    ov, _ = tables.pack_planes(ov_buf)
    cnt = torch.full((rays.shape[0] // 128,), -1, dtype=torch.int32, device=dev)
    n0 = rt_mxu.mxu_occl_kernel.launches
    occ = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, ov, cnt)
    occ0 = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq)
    torch.cuda.synchronize()
    assert rt_mxu.mxu_occl_kernel.launches == n0 + 2
    assert torch.equal(cnt, _mxu_cnt(rays, aabbs))
    occ2 = rt_mxu._mxu_occl_plain(eps, rays, aabbs, tfq, ov)
    assert (occ == occ2).float().mean().item() >= 0.999
    split = (occ0[:r] > 0) | rt_tile._oversized_occl(hp, sd, tl, ov_buf, EPS)
    assert torch.equal(occ[:r] > 0, split)
    assert 0.01 < occ[:r].float().mean().item() < 0.99


def test_mxtile_segments_on_card_match_cpu(dev, scene, monkeypatch):
    """A multi-segment table (MXU_TRI_LIMIT cut to 1024: three segments) on
    the card against the port on the CPU (plain versions): first-wins for
    the search, OR for the occlusion, whose first launch alone tests the
    oversized sub-block."""
    monkeypatch.setattr(rt_mxu, "MXU_TRI_LIMIT", 1024)
    nseg = -(-scene.triangles.capacity // 1024)
    assert nseg == 3
    o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(96, 72))
    tl = torch.full((o.shape[0],), 5.5)
    ref = (*rt_mxu.mxu_tile_search(o, d, scene.triangles, EPS),
           rt_mxu.mxu_tile_occlusion(o, d, tl, scene.triangles, EPS))
    n0 = (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches)
    tris = scene.to(dev).triangles
    got = (*rt_mxu.mxu_tile_search(o.to(dev), d.to(dev), tris, EPS),
           rt_mxu.mxu_tile_occlusion(o.to(dev), d.to(dev), tl.to(dev), tris, EPS))
    torch.cuda.synchronize()
    assert (rt_mxu.mxu_kernel.launches, rt_mxu.mxu_occl_kernel.launches) == (n0[0] + nseg,
                                                                             n0[1] + nseg)
    same = got[1].cpu() == ref[1]
    assert same.float().mean().item() >= 0.999
    rel = (got[0].cpu() - ref[0]).abs()[same] / ref[0].abs()[same].clamp(min=1.0)
    assert rel.max().item() < 1e-5
    assert (got[2].cpu() == ref[2]).float().mean().item() >= 0.999
    assert bool(ref[2].any()) and (ref[1] >= 0).float().mean().item() > 0.3


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
    eps, rays, aabbs, tfq = _mxu_args(scene.to(dev).triangles, o, d, None, False)
    with pytest.raises(ValueError, match="cnt_out"):
        rt_mxu.mxu_kernel(eps, rays, aabbs, tfq, cnt_out=torch.zeros(2, dtype=torch.int64,
                                                                     device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        rt_mxu.mxu_kernel(eps, rays, aabbs, tfq.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="tfq"):
        rt_mxu.mxu_kernel(eps, rays, aabbs, tfq.cpu())
    with pytest.raises(ValueError, match="rays"):
        rt_mxu.mxu_occl_kernel(eps, rays[:, :7].contiguous(), aabbs, tfq)
    with pytest.raises(ValueError, match="ov"):
        rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, tfq[:1])
    with pytest.raises(ValueError, match="blocks"):
        rt_mxu.mxu_kernel(eps, rays, torch.zeros(8, 257, device=dev), tfq)
    shifted = torch.empty(rays.numel() + 1, device=dev)[1:].view(rays.shape)
    shifted.copy_(rays)
    with pytest.raises(ValueError, match="aligned"):
        rt_mxu.mxu_kernel(eps, shifted, aabbs, tfq)


CORNELL_CAM = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3,
                             device="cpu")
MIXED_CAM = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3,
                           device="cpu")


def _lane_args(scene, o, d):
    tris = scene.triangles
    return (EPS, tris.v0, tris.v1, tris.v2, tris.valid, o.contiguous(), d.contiguous())


def _cpu(args):
    return [x.cpu() if torch.is_tensor(x) else x for x in args]


@pytest.mark.parametrize("name", ["cornell", "icospheres", "limit"])
def test_lane_kernel_matches_plain(dev, scene, name):
    """K4 against its plain version (constants, valid prefix, sweep) on a
    CPU copy, bit for bit: "cornell" has 36 valid triangles of 512 slots
    (trailing padding), "icospheres" 2,564 of 3,072, "limit" all 4,096 valid
    (the shared-memory limit, 208 KB)."""
    sc = {"cornell": lambda: b.cornell_box(device="cpu"), "icospheres": lambda: scene,
          "limit": lambda: b.random_scene(4092, extent=4.0, device="cpu")}[name]().to(dev)
    if name == "limit":
        assert sc.triangles.capacity == 4096 and bool(sc.triangles.valid.all())
    cam = CORNELL_CAM if name == "cornell" else CAM
    o, d = (x.reshape(-1, 3) for x in cam.to(dev).ray_grid(160, 117))  # not a block multiple
    args = _lane_args(sc, o, d)
    n0 = lane_pallas.lane_kernel.launches
    t, idx = lane_pallas.lane_kernel(*args)
    torch.cuda.synchronize()
    assert lane_pallas.lane_kernel.launches == n0 + 1
    t2, idx2 = lane_pallas._lane_plain(*_cpu(args))
    assert torch.equal(t.cpu(), t2) and torch.equal(idx.cpu(), idx2)
    assert (idx >= 0).float().mean().item() > 0.3
    t0, _ = lane_pallas.lane_kernel(*args[:5], o[:0], d[:0])
    assert t0.shape == (0,) and lane_pallas.lane_kernel.launches == n0 + 1


def _cornell_two_lights():
    """The Cornell shell and a second light of four faces on the ceiling:
    lights of 2 and 4 faces (L*F = 8, the first light's tri_idx padded)."""
    y = 1.98
    quads = [((0.4, y, -0.4), (0.4, y, -0.8), (0.6, y, -0.8), (0.6, y, -0.4)),
             ((0.6, y, -0.4), (0.6, y, -0.8), (0.8, y, -0.8), (0.8, y, -0.4))]
    light = MeshData(name="light2", vertices=b._quad_tris(quads), normals=None, uv=None,
                     material=b._CORNELL_MATERIALS["light"])
    sc = b.scene_from_mesh(b._cornell_shell() + [light], device="cpu")
    assert sc.lights.face_count.tolist() == [2, 4]
    return sc


FUSED_SCENES = {
    "cornell_g1": lambda: b.cornell_box(pad_multiple=128, device="cpu"),
    "cornell": lambda: b.cornell_box(device="cpu"),
    "mixed": lambda: b.mixed_scene(device="cpu"),
    "mirror": lambda: b.cornell_variant("mirror", device="cpu"),
    "limit": lambda: b.random_scene(2044, extent=4.0, device="cpu"),  # 2,048 valid
    "two_lights": _cornell_two_lights,
}


@pytest.mark.parametrize("name", list(FUSED_SCENES))
def test_fused_tables_kernel_matches_cpu(dev, name):
    """The table build on the card, bit for bit against the plain tensor-op
    version on the CPU (the tables that equal the JAX package's)."""
    sc = FUSED_SCENES[name]()
    if name == "limit":
        assert sc.triangles.capacity == fused_pallas.FUSED_TRI_LIMIT
    n0 = fused_pallas.fused_tables.launches
    got = fused_pallas.fused_tables(sc.to(dev))
    torch.cuda.synchronize()
    assert fused_pallas.fused_tables.launches == n0 + 1
    want = fused_pallas._fused_tables_plain(sc)
    for k, a, w in zip(("tcs", "shad", "sph", "lc", "cab", "counts", "n_tris"), got, want):
        a = a.cpu()
        assert a.dtype == w.dtype and a.shape == w.shape, k
        if a.is_floating_point():
            a, w = a.view(torch.int32), w.view(torch.int32)
        assert torch.equal(a, w), (k, int((a != w).sum()))


@pytest.mark.parametrize("name,cam,depth", [("cornell", CORNELL_CAM, 1),
                                            ("mixed", MIXED_CAM, 4),
                                            ("mirror", CORNELL_CAM, 2),
                                            ("two_lights", CORNELL_CAM, 1),
                                            ("two_lights", CORNELL_CAM, 3)])
def test_fused_kernel_matches_plain(dev, name, cam, depth):
    sc = FUSED_SCENES[name]().to(dev)
    o, d = (x.reshape(-1, 3).contiguous() for x in cam.to(dev).ray_grid(96, 71))
    ids = torch.arange(o.shape[0], device=dev) + 5
    tables = fused_pallas.fused_tables(sc)
    kw = dict(seed=1, eps=EPS, shadow_eps=1e-4, depth=depth, lights=sc.lights.num_lights,
              faces=sc.lights.max_faces)
    n0 = fused_pallas.fused_kernel.launches
    a = fused_pallas.fused_kernel(o, d, ids, *tables, **kw)
    torch.cuda.synchronize()
    assert fused_pallas.fused_kernel.launches == n0 + 1
    p = fused_pallas._fused_plain(o, d, ids, *tables, **kw)
    a, p = a.cpu().numpy(), p.cpu().numpy()
    assert np.isfinite(a).all() and a.sum() > 1.0
    diff = np.abs(a - p).max(-1)
    flipped = diff > 1e-2
    assert flipped.mean() <= 2e-3 and np.abs(a - p)[~flipped].max() <= 3e-5


def test_fused_frame_equals_its_rederivation_at_1080p(dev):
    """K3's depth-4 frame of config 4 (`mixed_scene()`, 1920x1080, the fit
    cell's camera) against the mxtile route's, which is what the fused
    backward re-derives: every pixel within 1e-3, on three seeds of the light
    draws. K3 adds its dots as torch.sum does on the card and divides the
    sphere normal and the light direction, so grazing sphere hits, whose t
    the sphere test's cancellation makes sensitive to the last ulp, reach the
    same surfaces and shadow tests on both."""
    from esctp1raytracer_tpu_torch.core.render import trace_rays

    sc = b.mixed_scene(device="cpu").to(dev)
    cam = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=16 / 9,
                         device="cpu").to(dev)
    o, d = (x.reshape(-1, 3).contiguous() for x in cam.ray_grid(1920, 1080))
    ids = torch.arange(o.shape[0], device=dev)
    for seed in (3100000011, 3100000604, 2**31 + 5):
        cfg = RenderConfig(backend="auto", depth=4, seed=seed)
        with torch.no_grad():
            fused = fused_pallas.fused_trace(o, d, sc, ids, cfg)
            rederived = trace_rays(o, d, sc, ids, cfg.replace(backend="mxtile"))
        off = (fused - rederived).abs().amax(-1)
        assert int((off > 1e-3).sum()) == 0, (seed, torch.nonzero(off > 1e-3).squeeze(1)[:16].tolist())


@pytest.mark.parametrize("count", [0, 1, 31, 33, 129, "stride"])
def test_fused_kernel_ray_counts(dev, count):
    """K3 at ray counts around the warp's 32-ray tile, and past the
    persistent grid's stride (two strides and a ragged tail), on the mixed
    scene at depth 2, against its plain version."""
    sc = b.mixed_scene(device="cpu").to(dev)
    kw = dict(seed=2, eps=EPS, shadow_eps=1e-4, depth=2, lights=sc.lights.num_lights,
              faces=sc.lights.max_faces)
    tables = fused_pallas.fused_tables(sc)
    n = tables[0].shape[1] // lane_pallas.TCS_W
    shape = fused_pallas.launch_shape(1 << 24, n, sc.spheres.capacity, kw["lights"], kw["faces"])
    stride = shape["blocks"] * shape["threads"]
    assert shape["blocks"] == torch.cuda.get_device_properties(dev).multi_processor_count * \
        shape["blocks_per_sm"]
    r = 2 * stride + 77 if count == "stride" else count
    w = 512
    o, d = (x.reshape(-1, 3)[:r].contiguous()
            for x in MIXED_CAM.to(dev).ray_grid(w, -(-max(r, 1) // w)))
    ids = torch.arange(r, device=dev) * 3
    n0 = fused_pallas.fused_kernel.launches
    a = fused_pallas.fused_kernel(o, d, ids, *tables, **kw)
    torch.cuda.synchronize()
    assert a.shape == (r, 3) and fused_pallas.fused_kernel.launches == n0 + (r > 0)
    p = fused_pallas._fused_plain(o, d, ids, *tables, **kw)
    diff = (a - p).abs().amax(-1)
    flipped = diff > 1e-2
    assert int(flipped.sum()) <= 2e-3 * r
    if r:
        assert np.isfinite(a.cpu().numpy()).all() and diff[~flipped].max().item() <= 3e-5


def test_fused_route_on_card_matches_cpu_and_differentiates(dev, monkeypatch):
    """The fused route on the card: the forward is one table build and one
    K3 launch, with neither `build_clusters` nor `lane_tri_constants`
    called; the backward's lane route launches K4 twice (camera and shadow
    rays) and builds no constants on the host either."""
    from esctp1raytracer_tpu_torch.accel import clusters
    from esctp1raytracer_tpu_torch.core.render import trace_rays

    scene = b.cornell_box(device="cpu")
    cfg = RenderConfig(backend="auto")
    a = render(scene, CORNELL_CAM, 48, 36, cfg).numpy()
    calls = []
    for mod, fn in ((clusters, "build_clusters"), (lane_pallas, "lane_tri_constants")):
        monkeypatch.setattr(mod, fn, lambda *x, _f=getattr(mod, fn), _n=fn: calls.append(_n)
                            or _f(*x))

    def launches():
        return (fused_pallas.fused_tables.launches, fused_pallas.fused_kernel.launches,
                lane_pallas.lane_kernel.launches)

    n0 = launches()
    sc = scene.to(dev)
    params = [p.detach().clone().requires_grad_(True) for p in float_params(sc)]
    o, d = (x.reshape(-1, 3) for x in CORNELL_CAM.to(dev).ray_grid(48, 36))
    color = trace_rays(o, d, merge_params(sc, params), torch.arange(o.shape[0], device=dev), cfg)
    torch.cuda.synchronize()
    assert [x - y for x, y in zip(launches(), n0)] == [1, 1, 0]
    grads = torch.autograd.grad((color * color).sum(), params)
    torch.cuda.synchronize()
    assert [x - y for x, y in zip(launches(), n0)] == [1, 1, 2]  # the backward's lane route
    assert calls == []
    diff = np.abs(color.detach().cpu().numpy().reshape(36, 48, 3) - a)
    assert diff.mean() < 1e-4 and (diff > 1e-2).mean() < 5e-3
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) >= 6


def test_lane_and_fused_wrappers_reject_bad_inputs(dev):
    sc = b.cornell_box()
    o, d = (x.reshape(-1, 3).contiguous() for x in CORNELL_CAM.to(dev).ray_grid(16, 16))
    eps, v0, v1, v2, valid, o, d = _lane_args(sc, o, d)
    with pytest.raises(ValueError, match="valid"):
        lane_pallas.lane_kernel(eps, v0, v1, v2, valid.long(), o, d)
    with pytest.raises(ValueError, match="v1"):
        lane_pallas.lane_kernel(eps, v0, v1.cpu(), v2, valid, o, d)
    with pytest.raises(ValueError, match="contiguous"):
        lane_pallas.lane_kernel(eps, v0, v1, v2, valid, o, d.t().contiguous().t())
    tables = fused_pallas.fused_tables(sc)
    kw = dict(seed=0, eps=EPS, shadow_eps=1e-4, depth=1, lights=1, faces=2)
    ids = torch.arange(256, device=dev)
    with pytest.raises(ValueError, match="limits"):
        fused_pallas.fused_kernel(o, d, ids, *tables, **dict(kw, depth=5))
    with pytest.raises(ValueError, match="counts"):
        fused_pallas.fused_kernel(o, d, ids, *tables[:5], tables[5].long(), tables[6], **kw)
    shifted = torch.empty(tables[1].numel() + 1, device=dev)[1:].view(tables[1].shape)
    shifted.copy_(tables[1])
    with pytest.raises(ValueError, match="aligned"):
        fused_pallas.fused_kernel(o, d, ids, tables[0], shifted, *tables[2:], **kw)
    big = b.random_scene(2100, extent=4.0)  # 2,104 triangles in 2,560 slots
    with pytest.raises(ValueError, match="limits"):
        fused_pallas.fused_tables(big)
    with pytest.raises(ValueError, match="ns"):
        fused_pallas.fused_tables(sc.map(lambda n, t: t.double() if n == "triangles.ns" else t))


def _tile_segments(tris, exclude_oversized=False):
    return tables.Tables(tris).segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT,
                                        exclude_oversized)


def _tile_args(tris, o, d, tl, exclude_oversized):
    (tc, aabbs, _), = _tile_segments(tris, exclude_oversized)
    ov_buf = tables.cluster_sort(tris)[3]
    return torch.tensor([EPS], device=o.device), tables.pad_rays(o, d, tl), aabbs, tc, ov_buf


def _shadow_rays(sc, o, d, light):
    hit = closest_hit(o, d, sc, EPS, tri_search=rt_tile.tile_tri_search)
    hp = o + d * (torch.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
    lv = torch.tensor(light, device=o.device) - hp
    dist = lv.norm(dim=-1)
    return hp, lv / dist[:, None], torch.where(hit.hit, dist - 1e-4, -1.0)


def _axis_rays(aabbs, n=3000, seed=0):
    """Rays along +-x, +-y, +-z (the other components +-0) from origins on
    a plane of a sub-block box: their slab values include 0 * inf = NaN."""
    rng = np.random.RandomState(seed)
    ab = aabbs.cpu().numpy()
    live = np.flatnonzero((ab[0:3] <= ab[3:6]).all(0))
    box = live[rng.randint(0, live.size, n)]
    lo, hi = ab[0:3, box].T, ab[3:6, box].T
    o = rng.uniform(lo, hi).astype(np.float32)
    axis, along = rng.randint(0, 3, n), rng.randint(0, 3, n)
    o[np.arange(n), axis] = np.where((rng.rand(n) < 0.5)[:, None], lo, hi)[np.arange(n), axis]
    sign = np.where(rng.rand(n) < 0.5, 1.0, -1.0).astype(np.float32)
    d = np.zeros((n, 3), np.float32) * -sign[:, None]
    d[np.arange(n), along] = sign
    return torch.from_numpy(o), torch.from_numpy(d)


@pytest.mark.parametrize("name", ["mesh", "soup", "axis", "padded"])
def test_tile_kernels_match_plain(dev, name):
    """K5 and K6 against their plain versions, bit for bit: K5 on a camera
    wavefront without and with a t-limit cull, K6 on its shadow wavefront
    with the oversized sub-block (and equal to the segment sweep ORed with
    `_oversized_occl`); each kernel with and without cnt_out (counting
    tests the groups that hold padding box by box), and cnt_out equal to
    the plain lists' cnt. "axis": axis-aligned rays whose origins lie on
    box planes; "padded": the mesh's table followed by 64 padding-only
    sub-blocks, so that two groups of 32 hold nothing else."""
    sc = b.mesh_scene(3) if name != "soup" else b.random_scene(3000, extent=4.0)
    cam = CAM if name != "soup" else Camera.look_at((0.0, 5.0, 12.0), (0.0, 1.0, 0.0),
                                                    vfov=60.0, aspect=4 / 3, device="cpu")
    tris = sc.triangles
    if name == "padded":
        filler = TriangleBuffer.empty(64 * 128, device=dev)
        tris = tris.map(lambda leaf, a: torch.cat([a, getattr(filler, leaf)]))
    if name == "axis":
        o, d = (x.to(dev) for x in _axis_rays(_tile_segments(tris)[0][1]))
    else:
        o, d = (x.reshape(-1, 3).contiguous() for x in cam.to(dev).ray_grid(160, 117))
    r = o.shape[0]
    tl = torch.full((r,), 9.0, device=dev)
    for limit in (None, tl):
        eps, rays, aabbs, tc, _ = _tile_args(tris, o, d, limit, False)
        cnt, cnt2 = (torch.full((rays.shape[0] // 8,), -1, dtype=torch.int32, device=dev)
                     for _ in range(2))
        n0 = rt_tile.tile_kernel.launches
        t, idx = rt_tile.tile_kernel(eps, rays, aabbs, tc, cnt)
        t1, idx1 = rt_tile.tile_kernel(eps, rays, aabbs, tc)
        torch.cuda.synchronize()
        assert rt_tile.tile_kernel.launches == n0 + 2
        t2, idx2 = rt_tile._tile_search_plain(eps, rays, aabbs, tc, cnt2)
        assert torch.equal(t, t2) and torch.equal(idx, idx2) and torch.equal(cnt, cnt2)
        assert torch.equal(t1, t2) and torch.equal(idx1, idx2)
        assert (idx[:r] >= 0).float().mean().item() > (0.0 if name == "axis" else 0.3)
    if name == "padded":
        assert int(cnt.min()) >= 64

    if name == "axis":
        hp, sd, stl = o, d, torch.from_numpy(np.random.RandomState(1).uniform(
            -1.0, 6.0, r).astype(np.float32)).to(dev)
    else:
        hp, sd, stl = _shadow_rays(sc, o, d, [0.3, 5.9, 2.2] if name != "soup"
                                   else [0.2, 5.9, 0.1])
    eps, rays, aabbs, tc, ov_buf = _tile_args(tris, hp, sd, stl, True)
    ov, _ = tables.pack_planes(ov_buf)
    cnt, cnt2 = (torch.full((rays.shape[0] // 8,), -1, dtype=torch.int32, device=dev)
                 for _ in range(2))
    n0 = rt_tile.tile_occl_kernel.launches
    occ = rt_tile.tile_occl_kernel(eps, rays, aabbs, tc, ov, cnt)
    occ1 = rt_tile.tile_occl_kernel(eps, rays, aabbs, tc, ov)
    torch.cuda.synchronize()
    assert rt_tile.tile_occl_kernel.launches == n0 + 2
    occ2 = rt_tile._tile_occl_plain(eps, rays, aabbs, tc, ov, cnt2)
    assert torch.equal(occ, occ2) and torch.equal(occ1, occ2) and torch.equal(cnt, cnt2)
    split = (rt_tile._tile_occl_plain(eps, rays, aabbs, tc)[:r] > 0) | rt_tile._oversized_occl(
        hp, sd, stl, ov_buf, EPS)
    assert torch.equal(occ[:r] > 0, split)
    assert 0.01 < occ[:r].float().mean().item() < 0.99


def test_tile_segments_on_card_match_cpu(dev, monkeypatch):
    """A multi-segment table (TILE_TRI_LIMIT cut to 1024: two segments) on
    the card against the port on the CPU (plain versions)."""
    monkeypatch.setattr(rt_tile, "TILE_TRI_LIMIT", 1024)
    sc = b.mesh_scene(3, device="cpu")
    o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(96, 72))
    tl = torch.full((o.shape[0],), 5.5)
    ref = (*rt_tile.tile_tri_search(o, d, sc.triangles, EPS),
           rt_tile.tile_occlusion(o, d, tl, sc.triangles, EPS))
    n0 = (rt_tile.tile_kernel.launches, rt_tile.tile_occl_kernel.launches)
    tris = sc.to(dev).triangles
    got = (*rt_tile.tile_tri_search(o.to(dev), d.to(dev), tris, EPS),
           rt_tile.tile_occlusion(o.to(dev), d.to(dev), tl.to(dev), tris, EPS))
    torch.cuda.synchronize()
    assert (rt_tile.tile_kernel.launches, rt_tile.tile_occl_kernel.launches) == (n0[0] + 2,
                                                                                 n0[1] + 2)
    same = got[1].cpu() == ref[1]
    assert same.float().mean().item() >= 0.999
    rel = (got[0].cpu() - ref[0]).abs()[same] / ref[0].abs()[same].clamp(min=1.0)
    assert rel.max().item() < 1e-5
    assert (got[2].cpu() == ref[2]).float().mean().item() >= 0.999
    assert bool(ref[2].any()) and (ref[1] >= 0).float().mean().item() > 0.3


def test_tile_route_on_card_matches_cpu_and_differentiates(dev):
    sc = b.mesh_scene(3, device="cpu")
    cfg = RenderConfig(backend="tile")
    a = render(sc, CAM, 64, 48, cfg).numpy()
    n0 = (rt_tile.tile_kernel.launches, rt_tile.tile_occl_kernel.launches)
    scd = sc.to(dev)
    params = [p.detach().clone().requires_grad_(True) for p in float_params(scd)]
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(64, 48))
    from esctp1raytracer_tpu_torch.core.render import trace_rays

    color = trace_rays(o, d, merge_params(scd, params), torch.arange(o.shape[0], device=dev), cfg)
    grads = torch.autograd.grad((color * color).sum(), params, allow_unused=True)
    torch.cuda.synchronize()
    assert rt_tile.tile_kernel.launches == n0[0] + 1
    assert rt_tile.tile_occl_kernel.launches == n0[1] + 1
    diff = np.abs(color.detach().cpu().numpy().reshape(48, 64, 3) - a)
    assert diff.mean() < 1e-4 and (diff > 1e-2).mean() < 5e-3
    grads = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(bool((g != 0).any()) for g in grads) >= 6


def test_tile_wrappers_reject_bad_inputs(dev):
    sc = b.mesh_scene(2)
    o, d = (x.reshape(-1, 3).contiguous() for x in CAM.to(dev).ray_grid(16, 16))
    eps, rays, aabbs, tc, _ = _tile_args(sc.triangles, o, d, None, False)
    with pytest.raises(ValueError, match="cnt_out"):
        rt_tile.tile_kernel(eps, rays, aabbs, tc, cnt_out=torch.zeros(32, dtype=torch.int64,
                                                                      device=dev))
    with pytest.raises(ValueError, match="rays"):
        rt_tile.tile_occl_kernel(eps, rays[:, :7].contiguous(), aabbs, tc)
    with pytest.raises(ValueError, match="tc"):
        rt_tile.tile_kernel(eps, rays, aabbs, tc.cpu())
    with pytest.raises(ValueError, match="ov"):
        rt_tile.tile_occl_kernel(eps, rays, aabbs, tc, tc)
    with pytest.raises(ValueError, match="sub-blocks"):
        rt_tile.tile_kernel(eps, rays, torch.zeros(8, 1025, device=dev), tc)


def test_one_rank_nccl_loss_and_grad_equals_single_device(dev, scene, monkeypatch):
    """One rank on one card: the backend rule picks NCCL, and the sharded
    loss and gradients, all-reduced through it, equal the single-device
    ones within tests/test_sharding.py:120-122's bars."""
    import socket

    import torch.distributed as dist

    from esctp1raytracer_tpu_torch.parallel import (
        init_distributed, loss_and_grad_sharded, make_mesh,
    )

    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"localhost:{port}", 1, 0) == 1
    try:
        assert dist.get_backend() == "nccl"
        sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend="mxtile")
        target = torch.zeros((48, 64, 3), device=dev)
        loss, grads = loss_and_grad_sharded(sc, target, cam, cfg, make_mesh())
        params = [p.detach().requires_grad_(True) for p in float_params(sc)]
        ref = torch.mean((render(merge_params(sc, params), cam, 64, 48, cfg) - target) ** 2)
        ref_grads = torch.autograd.grad(ref, params, allow_unused=True)
        np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-5)
        for g, r in zip(grads, ref_grads):
            r = torch.zeros_like(g) if r is None else r
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), rtol=1e-3, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_fit_scene_on_card_matches_cpu(dev, tmp_path):
    """Three Adam steps on the card (fused forward, lane backward) match the
    CPU's; the checkpoint comes back on the card with the template's dtypes."""
    import dataclasses

    from esctp1raytracer_tpu_torch.grad import fit_scene
    from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint

    cfg, runs = RenderConfig(backend="auto"), {}
    for device in ("cpu", dev):
        true = b.sphere_plane_scene(device=device)
        cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), aspect=1.0, device=device)
        start = dataclasses.replace(true, spheres=dataclasses.replace(
            true.spheres, kd=true.spheres.kd * 0.5, ks=true.spheres.ks * 0.5))
        path = str(tmp_path / f"{torch.device(device).type}.npz")
        runs[device] = (fit_scene(start, render(true, cam, 32, 32, cfg), cam, steps=3, lr=0.05,
                                  cfg=cfg, checkpoint_path=path, log_every=0,
                                  param_filter=lambda i, p: p is start.spheres.kd
                                  or p is start.spheres.ks), start, path)
    (cpu, _, _), (card, start, path) = runs["cpu"], runs[dev]
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)
    for field in ("kd", "ks"):
        np.testing.assert_allclose(getattr(card.scene.spheres, field).cpu().numpy(),
                                   getattr(cpu.scene.spheres, field).numpy(), atol=1e-5)
    loaded, step, extra = load_checkpoint(path, start)
    assert step == 3 and int(extra["adam_t"]) == 3
    for (name, a), (_, want) in zip(loaded.leaves(), card.scene.leaves()):
        assert a.device == want.device and a.dtype == want.dtype, name
        assert torch.equal(a, want), name


# --------------------------------------------------------------------------
# CUDA graphs (utils/graphs.py): chip_smoke.py path M's checks at small sizes
# --------------------------------------------------------------------------


def _grads_within(got, ref):
    """chip_smoke.py grads_agreement's bars, leaf by leaf (the backward's
    index_add_ atomics sum in another order per run): |g - ref| <= 3e-4 *
    max|ref| + 3e-3 * |ref|."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if r is not None:
            scale = max(r.abs().max().item(), 1e-6)
            assert bool(((g - r).abs() <= 3e-4 * scale + 3e-3 * r.abs()).all())


def _graph_step(scene, o, d, cfg):
    """step(ids) -> (image, gradients of sum(color^2) w.r.t. every float leaf)."""
    params = [p.detach().requires_grad_(True) for p in float_params(scene)]

    def step(ids):
        from esctp1raytracer_tpu_torch.core.render import trace_rays

        color = trace_rays(o, d, merge_params(scene, params), ids, cfg)
        grads = torch.autograd.grad(torch.sum(color * color), params, allow_unused=True)
        return color.detach(), grads

    return step


# route: (scene, camera, cfg); "chunked": the fused backward's mxtile
# re-derivation in ray chunks (config 4's rule, at this size).
GRAPH_ROUTES = {
    "mxtile": ("icospheres", CAM, RenderConfig(backend="mxtile")),
    "tile": ("icospheres", CAM, RenderConfig(backend="tile")),
    "lane": ("icospheres", CAM, RenderConfig(backend="lane")),
    "fused": ("cornell", CORNELL_CAM, RenderConfig(backend="auto")),
    "chunked": ("cornell", CORNELL_CAM, RenderConfig(backend="auto", depth=3)),
}


@pytest.mark.parametrize("route", list(GRAPH_ROUTES))
def test_graphed_step_equals_eager(dev, scene, route, monkeypatch):
    """A step captured and replayed: the image bit-equal to the eager step's,
    the gradients within grads_agreement's bars, each kernel's launches per
    replay equal to the eager step's; other ray ids give another image,
    equal to the eager one at those ids."""
    from esctp1raytracer_tpu_torch.kernels import launches
    from esctp1raytracer_tpu_torch.utils import graphs

    if route == "chunked":
        monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
        monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", 4096)
    name, cam, cfg = GRAPH_ROUTES[route]
    sc = scene.to(dev) if name == "icospheres" else b.cornell_box(device=dev)
    o, d = (x.reshape(-1, 3).contiguous() for x in cam.to(dev).ray_grid(96, 72))
    ids = torch.arange(o.shape[0], dtype=torch.int64, device=dev)
    step = _graph_step(sc, o, d, cfg)
    g = graphs.graphed(step)
    try:
        want, eager = launches.counted(lambda: step(ids))
        g(ids + 1)  # eager
        g(ids + 2)  # the capture
        assert len(g.cache) == 1
        (img, grads), replay = launches.counted(lambda: g(ids))
        assert replay == eager and sum(eager.values()) > 0, (replay, eager)
        assert torch.equal(img, want[0])
        _grads_within(grads, want[1])
        img2, _ = g(ids + 7 * o.shape[0])
        assert not torch.equal(img2, img)
        assert torch.equal(img2, step(ids + 7 * o.shape[0])[0])
    finally:
        graphs.clear()


def test_graphed_render_and_fit_step_equal_eager(dev, scene):
    """`render` and the fit step (`optimize.loss_and_grad`) replayed: the
    image bit-equal, the loss within 1e-5 relative and the gradients within
    grads_agreement's bars of the eager call, the launches per replay equal;
    new scene values reach the graph."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.kernels import launches
    from esctp1raytracer_tpu_torch.utils import graphs

    sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend="auto")
    try:
        with torch.no_grad():
            want = render.__wrapped__(sc, cam, 64, 48, cfg)
            for _ in range(3):
                assert torch.equal(render(sc, cam, 64, 48, cfg), want)
        frozen = (False,) * len(float_params(sc))
        args = (sc, want * 0.8, cam, 64, 48, cfg, frozen)
        (loss0, grads0), eager = launches.counted(lambda: optimize.loss_and_grad.__wrapped__(*args))
        optimize.loss_and_grad(*args)
        optimize.loss_and_grad(*args)
        (loss, grads), replay = launches.counted(lambda: optimize.loss_and_grad(*args))
        assert replay == eager and sum(eager.values()) > 0, (replay, eager)
        assert abs(loss.item() - loss0.item()) <= 1e-5 * abs(loss0.item())
        _grads_within(grads, grads0)
        brighter = dataclasses.replace(sc, triangles=dataclasses.replace(
            sc.triangles, kd=sc.triangles.kd * 1.5))
        args = (brighter,) + args[1:]
        loss2, _ = optimize.loss_and_grad(*args)
        loss3, _ = optimize.loss_and_grad.__wrapped__(*args)
        assert loss2.item() != loss.item()
        assert abs(loss2.item() - loss3.item()) <= 1e-5 * abs(loss3.item())
        assert len(render.cache) == 1 and len(optimize.loss_and_grad.cache) == 1
    finally:
        graphs.clear()


def test_capture_at_trace_level_raises(dev, scene, capsys):
    """At TRACE the first, eager call prints the per-bounce summary; the
    capture that would follow raises."""
    from esctp1raytracer_tpu_torch.utils import debug, graphs

    sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend="lane")
    level = debug.current_level()
    debug.set_level(debug.TRACE)
    try:
        with torch.no_grad():
            render(sc, cam, 40, 30, cfg)
            assert "trace[bounce 0]" in capsys.readouterr().out
            with pytest.raises(RuntimeError, match="TRACE"):
                render(sc, cam, 40, 30, cfg)
    finally:
        debug.set_level(level)
        graphs.clear()


def test_failed_capture_raises_without_eager_retry(dev):
    """A host read inside the captured function fails the capture: the call
    raises, and nothing runs the function again eagerly."""
    from esctp1raytracer_tpu_torch.utils import graphs

    calls = []

    def f(x):
        calls.append(1)
        return x * float(x.sum())

    g = graphs.graphed(f)
    x = torch.ones(4, device=dev)
    try:
        assert torch.equal(g(x), x * 4)
        with pytest.raises(RuntimeError):
            g(x)
        assert len(calls) == 2
        torch.cuda.synchronize()
        assert torch.equal(x * 2, torch.full((4,), 2.0, device=dev))  # the card still works
    finally:
        graphs.clear()


# --------------------------------------------------------------------------
# The JAX package's selectable pre-pass modes on the card (rt_tile.CULL_MODE,
# HIER_K, OCCL_EARLY_EXIT; rt_mxu.CULL_MODE)
# --------------------------------------------------------------------------

# case: (mode, HIER_K, early exit E); "hier-overflow": every bundle with two
# kept superblocks sweeps every sub-block.
TILE_MODES = {
    "exact": ("exact", 32, 0),
    "interval": ("interval", 32, 0),
    "hier": ("hier", 32, 0),
    "hier-overflow": ("hier", 1, 0),
    "entry": ("entry", 32, 0),
    "entry-E1": ("entry", 32, 1),
    "entry-E8": ("entry", 32, 8),
    "argsort-E8": ("argsort", 32, 8),
}


@pytest.mark.parametrize("case", list(TILE_MODES))
@pytest.mark.parametrize("name", ["mesh", "padded"])
def test_tile_mode_kernels_match_plain(dev, monkeypatch, case, name):
    """K5 (not for "entry": K5 takes ascending lists only) and K6 in each
    mode against their plain versions in the same mode, bit for bit, with
    and without cnt_out, cnt_out equal to the plain lists' cnt. "padded":
    64 padding-only sub-blocks, which every bundle keeps: more than 32 kept
    sub-blocks, so "exact" and "interval" take their dense fallback."""
    mode, hier_k, period = TILE_MODES[case]
    monkeypatch.setattr(rt_tile, "HIER_K", hier_k)
    sc = b.mesh_scene(3)
    tris = sc.triangles
    if name == "padded":
        filler = TriangleBuffer.empty(64 * 128, device=dev)
        tris = tris.map(lambda leaf, a: torch.cat([a, getattr(filler, leaf)]))
    o, d = (x.reshape(-1, 3).contiguous() for x in CAM.to(dev).ray_grid(160, 117))
    r = o.shape[0]

    def counted(fn, *args, **kw):
        cnt = torch.full((args[1].shape[0] // 8,), -1, dtype=torch.int32, device=dev)
        return fn(*args, cnt_out=cnt, **kw), cnt

    if mode != "entry":
        for limit in (None, torch.full((r,), 9.0, device=dev)):
            eps, rays, aabbs, tc, _ = _tile_args(tris, o, d, limit, False)
            (t, idx), cnt = counted(rt_tile.tile_kernel, eps, rays, aabbs, tc, mode=mode)
            t1, idx1 = rt_tile.tile_kernel(eps, rays, aabbs, tc, mode=mode)
            (t2, idx2), cnt2 = counted(rt_tile._tile_search_plain, eps, rays, aabbs, tc, mode=mode)
            torch.cuda.synchronize()
            assert torch.equal(cnt, cnt2)
            assert torch.equal(t, t2) and torch.equal(idx, idx2)
            assert torch.equal(t1, t2) and torch.equal(idx1, idx2)
            assert (idx[:r] >= 0).float().mean().item() > 0.3
    else:
        with pytest.raises(ValueError, match="entry"):
            rt_tile.tile_kernel(*_tile_args(tris, o, d, None, False)[:4], mode=mode)
    hp, sd, stl = _shadow_rays(sc.to(dev), o, d, [0.3, 5.9, 2.2])
    eps, rays, aabbs, tc, ov_buf = _tile_args(tris, hp, sd, stl, True)
    ov, _ = tables.pack_planes(ov_buf)
    kw = dict(mode=mode, early_exit=period)
    occ, cnt = counted(rt_tile.tile_occl_kernel, eps, rays, aabbs, tc, ov, **kw)
    occ1 = rt_tile.tile_occl_kernel(eps, rays, aabbs, tc, ov, **kw)
    occ2, cnt2 = counted(rt_tile._tile_occl_plain, eps, rays, aabbs, tc, ov, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cnt, cnt2)
    assert torch.equal(occ, occ2) and torch.equal(occ1, occ2)
    assert torch.equal(occ, rt_tile.tile_occl_kernel(eps, rays, aabbs, tc, ov))  # the default's
    assert 0.01 < occ[:r].float().mean().item() < 0.99
    if name == "padded" and mode in ("exact", "interval"):
        assert int(cnt.max()) == aabbs.shape[1]


@pytest.mark.parametrize("mode", ["exact", "interval"])
@pytest.mark.parametrize("name", ["icospheres", "padded"])
def test_mxu_mode_kernels_match_plain(dev, scene, name, mode):
    """K1 and K2 in each mode against the plain version in the same mode:
    tests/test_rt_mxu.py's bars, cnt_out equal to `_prep_mxu`'s cnt in that
    mode, the outputs equal to the default kernels'."""
    tris = _mxu_tris(scene, dev, name)
    o, d = (x.reshape(-1, 3) for x in CAM.to(dev).ray_grid(160, 117))
    r = o.shape[0]
    eps, rays, aabbs, tfq = _mxu_args(tris, o, d, None, False)
    cnt = torch.full((rays.shape[0] // 128,), -1, dtype=torch.int32, device=dev)
    t, idx = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq, cnt, mode=mode)
    t1, idx1 = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq, mode=mode)
    torch.cuda.synchronize()
    want_cnt = rt_mxu._prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6], cull_mode=mode)[2]
    assert torch.equal(cnt, want_cnt)
    assert torch.equal(t, t1) and torch.equal(idx, idx1)
    t2, idx2 = rt_mxu._mxu_search_plain(eps, rays, aabbs, tfq, mode=mode)
    same = idx == idx2
    assert same.float().mean().item() >= 0.999
    assert ((t - t2).abs()[same] / t2.abs()[same].clamp(min=1.0)).max().item() < 1e-5
    t0, idx0 = rt_mxu.mxu_kernel(eps, rays, aabbs, tfq)  # the default's
    assert torch.equal(t[:r], t0[:r]) and torch.equal(idx[:r], idx0[:r])
    sc = scene.to(dev)
    hit = closest_hit(o, d, sc, EPS, tri_search=rt_mxu.mxu_tile_search)
    hp = o + d * (torch.where(hit.hit, hit.t, 1.0)[:, None] - 1e-4)
    lv = torch.tensor([0.3, 8.0, 2.2], device=dev) - hp
    dist = lv.norm(dim=-1)
    eps, rays, aabbs, tfq = _mxu_args(tris, hp, lv / dist[:, None],
                                      torch.where(hit.hit, dist - 1e-4, -1.0), True)
    ov, _ = tables.pack_planes(tables.cluster_sort(tris)[3])
    cnt = torch.full_like(cnt, -1)
    occ = rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, ov, cnt, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(cnt, rt_mxu._prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6],
                                             cull_mode=mode)[2])
    occ2 = rt_mxu._mxu_occl_plain(eps, rays, aabbs, tfq, ov, mode=mode)
    assert (occ == occ2).float().mean().item() >= 0.999
    assert torch.equal(occ, rt_mxu.mxu_occl_kernel(eps, rays, aabbs, tfq, ov))  # the default's


# switch: (module, name, value, backend); each run by `render` on the card.
SWITCH_FLIPS = {
    "tile-interval": (rt_tile, "CULL_MODE", "interval", "tile"),
    "tile-hier": (rt_tile, "CULL_MODE", "hier", "tile"),
    "tile-early-exit": (rt_tile, "OCCL_EARLY_EXIT", 8, "tile"),
    "mxtile-exact": (rt_mxu, "CULL_MODE", "exact", "mxtile"),
}


@pytest.mark.parametrize("flip", list(SWITCH_FLIPS))
def test_graphed_render_follows_a_flipped_switch(dev, scene, monkeypatch, flip):
    """A switch flipped between two graphed `render` calls takes effect at
    the next call: a new key, whose eager warm-up passes the new mode to
    the kernel wrapper, and whose replay equals the eager render under the
    switch (not the graph captured before the flip)."""
    from esctp1raytracer_tpu_torch.utils import graphs

    mod, name, value, backend = SWITCH_FLIPS[flip]
    sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend=backend)
    seen = []
    spy = rt_tile.tile_kernel if backend == "tile" else rt_mxu.mxu_kernel

    def spied(*args, **kw):
        seen.append(kw)
        return spy(*args, **kw)

    spied.launches = 0
    monkeypatch.setattr(rt_tile if backend == "tile" else rt_mxu, spy.__name__, spied)
    graphs.clear()
    try:
        with torch.no_grad():
            for _ in range(3):  # eager, capture, replay
                before = render(sc, cam, 64, 48, cfg)
            assert len(render.cache) == 1
            seen.clear()
            monkeypatch.setattr(mod, name, value)
            after = [render(sc, cam, 64, 48, cfg) for _ in range(3)]
            with graphs.disabled():
                want = render(sc, cam, 64, 48, cfg)
        assert len(render.cache) == 2
        assert seen, "the flipped key ran no search eagerly"
        if name == "CULL_MODE":
            assert all(kw["mode"] == value for kw in seen), seen
        for img in after:
            assert torch.equal(img, want)
        assert torch.isfinite(before).all()
    finally:
        graphs.clear()


# --------------------------------------------------------------------------
# Spans inside the CUDA graphs (utils/profiling.py, utils/graphs.py)
# --------------------------------------------------------------------------

SPAN_W, SPAN_H = 960, 540  # the searches and shading well above a launch's latency


def _profiled(fn, n):
    """fn() n times under torch.profiler: (the last result, the profile)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            out = fn()
    return out, prof


def _last_replay(profiling):
    """The newest `graphs.call` root and its `graphs.replay` span."""
    root = [r for r in profiling.records() if r.name == "graphs.call"][-1]
    (replay,) = root.find("graphs.replay")
    return root, replay


def _spans_cover_replay(profiling, prof, replay):
    """The replay's top-level spans sum to it within 3%, and the profiler
    draws no span on the device."""
    top = sum(r.device_ms for r in replay.children)
    assert replay.children and abs(top - replay.device_ms) <= 0.03 * replay.device_ms, (
        [(r.name, r.device_ms) for r in replay.children], replay.device_ms)
    names = {r.name for root in profiling.records() for r in [root] + root.children}
    names |= {"intersect.closest_hit", "shading.shade", "optimize.backward", "rt_mxu.prepass"}
    drawn = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA} & names
    assert not drawn, drawn


def test_spanned_twin_render_bit_equal_timed_and_counted(dev, scene):
    """Under torch.profiler a graphed render whose plain graph is captured gets
    a spanned twin, captured (two graphs, replayed in turn) without a second
    eager call: its replays bit-equal to the plain graph's; its top-level spans (`camera.ray_grid`, the search,
    the shading) sum to its `graphs.replay` span within 3%; K1's tested-block
    count equals the sum of `_prep_mxu`'s list lengths on the same rays. With
    the profiler stopped the plain graph replays again."""
    from esctp1raytracer_tpu_torch.core.intersect import _sphere_best
    from esctp1raytracer_tpu_torch.utils import graphs, profiling

    sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend="mxtile")
    calls = []
    fn = render.fn
    try:
        with torch.no_grad():
            render(sc, cam, SPAN_W, SPAN_H, cfg)  # eager
            plain = render(sc, cam, SPAN_W, SPAN_H, cfg)  # the capture
            assert torch.equal(render(sc, cam, SPAN_W, SPAN_H, cfg), plain)
            render.fn = lambda *a, **k: calls.append(1) or fn(*a, **k)
            profiling.reset()
            twin, prof = _profiled(lambda: render(sc, cam, SPAN_W, SPAN_H, cfg), 3)
            assert len(render.cache) == 2 and len(calls) == 2  # the twin's two captures alone
            assert torch.equal(twin, plain)
            assert torch.equal(render(sc, cam, SPAN_W, SPAN_H, cfg), plain)
            assert len(calls) == 2 and profiling.counters()["graphs.twin_captures"] == 1
            root, replay = _last_replay(profiling)
            assert [r.name for r in replay.children] == [
                "camera.ray_grid", "intersect.closest_hit", "shading.shade"]
            _spans_cover_replay(profiling, prof, replay)
            o, d = (x.reshape(-1, 3).contiguous() for x in cam.ray_grid(SPAN_W, SPAN_H))
            hint, _ = _sphere_best(o, d, sc.spheres, EPS)
            (tfq, aabbs, _), = _mxu_segments(sc.triangles, False)
            want = int(_mxu_cnt(tables.pad_rays(o, d, hint), aabbs).sum())
            assert root.count("rt_mxu.closest_hit_blocks") == want > 0
            assert root.count("rt_mxu.any_hit_blocks") > 0
            assert root.counts["alloc.device_mallocs"] >= 0
    finally:
        render.fn = fn
        graphs.clear()


def test_spanned_twin_fit_step_bit_equal_and_timed(dev, scene):
    """The fit step's spanned twin: the loss bit-equal to the plain graph's
    and the gradients within grads_agreement's bars (the backward's
    scatter-adds are atomic, so two replays of one graph can differ in the
    last bits); `optimize.loss` and `optimize.backward` sum to the replay
    within 3%; each step's Adam update is a root span of its own, timed on
    the card."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import graphs, profiling

    sc, cam, cfg = scene.to(dev), CAM.to(dev), RenderConfig(backend="auto")
    frozen = (False,) * len(float_params(sc))
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, SPAN_W, SPAN_H, cfg) * 0.8
    args = (sc, target, cam, SPAN_W, SPAN_H, cfg, frozen)
    try:
        optimize.loss_and_grad(*args)
        loss0, grads0 = optimize.loss_and_grad(*args)
        profiling.reset()

        def step():
            loss, grads = optimize.loss_and_grad(*args)
            params = float_params(sc)
            optimize.adam_update(params, [torch.zeros_like(p) if g is None else g
                                          for p, g in zip(params, grads)],
                                 optimize.adam_init(params))
            return loss, grads

        (loss, grads), prof = _profiled(step, 3)
        assert torch.equal(loss, loss0)
        _grads_within(grads, grads0)
        _, replay = _last_replay(profiling)
        assert [r.name for r in replay.children] == ["optimize.loss", "optimize.backward"]
        _spans_cover_replay(profiling, prof, replay)
        adam = [r for r in profiling.records() if r.name == "optimize.adam"]
        assert len(adam) == 3 and all(r.device_ms > 0 for r in adam)
    finally:
        graphs.clear()


def test_spanned_twin_rederive_timed_and_counted(dev, monkeypatch):
    """Config 4's scene (`mixed_scene()`, depth 4) at 480x270 with the fused
    backward's chunked mxtile branch shrunk to that size (4 chunks of 32,768
    rays at most): each replay of the graphed fit step's spanned twin holds one
    `fused.rederive` inside `optimize.backward`, timed on the card, with its
    chunk, ray and reflection-ray counts equal to the eager profiled step's."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import graphs, profiling

    monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
    monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", 32768)
    sc = b.mixed_scene(device="cpu").to(dev)
    cam = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=16 / 9,
                         device="cpu").to(dev)
    cfg, w, h = RenderConfig(backend="auto", depth=4), 480, 270
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, w, h, cfg) * 0.8
    args = (sc, target, cam, w, h, cfg, (False,) * len(float_params(sc)))
    names = ("fused.rederive_chunks", "fused.rederive_rays", "render.reflect_rays",
             "render.reflect_live")
    try:
        with graphs.disabled():
            profiling.reset()
            _profiled(lambda: optimize.loss_and_grad(*args), 1)
            (eager,) = [r for root in profiling.records() for r in root.find("fused.rederive")]
            want = {n: eager.count(n) for n in names}
        assert want["fused.rederive_chunks"] == 4 and want["fused.rederive_rays"] == w * h
        assert want["render.reflect_rays"] == 3 * w * h and 0 < want["render.reflect_live"]
        optimize.loss_and_grad(*args)
        optimize.loss_and_grad(*args)
        profiling.reset()
        _profiled(lambda: optimize.loss_and_grad(*args), 3)
        roots = [r for r in profiling.records() if r.name == "graphs.call"]
        assert len(roots) == 3
        for root in roots:
            (backward,) = root.find("optimize.backward")
            (span,) = backward.find("fused.rederive")
            assert 0 < span.device_ms <= backward.device_ms
            assert {n: span.count(n) for n in names} == want
    finally:
        graphs.clear()


def test_graphed_rederive_builds_its_search_tables_on_each_replay(dev, monkeypatch):
    """Config 4's fit step with the chunked mxtile re-derivation (4 chunks x 4
    bounces at 480x270: 32 searches, one scene-table build), captured, then
    replayed on the scene an Adam step moved: the replay's loss within 1e-5
    relative and its gradients within grads_agreement's bars of the eager step
    on the moved scene. The replay runs no Python, so the one build it holds
    ran again on the moved leaves."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import graphs

    monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
    monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", 32768)
    builds = []
    build = tables.build_clusters
    monkeypatch.setattr(tables, "build_clusters", lambda tris: builds.append(1) or build(tris))
    sc = b.mixed_scene(device="cpu").to(dev)
    cam = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=16 / 9,
                         device="cpu").to(dev)
    cfg, w, h = RenderConfig(backend="auto", depth=4), 480, 270
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, w, h, cfg) * 0.8
    frozen = (False,) * len(float_params(sc))
    try:
        loss0, grads0 = optimize.loss_and_grad(sc, target, cam, w, h, cfg, frozen)  # eager
        optimize.loss_and_grad(sc, target, cam, w, h, cfg, frozen)  # the capture
        assert len(builds) == 2 and len(optimize.loss_and_grad.cache) == 1
        params = float_params(sc)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads0)]
        moved = merge_params(sc, optimize.adam_update(params, grads, optimize.adam_init(params))[0])
        loss, got = optimize.loss_and_grad(moved, target, cam, w, h, cfg, frozen)  # a replay
        assert len(builds) == 2 and len(optimize.loss_and_grad.cache) == 1
        loss1, want = optimize.loss_and_grad.__wrapped__(moved, target, cam, w, h, cfg, frozen)
        assert len(builds) == 3
        assert loss1.item() != loss0.item()
        assert abs(loss.item() - loss1.item()) <= 1e-5 * abs(loss1.item())
        _grads_within(got, want)
    finally:
        graphs.clear()


# ----------------------------------------------------------------------------
# The winner-row fetch (csrc/winner.cu)
# ----------------------------------------------------------------------------

WINNER_CASES = ["one_row", "random", "missed", "some_fields", "spheres", "r1", "r45",
                "one_row_1080p", "random_1080p"]


def _winner_case(scene, case):
    """(packed table [N, 32] on the CPU, prim [R] int64 on the CPU, the
    fields that get a gradient) of a case of `test_winner_kernels_match_reference`."""
    from esctp1raytracer_tpu_torch.core.intersect import argmin_hit, packed_tri_table
    from esctp1raytracer_tpu_torch.kernels import winner

    sc = b.mixed_scene(device="cpu") if case == "spheres" else scene
    table = packed_tri_table(sc.triangles)
    n = table.shape[0]
    g = torch.Generator().manual_seed(11)
    every = [name for name, _, _ in winner.FIELDS if name != "has_normals"]
    if case in ("missed", "spheres"):
        o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(64, 48))
        _, prim, is_sphere = argmin_hit(o, d, sc, EPS)
        assert (prim < 0).any() if case == "missed" else is_sphere.any()
        return table, torch.clamp(prim, min=0).long(), every
    prim = {"one_row": lambda: torch.full((5000,), 7, dtype=torch.int64),
            "random": lambda: torch.randint(0, n, (5000,), generator=g),
            "some_fields": lambda: torch.randint(0, 40, (5000,), generator=g),
            "r1": lambda: torch.tensor([n - 1]),
            "r45": lambda: torch.randint(0, 3, (45,), generator=g),
            "one_row_1080p": lambda: torch.full((1920 * 1080,), 3, dtype=torch.int64),
            "random_1080p": lambda: torch.randint(0, n, (1920 * 1080,), generator=g)}[case]()
    return table, prim, ["v1", "ks", "ns"] if case == "some_fields" else every


@pytest.mark.parametrize("case", WINNER_CASES)
def test_winner_kernels_match_reference(dev, scene, case):
    """The gather bit-equal to index_select on the card. The scatter within
    1e-5 of a float64 index_add_, relative to the float64 sum of the
    gradients' magnitudes per element: float32 sums in another order (the
    order of the atomics, which index_add_ does not fix either) differ by
    rounding bounded by that sum. Fields with no gradient add nothing; the
    groups counted equal `warp_groups`: one per warp on one row, at most R.
    The 1080p cases add into `MAX_COPIES` copies of the gradient."""
    from esctp1raytracer_tpu_torch.kernels import winner

    table, prim, diff = _winner_case(scene, case)
    table, prim = table.to(dev), prim.to(dev)
    r, n = prim.shape[0], table.shape[0]
    fields = winner.winner_gather(table, prim)
    rows = torch.index_select(table, 0, prim)
    for (name, a, w), got in zip(winner.FIELDS, fields):
        assert got.is_contiguous() and torch.equal(got, rows[:, a] if w == 1 else rows[:, a:a + w]), name
    gen = torch.Generator(device=dev).manual_seed(3)
    grads = [torch.randn(f.shape, generator=gen, device=dev) if name in diff else None
             for (name, _, _), f in zip(winner.FIELDS, fields)]
    cnt = torch.full((-(-r // 32),), -1, dtype=torch.int32, device=dev)
    got = winner.winner_scatter(grads, prim, n, cnt_out=cnt)
    want = torch.zeros((n, 32), dtype=torch.float64, device=dev)
    mag = torch.zeros((n, 32), dtype=torch.float64, device=dev)
    for (_, a, w), g in zip(winner.FIELDS, grads):
        if g is not None:
            want[:, a:a + w].index_add_(0, prim, g.double().reshape(-1, w))
            mag[:, a:a + w].index_add_(0, prim, g.double().abs().reshape(-1, w))
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * mag).all()), float((err / mag.clamp(min=1e-30)).max())
    assert bool((got[mag == 0] == 0).all()) and bool((mag > 0).any())
    assert torch.equal(cnt, winner.warp_groups(prim))
    if case.startswith("one_row"):
        assert bool((cnt == 1).all())
    assert 0 < int(cnt.sum()) <= r


def test_winner_fields_backward_runs_the_kernel_in_a_fit_step(dev):
    """On the card the fetch is the two kernels: a fit step on the flagship at
    a reduced size launches the gather once and the scatter once, by their
    launch counters."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.kernels import launches

    sc, cam, cfg = b.bench_scene(device=dev), CAM.to(dev), RenderConfig(backend="auto")
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, 320, 180, cfg) * 0.8
    frozen = (False,) * len(float_params(sc))
    launches.reset()
    loss, grads = optimize.loss_and_grad.__wrapped__(sc, target, cam, 320, 180, cfg, frozen)
    assert launches.read(launches.FETCH) == {"winner_gather": 1, "winner_scatter": 1}
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def _sphere_grid(pad, dev):
    """The ground plane and an area light (4 triangles, padded to `pad` rows)
    under a 4 x 4 grid of spheres."""
    from esctp1raytracer_tpu_torch.scene.types import Material

    centers = [(-1.5 + x, 0.3, -1.5 + z) for x in range(4) for z in range(4)]
    mat = Material.make(kd=(0.6, 0.3, 0.2), ks=(0.3, 0.3, 0.3), ns=16.0)
    spheres = b.make_spheres(centers, [0.3] * 16, [mat] * 16, device=dev)
    return b.scene_from_mesh([b._ground_plane(), b._area_light(center=(0.0, 6.0, 2.0), half=1.5)],
                             spheres=spheres, pad_multiple=pad, device=dev)


@pytest.mark.parametrize("backend", ["jnp", "auto"])
def test_sphere_winners_beyond_the_triangle_rows_on_the_card(dev, backend):
    """More spheres than triangle rows: a sphere winner's index is the sphere
    table's, and the winner fetch reads triangle row 0 for it (the kernels
    would stop on a row outside the table). The frame with 8 triangle rows
    equals the one with 512, and every gradient is within grads_agreement's
    bars of it (the scatter's atomics add in another order per run)."""
    from esctp1raytracer_tpu_torch.kernels import launches

    cam = Camera.look_at((0.0, 3.0, 5.0), (0.0, 0.3, -0.5), vfov=50.0, aspect=4 / 3,
                         device=dev)
    cfg = RenderConfig(backend=backend)

    def run(pad):
        sc = _sphere_grid(pad, dev)
        params = [p.detach().requires_grad_() for p in float_params(sc)]
        img = render.__wrapped__(merge_params(sc, params), cam, 96, 72, cfg)
        grads = torch.autograd.grad((img * img).sum(), params, allow_unused=True)
        return sc, img, grads

    launches.reset()
    small, img, grads = run(8)
    assert launches.read(launches.FETCH)["winner_scatter"] >= 1
    o, d = (x.reshape(-1, 3) for x in cam.ray_grid(96, 72))
    hit = closest_hit(o, d, small, EPS)
    assert bool((hit.is_sphere & (hit.prim >= small.triangles.capacity)).any())
    _, img_512, grads_512 = run(512)
    torch.testing.assert_close(img, img_512, rtol=0, atol=1e-6)
    tri_rows = [g is not None and g.shape[0] == 512 for g in grads_512]  # the triangle leaves
    assert not any(bool(g[8:].any()) for g, t in zip(grads_512, tri_rows) if t)
    _grads_within(grads, [g[:8] if t else g for g, t in zip(grads_512, tri_rows)])
    assert any(g is not None and bool(g.abs().sum() > 0) for g in grads)


def test_graphed_flagship_fit_step_equals_eager(dev):
    """The flagship's fit step (mxtile: K1, K2, the winner gather and
    scatter) at 320x180, replayed from its CUDA graph: the loss within 1e-5
    relative and every leaf's gradient within grads_agreement's bars of the
    eager port's (the scatter's atomics add in another order each run)."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import graphs

    sc, cam, cfg = b.bench_scene(device=dev), CAM.to(dev), RenderConfig(backend="auto")
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, 320, 180, cfg) * 0.8
    args = (sc, target, cam, 320, 180, cfg, (False,) * len(float_params(sc)))
    try:
        loss0, grads0 = optimize.loss_and_grad.__wrapped__(*args)
        optimize.loss_and_grad(*args)  # eager
        optimize.loss_and_grad(*args)  # the capture
        for _ in range(2):
            loss, grads = optimize.loss_and_grad(*args)
            assert abs(loss.item() - loss0.item()) <= 1e-5 * abs(loss0.item())
            _grads_within(grads, grads0)
        assert len(optimize.loss_and_grad.cache) == 1
        assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0
    finally:
        graphs.clear()


def test_graphed_flagship_fit_step_skips_its_empty_sphere_table(dev):
    """The flagship has no sphere (k = 0): its graphed 1080p fit step against
    the same scene forced to run all 8 sphere slots. The frame and the loss
    bit-equal; the sphere leaves get no gradient at k = 0 and exactly zero at
    8; every other leaf's gradient within grads_agreement's bars (the winner
    scatter's atomics add in another order each run, so no two runs of one
    step are bit-equal there)."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import graphs

    sc, cam, cfg = b.bench_scene(device=dev), CAM.to(dev), RenderConfig(backend="auto")
    assert sc.spheres.occupied == 0
    full = dataclasses.replace(sc, spheres=dataclasses.replace(sc.spheres))
    assert full.spheres.slots == full.spheres.capacity == 8
    with torch.no_grad():
        target = render.__wrapped__(sc, cam, 1920, 1080, cfg) * 0.8
    frozen = (False,) * len(float_params(sc))
    names = [n for n, t in sc.leaves() if t.is_floating_point()]
    runs = {}
    try:
        for key, scene in (("k", sc), ("full", full)):
            with torch.no_grad():
                frames = [render(scene, cam, 1920, 1080, cfg) for _ in range(3)]  # eager, capture, replay
            assert all(torch.equal(f, frames[0]) for f in frames[1:])
            for _ in range(3):  # eager, the capture, a replay
                loss, grads = optimize.loss_and_grad(scene, target, cam, 1920, 1080, cfg, frozen)
            runs[key] = frames[-1], loss, grads
        assert len(render.cache) == 2 and len(optimize.loss_and_grad.cache) == 2
    finally:
        graphs.clear()
    (img, loss, grads), (img_full, loss_full, grads_full) = runs["k"], runs["full"]
    assert torch.equal(img, img_full) and torch.equal(loss, loss_full)
    sphere = [n.startswith("spheres.") for n in names]
    assert all(g is None for g, s in zip(grads, sphere) if s)
    assert all(not bool(g.any()) for g, s in zip(grads_full, sphere) if s)
    _grads_within([g for g, s in zip(grads, sphere) if not s],
                  [g for g, s in zip(grads_full, sphere) if not s])
    assert sum(float(g.abs().sum()) for g in grads if g is not None) > 0


# --------------------------------------------------------------------------
# The Adam kernel (csrc/adam.cu): one launch for every leaf of a fit step
# --------------------------------------------------------------------------

# One element, 0-d, a size not a multiple of the kernel's 256-thread block, empty.
ADAM_ODD = [(1,), (), (1000,), (0, 3)]
ADAM_HP = dict(lr=0.05, b1=0.9, b2=0.999, eps=1e-8)


def adam_leaves(shapes, rng, dev):
    """float32 leaves of `shapes` from `rng`: normal values with zeros, +-1e-30
    and +-1e6 among them (5 of 16), contiguous on `dev` (tests/test_torch_optimize.py
    draws its CPU leaves here too)."""
    special = np.array([0.0, 1e-30, -1e-30, 1e6, -1e6], np.float32)
    out = []
    for s in shapes:
        g = np.asarray(rng.standard_normal(s), np.float32)
        pick = np.asarray(rng.integers(0, 16, s))
        g = np.where(pick < 5, special[np.minimum(pick, 4)], g).astype(np.float32)
        out.append(torch.as_tensor(g, device=dev))
    return out


def _bits(ts):
    return [t.view(torch.int32) for t in ts]


def _adam_steps(dev, shapes, steps=5, seed=27):
    """`steps` Adam steps through optimize.adam_update from random leaves,
    each held bit for bit to the eager tensor operations on the card
    (kernels/adam.py:_adam_plain): new p, m and v equal, t one more, the
    inputs unchanged, the outputs one new buffer aliasing no input. Returns
    the launches of each step."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.kernels import adam

    hp = ADAM_HP
    rng = np.random.default_rng(seed)
    params = adam_leaves(shapes, rng, dev)
    state = optimize.adam_init(params)
    launched = []
    for step in range(steps):
        grads = adam_leaves(shapes, rng, dev)
        ins = params + grads + state["m"] + state["v"]
        kept = [t.clone() for t in ins]
        tf = (state["t"] + 1).to(torch.float32)
        c1, c2 = 1 - hp["b1"] ** tf, 1 - hp["b2"] ** tf
        want = adam._adam_plain(params, grads, state["m"], state["v"], hp["lr"], hp["b1"],
                                hp["b2"], hp["eps"], c1, c2)
        before = adam.adam_step.launches
        new, st = optimize.adam_update(params, grads, state, **hp)
        launched.append(adam.adam_step.launches - before)
        assert int(st["t"]) == step + 1 and st["t"].dtype == torch.int32
        for what, got, ref in zip(("p", "m", "v"), (new, st["m"], st["v"]), want):
            for i, (a, b_) in enumerate(zip(_bits(got), _bits(ref))):
                assert got[i].shape == ref[i].shape and torch.equal(a, b_), (step, what, i)
        assert all(torch.equal(a, b_) for a, b_ in zip(_bits(kept), _bits(ins))), step
        outs = new + st["m"] + st["v"]
        assert len({t.untyped_storage().data_ptr() for t in outs}) == 1
        assert not ({outs[0].untyped_storage().data_ptr()}
                    & {t.untyped_storage().data_ptr() for t in ins})
        params, state = new, st
    return launched


def test_adam_kernel_equals_the_tensor_ops_bit_for_bit(dev):
    """The flagship's 21 float leaves and four odd ones: one launch a step,
    five steps bit-equal to the eager update on the card."""
    shapes = [tuple(p.shape) for p in float_params(b.bench_scene(device=dev))]
    assert len(shapes) == 21 and sum(int(np.prod(s)) for s in shapes) > 390_000
    assert _adam_steps(dev, shapes + ADAM_ODD) == [1] * 5


def test_adam_kernel_takes_up_to_max_leaves(dev):
    """MAX_LEAVES leaves, empty ones among them, in one launch, bit-equal."""
    from esctp1raytracer_tpu_torch.kernels import adam

    shapes = [(37 + i, 3) for i in range(adam.MAX_LEAVES - 3)] + [(0,)] * 3
    assert _adam_steps(dev, shapes, steps=2, seed=5) == [1, 1]


def test_adam_kernel_takes_strided_leaves(dev):
    """Strided gradients and moments (as an eager first call of a fit's
    `loss_and_grad` hands back slices of the packed table's gradient) go
    through the one launch, bit-equal to the tensor operations on them."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.kernels import adam

    hp = ADAM_HP
    rng = np.random.default_rng(3)
    shapes = [(8, 3), (8,), (5, 3)]
    params = adam_leaves(shapes, rng, dev)
    table = adam_leaves([(8, 32)], rng, dev)[0]
    grads = [table[:, 3:6], table[:, 30], adam_leaves([(3, 5)], rng, dev)[0].t()]
    state = optimize.adam_init(params)
    state["m"][0] = adam_leaves([(3, 8)], rng, dev)[0].t()
    assert not any(g.is_contiguous() for g in grads)
    tf = (state["t"] + 1).to(torch.float32)
    want = adam._adam_plain(params, grads, state["m"], state["v"], hp["lr"], hp["b1"], hp["b2"],
                            hp["eps"], 1 - hp["b1"] ** tf, 1 - hp["b2"] ** tf)
    before = adam.adam_step.launches
    new, st = optimize.adam_update(params, grads, state, **hp)
    assert adam.adam_step.launches == before + 1
    for got, ref in zip((new, st["m"], st["v"]), want):
        assert all(a.is_contiguous() and torch.equal(a, b_)
                   for a, b_ in zip(_bits(got), _bits(ref)))


@pytest.mark.parametrize("odd", ["float64", "shape", "leaves", "device"])
def test_adam_kernel_raises_on_leaves_it_does_not_take(dev, odd):
    """On the card a leaf that is not float32, not of its parameter's shape or
    not on the parameters' device, or more leaves than the launch takes,
    raises before any launch: there is no second path on the card."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.kernels import adam

    rng = np.random.default_rng(3)
    shapes = [(8, 3), (5,)] * (adam.MAX_LEAVES // 2 + 1 if odd == "leaves" else 1)
    params = adam_leaves(shapes, rng, dev)
    grads = adam_leaves(shapes, rng, dev)
    if odd == "float64":
        params = [p.double() for p in params]
        grads = [g.double() for g in grads]
    elif odd == "shape":
        grads[1] = grads[1][None]
    elif odd == "device":
        grads[1] = grads[1].cpu()
    state = optimize.adam_init(params)
    before = adam.adam_step.launches
    with pytest.raises(ValueError):
        optimize.adam_update(params, grads, state)
    assert adam.adam_step.launches == before


def test_adam_update_spans_count_the_kernel_leaves(dev):
    """Under spans on the card, `optimize.adam` counts the scene's 21 leaves,
    all of them through the kernel, and times the one launch."""
    from esctp1raytracer_tpu_torch.grad import optimize
    from esctp1raytracer_tpu_torch.utils import profiling

    params = float_params(b.cornell_box(device=dev))
    grads = [torch.ones_like(p) for p in params]
    state = optimize.adam_init(params)
    profiling.reset()
    try:
        _profiled(lambda: optimize.adam_update(params, grads, state), 2)
        recs = profiling.records()
    finally:
        profiling.reset()
    assert [r.name for r in recs] == ["optimize.adam"] * 2
    for rec in recs:
        assert rec.counts["optimize.adam_leaves"] == rec.counts["optimize.adam_kernel_leaves"] == 21
        assert rec.device_ms is not None and rec.device_ms > 0
