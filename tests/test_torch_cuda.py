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
* rendered images within the test_rt_mxu.py image bars of the CPU port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.intersect import EPS, closest_hit  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas, lane_pallas, rt_mxu, rt_tile  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as b  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import TriangleBuffer  # noqa: E402

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


def _mxu_args(tris, o, d, tl, exclude_oversized):
    (tfq, aabbs, _), = list(rt_mxu._segments(tris, exclude_oversized)[0])
    return torch.tensor([EPS], device=o.device), rt_tile._pad_rays(o, d, tl), aabbs, tfq


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
        (_, aabbs, _), = list(rt_mxu._segments(tris, False)[0])
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
        (_, aabbs, _), = list(rt_mxu._segments(tris, True)[0])
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
    _, ov_buf, _ = rt_mxu._segments(tris, True)
    ov, _ = rt_tile._pack_sub(ov_buf)
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


FUSED_SCENES = {
    "cornell_g1": lambda: b.cornell_box(pad_multiple=128, device="cpu"),
    "cornell": lambda: b.cornell_box(device="cpu"),
    "mixed": lambda: b.mixed_scene(device="cpu"),
    "mirror": lambda: b.cornell_variant("mirror", device="cpu"),
    "limit": lambda: b.random_scene(2044, extent=4.0, device="cpu"),  # 2,048 valid
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
                                            ("mirror", CORNELL_CAM, 2)])
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


def _tile_args(tris, o, d, tl, exclude_oversized):
    tc, aabbs, _, ov_buf, _ = rt_tile.tri_constants_sub(tris, exclude_oversized)
    return torch.tensor([EPS], device=o.device), rt_tile._pad_rays(o, d, tl), aabbs, tc, ov_buf


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
        o, d = (x.to(dev) for x in _axis_rays(rt_tile.tri_constants_sub(tris)[1]))
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
    ov, _ = rt_tile._pack_sub(ov_buf)
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
