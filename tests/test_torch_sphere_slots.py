"""Port: the sphere sites over a scene's occupied sphere slots.

`SphereBuffer.occupied` is one past the last valid sphere, a Python int the
builders set; the sphere search, the any-hit sphere term, the closest hit's
sphere recompute and `surface_attributes` run over the slots [0, k) and
not at all at k = 0. On the CPU, at sizes it holds:

* the frame and every leaf's gradient, bit for bit, with k as the builders
  set it and with the same scene forced to every slot (`occupied` None):
  three scenes (no sphere; `mixed_scene()`, 3 of 8; one sphere in the last
  slot), the jnp, mxu, lane, mxtile and tile routes' plain versions, depth 1
  and 3, whole and chunked, and the fused route's backward re-derivation;
* k through `map`, `detach`, `to`, `merge_params`, a checkpoint and a
  graph's key, with the leaves unchanged;
* the counters `intersect.sphere_slots` / `intersect.sphere_capacity` of
  each site, eager and inside a graph's replay.
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as b  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import (  # noqa: E402
    Material, SphereBuffer, float_params, merge_params, scene_from_numpy, scene_to_numpy,
)
from esctp1raytracer_tpu_torch.utils import graphs, profiling  # noqa: E402
from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402

W, H = 16, 12  # 192 camera rays
CHUNK = 80  # three chunks, the last of 32
CAM = Camera.look_at((0.0, 2.5, 7.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=W / H, device="cpu")
ROUTES = ["jnp", "mxu", "lane", "mxtile", "tile"]
SITES = ("intersect.sphere_slots", "intersect.sphere_capacity")


def _meshes():
    return [b.icosphere_mesh(subdivisions=1, radius=1.0, center=(-1.3, 1.0, 0.0)),
            b.icosphere_mesh(subdivisions=1, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
            b._ground_plane(), b._area_light(center=(0.0, 6.0, 2.0), half=1.5)]


def _last_slot():
    """Eight glossy spheres of which only the last is valid: k is the capacity."""
    mat = Material.make(kd=(0.6, 0.3, 0.2), ks=(0.5, 0.5, 0.5), ns=32.0)
    sp = b.make_spheres([(0.0, 0.6, 1.8)] * 8, [0.6] * 8, [mat] * 8, device="cpu")
    valid = np.arange(8) == 7
    sp = dataclasses.replace(sp, valid=torch.from_numpy(valid)).occupy(valid)
    return b.scene_from_mesh(_meshes(), spheres=sp, device="cpu")


SCENES = {
    "no_spheres": (lambda: b.scene_from_mesh(_meshes(), device="cpu"), 0),
    "mixed": (lambda: b.mixed_scene(device="cpu"), 3),
    "last_slot": (_last_slot, 8),
}


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    make, k = SCENES[request.param]
    scene = make()
    assert scene.spheres.occupied == k and scene.spheres.capacity == 8
    return request.param, scene


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()
    graphs.clear()


def every_slot(scene):
    """The same scene with every sphere slot run: `occupied` None."""
    full = dataclasses.replace(scene, spheres=dataclasses.replace(scene.spheres))
    assert full.spheres.occupied is None and full.spheres.slots == full.spheres.capacity
    return full


def frame_and_grads(scene, cfg):
    """The frame and the gradients of a fixed weighting of it with respect to
    every float leaf (None where the frame does not depend on the leaf)."""
    leaves = [p.detach().requires_grad_() for p in float_params(scene)]
    img = render(merge_params(scene, leaves), CAM, W, H, cfg)
    weights = torch.from_numpy(np.random.default_rng(7).uniform(0.5, 1.5, (H, W, 3))
                               .astype(np.float32))
    grads = torch.autograd.grad((img * weights).sum(), leaves, allow_unused=True)
    return img.detach(), grads


def assert_same_step(scene, cfg):
    """The frame and every gradient bit-equal at the builders' k and at every
    slot; a leaf with no gradient at k reads exactly zero at every slot. Returns
    the sphere leaves' gradients at k."""
    img, grads = frame_and_grads(scene, cfg)
    img_full, grads_full = frame_and_grads(every_slot(scene), cfg)
    assert torch.equal(img, img_full)
    names = [n for n, t in scene.leaves() if t.is_floating_point()]
    for name, g, g_full in zip(names, grads, grads_full):
        if g is None:
            assert g_full is None or not bool(g_full.any()), name
        else:
            assert g_full is not None and torch.equal(g, g_full), name
    sphere_grads = [g for n, g in zip(names, grads) if n.startswith("spheres.")]
    if scene.spheres.slots:  # the spheres are seen and differentiated
        assert any(g is not None and bool(g.any()) for g in sphere_grads)
    assert float(img.sum()) > 0
    return sphere_grads


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole", "chunked"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("route", ROUTES)
def test_route_bit_equal_to_every_slot(case, route, depth, chunk):
    _, scene = case
    sphere_grads = assert_same_step(scene, RenderConfig(backend=route, depth=depth,
                                                        ray_chunk=chunk))
    if not scene.spheres.slots:  # nothing of the sphere table reaches the frame
        assert all(g is None for g in sphere_grads)


@pytest.mark.parametrize("rederive", ["lane_d1", "lane_d3", "chunked_mxtile_d3"])
def test_fused_rederivation_bit_equal_to_every_slot(case, rederive, monkeypatch):
    """K3's plain version forward (it reads the whole table either way); the
    backward re-derives on lane, or on chunked mxtile when `BWD_MIN_RAYS` and
    `BWD_RAY_CHUNK` are shrunk."""
    _, scene = case
    if rederive.startswith("chunked"):
        monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
        monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", CHUNK)
    cfg = RenderConfig(backend="fused", depth=int(rederive[-1]))
    assert fused_pallas.fused_supported(scene, cfg.depth, cfg.light_mode)
    sphere_grads = assert_same_step(scene, cfg)
    if not scene.spheres.slots:  # the fused backward gives every leaf a gradient
        assert all(not bool(g.any()) for g in sphere_grads)


# --- k's plumbing ---------------------------------------------------------

MAPS = {
    "map": lambda sc: sc.map(lambda _, t: t.clone()),
    "detach": lambda sc: sc.detach(),
    "to": lambda sc: sc.to("cpu"),
    "merge_params": lambda sc: merge_params(sc, [p * 1.0 for p in float_params(sc)]),
}


@pytest.mark.parametrize("op", list(MAPS))
def test_occupied_survives(case, op):
    _, scene = case
    assert MAPS[op](scene).spheres.occupied == scene.spheres.occupied
    assert MAPS[op](every_slot(scene)).spheres.occupied is None


def test_builders_set_occupied_exactly():
    assert SphereBuffer.empty(device="cpu").occupied == 0
    assert SphereBuffer.empty(16, device="cpu").slots == 0
    mats = [Material.make(kd=(0.5, 0.5, 0.5))] * 9
    assert b.make_spheres([(0.0, 0.0, 0.0)] * 9, [0.5] * 9, mats, device="cpu").occupied == 9
    assert b.sphere_plane_scene(device="cpu").spheres.occupied == 1
    assert b.cornell_box(device="cpu").spheres.occupied == 0
    # Tables built any other way run every slot.
    assert scene_from_numpy(scene_to_numpy(b.mixed_scene(device="cpu")),
                            device="cpu").spheres.occupied is None


@pytest.mark.parametrize("config,k", [("flagship-10k-1080p", 0), ("cornell-original-1024x768", 0),
                                      ("mixed-d4-1080p", 3)])
def test_benchmark_scenes_set_occupied(config, k):
    import json

    from rtbench import scenes

    spec = json.loads((ROOT / "rtbench" / "configs" / f"{config}.json").read_text())
    assert scenes.port_scene(spec["scene"], "cpu").spheres.occupied == k


def test_leaves_and_checkpoint_unchanged_by_occupied(case, tmp_path):
    """k is no leaf: the leaves' names, order and shapes are the same at k and
    at every slot, and a checkpoint holds the same arrays; loading reads k
    from the loaded valid mask, whatever the template's."""
    _, scene = case
    full = every_slot(scene)
    assert [(n, t.shape) for n, t in scene.leaves()] == [(n, t.shape) for n, t in full.leaves()]
    assert not any("occupied" in n for n, _ in scene.leaves())
    assert len(float_params(scene)) == len(float_params(full)) == 21
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, full, step=3)
    for template in (scene, full):
        loaded, step, _ = load_checkpoint(path, template)
        assert step == 3 and loaded.spheres.occupied == scene.spheres.occupied
        for (_, a), (_, c) in zip(loaded.leaves(), scene.leaves()):
            assert torch.equal(a, c)


def test_graph_key_holds_occupied(case):
    """Two scenes that differ only in k get different graph keys, and a
    graph's rebuilt inputs keep k."""
    _, scene = case
    tensors, tensors_full = [], []
    key = graphs._flatten(scene, tensors)
    key_full = graphs._flatten(every_slot(scene), tensors_full)
    assert key != key_full and len(tensors) == len(tensors_full)
    rebuilt = graphs._rebuild(scene, iter([t.clone() for t in tensors]))
    assert rebuilt.spheres.occupied == scene.spheres.occupied


# --- the counters -----------------------------------------------------------

def _site_counts(root):
    """{span: (slots, capacity)} of the spans that counted, each its own counts."""
    out = {}
    for name in ("intersect.closest_hit", "intersect.any_hit", "shading.shade"):
        for rec in root.find(name):
            got = tuple(rec.counts.get(c, 0) for c in SITES)
            prev = out.get(name, (0, 0))
            out[name] = (prev[0] + got[0], prev[1] + got[1])
    return out


def _want(k, cap, depth=1):
    """argmin_hit and the sphere recompute in the closest hit's span, the
    sphere search or term in the any hit's, `surface_attributes` in the
    shading's own: per bounce."""
    return {"intersect.closest_hit": (2 * k * depth, 2 * cap * depth),
            "intersect.any_hit": (k * depth, cap * depth),
            "shading.shade": (k * depth, cap * depth)}


@pytest.mark.parametrize("route", ROUTES)
def test_sites_count_their_slots(case, route):
    _, scene = case
    k, cap = scene.spheres.slots, scene.spheres.capacity
    cfg = RenderConfig(backend=route, depth=2)
    with torch.no_grad(), torch.profiler.profile():
        with profiling.annotate("graphs.call"):
            render(scene, CAM, W, H, cfg)
    (root,) = profiling.records()
    assert _site_counts(root) == _want(k, cap, depth=2)
    assert root.count(SITES[0]) == 4 * 2 * k and root.count(SITES[1]) == 4 * 2 * cap
    # Off, nothing is counted.
    profiling.reset()
    with torch.no_grad():
        render(scene, CAM, W, H, cfg)
    assert profiling.records() == []


class _FakeGraph:
    """`torch.cuda.CUDAGraph` on the CPU: the capture runs the function, a
    replay runs nothing (the outputs and counts stay the capture's)."""

    def replay(self):
        pass


def test_counts_inside_a_graph_replay(case, monkeypatch):
    """The graphed render's spanned twin: each replay's copy of the spans
    holds the sites' counts as the eager profiled call counts them."""
    _, scene = case
    k, cap = scene.spheres.slots, scene.spheres.capacity
    monkeypatch.setattr(graphs, "_on_card", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_capture_spanned", lambda g, fn, kwargs: fn(**kwargs))
    cfg = RenderConfig(backend="mxtile")
    render(scene, CAM, W, H, cfg)  # the plain graph's eager first call
    render(scene, CAM, W, H, cfg)  # its capture
    with torch.profiler.profile():
        for _ in range(3):  # the twin's capture and replays
            render(scene, CAM, W, H, cfg)
    roots = [r for r in profiling.records() if r.name == "graphs.call"]
    assert len(roots) == 3
    for root in roots:
        (replay,) = root.find("graphs.replay")
        assert _site_counts(replay) == _want(k, cap)
