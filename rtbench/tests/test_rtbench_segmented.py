"""The 500k-triangle soup (`soup500k-1080p`, cell `bench500k-1080p-render`) at
sizes the CPU holds: its scene is the port builder's, its cell loads with its
share and at share 1 reads and counts every pixel, and the tile route's readers
(`rt_tile.prepass_device_ms`, `rt_tile.occl_settled_pct`) read their span and
counters on a fabricated and on a real CPU trace of a segmented scene, and None
where these are absent."""

import copy
import json
import types

import pytest
import torch

from esctp1raytracer_tpu_torch.utils import profiling
from rtbench import loops, run, scenes, trace
from rtbench.reference import render as ref
from rtbench.work import count as work
from test_rtbench_share import _every_pixel
from test_rtbench_spans import STEPS, _rec

CELL, CONFIG = "bench500k-1080p-render", "soup500k-1080p"
TILE = ("rt_tile.prepass_device_ms", "rt_tile.occl_settled_pct")


def test_scene_is_the_port_builders_table():
    from esctp1raytracer_tpu_torch.scene import builders

    spec = json.loads((run.ROOT / "rtbench" / "configs" / f"{CONFIG}.json").read_text())
    ours = scenes.port_scene(spec["scene"], "cpu")
    built = builders.random_scene(500_000, device="cpu")
    for (n, a), (m, b) in zip(ours.leaves(), built.leaves()):
        assert n == m and a.shape == b.shape and torch.equal(a, b), n


def test_cell_at_share_one_reads_and_counts_every_pixel():
    """The cell loads through `run.load_cell` with its share (1/50 of each frame);
    its loop at share 1, as the cells without a share run, checks exactly what the
    whole-frame check reads and counts exactly every pixel's work."""
    c = run.load_cell(CELL)
    assert c.share == 0.02 and c.config["scene"]["meshes"][0]["count"] == 500_000
    loop = loops.make(c.config, c.mix, 2**31 + 91, "cpu", (16, 9), 1.0)
    assert loop.work_scale == 1.0 and loop.pixels(0) is None
    loop.sampling = True
    for _ in range(2):
        loop.step()
        loop.settle()
    assert loop.check() == _every_pixel(loop)
    tris, records = loop.wavefronts(1)
    whole = []
    with torch.no_grad(), ref.precision(False):
        loop.reference_frame(1, record=whole)
    for job in work.JOBS:
        assert work.count(job, tris, records, loop.work_scale) == work.count(job, tris, whole)


@pytest.mark.parametrize("metric,cells", [
    (TILE[0], ["soup100k-4k-render", CELL]), (TILE[1], [CELL])])
def test_tile_metrics_are_declared_with_their_cells(metric, cells):
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    assert declared[metric]["workloads"] == cells
    assert declared[metric]["layer"] == "tile search"
    assert declared[metric]["moves"] == "rays_per_s"


# --- the tile route: `rt_tile.prepass` and the any-hit counters -------------------

RENDER_RANGES = [("graphs.call", 0.0, 50.0),
                 ("rtbench.step", 100.0, 200.0), ("graphs.call", 101.0, 150.0),
                 ("rtbench.step", 200.0, 300.0), ("graphs.call", 201.0, 250.0)]


def _render_step(k):
    """One graphed frame on the tile route: the closest hit's and the any hit's
    table work (2 + k and 0.5 ms) and the any hit's counters."""
    counts = {"rt_tile.occl_later_rays": 1000 + k, "rt_tile.occl_settled_rays": 400}
    shade = _rec("shading.shade", 30.0, [
        _rec("intersect.any_hit", 20.0, [_rec("rt_tile.prepass", 0.5)], counts)])
    search = _rec("intersect.closest_hit", 12.0, [_rec("rt_tile.prepass", 2.0 + k)])
    replay = _rec("graphs.replay", 45.0, [_rec("camera.ray_grid", 0.1), search, shade])
    return _rec("graphs.call", 46.0, [replay])


@pytest.fixture
def rendered(monkeypatch):
    roots = [_rec("graphs.call", 99.0)] + [_render_step(k) for k in range(2)]
    monkeypatch.setattr(profiling, "records", lambda: roots)
    return types.SimpleNamespace(cpu=RENDER_RANGES, steps=dict(STEPS))


def test_tile_readers_read_their_span_and_counters(rendered):
    assert run.reader(TILE[0])(rendered) == pytest.approx(3.0)  # 2.5 and 3.5
    assert run.reader(TILE[1])(rendered) == pytest.approx(100.0 * 800 / 2001)


@pytest.mark.parametrize("metric", TILE)
def test_tile_readers_return_none_without_their_spans(metric, monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: [])
    traced = types.SimpleNamespace(cpu=RENDER_RANGES, steps=dict(STEPS))
    assert run.reader(metric)(traced) is None


@pytest.mark.parametrize("metric", TILE)
def test_tile_readers_return_none_on_a_program_without_spans(metric, rendered, monkeypatch):
    for name in ("per_step", "by_step"):
        monkeypatch.delattr(profiling, name)
    assert run.reader(metric)(rendered) is None


def _small_soup_trace(monkeypatch, segment):
    """One frame of a small seeded soup (the 500k cell's recipe at 6,000 triangles,
    its ground and light scaled with it) on the tile route, in segments of
    `segment` triangles, under torch.profiler on the CPU, inside a harness step
    and a `graphs.call` span as a graphed frame runs on the card. Returns the
    trace as the readers get it and each any-hit launch's (live, occluded) masks."""
    from esctp1raytracer_tpu_torch.core.camera import Camera
    from esctp1raytracer_tpu_torch.core.render import RenderConfig, trace_rays
    from esctp1raytracer_tpu_torch.kernels import rt_tile

    spec = json.loads((run.ROOT / "rtbench" / "configs" / f"{CONFIG}.json").read_text())
    recipe = copy.deepcopy(spec["scene"])
    recipe["meshes"][0].update(count=6000, seed=3, extent=4.0)
    for mesh in recipe["meshes"][1:]:
        mesh["quads"] = [[[c * 0.2 for c in p] for p in q] for q in mesh["quads"]]
    scene = scenes.port_scene(recipe, "cpu")
    o, d = (x.reshape(-1, 3) for x in Camera.look_at(
        (0.0, 5.0, 11.0), (0.0, 0.6, 0.0), vfov=60.0, aspect=48 / 27, device="cpu"
    ).ray_grid(48, 27))
    launches, launch = [], rt_tile.tile_occl_kernel

    def spy(eps, rays, aabbs, tc, ov=None, **kw):
        out = launch(eps, rays, aabbs, tc, ov, **kw)
        launches.append((rays[:, 6] > 0.0, out > 0))
        return out

    monkeypatch.setattr(rt_tile, "TILE_TRI_LIMIT", segment)
    monkeypatch.setattr(rt_tile, "tile_occl_kernel", spy)
    profiling.reset()
    with torch.no_grad(), torch.profiler.profile() as prof:
        with torch.profiler.record_function("rtbench.step"), profiling.annotate("graphs.call"):
            trace_rays(o, d, scene, torch.arange(o.shape[0]), RenderConfig(backend="tile", seed=3))
    return trace.Traced(prof, [0], None, None), launches


def test_tile_span_and_counters_on_a_cpu_trace_of_a_segmented_scene(monkeypatch):
    """Six segments: both searches' `rt_tile.prepass` spans, the any hit's two
    counters on `intersect.any_hit`, and the settled share equal to a count, from
    the launches' own masks, of the live rays already occluded before each launch
    after the first. On the CPU the spans have no device time: the device ms reads
    None, as every device metric does there."""
    traced, launches = _small_soup_trace(monkeypatch, 1024)
    (root,) = [r for r in profiling.records() if r.name == "graphs.call"]
    assert len(root.find("rt_tile.prepass")) == 2 and len(launches) == 6
    (any_hit,) = root.find("intersect.any_hit")
    later = settled = 0
    occluded = torch.zeros_like(launches[0][1])
    for k, (live, out) in enumerate(launches):
        if k:
            later += int(live.sum())
            settled += int((live & occluded).sum())
        occluded |= out
    assert any_hit.counts["rt_tile.occl_later_rays"] == later > 0
    assert any_hit.counts["rt_tile.occl_settled_rays"] == settled > 0
    pct = run.reader(TILE[1])(traced)
    assert 0.0 < pct < 100.0 and pct == pytest.approx(100.0 * settled / later)
    assert run.reader(TILE[0])(traced) is None
    profiling.reset()


def test_settled_share_is_none_on_a_single_segment_trace(monkeypatch):
    traced, launches = _small_soup_trace(monkeypatch, 131_072)
    (root,) = [r for r in profiling.records() if r.name == "graphs.call"]
    assert len(root.find("rt_tile.prepass")) == 2 and len(launches) == 1
    assert root.count("rt_tile.occl_later_rays") == 0
    assert run.reader(TILE[1])(traced) is None
    profiling.reset()
