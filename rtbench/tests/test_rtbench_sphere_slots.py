"""The reader of `intersect.sphere_skip_pct` on fabricated records: the sphere
sites' counters summed over the profiled steps' roots, as a share of the
slots skipped; None where no site counted, and on a program without spans."""

import json
import types

import pytest

from esctp1raytracer_tpu_torch.utils import profiling
from rtbench import run

METRIC = "intersect.sphere_skip_pct"
STEPS = {1: (100.0, 200.0), 2: (200.0, 300.0)}
RANGES = [("graphs.call", 0.0, 50.0),  # the profiler's first, uncounted call
          ("rtbench.step", 100.0, 200.0), ("graphs.call", 101.0, 150.0),
          ("rtbench.step", 200.0, 300.0), ("graphs.call", 201.0, 250.0)]


def _rec(name, children=(), counts=None):
    rec = profiling.Record(name)
    rec.device_ms, rec.children, rec.counts = 1.0, list(children), dict(counts or {})
    return rec


def _step(k, cap=8):
    """A render step's replay: the closest hit's two sites, the any hit's one
    and `surface_attributes` in the shading's own counts."""
    def site(n):
        return {"intersect.sphere_slots": n * k, "intersect.sphere_capacity": n * cap}

    shade = _rec("shading.shade", [_rec("intersect.any_hit", counts=site(1))], site(1))
    replay = _rec("graphs.replay", [_rec("camera.ray_grid"),
                                    _rec("intersect.closest_hit", counts=site(2)), shade])
    return _rec("graphs.call", [replay])


@pytest.fixture
def traced():
    return types.SimpleNamespace(cpu=RANGES, steps=dict(STEPS))


@pytest.mark.parametrize("k,want", [(0, 100.0), (3, 62.5), (8, 0.0)])
def test_reader_reads_the_sites_counters(traced, monkeypatch, k, want):
    roots = [_step(8)] + [_step(k), _step(k)]  # the uncounted call every slot
    monkeypatch.setattr(profiling, "records", lambda: roots)
    assert run.reader(METRIC)(traced) == pytest.approx(want)


def test_reader_returns_none_without_counters(traced, monkeypatch):
    roots = [_rec("graphs.call", [_rec("graphs.replay")]) for _ in range(3)]
    monkeypatch.setattr(profiling, "records", lambda: roots)
    assert run.reader(METRIC)(traced) is None
    monkeypatch.setattr(profiling, "records", lambda: [_step(0) for _ in range(3)])
    monkeypatch.delattr(profiling, "by_step")
    assert run.reader(METRIC)(traced) is None


def test_metric_is_declared_with_its_cells():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert m["layer"] == "frame step" and m["moves"] == "rays_per_s"
    assert m["source"] == "program_counter" and m["unit"] == "%"
    assert m["workloads"] == ["flagship-fit", "flagship-render", "cornell-fit",
                              "soup100k-4k-render", "mixed-d4-fit"]
