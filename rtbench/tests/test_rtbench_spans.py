"""The readers of the program's spans and counters (`utils/profiling.py`) on a
fabricated `Traced`: each returns its number where its span or counter is
there, and None where it is not, as on a program that records none."""

import types

import pytest

from esctp1raytracer_tpu_torch.utils import profiling
from rtbench import run

STEPS = {1: (100.0, 200.0), 2: (200.0, 300.0)}
RANGES = [("graphs.call", 0.0, 50.0),  # the profiler's first, uncounted call
          ("rtbench.step", 100.0, 200.0), ("graphs.call", 101.0, 150.0),
          ("optimize.adam", 151.0, 160.0),
          ("rtbench.step", 200.0, 300.0), ("graphs.call", 201.0, 250.0),
          ("optimize.adam", 251.0, 260.0)]


def _rec(name, device_ms, children=(), counts=None):
    rec = profiling.Record(name)
    rec.device_ms, rec.children, rec.counts = device_ms, list(children), dict(counts or {})
    return rec


def _fit_step(k):
    """One fit step's roots: the graphed call (a replay of the loss and the
    backward, with K1's and K2's counts) and Adam."""
    shade = _rec("shading.shade", 6.0 + k, [
        _rec("intersect.any_hit", 2.0, [_rec("rt_mxu.prepass", 0.5)],
             {"rt_mxu.any_hit_blocks": 7})])
    search = _rec("intersect.closest_hit", 3.0, [_rec("rt_mxu.prepass", 0.5)],
                  {"rt_mxu.closest_hit_blocks": 10 + k})
    loss = _rec("optimize.loss", 10.0, [_rec("camera.ray_grid", 0.1), search, shade])
    replay = _rec("graphs.replay", 25.0, [loss, _rec("optimize.backward", 15.0 + k)])
    call = _rec("graphs.call", 27.0, [_rec("graphs.copy_in", 1.0), replay,
                                      _rec("graphs.clone_out", 1.0)],
                {"alloc.device_mallocs": k, "alloc.retries": 0})
    adam = _rec("optimize.adam", 0.8 + k, counts={"alloc.device_mallocs": 1})
    return [call, adam]


@pytest.fixture
def fit(monkeypatch):
    roots = [_rec("graphs.call", 99.0)] + _fit_step(0) + _fit_step(1)
    monkeypatch.setattr(profiling, "records", lambda: roots)
    monkeypatch.setattr(profiling, "counters", lambda: {
        "graphs.warm_calls": 1, "graphs.warm_s": 1.5, "graphs.captures": 1,
        "graphs.capture_s": 0.25, "graphs.twin_captures": 1, "graphs.twin_capture_s": 9.0})
    work = {1: 8000, 2: 9000}
    return types.SimpleNamespace(
        cpu=RANGES, steps=dict(STEPS),
        kernel_us=lambda names, steps: 1.0 if "mxu_search_kernel" in names else 0.0,
        work=lambda job, steps: {"pairs": sum(work[k] for k in steps)})


@pytest.fixture
def empty(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: [])
    monkeypatch.setattr(profiling, "counters", lambda: {})
    return types.SimpleNamespace(cpu=RANGES, steps=dict(STEPS),
                                 kernel_us=lambda names, steps: 1.0,
                                 work=lambda job, steps: {"pairs": 1})


EXPECTED = {
    "optimize.backward_device_ms": 15.5,  # 15 and 16
    "optimize.adam_device_ms": 1.3,  # 0.8 and 1.8
    "shading.shade_device_ms": 4.5,  # 6 - 2 and 7 - 2
    "rt_mxu.prepass_device_ms": 1.0,  # the closest-hit and the any-hit search's
    "rt_mxu.cull_useful_pct": 100.0 * 17000 / (21 * 128 * 128),
    "alloc.device_mallocs_per_step": 1.5,  # (0 + 1 + 1 + 1) / 2
    "graphs.capture_s": 1.75,  # the twin's 9 s left out
}


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_reads_its_span(metric, fit):
    assert run.reader(metric)(fit) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_returns_none_without_its_span(metric, empty):
    assert run.reader(metric)(empty) is None


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_returns_none_on_a_program_without_spans(metric, fit, monkeypatch):
    """The parent commit's program has none of the accessors."""
    for name in ("per_step", "by_step", "counters"):
        monkeypatch.delattr(profiling, name)
    assert run.reader(metric)(fit) is None


def test_device_readers_return_none_on_the_cpu(monkeypatch, fit):
    """Spans on the CPU have host times only: no device metric reads them."""
    roots = profiling.records()

    def strip(rec):
        rec.device_ms = None
        for c in rec.children:
            strip(c)

    for r in roots:
        strip(r)
    for metric in ("optimize.backward_device_ms", "optimize.adam_device_ms",
                   "shading.shade_device_ms", "rt_mxu.prepass_device_ms"):
        assert run.reader(metric)(fit) is None


def test_every_new_metric_is_declared_with_its_cells():
    import json

    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"]: m for m in bench["per_layer"]}
    for metric in EXPECTED:
        assert metric in declared
    fits, flags = ["flagship-fit", "cornell-fit"], ["flagship-fit", "flagship-render"]
    assert declared["optimize.backward_device_ms"]["workloads"] == fits
    assert declared["rt_mxu.cull_useful_pct"]["workloads"] == flags
    assert "workloads" not in declared["alloc.device_mallocs_per_step"]
    assert declared["graphs.capture_s"]["moves"] == "setup_s"
