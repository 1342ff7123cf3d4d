"""The reader of `optimize.adam_kernel_pct` on fabricated records: the Adam
update's leaf counters on `optimize.adam`, summed over the profiled steps'
roots, as the share of leaves the kernel updated; None where no update
counted a leaf, and on a program without spans."""

import json
import types

import pytest

from esctp1raytracer_tpu_torch.utils import profiling
from rtbench import run

METRIC = "optimize.adam_kernel_pct"
STEPS = {1: (100.0, 200.0), 2: (200.0, 300.0)}
RANGES = [("graphs.call", 0.0, 40.0), ("optimize.adam", 41.0, 50.0),  # the uncounted call
          ("rtbench.step", 100.0, 200.0), ("graphs.call", 101.0, 150.0),
          ("optimize.adam", 151.0, 160.0),
          ("rtbench.step", 200.0, 300.0), ("graphs.call", 201.0, 250.0),
          ("optimize.adam", 251.0, 260.0)]


def _rec(name, children=(), counts=None):
    rec = profiling.Record(name)
    rec.device_ms, rec.children, rec.counts = 1.0, list(children), dict(counts or {})
    return rec


def _step(leaves, kernel):
    """A fit step's roots: the graphed call, then Adam with its counters
    (None: a program that counts no leaf)."""
    counts = {"alloc.device_mallocs": 0}
    if leaves is not None:
        counts.update({"optimize.adam_leaves": leaves, "optimize.adam_kernel_leaves": kernel})
    return [_rec("graphs.call", [_rec("graphs.replay")]), _rec("optimize.adam", counts=counts)]


@pytest.fixture
def traced():
    return types.SimpleNamespace(cpu=RANGES, steps=dict(STEPS))


@pytest.mark.parametrize("kernel,want", [(21, 100.0), (0, 0.0)])
def test_reader_reads_the_leaf_counters(traced, monkeypatch, kernel, want):
    """100 where every leaf went through the kernel, 0 on the tensor operations;
    the uncounted first step (the other way) is left out."""
    roots = _step(21, 21 - kernel) + _step(21, kernel) + _step(21, kernel)
    monkeypatch.setattr(profiling, "records", lambda: roots)
    assert run.reader(METRIC)(traced) == pytest.approx(want)


def test_reader_returns_none_without_counters(traced, monkeypatch):
    roots = _step(None, 0) * 3
    monkeypatch.setattr(profiling, "records", lambda: roots)
    assert run.reader(METRIC)(traced) is None
    monkeypatch.setattr(profiling, "records", lambda: _step(21, 21) * 3)
    monkeypatch.delattr(profiling, "by_step")
    assert run.reader(METRIC)(traced) is None


def test_metric_is_declared_with_the_fit_cells():
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == METRIC]
    assert m["layer"] == "fit step" and m["moves"] == "rays_per_s"
    assert m["source"] == "program_counter" and m["unit"] == "%" and m["better"] == "higher"
    assert m["workloads"] == ["flagship-fit", "cornell-fit", "mixed-d4-fit"]
    fits = [w["name"] for w in bench["workloads"] if w["traffic"] == "fit-all-leaves"]
    assert sorted(m["workloads"]) == sorted(fits)
