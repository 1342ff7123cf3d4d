"""BENCHMARK.json against the contract, every cell's files found by name, and a
throwaway cell added by files alone."""

import json
import re
import shutil

import pytest

from rtbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rtbench"] and BENCH["command"] == ["python3", "rtbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"setup_s", "rays_per_s", "step_ms_p95", "peak_gib"} <= e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", [])) <= {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert c["file"].startswith("rtbench/") and c["reduced"] == []
        assert c["source"].startswith("https://")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_its_files(cell):
    c = run.load_cell(cell)
    assert c.config["width"] > 0 and c.mix["loop"] in ("fit", "render")
    assert c.end_to_end and c.per_layer
    for m in c.per_layer:
        assert callable(run.reader(m["name"]))
    assert set(c.limits) == ({"bad_px"} if c.mix["loop"] == "render"
                             else {"first_loss_gap", "grad_gap", "median_change_gap"})


def test_a_throwaway_cell_added_by_files_resolves_and_runs(tmp_path):
    """A new configuration, mix, cell and per-layer metric: files and entries only."""
    shutil.copytree(run.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    here = tmp_path / "rtbench"
    cfg = json.loads((here / "configs" / "cornell-original-1024x768.json").read_text())
    cfg["name"], cfg["width"], cfg["height"] = "cornell-tiny", 20, 15
    (here / "configs" / "cornell-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "render-fixed-8spp.json").read_text())
    mix["name"], mix["passes"] = "render-fixed-2spp", 2
    (here / "traffic" / "render-fixed-2spp.json").write_text(json.dumps(mix))
    (here / "cells" / "cornell-tiny-render.json").write_text(json.dumps({"limits": {"bad_px": 1e-3}}))
    (here / "metrics" / "harness.steps_traced.py").write_text(
        "def read(traced):\n    return float(len(traced.steps)) or None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "cornell-tiny", "source": "https://casual-effects.com/data/",
                             "file": "rtbench/configs/cornell-tiny.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "cornell-tiny-render", "config": "cornell-tiny",
                               "traffic": "render-fixed-2spp", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "harness.steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "harness",
                               "moves": "rays_per_s", "workloads": ["cornell-tiny-render"]})
    c = run.load_cell("cornell-tiny-render", bench, tmp_path)
    assert c.mix["passes"] == 2 and c.config["width"] == 20
    assert "harness.steps_traced" in [m["name"] for m in c.per_layer]
    r = run.run_cell("cornell-tiny-render", 7, 4.0, True, device="cpu", bench=bench,
                     root=tmp_path)
    assert r["correct"] and r["metrics"]["harness.steps_traced"]["value"] >= 1
