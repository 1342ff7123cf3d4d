"""The result line's keys, the checks last, and the import guard."""

import json
import shutil
import subprocess
import sys
import types

import pytest

from rtbench import run

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(trace, capsys):
    r = run.run_cell("cornell-render", 2**31 + 5, 1.0, trace, device="cpu", size=(16, 12))
    run.emit(r)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    keys = list(line)
    assert keys[:5] == REQUIRED
    assert set(keys) == set(REQUIRED) | {"card", "checks"} | ({"breakdown"} if trace else set())
    assert keys[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check bad_px = ")
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == {"rays_per_s", "step_ms_p95", "peak_gib", "setup_s"}


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "esctp1raytracer_tpu_torch_lookalike", types.ModuleType("x"))
    assert "esctp1raytracer_tpu" not in run.forbidden_modules() or \
        "esctp1raytracer_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax" in run.forbidden_modules()


def test_a_reader_that_loads_jax_makes_the_run_exit_nonzero(tmp_path):
    """The guard runs after the per-layer readers: one that imports a stub `jax`
    leaves no result."""
    shutil.copytree(run.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    (tmp_path / "rtbench" / "metrics" / "harness.loads_jax.py").write_text(
        "import sys\n\n\ndef read(traced):\n    sys.path.insert(0, %r)\n    import jax  # noqa\n"
        "    return None\n" % str(stub))
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "harness.loads_jax", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "harness",
                               "moves": "rays_per_s", "workloads": ["cornell-render"]})
    try:
        with pytest.raises(SystemExit) as exit_:
            run.run_cell("cornell-render", 11, 0.5, True, device="cpu", size=(16, 12),
                         bench=bench, root=tmp_path)
        assert exit_.value.code not in (0, None)
    finally:
        sys.modules.pop("jax", None)
        if str(stub) in sys.path:
            sys.path.remove(str(stub))


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); import torch; torch.set_num_threads(2)\n"
            "from rtbench import run\n"
            "run.run_cell('flagship-fit', 3, 0.2, True, device='cpu', size=(16, 9))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "print(run.forbidden_modules())" % str(run.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True).stdout.strip().splitlines()
    loaded = set(eval(out[-2]))
    assert "esctp1raytracer_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "esctp1raytracer_tpu"}
    assert out[-1] == "[]"


def test_no_card_exits_nonzero_with_no_result():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch; torch.cuda.is_available = lambda: False\n"
            "from rtbench import run; sys.exit(run.main(['--workload', 'cornell-render', "
            "'--seed', '1', '--seconds', '1']))" % str(run.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_bare_checkout_exits_nonzero_with_no_result(tmp_path):
    """Only BENCHMARK.json and the files under paths: the port is missing."""
    import shutil

    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.ROOT / "rtbench", tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "cornell-render",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""
