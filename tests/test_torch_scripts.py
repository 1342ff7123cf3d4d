"""The port's benchmark and matrix scripts against the JAX package's.

Mirrors tests/test_run_matrix.py and holds each `scripts/*_torch.py`
to the JAX script it ports, on the CPU (`--device cpu`):
* run_matrix_torch.py end to end as a subprocess (two strategies at
  48x36: rendering, the cross-check, the PPMs and the JSON keys);
* the tables: run_matrix's STRATEGIES, and bench_configs' and
  probe_device_loop's CONFIGS (names, eyes, sizes, depths), equal to the
  JAX scripts' (read from their source, which is not imported: the JAX
  scripts configure JAX's compilation cache when imported);
* each config's builder gives the JAX builder's tables, and the port's
  `resolve_backend` the JAX package's on them;
* bench_configs_torch.run_config and the probe's per-frame arithmetic on
  one config at a small size;
* make_golden_pixels_torch.py reproducing tests/golden/cornell_pixels_48x36.npz
  exactly;
* bench_scaling_torch.py on 1 and 2 gloo ranks at a tiny frame;
* every script that runs on the card refusing to run without one.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402

from esctp1raytracer_tpu.core.render import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu.core.render import resolve_backend as j_resolve_backend  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, resolve_backend  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_from_numpy, scene_to_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)

import bench_configs_torch  # noqa: E402
import bench_scaling_torch  # noqa: E402
import probe_device_loop_torch  # noqa: E402
import run_matrix_torch  # noqa: E402

CPU_ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def run(args, timeout=600, env=None):
    return subprocess.run([sys.executable] + args, capture_output=True, text=True,
                          env=env or CPU_ENV, cwd=REPO, timeout=timeout)


def jax_table(script, name):
    """The JAX script's `name` = [...] list, element by element as AST nodes,
    and the script's module-level function definitions."""
    with open(os.path.join(SCRIPTS, script)) as fh:
        tree = ast.parse(fh.read())
    table = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                 and any(isinstance(t, ast.Name) and t.id == name for t in node.targets))
    funcs = [node for node in tree.body if isinstance(node, ast.FunctionDef)]
    return table.elts, funcs


def jax_configs(script):
    """[(name, JAX builder, eye, w, h, depth)] of a JAX script's CONFIGS, the
    builder expressions evaluated against the JAX package's builders."""
    elts, funcs = jax_table(script, "CONFIGS")
    env = {"builders": jb}
    exec(compile(ast.Module(body=funcs, type_ignores=[]), script, "exec"), env)
    out = []
    for e in elts:
        name, builder, eye, w, h, depth = e.elts
        out.append((ast.literal_eval(name),
                    eval(compile(ast.Expression(builder), script, "eval"), env),
                    ast.literal_eval(eye), ast.literal_eval(w), ast.literal_eval(h),
                    ast.literal_eval(depth)))
    return out


def table_key(configs):
    return [(c[0], tuple(c[2]), c[3], c[4], c[5]) for c in configs]


def to_numpy_tables(scene):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


# --------------------------------------------------------------------------
# The tables
# --------------------------------------------------------------------------


def test_run_matrix_strategies_equal_jax():
    elts, _ = jax_table("run_matrix.py", "STRATEGIES")
    assert [ast.literal_eval(e) for e in elts] == run_matrix_torch.STRATEGIES


@pytest.mark.parametrize("script,port", [("bench_configs.py", bench_configs_torch),
                                         ("probe_device_loop.py", probe_device_loop_torch)])
def test_config_tables_equal_jax(script, port):
    assert table_key(port.CONFIGS) == table_key(jax_configs(script))


PROBE_CONFIGS = {c[0]: c for c in jax_configs("probe_device_loop.py")}


@pytest.mark.parametrize("name", list(PROBE_CONFIGS))
def test_builders_and_backends_equal_jax(name):
    """The port's builder gives the JAX builder's tables (valid rows equal),
    and the port resolves the JAX package's backend on them."""
    _, j_make, _, _, _, depth = PROBE_CONFIGS[name]
    port = {c[0]: c for c in probe_device_loop_torch.CONFIGS}[name]
    js = j_make()
    want = to_numpy_tables(js)
    got = scene_to_numpy(port[1](device="cpu"))
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    same = scene_from_numpy(want, device="cpu")
    j_backend = j_resolve_backend(JRenderConfig(backend="auto", depth=depth, ray_chunk=0), js)
    assert resolve_backend(RenderConfig(backend="auto", depth=depth, ray_chunk=0),
                           same) == j_backend
    bench = {c[0]: c for c in bench_configs_torch.CONFIGS}
    if name in bench:
        assert table_key([bench[name]]) == table_key([port])


# --------------------------------------------------------------------------
# The scripts, on the CPU
# --------------------------------------------------------------------------


def test_run_matrix_torch_smoke(tmp_path):
    out, js = tmp_path / "out", tmp_path / "rm.json"
    env = dict(CPU_ENV, RUN_MATRIX_STRATEGIES="sequential,ispc")
    proc = run([os.path.join(SCRIPTS, "run_matrix_torch.py"), "--device", "cpu",
                "--out", str(out), "--size", "48x36", "--json", str(js)], env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads(js.read_text())
    assert rec["all_match"] is True
    assert rec["backend_platform"] == "cpu" and rec["device_kind"] == "cpu"
    assert {s["strategy"] for s in rec["strategies"]} == {"sequential", "ispc"}
    for s in rec["strategies"]:
        assert s["steady_ms"] > 0 and s["first_ms"] > 0 and s["mrays_per_s"] > 0
        assert set(s["launches"]) == set(launches.WRAPPERS)
        assert not any(s["launches"].values())  # the CPU runs the plain versions
    assert set(rec["cross_check_flip_frac"]) == {"ispc"}
    assert (out / "outputsequential.ppm").exists()
    assert (out / "outputispc.ppm").exists()


def test_bench_configs_run_config_small():
    name, make, eye, _, _, depth = bench_configs_torch.CONFIGS[1]  # ten spheres, depth 2
    rec = bench_configs_torch.run_config(name, make, eye, 24, 16, depth, device="cpu")
    jax_keys = {"config", "rays", "tris", "depth", "backend", "device", "forward_ms",
                "forward_rays_per_s", "fwd_bwd_ms", "fwd_bwd_rays_per_s"}
    assert jax_keys <= set(rec)
    assert rec["rays"] == 24 * 16 and rec["depth"] == 2 and rec["backend"] == "fused"
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["forward_ms"] > 0 and rec["fwd_bwd_ms"] > 0
    assert rec["forward_rays_per_s"] == pytest.approx(rec["rays"] / rec["forward_ms"] * 1e3)
    assert set(rec["launches"]) == {"forward", "fwd_bwd"}
    assert all(n == 0 for leg in rec["launches"].values() for n in leg.values())


def test_probe_loop_arithmetic(monkeypatch):
    """frame_ms is (T(k2) - T(k1)) / (k2 - k1), and every frame of every loop
    (the two warm ones, eager and capture, and the timed) draws from ray ids
    of its own."""
    assert probe_device_loop_torch.loop_k(1920 * 1080) == (1, 3)
    assert probe_device_loop_torch.loop_k(512 * 512) == (2, 50)
    seen = []
    real = probe_device_loop_torch.make_frame

    def spy(scene, o, d, cfg, grad):
        frame = real(scene, o, d, cfg, grad)

        def counted(ids):
            seen.append(int(ids[0]))
            return frame(ids)
        return counted

    monkeypatch.setattr(probe_device_loop_torch, "make_frame", spy)
    monkeypatch.setattr(probe_device_loop_torch, "loop_k", lambda rays: (1, 3))
    name, make, eye, _, _, depth = probe_device_loop_torch.CONFIGS[0]  # sphere + plane
    rec = probe_device_loop_torch.probe(name, make, eye, 16, 12, depth, grad=True,
                                        device="cpu")
    raw = rec["raw_ms"]
    assert rec["frame_ms"] == pytest.approx((raw["3"] - raw["1"]) / 2, rel=1e-12)
    assert rec["leg"] == "fwd+bwd" and rec["backend"] == "fused" and rec["rays"] == 192
    loops = seen[:-1]  # the last is the one launch-counted frame
    assert len(loops) == 5 * 1 + 5 * 3 and len(set(loops)) == len(loops)


def test_make_golden_pixels_reproduces_committed_grid(tmp_path):
    out = tmp_path / "grid.npz"
    proc = run([os.path.join(SCRIPTS, "make_golden_pixels_torch.py"), "--out", str(out),
                "--device", "cpu"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = np.load(out)
    want = np.load(os.path.join(REPO, "tests", "golden", "cornell_pixels_48x36.npz"))
    assert set(got.files) == set(want.files) == {"rows", "cols", "rgb"}
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_bench_scaling_one_and_two_ranks():
    """Every section on 1 and 2 gloo ranks at tiny frames, in process (the
    ranks are processes of the script)."""
    text, ok = bench_scaling_torch.measure("cpu", size=(32, 24), grad_wh=(16, 12),
                                           prims_wh=(16, 16), ranks=(1, 2))
    assert torch.get_num_threads() == 1  # measure() gives the caller its threads back
    verdict = text.strip().splitlines()[-1]
    assert (verdict == "PASS") if ok else verdict.startswith("FAIL"), text
    for row in ("| unsharded | 1 |", "| sharded rays=1 | 1 |", "| sharded rays=2 | 2 |",
                "## Residual", "| 2 | 384 |", "## Sharded fwd+bwd train step",
                "| 2 x 1 |", "| 1 x 2 |", "1: gloo, 2: gloo"):
        assert row in text, row


@pytest.mark.parametrize("script", ["scripts/bench_configs_torch.py",
                                    "scripts/probe_device_loop_torch.py",
                                    "scripts/run_matrix_torch.py",
                                    "scripts/make_golden_pixels_torch.py",
                                    "scripts/bench_scaling_torch.py",
                                    "examples/render_cornell_torch.py"])
def test_cuda_asked_for_and_absent_fails(script, tmp_path):
    args = [os.path.join(REPO, script)]
    if script.endswith("run_matrix_torch.py"):
        args += ["--out", str(tmp_path)]
    elif script.endswith("render_cornell_torch.py"):
        args += [str(tmp_path / "c.ppm")]
    elif script.endswith(("make_golden_pixels_torch.py", "bench_scaling_torch.py")):
        args += ["--out", str(tmp_path / "out")]
    proc = run(args, timeout=300)
    assert proc.returncode != 0
    assert "No CUDA device" in proc.stderr
    assert not proc.stdout.strip() and not list(tmp_path.iterdir())
