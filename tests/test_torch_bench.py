"""Port vs JAX package: the benchmark (`bench_torch.py` against `bench.py`).

* The scene: `bench_torch`'s (the port's `bench_scene`) equals
  `bench.build_scene()` leaf for leaf.
* The headline's calls (`bench_torch.headline`, which `run` times) on
  JAX's rays of bench.py's camera at 48x27, against the loss and
  `jax.grad` built from bench.py's own pieces (`build_scene`, `DEPTH`,
  `trace_rays`, `float_params`, `merge_params`) on backend "auto" (mxtile
  on both sides; the JAX package's kernel in interpret mode, as
  tests/test_rt_mxu.py runs it): the image within tests/test_rt_mxu.py's
  bar (mean difference < 1e-4, < 0.5% of values off by more than 1e-2),
  the loss within 1e-5 relative, the gradients within
  tests/test_sharding.py:150-155's bars (atol 3e-4 of the leaf's scale,
  rtol 3e-3). The Cornell call (8 fused renders, ids + i) against
  bench.py's Cornell loop body, at 32x24: the sum within 1e-5 relative.
* `run("cpu", ...)` at 48x27 (Cornell 32x24): bench.py's keys and the
  port's, the rays/s and `vs_baseline` arithmetic from
  reference_baseline.json, and the Cornell leg skipped only where
  bench.py skips it.
* No fallback: a failing search makes `main` exit non-zero with bench.py's
  error record as the last line, no second backend tried (the counterpart
  of tests/test_bench_fallback.py); with no card, `--device cuda` fails.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
               "jax_persistent_cache_min_compile_time_secs")
_cache_config = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
import bench  # noqa: E402  (import is side-effect free but for JAX's cache settings)

for _k, _v in _cache_config.items():  # keep this test process's JAX configuration as it was
    jax.config.update(_k, _v)

import bench_torch  # noqa: E402

from esctp1raytracer_tpu import Camera as JCamera  # noqa: E402
from esctp1raytracer_tpu import RenderConfig as JRenderConfig  # noqa: E402
from esctp1raytracer_tpu import cornell_box as j_cornell_box  # noqa: E402
from esctp1raytracer_tpu.core.render import resolve_backend as j_resolve_backend  # noqa: E402
from esctp1raytracer_tpu.core.render import trace_rays as j_trace_rays  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import float_params as j_float_params  # noqa: E402
from esctp1raytracer_tpu.parallel.sharding import merge_params as j_merge_params  # noqa: E402
from esctp1raytracer_tpu_torch import RenderConfig, cornell_box  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import trace_rays  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import launches, rt_mxu  # noqa: E402
from esctp1raytracer_tpu_torch.scene.builders import bench_scene  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import scene_to_numpy  # noqa: E402

W, H, CW, CH = 48, 27, 32, 24
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "backend", "setup_compile_s",
              "cache_hits", "cache_new_entries"}
PORT_KEYS = {"resolved_backend", "device", "card", "rays", "fwd_ms", "fwd_bwd_ms", "cornell_ms",
             "host_ms", "peak_gib", "launches"}


def j_rays(eye, aspect, w, h):
    o, d = JCamera.look_at(eye, (0.0, 1.0, 0.0), vfov=60.0, aspect=aspect).ray_grid(w, h)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    return o, d, jnp.arange(o.shape[0], dtype=jnp.uint32)


def to_torch(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def to_numpy_tables(scene):
    return {jax.tree_util.keystr(p)[1:]: np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(scene)[0]}


@pytest.fixture(scope="module")
def j_scene():
    return bench.build_scene()


@pytest.fixture(scope="module")
def record():
    return bench_torch.run("cpu", W, H, (CW, CH), iters=1, batches=1)


def test_scene_equals_bench_build_scene(j_scene):
    want = to_numpy_tables(j_scene)
    got = scene_to_numpy(bench_scene(device="cpu"))
    assert set(got) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_headline_matches_jax(j_scene):
    jcfg = JRenderConfig(backend="auto", ray_chunk=0, block_size=512, depth=bench.DEPTH)
    o, d, ids = j_rays((0.0, 2.0, 6.0), bench.WIDTH / bench.HEIGHT, W, H)

    def loss_fn(ps):
        color = j_trace_rays(o, d, j_merge_params(j_scene, ps), ids, jcfg)
        return jnp.sum(color * color)

    params = j_float_params(j_scene)
    j_loss = float(jax.jit(loss_fn)(params))
    j_grads = [np.asarray(g) for g in jax.jit(jax.grad(loss_fn))(params)]
    j_image = np.asarray(j_trace_rays(o, d, j_scene, ids, jcfg))

    scene = bench_scene(device="cpu")
    cfg = RenderConfig(backend="auto", ray_chunk=0, block_size=512, depth=bench_torch.DEPTH)
    assert j_resolve_backend(jcfg, j_scene) == "mxtile"
    to, td = to_torch(o, d)
    tids = torch.arange(to.shape[0], dtype=torch.int64)
    fwd, fwd_bwd = bench_torch.headline(scene, to, td, cfg)
    launches.reset()
    loss = float(fwd(tids))
    grads = fwd_bwd(tids)
    assert not any(launches.read().values())  # the CPU runs the plain versions
    with torch.no_grad():
        image = trace_rays(to, td, scene, tids, cfg).numpy()
    diff = np.abs(image - j_image)
    assert diff.mean() < 1e-4
    assert (diff > 1e-2).mean() < 5e-3
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert len(grads) == len(j_grads)
    for i, (g, jg) in enumerate(zip(grads, j_grads)):
        g = np.zeros_like(jg) if g is None else g.numpy()
        scale = max(np.abs(jg).max(), 1e-6)
        np.testing.assert_allclose(g, jg, atol=3e-4 * scale, rtol=3e-3, err_msg=f"leaf {i}")


def test_cornell_call_matches_jax():
    o, d, ids = j_rays((0.0, 1.0, 2.0), 1024 / 768, CW, CH)
    jcfg = JRenderConfig(backend="fused", ray_chunk=0, block_size=512, depth=bench.DEPTH)
    jscene = j_cornell_box()

    @jax.jit
    def cf():  # bench.py's Cornell loop, reps = 8
        def body(i, acc):
            return acc + jnp.sum(j_trace_rays(o, d, jscene, ids + i.astype(jnp.uint32), jcfg))
        return jax.lax.fori_loop(0, bench_torch.CORNELL_REPS, body, 0.0)

    to, td = to_torch(o, d)
    call = bench_torch.cornell_call(cornell_box(device="cpu"), to, td,
                                    RenderConfig(backend="fused", ray_chunk=0, block_size=512,
                                                 depth=bench_torch.DEPTH))
    got = float(call(torch.arange(to.shape[0], dtype=torch.int64)))
    assert got > 0
    np.testing.assert_allclose(got, float(cf()), rtol=1e-5)


def test_run_record(record):
    assert BENCH_KEYS | PORT_KEYS == set(record)
    assert record["metric"] == "rays_per_s_chip_fwd_bwd_1080p" and record["unit"] == "rays/s"
    assert record["backend"] == "auto" and record["resolved_backend"] == "mxtile"
    assert record["device"] == {"platform": "cpu", "kind": "cpu"} and record["card"] is None
    assert record["rays"] == W * H
    assert record["value"] == round(W * H / (record["fwd_bwd_ms"] / 1e3), 1)
    assert record["fwd_ms"] > 0 and record["fwd_bwd_ms"] > 0 and record["cornell_ms"] > 0
    assert all(record["host_ms"][k] > 0 for k in ("fwd", "fwd_bwd", "cornell"))
    assert record["peak_gib"] == {"fwd": None, "fwd_bwd": None}
    assert record["cache_hits"] == record["cache_new_entries"] == 0  # no CUDA source loaded
    assert record["setup_compile_s"] >= 0
    assert set(record["launches"]) == {"fwd_bwd", "cornell"}
    for counts in record["launches"].values():
        assert set(counts) == set(launches.WRAPPERS) and not any(counts.values())


def test_vs_baseline_arithmetic(record):
    with open(os.path.join(REPO, "reference_baseline.json")) as fh:
        ref = json.load(fh)["rays_per_s_forward"]
    assert ref == 2512613
    want = CW * CH / (record["cornell_ms"] / 1e3) / ref
    assert record["vs_baseline"] == round(want, 3)


@pytest.mark.parametrize("content", [None, {"sequential_ms": 635}])
def test_cornell_leg_skipped_as_bench_skips_it(content, tmp_path, monkeypatch):
    """reference_baseline.json absent, or without rays_per_s_forward."""
    path = tmp_path / "reference_baseline.json"
    if content is not None:
        path.write_text(json.dumps(content))
    monkeypatch.setattr(bench_torch, "REFERENCE", str(path))
    monkeypatch.setenv("ESCTP_BENCH_BACKEND", "jnp")
    rec = bench_torch.run("cpu", 16, 9, (CW, CH), iters=1, batches=1)
    assert rec["vs_baseline"] is None and rec["cornell_ms"] is None
    assert rec["launches"]["cornell"] is None and rec["host_ms"]["cornell"] is None
    assert rec["backend"] == rec["resolved_backend"] == "jnp" and rec["value"] > 0


def test_failing_search_fails_the_run_without_fallback(monkeypatch, capsys):
    tried = []

    def spy(o, d, scene, ids, cfg, tri_search=None):
        tried.append(cfg.backend)
        return trace_rays(o, d, scene, ids, cfg, tri_search)

    def broken(*args, **kwargs):
        raise RuntimeError("mxtile kernel launch failed")

    monkeypatch.setattr(bench_torch, "trace_rays", spy)
    monkeypatch.setattr(rt_mxu, "mxu_tile_search", broken)
    assert bench_torch.main(["--device", "cpu"]) == 1
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert last["metric"] == "rays_per_s_chip_fwd_bwd_1080p" and last["value"] == 0.0
    assert last["vs_baseline"] is None and "mxtile kernel launch failed" in last["error"]
    assert "Traceback" in out.err
    assert tried == ["auto"]  # one attempt: no other backend


def test_cuda_asked_for_and_absent_fails():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "bench_torch.py"), "--device",
                           "cuda"], capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    last = json.loads(lines[-1])
    assert last["value"] == 0.0 and "No CUDA device" in last["error"]
    assert "No CUDA device" in proc.stderr
