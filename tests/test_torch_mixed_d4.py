"""Port: BASELINE config 4 (`mixed_scene()`: 1,284 triangles, 3 glossy spheres,
depth-4 reflections) as the benchmark's configuration `mixed-d4-1080p` and
cell `mixed-d4-fit`, on the CPU at sizes it holds.

* The configuration's recipe is `builders.mixed_scene()`, leaf for leaf.
* The port's `loss_and_grad` (auto: the fused forward, the backward
  re-derived on lane, or on chunked mxtile when `BWD_MIN_RAYS` and
  `BWD_RAY_CHUNK` are shrunk) against the plain reference's
  (`rtbench/reference/render.py`: its sphere and reflection code).
* A whole run of the cell reads `correct`; the TF32 control and each planted
  fault (`rtbench/faults.py`) do not.
* The instruments: the span `fused.rederive` with its chunk and ray counters,
  the counters `render.reflect_rays` / `render.reflect_live` of
  `core/render.py:trace_rays`, eager and inside a graph's replay; the
  benchmark's live-ray filter (`rtbench/work/live.py`) against the
  reference's own `active`; and the untraced step unchanged by them.
"""

import contextlib
import importlib.util
import json
import math
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from esctp1raytracer_tpu_torch.core import render as render_mod  # noqa: E402
from esctp1raytracer_tpu_torch.grad import optimize  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import fused_pallas  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders  # noqa: E402
from esctp1raytracer_tpu_torch.scene.types import merge_params  # noqa: E402
from esctp1raytracer_tpu_torch.utils import graphs, profiling  # noqa: E402
from rtbench import faults, loops, run, scenes  # noqa: E402
from rtbench.reference import render as ref  # noqa: E402
from rtbench.work import count as work  # noqa: E402
from rtbench.work import live  # noqa: E402

CELL = "mixed-d4-fit"
W, H = 32, 18  # 576 camera rays
CHUNK = 160  # the shrunk re-derivation chunk: 576 rays in 4 chunks, the last of 96
SEEDS = [2**31 + 61, 2**31 + 62]
# The first loss: the port's fused frame and the reference agree to float32
# rounding (read: 0 and 1.2e-7 relative); a shading or search fault moves it
# by percents.
LOSS_RTOL = 1e-5
# A leaf's gradient: the norm of the difference over the larger of the leaf's
# reference norm and the median leaf's. Both sides differentiate the same
# winners' classic recompute; their float32 sums over rays and bounces run
# in other orders (read: at most 7.8e-5, `spheres.kd`, whose gradient is a
# tenth of the median's). A winner that flips or a bounce left out moves a
# leaf by percents.
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()
    graphs.clear()


@pytest.fixture
def harness(monkeypatch):
    """rtbench/run.py in this process: the suite's conftest loads JAX for the
    parity tests, which a benchmark run refuses to have loaded at its end (the
    measuring process on the card imports neither); here the run's check is
    what is tested."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])
    return run


def _chunk(monkeypatch):
    """The backward's chunked mxtile branch at the CPU's size."""
    monkeypatch.setattr(fused_pallas, "BWD_MIN_RAYS", 1)
    monkeypatch.setattr(fused_pallas, "BWD_RAY_CHUNK", CHUNK)


@pytest.fixture
def chunked(monkeypatch):
    _chunk(monkeypatch)


def _fit(seed):
    cell = run.load_cell(CELL)
    return cell, loops.make(cell.config, cell.mix, seed, "cpu", (W, H))


def _port_step(fit):
    return optimize.loss_and_grad(merge_params(fit.scene, fit.params), fit.target, fit.cam,
                                  W, H, fit.rcfg, fit.frozen)


def test_configuration_is_mixed_scene():
    spec = json.loads((ROOT / "rtbench" / "configs" / "mixed-d4-1080p.json").read_text())
    ours = scenes.port_scene(spec["scene"], "cpu")
    built = builders.mixed_scene(device="cpu")
    pairs = list(zip(ours.leaves(), built.leaves()))
    assert len(pairs) == len(list(built.leaves()))
    for (n, a), (m, b) in pairs:
        assert n == m and a.shape == b.shape and torch.equal(a, b), n
    arrays = scenes.scene_arrays(spec["scene"])
    assert (len(arrays.v), len(arrays.spheres["radius"])) == (1284, 3)
    assert (ours.triangles.capacity, ours.spheres.capacity) == (1536, 8)
    assert spec["render"]["depth"] == 4 and spec["reduced"] == []
    assert fused_pallas.fused_supported(ours, 4, "area")


@pytest.mark.parametrize("route", ["lane", "chunked_mxtile"])
@pytest.mark.parametrize("seed", SEEDS)
def test_loss_and_grad_match_the_reference(route, seed, monkeypatch):
    """Loss and every leaf's gradient, spheres' centre and radius included,
    on the cell's seeded start (kd and ks perturbed per triangle), through the
    backward's default route at this size (lane) and its chunked mxtile one."""
    if route == "chunked_mxtile":
        _chunk(monkeypatch)
    picked = []
    bwd_cfg = fused_pallas._bwd_cfg
    monkeypatch.setattr(fused_pallas, "_bwd_cfg",
                        lambda *a: picked.append(bwd_cfg(*a)) or picked[-1])
    cell, fit = _fit(seed)
    loss, grads = _port_step(fit)
    want = ("mxtile", CHUNK) if route == "chunked_mxtile" else ("lane", 0)
    assert [(c.backend, c.ray_chunk) for c in picked] == [want]
    r_loss, r_grads = ref.loss_and_grad(fit.ref_start, fit.target, cell.config["camera"], W, H,
                                        fit.ids, fit.seed, fit.depth)
    assert abs(float(loss) - float(r_loss)) <= LOSS_RTOL * float(r_loss)
    grads = dict(zip(fit.names, grads))
    norms = sorted(float(g.norm()) for g in r_grads.values() if float(g.norm()) > 0)
    med = norms[len(norms) // 2]
    assert {"spheres.center", "spheres.radius"} <= set(r_grads)
    for k, g_ref in r_grads.items():
        g = grads[k][:g_ref.shape[0]]
        assert float((g - g_ref).norm()) <= GRAD_RTOL * max(float(g_ref.norm()), med), k
    assert all(float(r_grads[k].norm()) > 0 for k in ("spheres.center", "spheres.radius"))


def test_a_run_of_the_cell_is_correct(harness):
    r = harness.run_cell(CELL, 2**31 + 71, 0.3, False, device="cpu", size=(W, H))
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"rays_per_s", "step_ms_p95", "peak_gib", "setup_s"}


def test_the_control_is_not_correct(harness):
    r = harness.run_cell(CELL, 2**31 + 72, 0.3, False, device="cpu", size=(W, H), control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(fault, harness):
    r = harness.run_cell(CELL, 2**31 + 73, 0.3, False, device="cpu", size=(W, H), fault=fault)
    assert not r["correct"], (fault, r["checks"])


# ---------------------------------------------------------------------------
# The instruments
# ---------------------------------------------------------------------------

def _spied_shade(monkeypatch):
    """Record each bounce's hits and ks as trace_rays' shading returns them."""
    seen = []
    shade = render_mod.shade

    def spy(o, d, hit, *a, **k):
        out = shade(o, d, hit, *a, **k)
        seen.append((hit.hit, out[3]))
        return out

    monkeypatch.setattr(render_mod, "shade", spy)
    return seen


def _active_counts(seen, depth):
    """(rays, live) summed over the bounces after the first of each wavefront
    in `seen`, by the bounce loop's own rule."""
    rays = live_n = 0
    for w in range(0, len(seen), depth):
        active = torch.ones_like(seen[w][0])
        for k in range(1, depth):
            hit, ks = seen[w + k - 1]
            active = active & hit & (torch.amax(ks, -1) > 0.0)
            rays += active.numel()
            live_n += int(active.sum())
    return rays, live_n


@pytest.mark.parametrize("route", ["lane", "chunked_mxtile"])
def test_rederive_span_and_reflect_counters(route, monkeypatch):
    """Under the profiler: one `fused.rederive` in the backward, with
    ceil(rays / chunk) chunks and every ray counted, the reflection counters
    inside it equal to a direct count of `active` over the bounces after the
    first, and nothing counted while the profiler is off."""
    if route == "chunked_mxtile":
        _chunk(monkeypatch)
    _, fit = _fit(SEEDS[0])
    seen = _spied_shade(monkeypatch)
    with torch.profiler.profile():
        _port_step(fit)
    backward = [r for r in profiling.records() if r.name == "optimize.backward"]
    assert len(backward) == 1
    (span,) = backward[0].find("fused.rederive")
    chunks = math.ceil(W * H / CHUNK) if route == "chunked_mxtile" else 1
    assert span.counts["fused.rederive_chunks"] == chunks
    assert span.counts["fused.rederive_rays"] == W * H
    assert len(seen) == 4 * chunks  # the fused forward shades inside K3's plain version
    rays, live_n = _active_counts(seen, 4)
    assert rays == 3 * W * H and 0 < live_n < rays
    assert (span.count("render.reflect_rays"), span.count("render.reflect_live")) == (rays, live_n)

    # Off, the counters cost no device work: no tensor is summed for them,
    # and `count` records nothing.
    calls = []
    count = profiling.count
    profiling.reset()
    monkeypatch.setattr(profiling, "count", lambda name, v: calls.append(v) or count(name, v))
    _port_step(fit)
    assert calls and not any(isinstance(v, torch.Tensor) for v in calls)
    assert profiling.records() == []


class _FakeGraph:
    """`torch.cuda.CUDAGraph` on the CPU: the capture runs the function, a
    replay runs nothing (the outputs and counts stay the capture's)."""

    def replay(self):
        pass


def test_rederive_counts_inside_a_graph_replay(chunked, monkeypatch):
    """The graphed fit step's spanned twin: each replay holds one copy of
    `fused.rederive` under `optimize.backward`, with its chunk, ray and
    reflection counts and its search-table calls and builds (one build for
    the 32 searches) as the eager profiled step counts them."""
    monkeypatch.setattr(graphs, "_on_card", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_capture_spanned", lambda g, fn, kwargs: fn(**kwargs))
    _, fit = _fit(SEEDS[1])
    with torch.profiler.profile():
        _port_step(fit)
    (eager,) = [r for root in profiling.records() for r in root.find("fused.rederive")]
    names = ("fused.rederive_chunks", "fused.rederive_rays", "render.reflect_rays",
             "render.reflect_live", "rt_mxu.table_calls", "rt_mxu.table_builds")
    want = {n: eager.count(n) for n in names}
    assert want["fused.rederive_chunks"] == math.ceil(W * H / CHUNK)
    assert want["rt_mxu.table_calls"] == 2 * 4 * math.ceil(W * H / CHUNK)
    assert want["rt_mxu.table_builds"] == 1
    profiling.reset()
    _port_step(fit)  # the plain graph's eager first call
    _port_step(fit)  # its capture
    with torch.profiler.profile():
        for _ in range(3):  # the twin's capture and replays
            _port_step(fit)
    roots = [r for r in profiling.records() if r.name == "graphs.call"]
    assert len(roots) == 3
    for root in roots:
        (replay,) = root.find("graphs.replay")
        (backward,) = replay.find("optimize.backward")
        (span,) = backward.find("fused.rederive")
        assert {n: span.count(n) for n in names} == want


def test_counters_leave_the_untraced_step_unchanged(chunked):
    """The step's loss and gradients, bit for bit, with the profiler off and
    on (spans and counters recording), on the chunked route."""
    _, fit = _fit(SEEDS[0])
    loss0, grads0 = _port_step(fit)
    with torch.profiler.profile():
        loss1, grads1 = _port_step(fit)
    assert any(r.find("fused.rederive") for r in profiling.records())
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))


def test_live_filter_keeps_the_references_active_rays(monkeypatch):
    """rtbench/work/live.py on a small depth-4 frame of the cell's scene: each
    bounce's kept rays are exactly the reference's own `active` there (read
    from its bounce loop), and its shadow rays take the same mask."""
    cell = run.load_cell(CELL)
    arrays = scenes.scene_arrays(cell.config["scene"])
    scene = ref.scene_from_arrays(arrays, "cpu")
    seen = []
    bounce = ref.bounce

    def spy(o, d, ids, seed, k, sc, record=None):
        out = bounce(o, d, ids, seed, k, sc, record)
        seen.append((out[4], out[3]))
        return out

    monkeypatch.setattr(ref, "bounce", spy)
    rec = []
    ids = torch.arange(W * H, dtype=torch.int64)
    with torch.no_grad():
        ref.image(scene, cell.config["camera"], W, H, ids, 7, 4, record=rec)
    kept = live.live_records(rec)
    active = torch.ones(W * H, dtype=torch.bool)
    per_bounce = []
    for k in range(4):
        if k:
            hit, ks = seen[k - 1]
            active = active & hit & (torch.amax(ks, -1) > 0.0)
        per_bounce.append(active.clone())
    full = {k: r for k, r in enumerate(x for x in rec if x[0] == "closest_hit")}
    lights = len(arrays.lights)
    assert [r[0] for r in kept] == [r[0] for r in rec]
    for k in range(4):
        i = k * (1 + lights)
        assert torch.equal(kept[i][1], full[k][1][per_bounce[k]])
        assert torch.equal(kept[i][3], full[k][3][per_bounce[k]])
        for j in range(1, lights + 1):
            assert torch.equal(kept[i + j][3], rec[i + j][3][per_bounce[k]])
    assert 0 < int(per_bounce[1].sum()) < W * H
    tris = tuple(scene.leaves[f"triangles.{c}"] for c in ("v0", "v1", "v2"))
    assert live.count("search", tris, rec)["pairs"] < work.count("search", tris, rec)["pairs"]


def _reader(name):
    path = ROOT / "rtbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _rec(name, device_ms, children=(), counts=None):
    r = profiling.Record(name)
    r.device_ms, r.host_ms = device_ms, device_ms
    r.children = list(children)
    r.counts = dict(counts or {})
    return r


def test_readers_of_the_new_spans_and_counters(monkeypatch):
    """`fused.rederive_device_ms` averages the span's device ms over the
    steps; `render.reflect_live_pct` is the live rays over the rays counted,
    in %; both None on a program without the span or the counters."""
    def step(k, counts):
        rederive = _rec("fused.rederive", 40.0 + k, counts=counts)
        return _rec("graphs.call", 60.0, [_rec("graphs.replay", 59.0, [
            _rec("optimize.loss", 2.0), _rec("optimize.backward", 55.0, [rederive])])])

    ranges = [("rtbench.step", 20, 40), ("graphs.call", 21, 30),
              ("rtbench.step", 40, 60), ("graphs.call", 41, 50)]
    traced = types.SimpleNamespace(cpu=ranges, steps={1: (20, 40), 2: (40, 60)})
    counted = [step(k, {"render.reflect_rays": 3000, "render.reflect_live": 90 + k})
               for k in range(2)]
    monkeypatch.setattr(profiling, "records", lambda: counted)
    assert _reader("fused.rederive_device_ms")(traced) == pytest.approx(40.5)
    assert _reader("render.reflect_live_pct")(traced) == pytest.approx(100.0 * 181 / 6000)
    bare = [_rec("graphs.call", 60.0, [_rec("graphs.replay", 59.0)]) for _ in range(2)]
    monkeypatch.setattr(profiling, "records", lambda: bare)
    assert _reader("fused.rederive_device_ms")(traced) is None
    assert _reader("render.reflect_live_pct")(traced) is None


def test_table_reuse_reader_reads_its_counters(monkeypatch):
    """`rt_mxu.table_reuse_pct`: 100 x (1 - builds / calls) of the mxtile
    search's scene tables over the profiled steps; None on a program that
    counts no call, and on one without `by_step`."""
    def step(counts):
        rederive = _rec("fused.rederive", 40.0, [
            _rec("rt_mxu.prepass", 1.0, counts={"rt_mxu.table_calls": 1, **counts}),
            _rec("rt_mxu.prepass", 0.1, counts={"rt_mxu.table_calls": 63})])
        return _rec("graphs.call", 60.0, [_rec("graphs.replay", 59.0, [
            _rec("optimize.loss", 2.0), _rec("optimize.backward", 55.0, [rederive])])])

    ranges = [("rtbench.step", 20, 40), ("graphs.call", 21, 30),
              ("rtbench.step", 40, 60), ("graphs.call", 41, 50)]
    traced = types.SimpleNamespace(cpu=ranges, steps={1: (20, 40), 2: (40, 60)})
    read = _reader("rt_mxu.table_reuse_pct")
    counted = [step({"rt_mxu.table_builds": 1}), step({"rt_mxu.table_builds": 2})]
    monkeypatch.setattr(profiling, "records", lambda: counted)
    assert read(traced) == pytest.approx(100.0 * (1 - 3 / 128))
    bare = [_rec("graphs.call", 60.0, [_rec("graphs.replay", 59.0)]) for _ in range(2)]
    monkeypatch.setattr(profiling, "records", lambda: bare)
    assert read(traced) is None
    monkeypatch.delattr(profiling, "by_step")
    assert read(traced) is None


def test_rederive_roofline_reader_counts_live_work(monkeypatch):
    """`rt_mxu.rederive_roofline_pct`: the live search job's least time over
    K1 and K2's device time (any instantiation) on the first two steps they
    ran in; None where they ran in none."""
    cell = run.load_cell(CELL)
    arrays = scenes.scene_arrays(cell.config["scene"])
    scene = ref.scene_from_arrays(arrays, "cpu")
    rec = []
    with torch.no_grad():
        ref.image(scene, cell.config["camera"], W, H, torch.arange(W * H), 7, 4, record=rec)
    tris = tuple(scene.leaves[f"triangles.{c}"] for c in ("v0", "v1", "v2"))
    built = []

    class Loop:
        work_scale = 1.0

        def wavefronts(self, k):
            built.append(k)
            return tris, rec

    dev = [("void mxu_search_kernel<0>(float const*)", 21.0, 31.0),
           ("void mxu_occl_kernel<1>(float const*)", 32.0, 36.0),
           ("fused_frame_kernel", 36.0, 37.0),
           ("void mxu_search_kernel<0>(float const*)", 61.0, 65.0)]
    from rtbench.trace import PEAKS, Traced

    traced = Traced.__new__(Traced)
    traced.dev, traced.steps, traced.loop = dev, {1: (0, 20), 2: (20, 40), 3: (60, 80)}, Loop()
    traced._waves, traced._work = {}, {}
    got = _reader("rt_mxu.rederive_roofline_pct")(traced)
    spent = (10.0 + 4.0 + 4.0) * 1e-6
    w = live.count("search", tris, rec)
    want = 100.0 * 2 * work.least_seconds(w, PEAKS) / spent
    assert got == pytest.approx(want) and sorted(built) == [2, 3]
    traced.dev = [x for x in dev if "mxu" not in x[0]]
    assert _reader("rt_mxu.rederive_roofline_pct")(traced) is None
