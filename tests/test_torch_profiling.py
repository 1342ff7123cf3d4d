"""Port: the spans and counters of `utils/profiling.py`, and the graph layer's
(utils/graphs.py), on the CPU.

Spans are on exactly while a torch.profiler records; off, `annotate` is one
shared null context that creates nothing. On the CPU a span records its host
time (its device time needs the card: tests/test_torch_cuda.py holds a
spanned twin's replay there). The graph layer's caching is held here with a
stand-in for `torch.cuda.CUDAGraph` that runs the function once at capture,
as the card's capture records it.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu_torch.core.camera import Camera  # noqa: E402
from esctp1raytracer_tpu_torch.core.intersect import EPS, _sphere_best  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render  # noqa: E402
from esctp1raytracer_tpu_torch.grad import optimize  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import rt_mxu, tables  # noqa: E402
from esctp1raytracer_tpu_torch.parallel.sharding import float_params  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as b  # noqa: E402
from esctp1raytracer_tpu_torch.utils import graphs, profiling  # noqa: E402

W, H = 32, 24


@pytest.fixture
def fresh():
    profiling.reset()
    yield profiling
    profiling.reset()


@pytest.fixture(scope="module")
def scene():
    return b.scene_from_mesh([
        b.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
        b._ground_plane(),
        b._area_light(center=(0.0, 6.0, 2.0), half=1.5),
    ], device="cpu")


CAM = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=4 / 3, device="cpu")


def _tree(rec):
    return (rec.name, [_tree(c) for c in rec.children])


def test_annotate_off_is_the_shared_null_context(monkeypatch, fresh):
    """With no profiler recording: the same null context every time, and no
    RecordFunction range, CUDA event or record made; `count` does nothing."""
    def boom(*a, **k):
        raise AssertionError("made while spans are off")

    monkeypatch.setattr(profiling, "_RANGE", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not profiling.enabled()
    first = profiling.annotate("a")
    assert first is profiling.annotate("b", allocs=True) is profiling._NULL
    with first:
        with profiling.annotate("c"):
            profiling.count("n", 1)
    assert profiling.records() == [] and profiling.counters() == {}


def test_spans_nest_and_exclusive_times_add_up(fresh):
    """Under torch.profiler: each root and its children in order, a span's
    exclusive host time plus its children's equals its own, and every name is
    a host range of the profiler at operator scope (not a user annotation,
    which the profiler would also draw on the device)."""
    x = torch.ones((64, 64))
    with torch.profiler.profile() as prof:
        with profiling.annotate("t.outer"):
            x @ x
            with profiling.annotate("t.inner"):
                x @ x
                with profiling.annotate("t.leaf"):
                    x @ x
            with profiling.annotate("t.second"):
                x @ x
        with profiling.annotate("t.root2"):
            x @ x
    roots = profiling.records()
    assert [_tree(r) for r in roots] == [
        ("t.outer", [("t.inner", [("t.leaf", [])]), ("t.second", [])]), ("t.root2", [])]
    outer = roots[0]
    for rec in (outer, outer.children[0]):
        kids = sum(c.host_ms for c in rec.children)
        assert rec.exclusive("host") == pytest.approx(rec.host_ms - kids)
        assert 0.0 < kids <= rec.host_ms
    assert outer.device_ms is None and outer.exclusive() is None  # no card
    events = {e.name: e for e in prof.events()}
    for name in ("t.outer", "t.inner", "t.leaf", "t.second", "t.root2"):
        assert name in events and not events[name].is_user_annotation
        assert events[name].device_type == torch.autograd.DeviceType.CPU


def test_unrecorded_drops_operations_and_keeps_spans(fresh):
    """Inside `unrecorded()` (a spanned twin's capture) the profiler records
    no operation, while a span opened there is still recorded with its
    counts; after it, operations are recorded again."""
    x = torch.ones((8, 8))
    with torch.profiler.profile() as prof:
        x + 1
        with profiling.unrecorded():
            with profiling.annotate("t.quiet"):
                profiling.count("t.n", 3)
                x * 2
        x - 1
    names = [e.name for e in prof.events()]
    assert "aten::add" in names and "aten::sub" in names and "aten::mul" not in names
    (rec,) = profiling.records()
    assert rec.name == "t.quiet" and rec.counts == {"t.n": 3}


def test_trace_exporter_turns_spans_on(monkeypatch, tmp_path, fresh):
    """`trace()` is a profiler: the program's spans record inside it, and
    only there."""
    monkeypatch.setenv("ESCTP_PROFILE_DIR", str(tmp_path))
    with profiling.trace():
        assert profiling.enabled()
        with profiling.annotate("t.traced"):
            torch.ones(4).sum()
    assert not profiling.enabled()
    with profiling.annotate("t.untraced"):
        pass
    assert [r.name for r in profiling.records()] == ["t.traced"]


def test_counters_add_to_the_innermost_span_and_read_tensors_lazily(fresh):
    t = torch.tensor([3, 4], dtype=torch.int32)
    with torch.profiler.profile():
        with profiling.annotate("t.outer"):
            profiling.count("hits", 2)
            with profiling.annotate("t.inner"):
                profiling.count("hits", t.sum())
                profiling.count("hits", 1)
        profiling.count("hits", 100)  # no span open: dropped
    (root,) = profiling.records()
    assert root.counts == {"hits": 2} and root.children[0].counts == {"hits": 8}
    assert root.count("hits") == 10 and root.count("other") == 0
    profiling.add("setup", 1)
    profiling.add("setup", 0.5)
    assert profiling.counters() == {"setup": 1.5}
    profiling.reset()
    assert profiling.records() == [] and profiling.counters() == {}


def _rec(name, device_ms, children=(), counts=None):
    rec = profiling.Record(name)
    rec.device_ms, rec.children, rec.counts = device_ms, list(children), dict(counts or {})
    return rec


def test_by_step_pairs_roots_with_the_profilers_ranges(monkeypatch):
    """Roots pair, by name and in order from the newest, with the outermost
    host ranges of their names; the step whose interval holds a range's start
    takes its root. A root with no step (the profiler's first, uncounted
    call) and the ranges of a capture's spans inside a root are left out."""
    capture = _rec("graphs.call", 9.0, [_rec("graphs.replay", 9.0)])
    calls = [_rec("graphs.call", 5.0 + k, [_rec("graphs.replay", 4.0 + k, [
        _rec("shading.shade", 3.0, [_rec("intersect.any_hit", 1.0)])])]) for k in range(2)]
    adam = [_rec("optimize.adam", 0.5, counts={"alloc.device_mallocs": k}) for k in range(2)]
    old = _rec("graphs.call", 1.0)  # an earlier profiler's
    monkeypatch.setattr(profiling, "records",
                        lambda: [old, capture, calls[0], adam[0], calls[1], adam[1]])
    ranges = [("graphs.call", 0, 10), ("shading.shade", 2, 3),  # the capture's
              ("rtbench.step", 20, 40), ("graphs.call", 21, 30), ("optimize.adam", 31, 32),
              ("rtbench.step", 40, 60), ("graphs.call", 41, 50), ("optimize.adam", 51, 52)]
    steps = {1: (20, 40), 2: (40, 60)}
    got = profiling.by_step(ranges, steps)
    assert got == {1: [calls[0], adam[0]], 2: [calls[1], adam[1]]}
    assert profiling.per_step(ranges, steps, "shading.shade") == [3.0, 3.0]
    assert profiling.per_step(ranges, steps, "shading.shade", exclusive=True) == [2.0, 2.0]
    assert profiling.per_step(ranges, steps, "graphs.replay") == [4.0, 5.0]
    assert profiling.per_step(ranges, steps, "optimize.backward") == []
    assert profiling.per_step([r for r in ranges if r[0] != "graphs.call"], steps,
                              "graphs.replay") == []


class _FakeGraph:
    """`torch.cuda.CUDAGraph` on the CPU: the capture runs the function, a
    replay runs nothing (the outputs stay the capture's)."""

    def replay(self):
        pass


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(graphs, "_on_card", lambda tensors: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(graphs, "_capture_spanned", lambda g, fn, kwargs: fn(**kwargs))


def test_capture_counters_count_plain_graphs_only(fake_card, fresh):
    """The plain key's eager first call and capture count as set-up, with
    their seconds; the spanned twin that the first call under a profiler
    captures (two graphs, with no second eager call) counts apart."""
    calls = []

    def f(x):
        calls.append(1)
        with profiling.annotate("t.body"):
            return x * 2

    g = graphs.graphed(f)
    x = torch.ones(3)
    for _ in range(3):  # eager, capture, replay
        assert torch.equal(g(x), x * 2)
    c = profiling.counters()
    assert (c["graphs.warm_calls"], c["graphs.captures"], len(calls)) == (1, 1, 2)
    assert c["graphs.warm_s"] > 0 and c["graphs.capture_s"] > 0
    with torch.profiler.profile():
        for _ in range(2):  # the twin's capture, a replay
            assert torch.equal(g(x), x * 2)
    assert len(g.cache) == 2 and len(calls) == 4
    c2 = profiling.counters()
    assert c2["graphs.twin_captures"] == 1 and c2["graphs.twin_capture_s"] > 0
    assert {k: c2[k] for k in c} == c  # the plain counters did not move
    g(x)  # the plain graph again, with no profiler
    assert len(g.cache) == 2 and len(calls) == 4
    graphs.clear()


def test_twin_replays_add_the_captured_spans_under_graphs_replay(fake_card, fresh):
    """Each call through a graph is the root `graphs.call` with the copy-in,
    the replay and the clone-out; a spanned twin's replay holds a copy of the
    spans its graph's capture recorded, and the captures' own spans are not
    roots. The twin's two graphs replay in turn."""
    def f(x):
        with profiling.annotate("t.outer"):
            with profiling.annotate("t.inner"):
                profiling.count("t.n", 2)
                return x + 1

    g = graphs.graphed(f)
    x = torch.zeros(2)
    g(x)
    g(x)
    with torch.profiler.profile():
        g(x)  # the twin's captures and first replay
        g(x)
        g(x)
    (twin,) = [e for e in g.cache.values() if len(getattr(e, "takes", ())) == 2]
    assert twin.turn == 1
    roots = profiling.records()
    assert [r.name for r in roots] == ["graphs.call"] * 3
    for root in roots:
        assert _tree(root) == ("graphs.call", [
            ("graphs.copy_in", []),
            ("graphs.replay", [("t.outer", [("t.inner", [])])]),
            ("graphs.clone_out", [])])
        assert root.count("t.n") == 2
    inner = [r.find("t.inner")[0] for r in roots]
    assert len({id(r) for r in inner}) == 3  # one copy per replay
    graphs.clear()


def test_cpu_render_spans_and_k1_count(scene, fresh):
    """A render on the mxtile route under the profiler: the camera, the
    search (its sort and pack inside) and the shading (the shadow search
    inside it); K1's tested blocks equal the sum of `_prep_mxu`'s list
    lengths on the same rays, and K2's are counted too."""
    cfg = RenderConfig(backend="mxtile")
    with torch.no_grad():
        plain = render(scene, CAM, W, H, cfg)
        with torch.profiler.profile():
            img = render(scene, CAM, W, H, cfg)
    assert torch.equal(img, plain)
    assert [_tree(r) for r in profiling.records()] == [
        ("camera.ray_grid", []),
        ("intersect.closest_hit", [("rt_mxu.prepass", [])]),
        ("shading.shade", [("intersect.any_hit", [("rt_mxu.prepass", [])])])]
    o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(W, H))
    hint, _ = _sphere_best(o, d, scene.spheres, EPS)
    (_, aabbs, _), = tables.Tables(scene.triangles).segments(rt_mxu._pack_mxu,
                                                             rt_mxu.MXU_TRI_LIMIT)
    rays = tables.pad_rays(o, d, hint)
    want = int(rt_mxu._prep_mxu(rays[:, 0:3], rays[:, 3:6], aabbs, rays[:, 6])[2].sum())
    search, shade = profiling.records()[1:]
    assert search.count("rt_mxu.closest_hit_blocks") == want > 0
    assert shade.count("rt_mxu.any_hit_blocks") > 0


def _table_counts(root):
    return {n: root.count(n) for n in ("rt_mxu.table_calls", "rt_mxu.table_builds")}


def test_cpu_table_counters_on_an_mxtile_render(scene, fresh):
    """A depth-2 render on the mxtile route under the profiler: each of its four
    searches counts one `rt_mxu.table_calls` on its `rt_mxu.prepass` span, and
    only the first, which builds the scene tables the other three reuse, counts
    `rt_mxu.table_builds`."""
    cfg = RenderConfig(backend="mxtile", depth=2)
    with torch.no_grad(), torch.profiler.profile():
        render(scene, CAM, W, H, cfg)
    spans = [s for r in profiling.records() for s in r.find("rt_mxu.prepass")]
    assert [s.counts for s in spans] == (
        [{"rt_mxu.table_calls": 1, "rt_mxu.table_builds": 1}]
        + [{"rt_mxu.table_calls": 1}] * 3)


def test_table_counters_inside_a_graph_replay(fake_card, fresh):
    """The graphed depth-2 mxtile render's spanned twin: each replay counts the
    eager profiled render's four calls and one build."""
    sc = b.scene_from_mesh([b.icosphere_mesh(subdivisions=1, radius=1.0, center=(0.0, 1.0, 0.0)),
                            b._ground_plane(), b._area_light(center=(0.0, 6.0, 2.0), half=1.5)],
                           device="cpu")
    cfg = RenderConfig(backend="mxtile", depth=2)
    with torch.no_grad():
        with graphs.disabled(), torch.profiler.profile():
            render(sc, CAM, W, H, cfg)
        want = _table_counts(_root(profiling.records()))
        assert want == {"rt_mxu.table_calls": 4, "rt_mxu.table_builds": 1}
        profiling.reset()
        render(sc, CAM, W, H, cfg)  # the plain graph's eager first call
        render(sc, CAM, W, H, cfg)  # its capture
        with torch.profiler.profile():
            for _ in range(3):  # the twin's capture and replays
                render(sc, CAM, W, H, cfg)
    roots = [r for r in profiling.records() if r.name == "graphs.call"]
    assert len(roots) == 3
    for root in roots:
        (replay,) = root.find("graphs.replay")
        assert _table_counts(replay) == want
    graphs.clear()


def _root(roots):
    """Records under one root, to count over."""
    rec = profiling.Record("roots")
    rec.children = list(roots)
    return rec


def test_cpu_fit_step_spans(scene, fresh):
    """The fit step's spans on the CPU, where nothing is graphed: the render
    and loss, the backward and the Adam update, each a root; the allocator's
    counts need the card. The update counts the scene's 21 float leaves, none
    of them through the kernel (CPU tensors take the tensor operations)."""
    cfg = RenderConfig(backend="auto")
    with torch.no_grad():
        target = render(scene, CAM, W, H, cfg) * 0.8
    params = float_params(scene)
    with torch.profiler.profile():
        loss, grads = optimize.loss_and_grad(scene, target, CAM, W, H, cfg,
                                             (False,) * len(params))
        optimize.adam_update(params, [torch.zeros_like(p) if g is None else g
                                      for p, g in zip(params, grads)],
                             optimize.adam_init(params))
    roots = profiling.records()
    assert [r.name for r in roots] == ["optimize.loss", "optimize.backward", "optimize.adam"]
    assert [c.name for c in roots[0].children][:1] == ["camera.ray_grid"]
    assert roots[0].find("lane.search") or roots[0].find("fused.frame")
    assert len(params) == 21
    assert roots[2].counts == {"optimize.adam_leaves": 21, "optimize.adam_kernel_leaves": 0}
    assert all(r.host_ms > 0 for r in roots)


def _metric(name):
    """The reader `read(traced)` of rtbench/metrics/<name>.py."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "rtbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_winner_adds_reader_reads_its_counters(monkeypatch):
    """`intersect.winner_adds_pct`: the row adds over the rays reduced of the
    profiled steps, in %; None without the counters, as on a program that
    counts none, and None on a program without `by_step`."""
    import types

    read = _metric("intersect.winner_adds_pct")

    def step(k, counts):
        grad = _rec("intersect.winner_grad", 1.0, counts=counts)
        return _rec("graphs.call", 9.0, [_rec("graphs.replay", 8.0, [
            _rec("optimize.loss", 3.0), _rec("optimize.backward", 5.0, [grad])])])

    ranges = [("rtbench.step", 20, 40), ("graphs.call", 21, 30),
              ("rtbench.step", 40, 60), ("graphs.call", 41, 50)]
    traced = types.SimpleNamespace(cpu=ranges, steps={1: (20, 40), 2: (40, 60)})
    counted = [step(k, {"intersect.winner_rays": 6400, "intersect.winner_row_adds": 300 + k})
               for k in range(2)]
    monkeypatch.setattr(profiling, "records", lambda: counted)
    assert read(traced) == pytest.approx(100.0 * 601 / 12800)
    monkeypatch.setattr(profiling, "records", lambda: [step(k, {}) for k in range(2)])
    assert read(traced) is None
    monkeypatch.delattr(profiling, "by_step")
    assert read(traced) is None


def test_cpu_winner_grad_span_counts_rays_and_groups(scene, fresh):
    """A fit step on the lane route under the profiler: the backward of the
    winner fetch runs in `intersect.winner_grad` inside `optimize.backward`,
    counting the rays it reduced and the row groups of 32 consecutive rays
    (`warp_groups` of the clamped winners)."""
    from esctp1raytracer_tpu_torch.core.intersect import closest_hit
    from esctp1raytracer_tpu_torch.kernels import lane_pallas, winner

    cfg = RenderConfig(backend="lane")
    with torch.no_grad():
        target = render(scene, CAM, W, H, cfg) * 0.8
    params = float_params(scene)
    with torch.profiler.profile():
        optimize.loss_and_grad(scene, target, CAM, W, H, cfg, (False,) * len(params))
    backward = [r for r in profiling.records() if r.name == "optimize.backward"]
    assert len(backward) == 1
    spans = backward[0].find("intersect.winner_grad")
    assert len(spans) == 1 and spans[0].host_ms > 0
    o, d = (x.reshape(-1, 3) for x in CAM.ray_grid(W, H))
    with torch.no_grad():
        prim = closest_hit(o, d, scene, tri_search=lane_pallas.lane_tri_search).prim
    groups = int(winner.warp_groups(torch.clamp(prim, min=0).long()).sum())
    assert spans[0].counts == {"intersect.winner_rays": W * H,
                               "intersect.winner_row_adds": groups}
    assert W * H // 32 <= groups < W * H
