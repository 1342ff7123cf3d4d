"""Port vs JAX package: debug levels, the Timer's stderr block and the
profiling hooks (torch.profiler in the port).

Tolerances: none. The Timer's block is compared as text, byte for byte,
at the same elapsed time.
"""

import io
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu.utils import debug as j_debug  # noqa: E402
from esctp1raytracer_tpu.utils.timing import Timer as JTimer  # noqa: E402
from esctp1raytracer_tpu_torch.utils import debug  # noqa: E402
from esctp1raytracer_tpu_torch.utils.profiling import annotate, trace  # noqa: E402
from esctp1raytracer_tpu_torch.utils.timing import Timer  # noqa: E402


def test_debug_levels_match_jax():
    assert (debug.QUIET, debug.INFO, debug.DEBUG, debug.TRACE) == (
        j_debug.QUIET, j_debug.INFO, j_debug.DEBUG, j_debug.TRACE)
    try:
        for level in (-1, 0, 1, 2, 3, 99):
            debug.set_level(level)
            j_debug.set_level(level)
            assert debug.current_level() == j_debug.current_level()
            assert debug.get_logger().level == j_debug.get_logger().level
        assert debug.current_level() == debug.TRACE  # clamped
        assert debug.get_logger().name == "esctp1raytracer_tpu_torch"
        assert not debug.get_logger().propagate
    finally:
        debug.set_level(debug.INFO)
        j_debug.set_level(j_debug.INFO)


@pytest.mark.parametrize("fields", [
    {},
    {"Threaded": "false", "Flattened": "true", "ISPC": "false", "Mode": "single/mxu",
     "Devices": 1},
])
def test_timer_report_identical_to_jax(fields):
    with Timer("render") as t:
        pass
    assert t.elapsed_ms >= 0.0
    out, ref = io.StringIO(), io.StringIO()
    for timer, buf in ((t, out), (JTimer("render"), ref)):
        timer.fields, timer.elapsed_ms = dict(fields), 12.3456
        timer.report(file=buf)
    assert out.getvalue() == ref.getvalue()
    assert out.getvalue().endswith("\n Duration  : 12.346 ms\n")


def test_trace_is_a_noop_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("ESCTP_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with trace():
        assert not torch.autograd.profiler._is_profiler_enabled
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("from_env", [False, True])
def test_trace_writes_a_chrome_trace(monkeypatch, tmp_path, from_env):
    if from_env:
        monkeypatch.setenv("ESCTP_PROFILE_DIR", str(tmp_path))
    with trace(None if from_env else str(tmp_path)):
        with annotate("port-region"):
            torch.ones((8, 8)).sum()
    files = list(tmp_path.rglob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port-region" for e in events)


def test_annotate_outside_a_trace():
    with annotate("region"):
        torch.ones(2).sum()
