"""Host seconds of the graph layer's set-up (utils/graphs.py): the eager first
calls of its plain graphs (the kernels' builds and library loads included) and
their captures, before the window; a spanned twin captured under the profiler
is not counted. None where the program counts none."""

from esctp1raytracer_tpu_torch.utils import profiling


def read(traced):
    counters = getattr(profiling, "counters", None)
    c = counters() if counters else {}
    if not c.get("graphs.captures"):
        return None
    return c.get("graphs.warm_s", 0.0) + c["graphs.capture_s"]
