"""The share of the mxtile searches that reused a scene table already built,
in %: 100 x (1 - `rt_mxu.table_builds` / `rt_mxu.table_calls`), the program's
counters on the searches' span `rt_mxu.prepass` (kernels/rt_mxu.py: one call
per closest-hit or any-hit search, one build per cluster sort), summed over
the profiled steps. A trace builds its tables once for all its searches: 50
where a step's two searches share them, 98.4 for 64. None where the program
counts no call."""

from esctp1raytracer_tpu_torch.utils import profiling

CALLS = "rt_mxu.table_calls"
BUILDS = "rt_mxu.table_builds"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    calls = sum(r.count(CALLS) for r in roots)
    if not calls:
        return None
    return 100.0 * (1.0 - sum(r.count(BUILDS) for r in roots) / calls)
