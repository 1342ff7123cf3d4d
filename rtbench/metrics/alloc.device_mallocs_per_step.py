"""The caching allocator's device allocations (cudaMalloc) per profiled step:
the program's counter `alloc.device_mallocs` (the change of
`num_device_alloc` over the spans `graphs.call` and `optimize.adam`, where a
step's graphed call and its eager Adam update allocate), summed per step and
averaged over the profiled steps. 0 where the pools are warm. None where the
program counts none."""

from esctp1raytracer_tpu_torch.utils import profiling

COUNTER = "alloc.device_mallocs"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    if not any(COUNTER in r.counts for r in roots):
        return None
    return sum(r.counts.get(COUNTER, 0) for r in roots) / len(traced.steps)
