"""The share of the reflection rays that are still live, in %: the program's
counter `render.reflect_live` (the rays still active at a bounce after the
first, summed on the device) over `render.reflect_rays` (the rays
`core/render.py:trace_rays` traces at those bounces), summed over the profiled
steps. The rest are rays that missed or hit a surface with no specular term,
searched and shaded again and masked out. None where the program counts no
ray."""

from esctp1raytracer_tpu_torch.utils import profiling

RAYS = "render.reflect_rays"
LIVE = "render.reflect_live"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    rays = sum(r.count(RAYS) for r in roots)
    if not rays:
        return None
    return 100.0 * sum(r.count(LIVE) for r in roots) / rays
