"""The share of the shadow rays that K6 tests again after an earlier segment
found them occluded, in %: the program's counter `rt_tile.occl_settled_rays`
(the live rays, t_limit > 0, of each K6 launch after a frame's first that an
earlier launch or the oversized sub-block already occluded, summed on the
device) over `rt_tile.occl_later_rays` (the live rays those launches test),
summed over the profiled steps (kernels/rt_tile.py: `tile_occlusion`). None
where no launch after the first ran: a scene of one segment, or a program that
counts none."""

from esctp1raytracer_tpu_torch.utils import profiling

LATER = "rt_tile.occl_later_rays"
SETTLED = "rt_tile.occl_settled_rays"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    later = sum(r.count(LATER) for r in roots)
    if not later:
        return None
    return 100.0 * sum(r.count(SETTLED) for r in roots) / later
