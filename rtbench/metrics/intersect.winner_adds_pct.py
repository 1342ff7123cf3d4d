"""The winner-row backward's adds per ray reduced, in %: the program's counter
`intersect.winner_row_adds` (the row groups the scatter kernel adds, one per
distinct winner among 32 consecutive rays) over `intersect.winner_rays` (the
rays it reduces), summed over the profiled steps. 100% is one add per ray, as
`index_add_` made; coherent primary rays merge to a few %. None where the
program counts no rays."""

from esctp1raytracer_tpu_torch.utils import profiling

RAYS = "intersect.winner_rays"
ADDS = "intersect.winner_row_adds"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    rays = sum(r.count(RAYS) for r in roots)
    if not rays:
        return None
    return 100.0 * sum(r.count(ADDS) for r in roots) / rays
