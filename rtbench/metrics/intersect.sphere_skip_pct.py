"""The share of the sphere table's slots that the sphere sites skipped, in %:
100 x (1 - `intersect.sphere_slots` / `intersect.sphere_capacity`), the
program's counters (core/intersect.py: each sphere site adds the rows it ran
over and the table's slots to its innermost span), summed over the profiled
steps. 100 where the scene has no sphere, 62.5 for 3 spheres in 8 slots, 0
where every slot is occupied. None where the program counts no site."""

from esctp1raytracer_tpu_torch.utils import profiling

SLOTS = "intersect.sphere_slots"
CAPACITY = "intersect.sphere_capacity"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    capacity = sum(r.count(CAPACITY) for r in roots)
    if not capacity:
        return None
    return 100.0 * (1.0 - sum(r.count(SLOTS) for r in roots) / capacity)
