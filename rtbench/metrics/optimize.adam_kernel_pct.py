"""The share of the Adam update's leaves that its one-launch kernel updated,
in %: 100 x `optimize.adam_kernel_leaves` / `optimize.adam_leaves`, the
program's counters on the span `optimize.adam` (grad/optimize.py:adam_update:
every leaf it updated, and those csrc/adam.cu's launch updated), summed over
the profiled steps. 100 where every leaf went through the kernel, 0 where the
tensor operations ran. None where the program counts no leaf."""

from esctp1raytracer_tpu_torch.utils import profiling

LEAVES = "optimize.adam_leaves"
KERNEL = "optimize.adam_kernel_leaves"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None or not traced.steps:
        return None
    roots = [r for rs in by_step(traced.cpu, traced.steps).values() for r in rs]
    leaves = sum(r.count(LEAVES) for r in roots)
    if not leaves:
        return None
    return 100.0 * sum(r.count(KERNEL) for r in roots) / leaves
