"""The share of the (ray, triangle) pairs K1 tests that the closest-hit job
needs, in %: the job's pairs (rtbench/work/count.py) over the pairs in the
blocks K1's 128-ray groups test (the program's counter
`rt_mxu.closest_hit_blocks` × 128 rays × 128 triangles), on the steps the
roofline share counts. Low where the cull keeps whole blocks that most rays of
a group do not enter. None where the program counts no blocks."""

from esctp1raytracer_tpu_torch.utils import profiling
from rtbench.trace import WORK_STEPS

KERNELS = ("mxu_search_kernel",)
COUNTER = "rt_mxu.closest_hit_blocks"
PAIRS_PER_BLOCK = 128 * 128  # RAY_TILE rays by SUB triangles
JOB = "closest_hit"


def read(traced):
    by_step = getattr(profiling, "by_step", None)
    if by_step is None:
        return None
    steps = [k for k in sorted(traced.steps) if traced.kernel_us(KERNELS, [k]) > 0][:WORK_STEPS]
    roots = by_step(traced.cpu, {k: traced.steps[k] for k in steps})
    tested = sum(r.count(COUNTER) for k in steps for r in roots[k]) * PAIRS_PER_BLOCK
    if not tested:
        return None
    return 100.0 * traced.work(JOB, steps)["pairs"] / tested
