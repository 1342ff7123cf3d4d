"""K1 and K2's share of their roofline where they run only inside the fused
backward's chunked re-derivation (kernels/fused_pallas.py: `_FusedTraceDiff`,
kernels/rt_mxu.py, csrc/rt_mxu.cu): the search job's least time over the
device time of those kernels, on the first two profiled steps in which they
ran, as `Traced.roofline_pct` reads a share. The work counts only the rays
live at each bounce (rtbench/work/live.py): the dead reflection rays that the
program searches again are spent time, not needed work. None where neither
kernel ran."""

from rtbench.trace import PEAKS, WORK_STEPS
from rtbench.work import count as work
from rtbench.work import live

KERNELS = ("mxu_search", "mxu_occl")
JOB = "search"


def read(traced):
    steps = [k for k in sorted(traced.steps) if traced.kernel_us(KERNELS, [k]) > 0][:WORK_STEPS]
    if not steps:
        return None
    spent = traced.kernel_us(KERNELS, steps) * 1e-6
    total = {"flops": 0, "bytes": 0}
    for k in steps:
        tris, records = live.wavefronts(traced, k)
        w = live.count(JOB, tris, records, traced.loop.work_scale)
        total = {key: total[key] + w[key] for key in total}
    return 100.0 * work.least_seconds(total, PEAKS) / spent
