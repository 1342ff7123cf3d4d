"""K1's share of its roofline (kernels/rt_mxu.py, csrc/rt_mxu.cu): the closest-hit
job's least time (rtbench/work/count.py) over the device time of these kernels."""

KERNELS = ("mxu_search_kernel",)
JOB = "closest_hit"


def read(traced):
    return traced.roofline_pct(KERNELS, JOB)
