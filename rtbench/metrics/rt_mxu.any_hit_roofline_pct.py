"""K2's share of its roofline (kernels/rt_mxu.py, csrc/rt_mxu.cu): the any-hit job's
least time (rtbench/work/count.py) over the device time of these kernels."""

KERNELS = ("mxu_occl_kernel",)
JOB = "any_hit"


def read(traced):
    return traced.roofline_pct(KERNELS, JOB)
