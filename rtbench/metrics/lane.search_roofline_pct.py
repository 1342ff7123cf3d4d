"""K4's share of its roofline (kernels/lane_pallas.py, csrc/lane.cu), where the
backward re-derives the camera and shadow searches: the search job's least time
(rtbench/work/count.py) over the device time of the lane kernel."""

KERNELS = ("lane_search_kernel",)
JOB = "search"


def read(traced):
    return traced.roofline_pct(KERNELS, JOB)
