"""K5's share of its roofline (kernels/rt_tile.py, csrc/rt_tile.cu): the closest-hit
job's least time (rtbench/work/count.py) over the device time of these kernels."""

KERNELS = ("tile_search",)
JOB = "closest_hit"


def read(traced):
    return traced.roofline_pct(KERNELS, JOB)
