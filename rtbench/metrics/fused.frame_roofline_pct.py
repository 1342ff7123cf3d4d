"""K3's share of its roofline (kernels/fused_pallas.py, csrc/fused.cu): the frame job's
least time (both searches and the shading; rtbench/work/count.py) over the device
time of the frame kernel. The table build is a launch of its own and not counted."""

KERNELS = ("fused_frame_kernel",)
JOB = "frame"


def read(traced):
    return traced.roofline_pct(KERNELS, JOB)
