"""Device ms per step of the mxtile searches' sort and pack (kernels/rt_mxu.py:
the span `rt_mxu.prepass`: the rays' padding, the triangles' cluster sort and
the feature table's packing, for the closest-hit and the any-hit search), on
the profiled steps. None where the program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "rt_mxu.prepass"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN) if per_step else []
    return sum(ms) / len(ms) if ms else None
