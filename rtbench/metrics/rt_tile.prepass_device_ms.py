"""Device ms per step of the tile searches' table work (kernels/rt_tile.py: the
span `rt_tile.prepass`: the rays' padding, the triangles' one cluster sort of a
frame and each search's packed segments, and the any-hit search's oversized
sub-block, for the closest-hit and the any-hit search), on the profiled steps.
None where the program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "rt_tile.prepass"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN) if per_step else []
    return sum(ms) / len(ms) if ms else None
