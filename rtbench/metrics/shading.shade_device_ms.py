"""Device ms per step of the shading (core/shading.py: the span
`shading.shade`) less the shadow rays' search inside it (`intersect.any_hit`),
on the profiled steps: the forward's shading tensor ops. None where the
program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "shading.shade"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN, exclusive=True) if per_step else []
    return sum(ms) / len(ms) if ms else None
