"""Device ms per fit step of the Adam update (grad/optimize.py: the span
`optimize.adam` around adam_update, run eagerly): from the update's first
operation on the stream to its last, on the profiled steps. Its host dispatch
overlaps the step's replay, so this is under optimize.adam_ms. None where the
program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "optimize.adam"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN) if per_step else []
    return sum(ms) / len(ms) if ms else None
