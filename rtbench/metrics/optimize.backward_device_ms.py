"""Device ms per fit step of the backward (grad/optimize.py: the span
`optimize.backward` around torch.autograd.grad), timed by the events the span
records inside the step's CUDA graph, on the profiled steps. None where the
program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "optimize.backward"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN) if per_step else []
    return sum(ms) / len(ms) if ms else None
