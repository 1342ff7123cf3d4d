"""Device ms per fit step of the fused backward's re-derivation
(kernels/fused_pallas.py: the span `fused.rederive` around `_FusedTraceDiff`'s
chunk loop: every chunk's `trace_rays` and its autograd backward), timed by the
events the span records inside the step's CUDA graph, on the profiled steps.
None where the program has no such span."""

from esctp1raytracer_tpu_torch.utils import profiling

SPAN = "fused.rederive"


def read(traced):
    per_step = getattr(profiling, "per_step", None)
    ms = per_step(traced.cpu, traced.steps, SPAN) if per_step else []
    return sum(ms) / len(ms) if ms else None
