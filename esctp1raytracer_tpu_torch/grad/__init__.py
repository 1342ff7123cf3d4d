from esctp1raytracer_tpu_torch.grad.optimize import (
    OptimizeResult,
    adam_init,
    adam_update,
    fit_scene,
)

__all__ = ["OptimizeResult", "fit_scene", "adam_init", "adam_update"]
