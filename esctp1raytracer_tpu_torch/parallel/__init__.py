from esctp1raytracer_tpu_torch.parallel.sharding import (
    make_mesh,
    render_sharded,
    train_step_sharded,
    loss_and_grad_sharded,
    float_params,
    merge_params,
)
from esctp1raytracer_tpu_torch.parallel.distributed import init_distributed

__all__ = [
    "make_mesh",
    "render_sharded",
    "train_step_sharded",
    "loss_and_grad_sharded",
    "float_params",
    "merge_params",
    "init_distributed",
]
