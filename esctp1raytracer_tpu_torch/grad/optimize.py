"""Inverse rendering: fit scene parameters to a target image.

Counterpart of `esctp1raytracer_tpu/grad/optimize.py`, with its names,
arguments and Adam state: lists `m` and `v` and an int32 step `t`, so the
checkpoint extras `adam_t`, `adam_m_{i}` and `adam_v_{i}` mean the same in
both packages and a run started in one resumes in the other.

Each step is the loss and its gradients, `loss_and_grad` (the render and
`torch.autograd.grad` of the mean-squared error with respect to the
leaves that are fitted), then the Adam update under `torch.no_grad()`.
On the card `loss_and_grad` replays one CUDA graph per shape, as the JAX
package jits it (utils/graphs.py); Adam and the checkpoints run eagerly,
as there. With a `mesh` the loss and gradients
come from `loss_and_grad_sharded` (rays and prims split over the ranks,
gradients all-reduced). Every rank loads the checkpoint, since all hold
the replicated scene; only rank 0 of the mesh writes it, so that ranks
never race on the file, and the ranks meet at a barrier after its last
write, so that none returns before the final checkpoint is on disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render
from esctp1raytracer_tpu_torch.parallel.sharding import (
    float_params,
    loss_and_grad_sharded,
    merge_params,
)
from esctp1raytracer_tpu_torch.scene.types import Scene
from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from esctp1raytracer_tpu_torch.utils.debug import get_logger
from esctp1raytracer_tpu_torch.utils.graphs import graphed

logger = get_logger(__name__)


@graphed(static_argnames=("width", "height", "cfg", "frozen"))
def loss_and_grad(scene: Scene, target: torch.Tensor, camera: Camera, width: int, height: int,
                  cfg: RenderConfig, frozen: tuple):
    """mean((render(scene) - target)^2) and its gradients with respect to the
    float leaves not `frozen` (None for the frozen ones)."""
    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(not frz)
                  for p, frz in zip(float_params(scene), frozen)]
        img = render(merge_params(scene, leaves), camera, width, height, cfg)
        loss = torch.mean((img - target) ** 2)
        fitted = [p for p in leaves if p.requires_grad]
        got = iter(torch.autograd.grad(loss, fitted, allow_unused=True) if fitted else ())
    return loss.detach(), [next(got) if p.requires_grad else None for p in leaves]


def adam_init(params: Sequence[torch.Tensor]):
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": torch.zeros((), dtype=torch.int32)}


@torch.no_grad()
def adam_update(params, grads, state, lr=1e-2, b1=0.9, b2=0.999, eps=1e-8):
    """JAX's update formula, term for term, on new tensors (nothing in place)."""
    t = state["t"] + 1
    m = [b1 * m_ + (1 - b1) * g for m_, g in zip(state["m"], grads)]
    v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(state["v"], grads)]
    tf = t.to(torch.float32)
    # 0-d float32 tensors on the host: a CUDA operand takes them as scalars.
    c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf
    mhat = [m_ / c1 for m_ in m]
    vhat = [v_ / c2 for v_ in v]
    new_params = [
        p - lr * mh / (torch.sqrt(vh) + eps)
        for p, mh, vh in zip(params, mhat, vhat)
    ]
    return new_params, {"m": m, "v": v, "t": t}


@dataclass
class OptimizeResult:
    scene: Scene
    losses: List[float]
    steps: int


def fit_scene(
    scene: Scene,
    target: torch.Tensor,  # [H, W, 3]
    camera: Camera,
    steps: int = 100,
    lr: float = 1e-2,
    cfg: RenderConfig = RenderConfig(),
    mesh=None,
    param_filter: Optional[Callable[[int, torch.Tensor], bool]] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 25,
    log_every: int = 10,
) -> OptimizeResult:
    """Adam-optimize the scene's float parameters toward `target`.

    `param_filter(i, leaf) -> bool` freezes parameters it rejects (their
    gradients are zeroed) — e.g. keep geometry fixed and fit materials. It
    sees the scene's own leaf tensors, so it may test identity
    (`leaf is scene.spheres.kd`). With `mesh` set, the forward/backward
    shards rays (and prims) across the mesh's ranks and all-reduces scene
    gradients (parallel/sharding.py); otherwise the single-device renderer
    is differentiated directly.
    """
    # The filter sees the caller's own leaves, before a checkpoint replaces
    # them, so an identity test (`leaf is scene.spheres.kd`) holds on resume
    # too. (The JAX package filters the loaded leaves: a resumed run with
    # such a filter freezes every leaf there.)
    frozen = tuple(
        param_filter is not None and not param_filter(i, p)
        for i, p in enumerate(float_params(scene))
    )
    start_step = 0
    resume_extra: Dict[str, np.ndarray] = {}
    if checkpoint_path:
        try:
            scene, start_step, resume_extra = load_checkpoint(checkpoint_path, scene)
            logger.info("resumed from %s at step %d", checkpoint_path, start_step)
        except FileNotFoundError:
            pass

    height, width = target.shape[0], target.shape[1]
    params = float_params(scene)

    def step_loss_and_grad(ps):
        if mesh is None:
            return loss_and_grad(merge_params(scene, ps), target, camera, width, height, cfg,
                                 frozen)
        return loss_and_grad_sharded(merge_params(scene, ps), target, camera, cfg, mesh)

    state = adam_init(params)
    if "adam_t" in resume_extra:  # restore the optimizer moments too —
        # resetting them would change the optimization trajectory
        state = {
            "m": [torch.as_tensor(resume_extra[f"adam_m_{i}"], device=p.device)
                  for i, p in enumerate(params)],
            "v": [torch.as_tensor(resume_extra[f"adam_v_{i}"], device=p.device)
                  for i, p in enumerate(params)],
            "t": torch.as_tensor(resume_extra["adam_t"], dtype=torch.int32),
        }

    def adam_extra(st):
        extra = {"adam_t": st["t"]}
        for i, (m_, v_) in enumerate(zip(st["m"], st["v"])):
            extra[f"adam_m_{i}"] = m_
            extra[f"adam_v_{i}"] = v_
        return extra

    def save(sc, step, st):
        if mesh is None or mesh.rank == 0:
            save_checkpoint(checkpoint_path, sc, step, extra=adam_extra(st))

    losses: List[float] = []
    for step in range(start_step, steps):
        loss, grads = step_loss_and_grad(params)
        grads = [torch.zeros_like(p) if frz or g is None else g
                 for p, g, frz in zip(params, grads, frozen)]
        params, state = adam_update(params, grads, state, lr=lr)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            logger.info("step %d loss %.6g", step, losses[-1])
        if checkpoint_path and checkpoint_every and (step + 1) % checkpoint_every == 0:
            save(merge_params(scene, params), step + 1, state)

    final = merge_params(scene, params)
    if checkpoint_path:
        save(final, steps, state)
        if mesh is not None:
            mesh.barrier()
    return OptimizeResult(scene=final, losses=losses, steps=steps - start_step)
