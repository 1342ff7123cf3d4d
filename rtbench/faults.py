"""Faults planted underneath the timed path, to see `correct` come out false.

Each is a way a change to the program could break a cell while the loop
still runs: a step that returns its state unchanged, half of the batch (the
rays) left out with the mean taken over the rest, and an answer altered
where it is produced. (One card: there is no exchange between cards to leave
out.) `planted(name)` swaps the port's entry in `rtbench.loops` for a broken
one for the length of a run; nothing else reads these.
"""

from __future__ import annotations

import contextlib

import torch

from esctp1raytracer_tpu_torch.core.render import render
from esctp1raytracer_tpu_torch.scene.types import float_params, merge_params
from esctp1raytracer_tpu_torch.utils import graphs
from rtbench import loops

ALTER = 1.01  # an altered answer is off by 1%

FAULTS = ("state_unchanged", "half_batch", "altered")


def _fit_loss(rows_kept: float, scale: float):
    """A fit step's loss and gradients from the rendered image scaled by `scale`,
    over the first `rows_kept` of its rows."""

    def loss_and_grad(scene, target, camera, width, height, cfg, frozen):
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(not f)
                      for p, f in zip(float_params(scene), frozen)]
            img = render(merge_params(scene, leaves), camera, width, height, cfg) * scale
            h = max(1, int(height * rows_kept))
            loss = torch.mean((img[:h] - target[:h]) ** 2)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), list(grads)

    return loss_and_grad


def _half_rays(trace_rays):
    def broken(o, d, scene, ray_ids, cfg, tri_search=None):
        c = trace_rays(o, d, scene, ray_ids, cfg, tri_search)
        h = c.shape[0] // 2
        return torch.cat([c[:h], torch.zeros_like(c[h:])])
    return broken


def _scaled(trace_rays):
    def broken(o, d, scene, ray_ids, cfg, tri_search=None):
        return trace_rays(o, d, scene, ray_ids, cfg, tri_search) * ALTER
    return broken


class _Stale:
    """The graph layer with every graphed call returning its first output again."""

    clear = staticmethod(graphs.clear)

    @staticmethod
    def graphed(fn):
        g, first = graphs.graphed(fn), []

        def call(*args, **kwargs):
            if not first:
                first.append(g(*args, **kwargs))
            return first[0]

        return call


@contextlib.contextmanager
def planted(name: str):
    """Inside the block, rtbench.loops drives the port with fault `name` in it."""
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "state_unchanged":
        patch(loops, "adam_update", lambda params, grads, state, lr=1e-2: (params, state))
        patch(loops, "graphs", _Stale)
    elif name == "half_batch":
        patch(loops, "loss_and_grad", _fit_loss(0.5, 1.0))
        patch(loops, "trace_rays", _half_rays(loops.trace_rays))
    else:
        patch(loops, "loss_and_grad", _fit_loss(1.0, ALTER))
        patch(loops, "trace_rays", _scaled(loops.trace_rays))
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
