"""A step's wavefronts cut to the rays that each bounce has to trace.

The reference (`rtbench/reference/render.py:trace`) searches every ray at
every bounce and masks the inactive ones out afterwards: a ray that missed,
or hit a surface with no specular term, keeps its origin and direction from
then on. So at a bounce after the first the live rays are exactly those
whose origin or direction differs from their record at the bounce before,
and the shadow rays of a bounce take that bounce's mask. `count` counts a
job (`rtbench/work/count.py`) over those rays alone: a program that stops
tracing dead rays is not charged for work it no longer has to do, and one
that traces them reads that work as spent over its roofline.
"""

from __future__ import annotations

import torch

from rtbench.work import count as work


def _take(rec: tuple, mask: torch.Tensor) -> tuple:
    return tuple(x[mask] if isinstance(x, torch.Tensor) else x for x in rec)


def live_records(records: list) -> list:
    """`records` (the reference's, every pass in order) with each bounce's
    closest-hit and any-hit records cut to the rays live at that bounce."""
    out, prev, mask = [], None, None
    for rec in records:
        if rec[0] == "closest_hit":
            o, d, bounce = rec[1], rec[2], rec[4]
            mask = None
            if bounce > 0:
                mask = ~(torch.all(o == prev[0], 1) & torch.all(d == prev[1], 1))
            prev = (o, d)
        out.append(rec if mask is None else _take(rec, mask))
    return out


def count(job: str, tris, records: list, scale: float = 1.0) -> dict:
    """`rtbench.work.count.count` over the live rays of each bounce."""
    return work.count(job, tris, live_records(records), scale)


def wavefronts(traced, step: int):
    """Step `step`'s (tris, records), rebuilt once per run and shared with
    the readers that `traced.work` serves."""
    if step not in traced._waves:
        traced._waves[step] = traced.loop.wavefronts(step)
    return traced._waves[step]
