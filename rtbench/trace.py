"""What a `--trace 1` run reads: a torch.profiler stretch of the window.

The harness names its own ranges (`rtbench.step` around each step, and
inside it `rtbench.call`, `rtbench.adam`, `rtbench.camera`,
`rtbench.readback`); the device's kernels and copies come from the
profiler's CUDA activity. `Traced` is what the per-layer readers in
`rtbench/metrics/` receive.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from rtbench.work import count as work

PEAKS = json.loads((Path(__file__).resolve().parent / "work" / "peaks.json").read_text())
WORK_STEPS = 2  # profiled steps whose work is counted for a roofline share
HARNESS_RANGES = ("rtbench.call", "rtbench.adam", "rtbench.camera", "rtbench.readback")


def _union(intervals, lo, hi):
    """Length of the union of [s, e) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


class Traced:
    """One run's profiled stretch, its host-clock layer timings and its loop."""

    def __init__(self, prof, step_ids, loop, timing):
        cpu, dev = [], []
        for e in prof.events():
            item = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type != torch.autograd.DeviceType.CUDA:
                cpu.append(item)
            elif not e.name.startswith("rtbench."):  # the harness's ranges drawn on the device
                dev.append(item)
        self.cpu = cpu
        self.dev = sorted(dev, key=lambda x: x[1])
        spans = sorted((s, e) for n, s, e in cpu if n == "rtbench.step")
        self.steps = dict(zip(step_ids, spans))  # step index -> (start, end) in us
        self.start = spans[0][0] if spans else 0.0
        self.end = spans[-1][1] if spans else 0.0
        self.loop, self.timing = loop, timing
        self._work = {}
        self._waves = {}  # step -> its wavefronts, rebuilt once for every job
        self._cpu_arrays = None

    # -- the device ----------------------------------------------------------
    def busy_us(self) -> float:
        return _union([(s, e) for _, s, e in self.dev], self.start, self.end)

    def window_us(self) -> float:
        return self.end - self.start

    def kernel_us(self, names, steps) -> float:
        """Device time of the kernels whose name holds one of `names`, in `steps`."""
        total = 0.0
        for k in steps:
            lo, hi = self._bounds(k)
            total += sum(e - s for n, s, e in self.dev
                         if lo <= s < hi and any(x in n for x in names))
        return total

    def _bounds(self, k):
        """Step k's device interval: from its start to the next profiled step's start."""
        order = sorted(self.steps)
        i = order.index(k)
        hi = self.steps[order[i + 1]][0] if i + 1 < len(order) else float("inf")
        return self.steps[k][0], hi

    # -- work and rooflines ----------------------------------------------------
    def work(self, job: str, steps) -> dict:
        total = {"flops": 0, "bytes": 0, "pairs": 0}
        for k in steps:
            if (job, k) not in self._work:
                if k not in self._waves:
                    self._waves[k] = self.loop.wavefronts(k)
                tris, records = self._waves[k]
                self._work[(job, k)] = work.count(job, tris, records, self.loop.work_scale)
            for key in total:
                total[key] += self._work[(job, k)][key]
        return total

    def roofline_pct(self, kernels, job: str):
        """The least time of `job` over the kernels' device time, in %, on the first
        WORK_STEPS profiled steps in which the kernels ran; None where none ran."""
        steps = [k for k in sorted(self.steps) if self.kernel_us(kernels, [k]) > 0][:WORK_STEPS]
        if not steps:
            return None
        spent = self.kernel_us(kernels, steps) * 1e-6
        return 100.0 * work.least_seconds(self.work(job, steps), PEAKS) / spent

    # -- the breakdown ---------------------------------------------------------
    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps summed by
        what the host was doing (the innermost harness range, else the innermost
        host operation, around the gap's middle)."""
        ops = {}
        for n, s, e in self.dev:
            if self.start <= s < self.end:
                ops[n[:120]] = ops.get(n[:120], 0.0) + (e - s) * 1e-6
        gaps, last = {}, self.start
        for _, s, e in self.dev + [("", self.end, self.end)]:
            if s > last and s <= self.end:
                gaps.setdefault(self._host_at((last + s) / 2), []).append((s - last) * 1e-6)
            last = max(last, e)
        top = lambda d: sorted(d.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n, t] for n, t in top(ops)],
                "idle_gaps": [[n, t] for n, t in top({k: sum(v) for k, v in gaps.items()})]}

    def _host_at(self, t) -> str:
        if self._cpu_arrays is None:
            cpu = [x for x in self.cpu if x[0] != "rtbench.step"]
            self._cpu_arrays = ([n for n, _, _ in cpu], np.array([s for _, s, _ in cpu]),
                                np.array([e for _, _, e in cpu]),
                                np.array([n in HARNESS_RANGES for n, _, _ in cpu], bool))
        names, starts, ends, mine = self._cpu_arrays
        inside = (starts <= t) & (ends > t)
        label = []
        for group in (inside & mine, inside & ~mine):
            idx = np.nonzero(group)[0]
            if idx.size:
                label.append(names[idx[np.argmin(ends[idx] - starts[idx])]])
        return "/".join(label) or "between steps"
