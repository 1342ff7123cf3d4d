"""Profiling: per-phase timers and torch.profiler trace capture.

Counterpart of `esctp1raytracer_tpu/utils/profiling.py`, on
`torch.profiler`. The reference's only instrumentation is two wall-clock
timers printed to stderr (src/main.cpp:569-579, :645-654). Here: `trace()`
records a region with torch.profiler and writes a Chrome trace (viewable in
Perfetto), `annotate()` names sub-regions inside it, and `phase()` times a
region on the host clock after synchronising the card. `device_time` runs
one call under torch.profiler and sums the device time of the operations
it ran: the time with the host taken out.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch

from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record the enclosed region with torch.profiler and write a Chrome
    trace into log_dir.

    log_dir defaults to $ESCTP_PROFILE_DIR; when neither is set, the
    region runs unprofiled (no profiler is created)."""
    log_dir = log_dir or os.environ.get("ESCTP_PROFILE_DIR")
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named sub-region inside a trace."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase(name: str, report: bool = True) -> Iterator[None]:
    """Wall-clock phase timer, logged at INFO. It synchronises the card
    (once CUDA is in use) before it reads the clock, so the phase includes
    the device work it queued."""
    start = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if report:
        logger.info("phase %-16s %8.2f ms", name, (time.perf_counter() - start) * 1e3)


def device_time(fn: Callable[[], object]) -> dict:
    """fn() once under torch.profiler on the card: the device operations it
    ran (kernels, copies, fills), their summed device time in ms, the wall
    ms of the profiled call (the card synchronised) and the busy share
    (device time over wall; one stream, so the operations do not overlap).
    Needs a card."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) * 1e3
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    return {"device_ops": len(ops), "device_ms": busy, "wall_ms": wall,
            "busy_share": busy / wall if wall > 0 else None}
