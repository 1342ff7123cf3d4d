"""Wall-clock timer printing the reference's stderr timing block.

Counterpart of `esctp1raytracer_tpu/utils/timing.py`: the reference
prints its strategy flags and "Duration: <ms>" to stderr after a render
(src/main.cpp:645-654), and `report` prints the same block. The timer
reads the host clock only; a caller timing work on the card synchronises
before the block exits. `elapsed_ms` times calls on the card with CUDA
events, and on the CPU with the host clock.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import torch


@dataclass
class Timer:
    name: str = "render"
    fields: dict = field(default_factory=dict)
    _start: float = 0.0
    elapsed_ms: float = 0.0

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed_ms = (time.perf_counter() - self._start) * 1e3

    def report(self, file=None) -> None:
        # file resolved at call time so a redirected stderr is honoured.
        if file is None:
            file = sys.stderr
        print("", file=file)
        for key, value in self.fields.items():
            print(f" {key:<10}: {value}", file=file)
        print(f"\n Duration  : {self.elapsed_ms:.3f} ms", file=file)


def elapsed_ms(fn: Callable[[], object], device: str, iters: int = 1) -> float:
    """Mean milliseconds per call of fn() over `iters` calls: between two
    CUDA events on the card (the card synchronised after the second), on
    the host clock on the CPU."""
    if device == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
