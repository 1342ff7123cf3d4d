"""Wall-clock timer printing the reference's stderr timing block.

Counterpart of `esctp1raytracer_tpu/utils/timing.py`: the reference
prints its strategy flags and "Duration: <ms>" to stderr after a render
(src/main.cpp:645-654), and `report` prints the same block. The timer
reads the host clock only; a caller timing work on the card synchronises
before the block exits.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


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
