"""Profiling: the port's spans and counters, and torch.profiler trace capture.

Counterpart of `esctp1raytracer_tpu/utils/profiling.py`, on
`torch.profiler`. The reference's only instrumentation is two wall-clock
timers printed to stderr (src/main.cpp:569-579, :645-654). Here:

* `annotate(name)` is the program's span, named `<module>.<what>` where its
  work happens (`camera.ray_grid`, `intersect.closest_hit`, `shading.shade`,
  `optimize.backward`, `graphs.replay`, ...). It is on exactly while a
  torch.profiler records (`torch.profiler.profile`, `emit_nvtx`, `trace()`
  below): off, it is one shared null context. On, it opens a RecordFunction
  range of its name (on the profiler's clock beside the device trace;
  `emit_nvtx` makes it an NVTX range for Nsight Systems), records a pair of
  CUDA timing events on the current stream once CUDA is in use, and the host
  time. Its range has operator scope, as an ATen operation's: the profiler
  draws no device-side annotation for it, which would read as device time
  over the gaps between kernels.
* Spans nest. Each outermost span (a root: `graphs.call` around a graphed
  call, `optimize.adam`, or whatever span opens first in an eager step) is
  one entry of `records()`, in order, with its children. A graph captured
  while spans are on (utils/graphs.py) holds its spans' events as event
  nodes: each replay adds a copy of the captured spans under its
  `graphs.replay` span, timed by that replay. Device times are read lazily,
  for the roots the card has completed: once a graph's replay is launched
  (while the card runs it), before a graph replays again, when `records()`
  is asked, and by a root that finds `PENDING` roots unread.
* Counters: `count(name, value)` adds to the innermost open span while spans
  are on (a tensor is summed on the device and read with the span's events:
  the mxtile kernels' tested blocks); `annotate(name, allocs=True)` records
  the caching allocator's `num_device_alloc` and `num_alloc_retries` over the
  span. `add(name, value)` is always on, for what runs once per key (the
  graph layer's warm-ups and captures). `counters()` reads those.
* `trace()` records a region with torch.profiler and writes a Chrome trace
  (viewable in Perfetto); `device_time()` runs one call under torch.profiler
  and sums the device time of the operations it ran.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Callable, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from esctp1raytracer_tpu_torch.utils.debug import get_logger

logger = get_logger(__name__)

_NULL = contextlib.nullcontext()
# A RecordFunction at operator scope; the public record_function is a user
# annotation, which the profiler also draws on the device.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)
KEEP = 4096  # root records kept: the newest
PENDING = 64  # unread roots that make the next root read what is complete
# The roots `by_step` pairs with a profiler's host ranges: they never nest.
ROOTS = ("graphs.call", "optimize.adam")
# The caching allocator's statistics an `allocs` span counts, and its counters' names.
_ALLOC = (("num_device_alloc", "alloc.device_mallocs"), ("num_alloc_retries", "alloc.retries"))

# The open spans, innermost last. One list for every thread: autograd's device
# thread opens the backward's spans while the thread that called it waits in
# `optimize.backward`.
_open: list = []
_roots: collections.deque = collections.deque(maxlen=KEEP)
_pending: list = []  # roots whose device times are not read yet, in order
_counters: dict = {}
_capturing: list = []  # the open `capturing()` blocks
_side: dict = {}  # device -> the stream counts are read on
_free: dict = {}  # device -> timing events read and free to record again


def enabled() -> bool:
    """Whether spans are on: a torch.profiler records."""
    return _autograd_profiler._is_profiler_enabled


class Record:
    """One span: `name`, `children` (spans it opened, in order), `host_ms`,
    `device_ms` (between its two events on the card; None on the CPU or for a
    span that never ran on a stream) and `counts` (name -> int)."""

    __slots__ = ("name", "children", "host_ms", "device_ms", "counts", "_t0", "_events",
                 "_device_counts", "_pool")

    def __init__(self, name: str):
        self.name = name
        self.children = []
        self.host_ms = None
        self.device_ms = None
        self.counts = {}
        self._t0 = 0
        self._events = None  # (start, end) CUDA events until read
        self._pool = None  # the device whose free events take them back once read
        self._device_counts = []  # (name, tensor) until read

    def find(self, name: str) -> list:
        """The spans named `name` in this tree, outermost first."""
        if self.name == name:
            return [self]
        return [r for c in self.children for r in c.find(name)]

    def count(self, name: str) -> int:
        """The counter `name` summed over this tree."""
        return self.counts.get(name, 0) + sum(c.count(name) for c in self.children)

    def exclusive(self, clock: str = "device"):
        """The span's ms on `clock` ("device" or "host") less its children's."""
        own = getattr(self, f"{clock}_ms")
        kids = [getattr(c, f"{clock}_ms") for c in self.children]
        if own is None or any(k is None for k in kids):
            return None
        return own - sum(kids)

    def _copy(self) -> "Record":
        """A replay's copy of a captured span: its events and device counts,
        which the replay rewrites, and copies of its children."""
        rec = Record(self.name)
        rec._events, rec._device_counts = self._events, list(self._device_counts)
        rec.counts = dict(self.counts)
        rec.children = [c._copy() for c in self.children]
        return rec

    def _read(self, block: bool, done: bool = False) -> bool:
        """Read the device times and counts of this tree once its end event is
        complete (waiting for it with `block`; known to be with `done`: the
        children of a span read); False while it is not."""
        if self._events is not None:
            start, end = self._events
            if end is None:
                return False  # still open
            if not done and not end.query():
                if not block:
                    return False
                end.synchronize()
            self.device_ms = start.elapsed_time(end)
            if self._pool is not None:
                _free.setdefault(self._pool, []).extend(self._events)
            self._events = None
        for name, t in self._device_counts:
            self.counts[name] = self.counts.get(name, 0) + _value(t)
        self._device_counts = []
        return all(c._read(True, done=self.device_ms is not None) for c in self.children)


class _Span:
    """The context of one span while spans are on."""

    __slots__ = ("rec", "range", "allocs", "stats")

    def __init__(self, name: str, allocs: bool):
        self.rec = Record(name)
        self.range = _RANGE(name)
        self.allocs = allocs
        self.stats = None

    def __enter__(self) -> Record:
        rec = self.rec
        if _open:
            _open[-1].children.append(rec)
        else:
            if len(_pending) >= PENDING:
                _drain(block=False)
            _roots.append(rec)
            _pending.append(rec)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            if self.allocs:
                self.stats = _alloc_stats()
            rec._events = (_event(), None)
            rec._pool = None if _capturing else torch.cuda.current_device()
        _open.append(rec)
        rec._t0 = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        rec.host_ms = (time.perf_counter_ns() - rec._t0) * 1e-6
        if rec._events is not None:
            rec._events = (rec._events[0], _event())
            if self.stats is not None:
                for (_, name), before, now in zip(_ALLOC, self.stats, _alloc_stats()):
                    rec.counts[name] = now - before
        if _open and _open[-1] is rec:
            _open.pop()
        elif rec in _open:
            _open.remove(rec)
        self.range.__exit__(None, None, None)


def _event():
    """A timing event recorded on the current stream: inside `capturing()` a
    new one, an event node of the graph; else one read before, if there is."""
    free = None if _capturing else _free.get(torch.cuda.current_device())
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True, external=bool(_capturing))
    ev.record()
    return ev


def _value(t) -> int:
    """A complete count tensor's value. On the card it is read on a stream of
    its own: the current stream may be running a replay, which a read there
    would wait for."""
    if not t.is_cuda:
        return int(t.item())
    stream = _side.get(t.device)
    if stream is None:
        stream = _side[t.device] = torch.cuda.Stream(t.device)
    with torch.cuda.stream(stream):
        return int(t.item())


def _alloc_stats() -> tuple:
    stats = torch.cuda.memory_stats_as_nested_dict()
    return tuple(stats.get(key, 0) for key, _ in _ALLOC)


def annotate(name: str, allocs: bool = False):
    """The span `name` (module docstring): the shared null context unless a
    torch.profiler records. `allocs`: also record the caching allocator's
    device allocations and retries over the span (they cost tens of us to
    read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, allocs)


def count(name: str, value) -> None:
    """Add `value` (a number, or a tensor read with the span's events) to the
    counter `name` of the innermost open span, while spans are on."""
    if not _autograd_profiler._is_profiler_enabled or not _open:
        return
    rec = _open[-1]
    if isinstance(value, torch.Tensor):
        rec._device_counts.append((name, value))
    else:
        rec.counts[name] = rec.counts.get(name, 0) + value


def add(name: str, value) -> None:
    """Add `value` to the process-wide counter `name` (always on)."""
    _counters[name] = _counters.get(name, 0) + value


def counters() -> dict:
    """The process-wide counters (`add`)."""
    return dict(_counters)


def _drain(block: bool) -> None:
    """Read the pending roots in order, up to the first whose end event is
    not complete (with `block`, waiting for each)."""
    while _pending and _pending[0]._read(block):
        _pending.pop(0)


def drain() -> None:
    """Read the pending roots that the card has completed, in order (a graph's
    replay calls this once it is launched, while the card runs it)."""
    _drain(block=False)


def records() -> list:
    """The root records, oldest first, each with its device times read."""
    _drain(block=True)
    return list(_roots)


def reset() -> None:
    """Forget the records and the counters."""
    _drain(block=True)
    _roots.clear()
    _counters.clear()


@contextlib.contextmanager
def capturing() -> Iterator[list]:
    """Spans opened inside go into the yielded list (a graph's captured spans,
    timed by each replay: `replayed`) and not into `records()`."""
    holder = Record("capture")
    _open.append(holder)
    _capturing.append(holder)
    try:
        yield holder.children
    finally:
        _open.remove(holder)
        _capturing.remove(holder)


@contextlib.contextmanager
def unrecorded() -> Iterator[None]:
    """The profiler records neither the operations opened inside the block nor,
    on the card, their CUDA runtime calls, while the spans stay on. A spanned
    twin's capture runs nothing on the card, and its host events (every
    operation and kernel launch of the step, twice) would only lengthen the
    trace that readers walk."""
    autograd = torch._C._autograd
    cuda = {torch._C._profiler.ProfilerActivity.CUDA} if torch.cuda.is_available() else None
    autograd._enable_record_function(False)
    if cuda:
        autograd._toggle_collection_dynamic(False, cuda)
    try:
        yield
    finally:
        if cuda:
            autograd._toggle_collection_dynamic(True, cuda)
        autograd._enable_record_function(True)


def replayed(captured: list, parent: Record) -> list:
    """Copies of a graph's captured spans for the replay just launched, added
    under `parent` (its `graphs.replay` span); returned for `settle`."""
    copies = [r._copy() for r in captured]
    parent.children.extend(copies)
    return copies


def settle(recs: Optional[list]) -> None:
    """Read `recs` now (waiting for the card): a graph's next replay rewrites
    the events and counts they share with its captured spans."""
    for rec in recs or ():
        rec._read(True)


def _top_ranges(ranges, names: set) -> list:
    """The ranges named in `names` that no other range of those names holds,
    in start order."""
    mine = sorted(((s, -e, n) for n, s, e in ranges if n in names))
    top, end = [], float("-inf")
    for s, neg_e, n in mine:
        if s >= end:
            top.append((n, s, -neg_e))
            end = -neg_e
    return top


def _names(recs) -> set:
    out = set()
    for r in recs:
        out.add(r.name)
        out |= _names(r.children)
    return out


def by_step(ranges, steps: dict) -> dict:
    """The root records (`ROOTS`) grouped by the caller's steps.

    `ranges`: (name, start, end) of the host ranges a profiler recorded, on
    its clock (each span's RecordFunction range is one); `steps`: step ->
    (start, end) on the same clock. The outermost ranges of each root's name
    are paired with the roots of that name in order, counted from the newest;
    a root belongs to the step whose interval holds its range's start."""
    recs = records()
    roots = [r for r in recs if r.name in ROOTS]
    out = {k: [] for k in steps}
    top = _top_ranges(ranges, _names(recs) | set(ROOTS))
    for name in ROOTS:
        mine = [r for r in roots if r.name == name]
        theirs = [(s, e) for n, s, e in top if n == name]
        if not theirs or len(theirs) > len(mine):
            continue
        for rec, (s, _) in zip(mine[-len(theirs):], theirs):
            for k, (lo, hi) in steps.items():
                if lo <= s < hi:
                    out[k].append(rec)
    return out


def per_step(ranges, steps: dict, name: str, exclusive: bool = False) -> list:
    """The device ms of the spans named `name` in each step (see `by_step`),
    exclusive of their child spans with `exclusive`, for the steps in which
    one ran on the card."""
    out = []
    for roots in by_step(ranges, steps).values():
        spans = [r for root in roots for r in root.find(name)]
        ms = [r.exclusive() if exclusive else r.device_ms for r in spans]
        if spans and all(x is not None for x in ms):
            out.append(sum(ms))
    return out


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


def device_time(fn: Callable[[], object]) -> dict:
    """fn() once under torch.profiler on the card: the device operations it
    ran (kernels, copies, fills), their summed device time in ms, the wall
    ms of the profiled call (the card synchronised) and the busy share
    (device time over wall; one stream, so the operations do not overlap).
    A graphed call captures its spanned twin at its first call under a
    profiler (utils/graphs.py): profile one that has run under one before.
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
