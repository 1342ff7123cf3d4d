"""CUDA graphs: the port's counterpart of `jax.jit`.

The JAX package compiles each step into one program (`render`, the fit
step, bench.py's and the driver scripts' jitted calls). `graphed(fn)`
returns a callable with fn's signature that, on the card, captures fn
into one `torch.cuda.CUDAGraph` and replays it: the same kernels and
tensor operations in the same order, without their per-operation host
dispatch.

Calls on one key (the static arguments' values; the shape, dtype,
device and `requires_grad` of every tensor reached through the other
arguments, dataclasses such as `Scene` and `Camera` walked field by
field, and the Python values beside them; the debug level; the search
layer's switches, `SEARCH_SWITCHES`, which a graph bakes in as it does
any Python value, so that one flipped between two calls takes effect at
the next):

1. runs fn eagerly: the warm-up, which also builds the kernels;
2. captures fn on static copies of the inputs (on a side stream, in a
   private memory pool, as `torch.cuda.graph` does), then replays it;
3. and later: copies the inputs into the static copies and replays.

Every call returns fresh tensors (clones of the static outputs), as JAX
returns fresh arrays. fn runs directly, and nothing is captured, when no
input lies on the card (the CPU has no graphs), inside `disabled()` (the
counterpart of `jax.disable_jit()`), while another capture is running
(nested jit is inlined: that is how `render` sits inside the fit step's
graph), and under autograd when an input requires grad (a replay cannot
extend the caller's autograd graph; the JAX counterpart is a jitted
function inlined into an outer `jax.grad`). A capture that fails raises
its error: nothing retries eagerly. At TRACE level a capture raises,
since the per-bounce print reads the card (the first, eager call prints).

Each graph holds its private pool, about the step's eager peak, until
`clear()` (the counterpart of `jax.clear_caches()`). The kernel
wrappers count a launch when they are called, so a capture would count
launches that the card never ran: the counts a capture adds are taken
back and added again on every replay, so `.launches` stays the number of
launches on the card.

Spans (utils/profiling.py) key the graphs too: while a torch.profiler
records, a key whose plain graph is already captured (or warmed) gets a
spanned twin, captured at once with no second warm-up, whose spans are
event nodes timed by each replay; with no profiler the plain graph, which
holds no event node, replays as before. The twin is two graphs replayed in
turn (`_Captured`); its capture records no operation in the profiler's
trace (`profiling.unrecorded`) and keeps the allocator's cache
(`torch.cuda.graph` empties it), so that the steps after it allocate as the
steps before did. Each call through a graph is the span
`graphs.call` (with the allocator's counts) holding `graphs.copy_in`,
`graphs.replay` and `graphs.clone_out`. The plain graphs' eager first calls
and captures are counted with their seconds on the host clock
(`profiling.counters()`: `graphs.warm_calls`, `graphs.warm_s`,
`graphs.captures`, `graphs.capture_s`; the twins' as `graphs.twin_captures`,
`graphs.twin_capture_s`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import time
import weakref
from typing import Callable, Iterator

import torch

from esctp1raytracer_tpu_torch.kernels import launches, rt_mxu, rt_tile
from esctp1raytracer_tpu_torch.utils import profiling
from esctp1raytracer_tpu_torch.utils.debug import TRACE, current_level

_state = {"disabled": 0}
_caches: "weakref.WeakSet[Graphed]" = weakref.WeakSet()
_WARM = object()  # a key seen once: its next call captures
# The module switches that choose what the search kernels do (kernels/rt_tile.py,
# kernels/rt_mxu.py), read when a step runs: (module, name) each.
SEARCH_SWITCHES = ((rt_tile, "CULL_MODE"), (rt_tile, "OCCL_EARLY_EXIT"), (rt_tile, "HIER_GROUP"),
                   (rt_tile, "HIER_K"), (rt_mxu, "CULL_MODE"))


def _switches() -> tuple:
    return tuple(getattr(mod, name) for mod, name in SEARCH_SWITCHES)


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Run every graphed function eagerly inside the block."""
    _state["disabled"] += 1
    try:
        yield
    finally:
        _state["disabled"] -= 1


def clear() -> None:
    """Drop every captured graph and its memory pool."""
    for g in list(_caches):
        g.cache.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _flatten(obj, tensors: list):
    """obj's structure as a hashable key; its tensors appended to `tensors`."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("T", tuple(obj.shape), obj.dtype, obj.device, obj.requires_grad)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj), tuple((f.name, _flatten(getattr(obj, f.name), tensors))
                                 for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return (type(obj), tuple(_flatten(x, tensors) for x in obj))
    if isinstance(obj, dict):
        return (dict, tuple((k, _flatten(v, tensors)) for k, v in obj.items()))
    hash(obj)  # a Python value is baked into the graph, so it keys it
    return ("V", obj)


def _rebuild(obj, tensors: Iterator[torch.Tensor]):
    """obj with its tensors replaced, in `_flatten`'s order, by `tensors`."""
    if isinstance(obj, torch.Tensor):
        return next(tensors)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = dataclasses.fields(obj)
        out = dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), tensors)
                                          for f in fields if f.init})
        for f in fields:  # a value set after construction (SphereBuffer.occupied)
            if not f.init:
                object.__setattr__(out, f.name, getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(x, tensors) for x in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, tensors) for k, v in obj.items()}
    return obj


def _on_card(tensors) -> bool:
    return any(t.is_cuda for t in tensors)


def _capture_spanned(graph, fn, kwargs):
    """`torch.cuda.graph` without its emptying of the allocator's cache."""
    torch.cuda.synchronize()
    stream = _state.get("stream")
    if stream is None:
        stream = _state["stream"] = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            return fn(**kwargs)
        finally:
            graph.capture_end()


class _Take:
    """One captured graph of a key: its outputs and, spanned, its spans and
    their copies for the last replay."""

    def __init__(self, fn, kwargs, spanned):
        self.graph = torch.cuda.CUDAGraph()
        self.spans = self.last = None
        if spanned:
            with profiling.capturing() as self.spans, profiling.unrecorded():
                out = _capture_spanned(self.graph, fn, kwargs)
        else:
            with torch.cuda.graph(self.graph):
                out = fn(**kwargs)
        self.outputs = []
        self.out_tree = out
        _flatten(out, self.outputs)


class _Captured:
    """One key's graph on its static inputs, and the launches per replay. A
    spanned twin captures two graphs and replays them in turn: a replay
    rewrites its graph's span events, so the other graph's last replay is
    read while this one runs, with the card busy."""

    def __init__(self, fn, static, dynamic, tensors, spanned=False):
        self.inputs = [t.detach().clone().requires_grad_(t.requires_grad) for t in tensors]
        kwargs = dict(static, **_rebuild(dynamic, iter(self.inputs)))
        before = {name: w.launches for name, w in launches.COUNTED.items()}
        self.takes, self.turn = [], 0
        try:
            for _ in range(2 if spanned else 1):
                self.takes.append(_Take(fn, kwargs, spanned))
        finally:  # the captures ran nothing on the card
            self.launches = {name: (w.launches - before[name]) // max(len(self.takes), 1)
                             for name, w in launches.COUNTED.items()}
            for name, w in launches.COUNTED.items():
                w.launches = before[name]
        if any(t.requires_grad for t in self.takes[0].outputs):
            raise RuntimeError("a captured function must not return a tensor that requires "
                               "grad: a replay cannot extend the caller's autograd graph")

    def replay(self, tensors):
        take = self.takes[self.turn]
        self.turn = (self.turn + 1) % len(self.takes)
        with profiling.annotate("graphs.copy_in"), torch.no_grad():
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
        if take.spans is not None:
            profiling.settle(take.last)  # this replay rewrites what they read
        with profiling.annotate("graphs.replay") as span:
            take.graph.replay()
        if take.spans is not None:
            take.last = profiling.replayed(take.spans, span)
        for name, n in self.launches.items():
            launches.COUNTED[name].launches += n
        with profiling.annotate("graphs.clone_out"):
            out = _rebuild(take.out_tree, (t.clone() for t in take.outputs))
        if take.spans is not None:
            profiling.drain()  # what the card has completed, read while it runs this replay
        return out


class Graphed:
    """fn, captured and replayed per key on the card (see the module docstring)."""

    def __init__(self, fn: Callable, static_argnames=()):
        self.fn = fn
        self.signature = inspect.signature(fn)
        self.static_argnames = tuple(static_argnames)
        self.cache = {}
        functools.update_wrapper(self, fn)
        _caches.add(self)

    def _bind(self, args, kwargs):
        """(key, static arguments, the others, the others' tensors) of a call."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        static = {k: v for k, v in bound.arguments.items() if k in self.static_argnames}
        dynamic = {k: v for k, v in bound.arguments.items() if k not in self.static_argnames}
        tensors = []
        key = (tuple(static.items()), _flatten(dynamic, tensors), current_level(), _switches(),
               profiling.enabled())
        return key, static, dynamic, tensors

    def key(self, *args, **kwargs):
        """The cache key of a call with these arguments."""
        return self._bind(args, kwargs)[0]

    def __call__(self, *args, **kwargs):
        key, static, dynamic, tensors = self._bind(args, kwargs)
        if (not _on_card(tensors) or _state["disabled"]
                or torch.cuda.is_current_stream_capturing()
                or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
            return self.fn(*args, **kwargs)
        with profiling.annotate("graphs.call", allocs=True):
            return self._call(key, static, dynamic, tensors, args, kwargs)

    def _call(self, key, static, dynamic, tensors, args, kwargs):
        spans = key[-1]
        entry = self.cache.get(key)
        if entry is None and spans and self.cache.get(key[:-1] + (False,)) is not None:
            entry = _WARM  # a spanned twin: the plain key's first call warmed it up
        if entry is None:
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            if not spans:
                profiling.add("graphs.warm_calls", 1)
                profiling.add("graphs.warm_s", time.perf_counter() - t0)
            self.cache[key] = _WARM
            return out
        if entry is _WARM:
            if current_level() >= TRACE:
                raise RuntimeError(f"{self.fn.__qualname__}: a CUDA graph cannot capture the "
                                   "TRACE print, which reads the card; run it eagerly under "
                                   "graphs.disabled() or below TRACE level")
            t0 = time.perf_counter()
            entry = self.cache[key] = _Captured(self.fn, static, dynamic, tensors, spans)
            what = "graphs.twin_capture" if spans else "graphs.capture"
            profiling.add(what + "s", 1)
            profiling.add(what + "_s", time.perf_counter() - t0)
        return entry.replay(tensors)


def graphed(fn: Callable = None, static_argnames=()):
    """fn as a `Graphed` callable; usable as a decorator, with or without
    `static_argnames`."""
    if fn is None:
        return functools.partial(graphed, static_argnames=static_argnames)
    return Graphed(fn, static_argnames)
