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
field, and the Python values beside them; the debug level):

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
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import weakref
from typing import Callable, Iterator

import torch

from esctp1raytracer_tpu_torch.kernels import launches
from esctp1raytracer_tpu_torch.utils.debug import TRACE, current_level

_state = {"disabled": 0}
_caches: "weakref.WeakSet[Graphed]" = weakref.WeakSet()
_WARM = object()  # a key seen once: its next call captures


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
        return dataclasses.replace(obj, **{f.name: _rebuild(getattr(obj, f.name), tensors)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(x, tensors) for x in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, tensors) for k, v in obj.items()}
    return obj


class _Captured:
    """One key's graph: its static inputs and outputs, and the launches per replay."""

    def __init__(self, fn, static, dynamic, tensors):
        self.inputs = [t.detach().clone().requires_grad_(t.requires_grad) for t in tensors]
        args = _rebuild(dynamic, iter(self.inputs))
        before = {name: w.launches for name, w in launches.WRAPPERS.items()}
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                out = fn(**static, **args)
        finally:  # the capture ran nothing on the card
            self.launches = {name: w.launches - before[name]
                             for name, w in launches.WRAPPERS.items()}
            for name, w in launches.WRAPPERS.items():
                w.launches = before[name]
        self.outputs = []
        self.out_tree = out
        _flatten(out, self.outputs)
        if any(t.requires_grad for t in self.outputs):
            raise RuntimeError("a captured function must not return a tensor that requires "
                               "grad: a replay cannot extend the caller's autograd graph")

    def replay(self, tensors):
        with torch.no_grad():
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
        self.graph.replay()
        for name, n in self.launches.items():
            launches.WRAPPERS[name].launches += n
        return _rebuild(self.out_tree, (t.clone() for t in self.outputs))


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
        key = (tuple(static.items()), _flatten(dynamic, tensors), current_level())
        return key, static, dynamic, tensors

    def key(self, *args, **kwargs):
        """The cache key of a call with these arguments."""
        return self._bind(args, kwargs)[0]

    def __call__(self, *args, **kwargs):
        key, static, dynamic, tensors = self._bind(args, kwargs)
        if (not any(t.is_cuda for t in tensors) or _state["disabled"]
                or torch.cuda.is_current_stream_capturing()
                or (torch.is_grad_enabled() and any(t.requires_grad for t in tensors))):
            return self.fn(*args, **kwargs)
        entry = self.cache.get(key)
        if entry is None:
            out = self.fn(*args, **kwargs)
            self.cache[key] = _WARM
            return out
        if entry is _WARM:
            if current_level() >= TRACE:
                raise RuntimeError(f"{self.fn.__qualname__}: a CUDA graph cannot capture the "
                                   "TRACE print, which reads the card; run it eagerly under "
                                   "graphs.disabled() or below TRACE level")
            entry = self.cache[key] = _Captured(self.fn, static, dynamic, tensors)
        return entry.replay(tensors)


def graphed(fn: Callable = None, static_argnames=()):
    """fn as a `Graphed` callable; usable as a decorator, with or without
    `static_argnames`."""
    if fn is None:
        return functools.partial(graphed, static_argnames=static_argnames)
    return Graphed(fn, static_argnames)
