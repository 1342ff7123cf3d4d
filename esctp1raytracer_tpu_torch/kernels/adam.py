"""Adam's update of a scene's float leaves: one CUDA launch for all of them.

`adam_step(params, grads, m, v, lr, b1, b2, eps, c1, c2)` returns the new
parameters, first and second moments (three lists of new tensors: nothing is
updated in place) and the number of leaves the kernel updated. `c1` and `c2`
are the bias corrections, `1 - b1 ** t` and `1 - b2 ** t`, as 0-d float32 CPU
tensors.

On CPU tensors `_adam_plain` runs: the tensor operations of JAX's formula,
term for term (the CPU path, and the kernel's twin, which the card tests hold
it bit-equal to). On the card one launch of `csrc/adam.cu` updates every leaf
(at most `MAX_LEAVES`; a scene has 21), into one new buffer whose views are
the three outputs of every leaf (`_outputs`). The inputs are made contiguous
(an eager first call of a fit's `loss_and_grad` hands back some gradients as
strided slices of the packed table's), and a leaf that is not float32 of its
parameter's shape on the parameters' device raises, as more leaves do. The
host's work is what a fit step waits on, so it is kept to a few Python
operations per leaf. The kernel rounds as the tensor operations do on the
card, where a tensor divided by a CPU scalar is multiplied by the scalar's
float32 reciprocal: the wrapper passes `1/c1` and `1/c2` as such.
`adam_step.launches` counts the launches (kernels/launches.py: `ADAM`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from esctp1raytracer_tpu_torch.kernels import _build

MAX_LEAVES = 32  # csrc/adam.cu: kMaxLeaves, the leaves its launch takes


def _adam_plain(params, grads, m, v, lr, b1, b2, eps, c1, c2):
    """JAX's update, term for term, as tensor operations on new tensors."""
    m = [b1 * m_ + (1 - b1) * g for m_, g in zip(m, grads)]
    v = [b2 * v_ + (1 - b2) * g * g for v_, g in zip(v, grads)]
    mhat = [m_ / c1 for m_ in m]
    vhat = [v_ / c2 for v_ in v]
    new_params = [
        p - lr * mh / (torch.sqrt(vh) + eps)
        for p, mh, vh in zip(params, mhat, vhat)
    ]
    return new_params, m, v


def _outputs(params) -> list:
    """3 x len(params) new float32 tensors, each shaped as its leaf (the new
    parameters, then m, then v), views of one buffer: the leaves of one shape
    are rows of one block of it, taken apart by a single `unbind`."""
    groups = {}
    for i, p in enumerate(params):
        groups.setdefault(p.shape, []).append(i)
    n = len(params)
    buf = torch.empty((3 * sum(p.numel() for p in params),), dtype=torch.float32,
                      device=params[0].device)
    outs, start = [None] * (3 * n), 0
    for shape, idx in groups.items():
        k = len(idx)
        end = start + 3 * k * params[idx[0]].numel()
        rows = buf[start:end].view(3 * k, *shape).unbind(0)
        for r in range(3):
            for j, i in enumerate(idx):
                outs[r * n + i] = rows[r * k + j]
        start = end
    return outs


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/adam.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("adam")
        vp, cf = ctypes.c_void_p, ctypes.c_float
        lib.adam_update.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int, cf, cf, cf, cf, cf, cf, cf, cf, vp]
        lib.adam_update.restype = ctypes.c_int
        lib.adam_max_leaves.restype = ctypes.c_int
        if lib.adam_max_leaves() != MAX_LEAVES:
            raise RuntimeError(f"csrc/adam.cu takes {lib.adam_max_leaves()} leaves a launch, "
                               f"MAX_LEAVES is {MAX_LEAVES}")
        _LIB = lib
    return _LIB


def _inverse(c) -> float:
    """1/c in float32, as PyTorch takes a CPU scalar divisor's reciprocal."""
    return float(np.float32(1.0) / np.float32(float(c)))


def _adam_kernel(params, grads, m, v, lr, b1, b2, eps, c1, c2):
    """The one launch over CUDA leaves, into `_outputs`."""
    n = len(params)
    if not 0 < n <= MAX_LEAVES or not len(grads) == len(m) == len(v) == n:
        raise ValueError(f"{n} parameters, {len(grads)} gradients, {len(m)} and {len(v)} "
                         f"moments: one launch takes 1 to {MAX_LEAVES} leaves of four each")
    params, grads, m, v = ([t.contiguous() for t in ts] for ts in (params, grads, m, v))
    dev, f32 = params[0].device, torch.float32
    for i, leaf in enumerate(zip(params, grads, m, v)):
        shape = leaf[0].shape
        for t in leaf:  # a plain test first: this walk is on the fit step's host path
            if t.dtype is not f32 or t.shape != shape or t.device != dev:
                _build.check_tensors({f"{name}{i}": (x, f32, shape)
                                      for name, x in zip("pgmv", leaf)}, dev)
    sizes = [p.numel() for p in params]
    outs = _outputs(params)
    if sum(sizes):
        lib = _lib()
        ptrs = [t.data_ptr() for t in (*params, *grads, *m, *v, *outs)]
        _build.check_launch(lib, "adam", lib.adam_update(
            (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int64 * n)(*sizes), n,
            lr, b1, 1 - b1, b2, 1 - b2, eps, _inverse(c1), _inverse(c2),
            torch.cuda.current_stream(params[0].device).cuda_stream))
        adam_step.launches += 1
    return outs[:n], outs[n:2 * n], outs[2 * n:]


def adam_step(params, grads, m, v, lr, b1, b2, eps, c1, c2):
    """(new params, new m, new v, the leaves the kernel updated): the tensor
    operations on CPU tensors (0 leaves), else the kernel (every leaf)."""
    if not params or params[0].device.type == "cpu":
        return (*_adam_plain(params, grads, m, v, lr, b1, b2, eps, c1, c2), 0)
    return (*_adam_kernel(params, grads, m, v, lr, b1, b2, eps, c1, c2), len(params))


# Launches on the card (kernels/launches.py: `ADAM`).
adam_step.launches = 0
