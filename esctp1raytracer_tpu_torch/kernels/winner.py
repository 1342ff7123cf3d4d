"""The winner-row fetch: each ray's packed triangle row as twelve fields.

`winner_fields(table, prim)` reads rows `prim` [R] of the packed table [N, 32]
(core/intersect.py:packed_tri_table) as a `WinnerRow` of contiguous tensors,
v0 ... ke [R, 3], ns and has_normals [R]: the values of
`index_select(table, 0, prim)[:, a:b]`, bit for bit. It is one autograd
Function, so that its backward adds each field's gradient into the table's
rows directly: read through slices, each slice's gradient would be a
zero-filled [R, 32] tensor added into a running sum before one atomic per
element (about 15 GB of traffic a 1080p step, ~10 ms on the H100).

On CUDA tensors the forward is one gather kernel and the backward one
warp-merged scatter-add kernel (`csrc/winner.cu`): a warp groups its rays by
row, sums each group's gradients in registers and adds them to the row once,
into one of a few copies of the gradient (summed after it), so that the rows
most rays win are not one contended address.
On CPU tensors the plain versions run: `index_select` per field, and one
`index_add_` per field that has a gradient. The Function saves only `prim`.
Each wrapper counts its launches on the card in `.launches`
(kernels/launches.py: `FETCH`). A row outside the table stops the kernels,
as it stops `index_select` and `index_add_`: missed rays and sphere winners
come on row 0 (core/intersect.py:closest_hit).

While spans are on (utils/profiling.py) the backward runs in the span
`intersect.winner_grad`, with the counters `intersect.winner_rays` (the rays
reduced) and `intersect.winner_row_adds` (the groups added, `warp_groups`; on
the card the kernel's per-warp counts, summed in the graph). `index_add_`
made one add per ray.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

from esctp1raytracer_tpu_torch.kernels import _build
from esctp1raytracer_tpu_torch.utils import profiling

# The fields of a packed row, in its column order: (name, first column, width).
FIELDS = (("v0", 0, 3), ("v1", 3, 3), ("v2", 6, 3), ("n0", 9, 3), ("n1", 12, 3),
          ("n2", 15, 3), ("ka", 18, 3), ("kd", 21, 3), ("ks", 24, 3), ("ke", 27, 3),
          ("ns", 30, 1), ("has_normals", 31, 1))
COLS = 32
WARP = 32  # rays per group of the scatter kernel
# The scatter kernel adds warp w into copy w % copies of the gradient, so that
# the rows most rays win are not one address for every warp: up to MAX_COPIES,
# while the copies take at most an eighth of the fields' bytes.
MAX_COPIES = 8

WinnerRow = namedtuple("WinnerRow", [name for name, _, _ in FIELDS])


def _shape(rays: int, width: int) -> tuple:
    return (rays, width) if width > 1 else (rays,)


def _gather_plain(table, prim):
    """The fields of rows `prim` of `table`, each through `index_select`."""
    return tuple(torch.index_select(table[:, a] if w == 1 else table[:, a:a + w], 0, prim)
                 for _, a, w in FIELDS)


def warp_groups(prim) -> torch.Tensor:
    """The number of distinct rows among each 32 consecutive rays, int32
    [ceil(R / 32)]: the groups the scatter kernel adds, warp by warp."""
    r = prim.shape[0]
    pad = -r % WARP
    if pad:  # the last warp's missing lanes repeat its last ray: no new row
        prim = torch.cat([prim, prim[-1:].expand(pad)])
    rows = torch.sort(prim.reshape(-1, WARP), dim=1).values
    return (1 + (rows[:, 1:] != rows[:, :-1]).sum(dim=1)).to(torch.int32)


def _scatter_plain(grads, prim, n, cnt_out=None):
    """The table's gradient [n, 32]: each field's gradient added into its
    columns of rows `prim` by `index_add_`; fields with None are skipped."""
    gtab = torch.zeros((n, COLS), dtype=torch.float32, device=prim.device)
    for (_, a, w), g in zip(FIELDS, grads):
        if g is not None:
            gtab[:, a:a + w].index_add_(0, prim, g.reshape(-1, w))
    if cnt_out is not None:
        cnt_out.copy_(warp_groups(prim))
    return gtab


# --------------------------------------------------------------------------
# The CUDA kernels (csrc/winner.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("winner")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.winner_gather.argtypes = [vp, vp, ci, ci, ctypes.POINTER(vp), vp]
        lib.winner_scatter.argtypes = [ctypes.POINTER(vp), vp, ci, ci, ci, vp, vp, vp]
        lib.winner_gather.restype = lib.winner_scatter.restype = ci
        _LIB = lib
    return _LIB


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(FIELDS))(*(None if t is None else t.data_ptr() for t in tensors))


def winner_gather(table, prim):
    """The fields of rows `prim` (int64 [R], each in [0, N)) of the packed
    table (float32 [N, 32]): a tuple in `FIELDS` order, each contiguous
    float32 [R, 3] or [R] (on the card, views of one buffer)."""
    if prim.device.type == "cpu":
        return _gather_plain(table, prim)
    r = prim.shape[0]
    _build.check_tensors({"table": (table, torch.float32, (table.shape[0], COLS)),
                          "prim": (prim, torch.int64, (r,))}, prim.device)
    # One allocation of index_select's size, each field a contiguous view of it.
    buf = torch.empty((COLS * r,), dtype=torch.float32, device=prim.device)
    outs = tuple(buf[a * r:(a + w) * r].view(_shape(r, w)) for _, a, w in FIELDS)
    if r:
        lib = _lib()
        _build.check_launch(lib, "winner", lib.winner_gather(
            table.data_ptr(), prim.data_ptr(), r, table.shape[0], _ptrs(outs),
            torch.cuda.current_stream(prim.device).cuda_stream))
        winner_gather.launches += 1
    return outs


def winner_scatter(grads, prim, n, cnt_out=None):
    """The packed table's gradient, float32 [n, 32]: the fields' gradients
    `grads` (in `FIELDS` order; each [R, width] or [R], or None) added into
    rows `prim` (int64 [R]). cnt_out (int32 [ceil(R / 32)]) or None: receives
    each warp's number of groups (`warp_groups`). On the card the kernel adds
    into `MAX_COPIES` copies at most, summed here."""
    if prim.device.type == "cpu":
        return _scatter_plain(grads, prim, n, cnt_out)
    r, dev = prim.shape[0], prim.device
    grads = [None if g is None else g.contiguous() for g in grads]
    want = {"prim": (prim, torch.int64, (r,))}
    for (name, _, w), g in zip(FIELDS, grads):
        if g is not None:
            want[name] = (g, torch.float32, _shape(r, w))
    if cnt_out is not None:
        want["cnt_out"] = (cnt_out, torch.int32, (-(-r // WARP),))
    _build.check_tensors(want, dev)
    copies = max(1, min(MAX_COPIES, r // (8 * max(n, 1))))
    gtab = torch.zeros((copies, n, COLS), dtype=torch.float32, device=dev)
    if r:
        lib = _lib()
        _build.check_launch(lib, "winner", lib.winner_scatter(
            _ptrs(grads), prim.data_ptr(), r, n, copies, gtab.data_ptr(),
            None if cnt_out is None else cnt_out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        winner_scatter.launches += 1
    return gtab[0] if copies == 1 else gtab.sum(dim=0)


# Launches on the card (kernels/launches.py: `FETCH`).
winner_gather.launches = 0
winner_scatter.launches = 0


class _WinnerFields(torch.autograd.Function):
    """Forward: `winner_gather`. Backward: `winner_scatter` of the fields'
    gradients (None for a field no one differentiated) into the table."""

    @staticmethod
    def forward(ctx, table, prim):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(prim)
        ctx.n = table.shape[0]
        return winner_gather(table, prim)

    @staticmethod
    def backward(ctx, *grads):
        prim, = ctx.saved_tensors
        with profiling.annotate("intersect.winner_grad"):
            cnt = None
            if profiling.enabled():
                cnt = torch.empty((-(-prim.shape[0] // WARP),), dtype=torch.int32,
                                  device=prim.device)
            gtab = winner_scatter(grads, prim, ctx.n, cnt_out=cnt)
            if cnt is not None:
                profiling.count("intersect.winner_rays", prim.shape[0])
                profiling.count("intersect.winner_row_adds", cnt.sum())
        return gtab, None


def winner_fields(table: torch.Tensor, prim: torch.Tensor) -> WinnerRow:
    """Rows `prim` [R] (any integer dtype, each in [0, N)) of the packed table
    [N, 32] as a `WinnerRow`, differentiable with respect to the table."""
    return WinnerRow(*_WinnerFields.apply(table.contiguous(), prim.reshape(-1).long()))
