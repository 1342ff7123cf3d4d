"""The kernel wrappers' launch counters, reset and read together.

Each CUDA kernel's wrapper adds one to its `.launches` where it launches
its kernel, and nowhere else (a CPU tensor runs the plain version and
counts nothing). The scripts set every count to 0 just before a
run and read them just after, to show which kernels the run went through.
A CUDA graph replay adds the launches its capture counted
(utils/graphs.py), so a count is the number of launches on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from esctp1raytracer_tpu_torch.kernels import fused_pallas, lane_pallas, rt_mxu, rt_tile

# The wrapper of each hand-written kernel, by name (K1, K2, the fused table
# build, K3, K4, K5, K6).
WRAPPERS = {
    "mxu_kernel": rt_mxu.mxu_kernel,
    "mxu_occl_kernel": rt_mxu.mxu_occl_kernel,
    "fused_tables": fused_pallas.fused_tables,
    "fused_kernel": fused_pallas.fused_kernel,
    "lane_kernel": lane_pallas.lane_kernel,
    "tile_kernel": rt_tile.tile_kernel,
    "tile_occl_kernel": rt_tile.tile_occl_kernel,
}


def reset() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read() -> Dict[str, int]:
    """Every wrapper's count (the card synchronised first, once CUDA is in use;
    never inside a CUDA graph capture, which cannot synchronise)."""
    if torch.cuda.is_initialized():
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("launches.read() cannot synchronise inside a CUDA graph capture")
        torch.cuda.synchronize()
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def counted(fn: Callable[[], object]) -> Tuple[object, Dict[str, int]]:
    """(fn(), every wrapper's launches in that call): the counts set to 0
    just before the call and read just after."""
    reset()
    out = fn()
    return out, read()
