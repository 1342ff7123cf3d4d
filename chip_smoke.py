"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main paths at full size, through `trace_rays` /
`render` with backend "auto", and holds every CUDA kernel on them
against its plain PyTorch version:

A. the flagship (bench.py): 1920x1080 camera rays over the 10,244-triangle
   benchmark scene, depth 1, forward and the gradient of sum(color^2)
   with respect to every float scene leaf; "auto" resolves to mxtile
   (kernels K1, K2);
B. the Cornell box (bench.py's Cornell leg), 1024x768, depth 1: "auto"
   resolves to the fused route, two launches: the table build and the
   whole-frame kernel K3; the backward re-derives the frame on the lane
   route (K4, one launch per search);
C. BASELINE config 4: mixed_scene(), 1920x1080, depth 4: "auto" resolves
   to the table build and K3, whose backward re-derives the frame through
   chunked mxtile (K1, K2);
D. the Cornell box with light_mode="reference_cpp", 1024x768, forward:
   "auto" resolves to the lane kernel K4;
E. BASELINE config 5: random_scene(100_000) (100,004 triangles, 784
   sub-blocks of 128), 3840x2160, depth 1: "auto" resolves to the tile
   kernels K5 (camera rays) and K6 (shadow rays); forward and fwd+bwd
   each run the 8,294,400-ray frame as one wavefront;
F. random_scene(500_000), 1920x1080, depth 1: "auto" resolves to tile,
   through four 131,072-triangle segments (`tables.Tables.segments`);
G. the reference's own entry point, `python -m esctp1raytracer_tpu_torch`
   (`cli.main`), in process: the Cornell OBJ (`write_cornell_obj`) at
   1024x768 with --ispc ("auto" -> fused: the table build and K3); the
   benchmark scene's meshes written as an OBJ (`write_obj`, 10,244
   triangles in 10,752 slots once loaded) at 1920x1080 with --ispc ("auto"
   -> mxtile: K1, K2); each PPM byte-identical to the one written from
   `render` called directly on `scene_from_mesh(load_obj_with_mat(obj))`;
   then the golden leg: the Cornell OBJ at 1024x768 in
   light_mode="reference_cpp" for 8 seeds ("auto" -> lane: K4), the mean of
   the frames clamped at 1, box-averaged by 4 with the reference C++
   binary's own image (tests/golden/cornell_cpp_mean.npz) and held to
   tests/test_golden.py's bars;
H. training on one rank, at the flagship's width: `fit_scene` on the
   flagship at 1920x1080 ("auto" -> mxtile: K1, K2), the target its true
   render, the start with the triangles' kd halved, `param_filter` fitting
   triangles.kd, 6 Adam steps at lr 0.05 with a checkpoint every 3; then a
   second run resumed from the step-3 checkpoint. The loss falls, one K1,
   one K2 and one Adam launch per step, the resumed run equals the
   uninterrupted one within RESUME_RTOL / RESUME_ATOL, and the checkpoint
   loaded into a fresh template equals `scene_to_numpy` of the fitted scene;
I. the sharded renderer and trainer (`parallel/`), ranks of this script
   (`--rank-leg`, the torchrun environment, each with a time-out) on the
   one card: (a) one rank over NCCL: `loss_and_grad_sharded` on the
   flagship at 1920x1080; (b) two ranks over gloo, rays = 2, on the
   flagship (K1/K2 per rank) and on Cornell at 1024x768 (the table build
   and K3 per rank, K4 in the backward): `render_sharded`,
   `loss_and_grad_sharded` and one `train_step_sharded`; (c) four ranks
   over gloo, rays = 2 x prims = 2, on the flagship: `render_sharded` and
   `loss_and_grad_sharded` (the prims split scans with `_scan_blocks`, no
   kernel). Rank 0 writes its arrays; this process holds them against the
   unsharded run (tests/test_sharding.py's image bar and :150-155's
   gradient bars) and the train step's loss bit-equal on every rank;
J. the benchmark and matrix scripts, each run as a user runs it (a subprocess from the
   repository root, reusing the kernels built in build/torch_kernels/):
   scripts/bench_configs_torch.py on BASELINE configs 1-5 (a process each:
   sphere_plane 256x256 and ten_sphere 512x512 depth 2 on fused, the
   mesh at 1920x1080 on mxtile, config 4 on fused, config 5 on tile),
   forward and fwd+bwd; scripts/run_matrix_torch.py on Cornell at 1024x768,
   all five strategies, with the 4-seed golden leg (jnp, reference_cpp)
   against the reference C++ binary's image; scripts/probe_device_loop_torch.py
   on the flagship and config 4, forward and --grad;
   examples/render_cornell_torch.py, its PPM byte-equal to a direct
   render's; then configs 1 and 2's table builds and K3 frames against
   their plain versions, as for Cornell;
K. the root entry points: bench_torch.py as a user runs it (a subprocess,
   reusing build/torch_kernels/): the 1080p fwd+bwd headline on mxtile and
   the Cornell leg's vs_baseline, with one K1 and one K2 per fwd+bwd step and
   8 table builds and 8 K3 per Cornell call, nothing else; entry_torch.entry()
   (mesh_scene(4), 128x128, mxtile: one K1, one K2), its image against the
   same route's plain versions on a CPU copy of its inputs; and
   entry_torch.dryrun_multichip on 2 and 4 gloo ranks of this script sharing
   the card (`--rank-leg dryrun2|dryrun4`): one sharded train step each of
   jnp and mxu (no kernel; prims = 2 on four ranks), lane (K4), tile (K5,
   K6) and auto (the table build and K3, K4 in the backward) on
   sphere_plane_scene() with a 16x16 target, each loss finite, equal on
   every rank and within 1e-5 of jnp's; then K5 and K6 on each rank's tile
   wavefronts, bit-identical to their plain versions;
L. two light sources of unequal face counts, and none: (L1) the benchmark
   scene's meshes and a second area light, 1920x1080, "auto" -> mxtile: K1
   on the camera wavefront and K2 on the R x 2 shadow wavefront within the
   JAX tests' bars of their plain versions, one K1 and one K2 per step, a
   64x48 frame against jnp; (L2) the Cornell meshes and a second light of
   four faces on the ceiling (faces 2 and 4), 1024x768, "auto" -> fused at
   depth 1 and 3: the table build bit-equal to its plain version on a CPU
   copy, K3 bit-identical to its plain version, K4 bit-identical on the
   backward's camera and R x 2 shadow wavefronts, the light draws on the
   card bit-equal to the CPU's, one table build and one K3 per forward and
   2 x depth K4 per backward; (L3) a subdivision-6 icosphere, the ground
   plane and two area lights (81,926 triangles, one tile segment),
   1920x1080, "auto" -> tile: K5 and K6 (on the R x 2 shadow wavefront)
   bit-identical to their plain versions on a TILE_SLICE-ray slice, one K5
   and one K6 per step; (L4) empty_nolight at 1024x768 on auto, fused,
   lane, mxtile and tile: each route's search kernel (K4, K1, K5) on the
   camera wavefront, the only one, against its plain version; the image
   exactly black, every gradient zero and finite, the resolved route's
   search launched once per step and no other kernel (fused and auto
   resolve to lane); (L5) the ten Cornell variants at 512x512 through
   "auto": finite, non-black but empty_nolight, against the jnp route (the
   eps-window flips set aside within tests/test_fused.py's budget, the
   image bar's mean on the rest), the route's kernels and no
   other (K3 bit-identical to its plain version on the fused ones), the
   Cornell signature; and reference_cpp's draws on a light of four faces
   on the card bit-equal to the CPU's, on exactly its corners {f0c0, f0c1,
   f0c2, f1c0};
M. the JAX package's compiled steps as CUDA graphs (utils/graphs.py), each
   captured and replayed against the same step run eagerly (under
   `graphs.disabled()`): the flagship forward and fwd+bwd through
   `bench_torch.headline`, the Cornell call of 8 renders
   (`bench_torch.cornell_call`), config 4 fwd+bwd, config 5 fwd+bwd (one
   timed call each way), and `fit_scene` on the flagship (3 steps each way,
   then its step `optimize.loss_and_grad`): the image or the forward's loss
   bit-equal to the eager step's, the gradients within `grads_agreement`'s
   bars, each kernel's launches per replay equal to the eager step's, two
   replays at other ray ids (new kd for the fit step) other outputs, each
   equal to the eager step's there; then a capture at TRACE level, which
   must raise. Printed per step: the eager and graphed ms (CUDA events,
   median of 5, ids moved on per call), the host ms per call, the capture
   ms, the peak memory and the busy share of one step each way;
N. the JAX package's selectable pre-pass modes (rt_tile.CULL_MODE,
   OCCL_EARLY_EXIT; rt_mxu.CULL_MODE), each run by an instantiation of K1,
   K2, K5 or K6 (MODE_CASES): first the default instantiations' ptxas lines
   (registers, spills, shared memory) equal to those the kernels had before
   the modes (DEFAULT_PTXAS); then in each mode the kernel on MODE_SLICE
   rays of the heaviest rows of the flagship's camera and shadow wavefronts
   (K1, K2) and config 5's (K5, K6) against its plain version in the same
   mode (K5, K6 bit-identical; K1, K2 the bars of tests/test_rt_mxu.py), its
   cnt_out equal to the plain lists'; on the whole wavefront bit-identical
   to the default (argsort) kernel and timed beside it in turns; the
   default instantiation timed again, within 1% of the top of its earlier
   runs (DEFAULT_MS); then `render` on the flagship, graphed, with a switch
   flipped between calls (mxtile interval, tile hier and the early exit):
   a new key, the replay equal to the eager render under the switch, its
   launches the eager call's, and the cnt_out it captured equal to the
   plain lists' cnt in the new mode on the replay's rays.

Phases, any failure exits non-zero (no phase catches its own failure):
1. device: needs a CUDA device (there is no CPU path); prints the card's
   name and power limit (nvidia-smi), the torch and CUDA versions, and
   turns TF32 off;
2. build: builds the six CUDA sources from csrc/ with nvcc and the three
   host C++ libraries from native/ with g++ (the OBJ loader, the PPM
   writer, the BVH builder), one process each, all started together; a
   host library that does not build fails the run; prints each kernel's
   registers, spills and shared memory;
3. kernels: each kernel against its plain PyTorch version on the inputs
   its main paths give it, with the bars of the JAX package's tests, and
   the time of each (CUDA events) beside its bound (the larger of its
   bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s): K1/K2
   on the flagship's wavefronts and on every wavefront of config 4's
   chunked backward, each on the whole wavefront as the entry points call
   it, its kept count per group (cnt_out) equal to `_prep_mxu`'s, its
   output the same without cnt_out and within the JAX tests' bars of its
   plain version's (K2 with the oversized sub-block: also equal to K2
   without it ORed with `_oversized_occl`), with the mean list and its
   padding-only share; K3 on the Cornell and config-4 frames, K4 on
   Cornell's camera and shadow wavefronts, K5 and K6 on config 5's camera
   and shadow wavefronts and, per segment, on the 500k soup's: the kernel
   on the whole wavefront, its kept count per bundle (cnt_out) equal to
   the plain path's lists there, its output the same without cnt_out and
   bit-identical to the plain version's on a 262,144-ray slice across the
   horizon rows, where the lists are longest (K6 with the oversized
   sub-block: also to the segment sweep ORed with `_oversized_occl`); for
   the 500k soup, the plain
   segments combined equal to the entry points' own output; the layers of
   config 5's forward timed alone. The fused table build equal bit for bit
   to its plain version on a CPU copy of Cornell, config 4 and a
   2,048-triangle table (and the plain version run on the card compared
   with it); K4's t bit-identical to its plain version on a CPU copy. Bounds
   count the pairs each kernel evaluates on this run's data: K2 and K6 up
   to their early exits; K3 per bounce, the pairs of each live ray with the
   chunks its own slab test keeps and its shadow pairs up to its first
   occluder, with a fixed count per ray for the rest; K3 and K4 count a
   pair that the exact division skip rejects at 16 operations, not 40.
   K3-K6 build with -fmad=false (no FMAs), so they can reach at most half
   of a bound taken at 67 TFLOP/s. The winner-row fetch (csrc/winner.cu) on
   the winners of the flagship's and Cornell's camera wavefronts (their
   routes' own searches): the gather bit-equal to index_select of the
   [R, 32] row, the scatter-add within 1e-5 of a float64 index_add_
   relative to the sum of the gradients' magnitudes, its group count equal
   to its plain version's; each timed beside its plain version, the library
   call it replaced and its bound (bytes). The Adam kernel (csrc/adam.cu)
   over the flagship's and Cornell's 21 float leaves, five steps through
   `optimize.adam_update` from adam_init with gradients that hold zeros,
   +-1e-30 and +-1e6: one launch a step, its new parameters and moments
   bit-equal to the tensor operations' on the card, its inputs unchanged,
   its outputs one new buffer; its device time (50 launches in one CUDA
   graph) beside its bound (bytes) and the tensor operations' time;
4. main paths A-F: for each, every kernel's launch counter set to 0 just
   before a run and read just after (forward, then forward + backward),
   checks (finite, non-black image, finite gradients, counters > 0, a
   small frame agreeing with the plain `jnp` backend; the winner fetch's
   gathers and scatters, exactly one each in the flagship's fwd+bwd, one
   gather in its forward, none in Cornell's fused forward and one each in
   its fwd+bwd, and elsewhere no scatter in a forward), then forward and
   fwd+bwd times from CUDA events (median of 5, ray ids varied per
   iteration) and the peak device memory; the flagship's fwd+bwd step
   calls neither `_prep_mxu` nor `_oversized_occl` (counting spies);
   Cornell's forward is one table build and one K3 launch and calls
   neither `build_clusters` nor `lane_tri_constants`, its fwd+bwd launches
   K4 twice and builds no constants on the host, and `lane_tri_search` is
   one launch (counting spies); the layers of the flagship's forward, and
   of the Cornell and config-4 steps, timed alone. Path G: each CLI run
   and the golden leg with the counters set to 0 just before and read
   just after (exit 0, `Mode single/auto` on stderr, its kernels launched);
   it prints the CLI's stderr block and wall time, the native OBJ load,
   the direct render and the native PPM write times of the 1920x1080
   frame (the Python loader's and writer's beside them, the two writers
   byte-identical), and the golden numbers beside their bars. Path H: the
   counters set to 0 just before each of its two runs and read just after;
   the ms of each step (the first apart), the Adam update,
   `save_checkpoint` and `load_checkpoint`, and the peak memory. Path I:
   each rank sets the counters to 0 just before each call and reads them
   just after; each leg's ms per call (median of 3) and the share of one
   call spent in the all-reduces. Path J: each script sets the counters to
   0 just before each run it reports (a config's forward and fwd+bwd, a
   strategy's first call, a probed frame) and reads them just after; the
   kernels each launched must be those of its backend and no other; the
   resolved backends, finite positive times, every strategy matching the
   sequential one and the golden within tests/test_golden.py's bars. Path
   K: the bench sets the counts to 0 just before its counted fwd+bwd step
   and Cornell call and reads them just after; entry() and each dry-run
   step likewise (each rank, each backend). Path L: each leg's forward and
   fwd+bwd with the counts set to 0 just before and read just after, held
   to the route's exact counts; the resolved backend, the times, the peak
   memory and each kernel's time beside its bound printed per leg. Path M:
   each step's eager call and one replay with the counts set to 0 just
   before and read just after, held equal (fit_scene's: also one winner
   gather and one scatter a step, eager and graphed). Path N: each graphed render
   with the counts set to 0 just before and read just after;
5. prints the wall time, {"kernels": [...]} and, as the last line, the
   result line.

Usage: python3 chip_smoke.py   (from the repository root)
       python3 chip_smoke.py --profile   (instead: one fwd+bwd step each of
       the flagship, Cornell, config 4 and config 5 under torch.profiler, and
       a replay of the flagship's and config 4's as one CUDA graph: device
       operations, device time, busy share of the step, costliest kernels)
"""

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from esctp1raytracer_tpu_torch import cli
from esctp1raytracer_tpu_torch.accel import clusters, native_bvh
from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.intersect import EPS, argmin_hit, packed_tri_table
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, resolve_backend, trace_rays
from esctp1raytracer_tpu_torch.grad import fit_scene, optimize
from esctp1raytracer_tpu_torch.io import native_ppm
from esctp1raytracer_tpu_torch.io.ppm import read_ppm, write_ppm, write_ppm_python
from esctp1raytracer_tpu_torch.kernels import (
    _build, adam, fused_pallas, lane_pallas, launches, rt_mxu, rt_tile, tables, winner,
)
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask
from esctp1raytracer_tpu_torch.parallel import (
    init_distributed, loss_and_grad_sharded, make_mesh, render_sharded, sharding,
    train_step_sharded,
)
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params
from esctp1raytracer_tpu_torch.scene import native_loader
from esctp1raytracer_tpu_torch.core.shading import sample_lights
from esctp1raytracer_tpu_torch.scene.builders import (
    _CORNELL_MATERIALS, CORNELL_VARIANTS, _area_light, _cornell_shell, _ground_plane, _quad_tris,
    bench_meshes, bench_scene, cornell_box, cornell_variant, icosphere_mesh, mesh_scene,
    mixed_scene, random_scene, scene_from_mesh, sphere_plane_scene, ten_sphere_scene,
    write_cornell_obj, write_obj,
)
from esctp1raytracer_tpu_torch.scene.matjson import load_obj_with_mat
from esctp1raytracer_tpu_torch.scene.types import Material, MeshData, scene_to_numpy
from esctp1raytracer_tpu_torch.utils import device as devinfo
from esctp1raytracer_tpu_torch.utils import debug, graphs, nativebuild, profiling
from esctp1raytracer_tpu_torch.utils.checkpoint import load_checkpoint
from esctp1raytracer_tpu_torch.utils.timing import elapsed_ms

import entry_torch

CSRC = "esctp1raytracer_tpu_torch/csrc/"
TPU = "esctp1raytracer_tpu/kernels/"
# wrapper name (launches.WRAPPERS' order): (plain version, its CUDA source,
# the TPU kernel it replaces)
_PLAIN = {
    "mxu_kernel": (rt_mxu._mxu_search_plain, "rt_mxu.cu", TPU + "rt_mxu.py:153"),
    "mxu_occl_kernel": (rt_mxu._mxu_occl_plain, "rt_mxu.cu", TPU + "rt_mxu.py:215"),
    "fused_tables": (fused_pallas._fused_tables_plain, "fused.cu",
                     TPU + "fused_pallas.py:91 fused_tables (XLA ops, not a Pallas kernel)"),
    "fused_kernel": (fused_pallas._fused_plain, "fused.cu", TPU + "fused_pallas.py:162"),
    "lane_kernel": (lane_pallas._lane_plain, "lane.cu", TPU + "lane_pallas.py:69"),
    "tile_kernel": (rt_tile._tile_search_plain, "rt_tile.cu", TPU + "rt_tile.py:241"),
    "tile_occl_kernel": (rt_tile._tile_occl_plain, "rt_tile.cu", TPU + "rt_tile.py:328"),
}
KERNELS = {name: _PLAIN[name] for name in launches.WRAPPERS}
# The winner-row fetch's kernels (launches.FETCH), read apart from KERNELS: every
# route that calls closest_hit launches them.
FETCH = {
    "winner_gather": (winner._gather_plain, "winner.cu",
                      "esctp1raytracer_tpu/core/intersect.py:431 jnp.take of the winner row "
                      "(XLA's gather, not a Pallas kernel)"),
    "winner_scatter": (winner._scatter_plain, "winner.cu",
                       "esctp1raytracer_tpu/core/intersect.py:431 the gather's gradient "
                       "(XLA's scatter-add fused with the slices', not a Pallas kernel)"),
}
# The fit step's Adam update (launches.ADAM), read apart too: one launch a fit step.
ADAM = {
    "adam_step": (adam._adam_plain, "adam.cu",
                  "esctp1raytracer_tpu/grad/optimize.py:40 adam_update (eager jnp operations, "
                  "not a Pallas kernel)"),
}
SOURCES = ("rt_mxu", "lane", "fused", "rt_tile", "winner", "adam")
# The host C++ of path G: each library's availability check (built with g++).
NATIVE = {"objloader": native_loader.native_available, "ppm": native_ppm.native_available,
          "bvh": native_bvh.native_bvh_available}
REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden" / "cornell_cpp_mean.npz"
TILE_SLICE = 262_144  # rays of config 5's wavefronts held against the plain versions
# Path H: the resumed run against the uninterrupted one (the card's backward
# scatter-adds with atomics, so gradients differ in the last bits run to run).
RESUME_RTOL = 1e-4  # losses, relative
RESUME_ATOL = 1e-4  # fitted kd (each Adam step moves it by up to lr = 0.05)
# Path I: each leg's mesh; the prims split runs `_scan_blocks`, whose
# [rays, 512]-wide blocks take 262,144-ray chunks to keep four ranks' worth
# of intermediates on the card (a chunk size, not a smaller frame).
LEG_MESH = {"nccl1": dict(rays=1), "gloo2": dict(rays=2), "gloo4": dict(rays=2, prims=2)}
PRIMS_CFG = RenderConfig(backend="auto", ray_chunk=262_144)
FLAG_WH, CORN_WH = (1920, 1080), (1024, 768)  # path I's frames
# Path J: the kernels each script leg launches, by the backend it resolves to.
K12, K3 = ("mxu_kernel", "mxu_occl_kernel"), ("fused_tables", "fused_kernel")
K4, K56 = ("lane_kernel",), ("tile_kernel", "tile_occl_kernel")
# bench_configs_torch.py: config -> (backend, forward's kernels, fwd+bwd's).
# The fused backward re-derives the frame on lane (K4), or for config 4's
# 2M rays at depth 4 on chunked mxtile (K1, K2).
BENCH_LEGS = {"sphere_plane_256": ("fused", K3, K3 + K4),
              "ten_sphere_512": ("fused", K3, K3 + K4),
              "mesh10k_1080p": ("mxtile", K12, K12),
              "mixed_1080p_d4": ("fused", K3, K3 + K12),
              "soup100k_4k": ("tile", K56, K56)}
# run_matrix_torch.py's strategies on Cornell: jnp and mxu are tensor
# operations, auto is the fused route (the table build and K3).
MATRIX_LEGS = {"sequential": (), "thread": K3, "bvh": (), "bvh_thread": K3, "ispc": K3}
# probe_device_loop_torch.py: config -> (a forward frame's kernels, a fwd+bwd frame's).
PROBE_LEGS = {"flagship_10k_1080p": (K12, K12), "mixed_1080p_d4": (K3, K3 + K12)}
# Each kernel's bound: the least time the card could take for its work, the
# larger of its bytes over the memory rate and its float32 operations over
# the float32 peak (H100 SXM data sheet, dense, at the full 700 W). No
# single PyTorch call computes any of the six functions (a closest or any
# hit over a cull, with the eps window and a tie rule): library_ms is null.
PEAK_F32 = 67e12  # float32 operations/s outside the tensor cores (an FMA counts 2)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# Operations per (ray, triangle) pair of lane_plane.cuh's plane_hit (K3-K6):
# det 5 and its negation, |det| and its compare, the division, t 7, p 6,
# u 6, v 6, min(u, v) and its compare, u + v and its compare, t >= eps, and
# the compare with the running t or the t_limit. K3-K6 build with
# -fmad=false: no FMAs, so they can reach at most half of a bound taken at
# PEAK_F32 (which counts an FMA as 2 operations).
PAIR_OPS = 40
# A pair that K3's and K4's exact division skip rejects (plane_skip), up to
# the test: det 5 and its negation, |det| and its compare, the numerator 6,
# the two sign tests.
SKIP_PAIR_OPS = 16
# K3's fixed operations, counted from csrc/fused.cu. Per sphere test
# (sphere_t): oc 3, b 5, c0 7, disc 2, its compare and the root 2, tn 2, its
# compare and t 3, the three tests 3, the compare with the running t 1.
SPHERE_OPS = 28
# Per live ray that hits: the winner's Moller-Trumbore recompute 62 (edges
# 6, two crosses 18, four dots 20, the division, three products, seven
# compares, two selects), the hit point 8, the cheapest normal (a
# sphere's) 8.
FUSED_HIT_OPS = 78
# Per hit ray and light: three murmur3 draws 45 (mix 2, fmix 11 and the
# conversion 2 each), the face 3, the point on it 21, the shadow ray
# (lv 3, dist 7, ld 4, t_lim 1) 15, d.n 5.
FUSED_DRAW_OPS = 89
# Per shadow ray in the mask (d.n > 0): the Phong term (hv 6, spec_dot 14,
# the power 4, the contribution 21).
FUSED_PHONG_OPS = 45
# Per (ray, triangle) pair of K1/K2: the 25 FMAs that can meet a non-zero
# coefficient (50 operations; csrc/rt_mxu.cu skips the other 39, each an
# exact zero) and the window (the division, t, u, v, |det|, five compares,
# u + v, the compare with the running t or the t_limit).
MXU_PAIR_OPS = 62
# The full count, printed beside the one above: all 64 FMAs (128 operations)
# and the window, over every listed block, padding-only ones included, as a
# kernel that skipped neither zeros nor padding would do.
MXU_PAIR_OPS_FULL = 140
# Per (ray, box) slab test (cull.py:block_cull_mask): 6 differences, 6
# products, 6 per-axis minima and maxima, 4 across the axes, 3 compares.
SLAB_OPS = 25


def check(ok, msg):
    if not ok:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def say(*args):
    print(*args, flush=True)


def wrapper(name):
    return launches.WRAPPERS[name]


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, nbytes):
    """(bound_ms, "operations" or "bytes"): the larger of ops over PEAK_F32
    and nbytes over PEAK_BYTES."""
    by_ops, by_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")



def device_phase():
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    card = devinfo.card("cuda")
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 = {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    t0 = time.perf_counter()
    # One nvcc per CUDA source and one g++ per host library, all in parallel.
    with ThreadPoolExecutor(len(SOURCES) + len(NATIVE)) as pool:
        native = {name: pool.submit(fn) for name, fn in NATIVE.items()}
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
        native = {name: f.result() for name, f in native.items()}
    for mod in (rt_mxu, lane_pallas, fused_pallas, rt_tile, winner, adam):
        mod._lib()
    say(f"build: {time.perf_counter() - t0:.2f} s ({len(SOURCES)} CUDA sources and "
        f"{len(NATIVE)} host libraries in parallel)")
    # On the card's machine a host library that does not build is a failure,
    # not a fallback to the Python loader or writer.
    for name, ok in native.items():
        check(ok, f"native {name} did not build: {nativebuild.last_build_error()}")
        say(f"  native {name}: {nativebuild.library_path(name).name}")
    for name, lib in libs.items():
        say(f"  {lib.name}: nvcc {' '.join(_build.NVCC_FLAGS + _build.SOURCE_FLAGS.get(name, []))}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("    ptxas:", line.strip())


def camera(eye, w, h):
    return Camera.look_at(eye, (0.0, 1.0, 0.0), vfov=60.0, aspect=w / h)


def rays(cam, w, h):
    o, d = (x.reshape(-1, 3).contiguous() for x in cam.ray_grid(w, h))
    return o, d, torch.arange(o.shape[0], dtype=torch.int64, device=o.device)


# --------------------------------------------------------------------------
# Phase 3: each kernel against its plain version on its main path's inputs
# --------------------------------------------------------------------------


def capture_wavefronts(o, d, scene, ids, cfg, search, occlusion=None):
    """The wavefronts the search and occlusion hooks receive in one forward,
    in call order: [(occl, o, d, tris, eps, t_limit), ...], with occl False
    for a closest-hit search and True for an any-hit query."""
    seen = []

    def spy(oo, dd, tris, eps, t_limit=None):
        seen.append((False, oo, dd, tris, eps, t_limit))
        return search(oo, dd, tris, eps, t_limit)

    if occlusion is not None:
        def occl(oo, dd, t_limit, tris, eps):
            seen.append((True, oo, dd, tris, eps, t_limit))
            return occlusion(oo, dd, t_limit, tris, eps)

        spy.occlusion = occl
    with torch.no_grad():
        trace_rays(o, d, scene, ids, cfg, tri_search=spy)
    torch.cuda.synchronize()
    return seen


def search_agreement(name, out_k, out_p):
    """Closest-hit outputs (t, idx) of a kernel and of its plain version, held
    to the bars of the JAX package's tests: winners agree on >= 99.9% of the
    rays, and t to a relative 1e-5 where they agree. Returns (agreement,
    max abs t error, max relative t error, hit share)."""
    (t_k, i_k), (t_p, i_p) = out_k, out_p
    same = i_k == i_p
    agree = same.float().mean().item()
    hit = same & (t_p < 1e29)
    err = (t_k - t_p).abs()[hit]
    max_abs = err.max().item() if err.numel() else 0.0
    rel = (err / t_p[hit].abs().clamp(min=1.0)).max().item() if err.numel() else 0.0
    check(agree >= 0.999, f"{name}: winner agreement {agree} < 0.999")
    check(rel < 1e-5, f"{name}: relative t error {rel} >= 1e-5")
    return agree, max_abs, rel, (i_k >= 0).float().mean().item()


def time_pair(name, fn_k, fn_p, iters_k, iters_p, card, what):
    """The kernel's time (median of 3 windows of iters_k calls) and the plain
    version's (one window of iters_p calls), ms per call."""
    fn_k()
    ms = statistics.median(elapsed_ms(fn_k, "cuda", iters_k) for _ in range(3))
    plain_ms = elapsed_ms(fn_p, "cuda", iters_p)
    say(f"{name} [{what}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    return ms, plain_ms


def mxu_segments(tris, exclude_oversized=False):
    """mxtile's packed segments of `tris`, built afresh (kernels/tables.py)."""
    return tables.Tables(tris).segments(rt_mxu._pack_mxu, rt_mxu.MXU_TRI_LIMIT, exclude_oversized)


def tile_segments(tris, exclude_oversized=False):
    """The tile route's packed segments of `tris`, built afresh."""
    return tables.Tables(tris).segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT,
                                        exclude_oversized)


def mxtile_args(wavefront):
    """K1's or K2's arguments on one captured wavefront, as the entry points
    pass them: (wrapper name, args, ov_buf or None). K2 gets the oversized
    sub-block, as mxu_tile_occlusion's first segment does."""
    occl, oo, dd, tris, eps, t_limit = wavefront
    found = tables.Tables(tris)
    (tfq, aabbs, _), = found.segments(rt_mxu._pack_mxu, rt_mxu.MXU_TRI_LIMIT, occl)
    rays_, eps_t = tables.pad_rays(oo, dd, t_limit), tables.eps_tensor(eps, oo.device)
    if occl:
        return "mxu_occl_kernel", (eps_t, rays_, aabbs, tfq, found.oversized()), found.sort()[3]
    return "mxu_kernel", (eps_t, rays_, aabbs, tfq), None


def mxtile_check(name, label, args, ov_buf, wavefront):
    """K1 or K2 on a whole wavefront against its plain version on the same
    inputs, with the bars of the JAX package's tests (K1: winners agree on
    >= 99.9% of the rays, t to a relative 1e-5; K2: occlusion agrees on
    >= 99.9%); its cnt_out equal to the plain path's list lengths
    (`_prep_mxu`'s cnt), its output the same without cnt_out, and K2 with
    the oversized sub-block equal to K2 without it ORed with
    `_oversized_occl` (and within the bar of the plain segment sweep ORed
    with it). Returns (agreement, max abs error, max relative t error or
    None, hit or occluded share, the plain path's lists)."""
    lists = rt_mxu._plain_lists(args[1], args[2], None)
    cnt = lists[2]
    cnt_k = torch.full_like(cnt, -1)
    out_k = wrapper(name)(*args, cnt_out=cnt_k)
    check(torch.equal(cnt_k, cnt), f"{label}: cnt_out differs from _prep_mxu's cnt on "
          f"{int((cnt_k != cnt).sum())} of {cnt.numel()} groups")
    identical(f"{label} without cnt_out vs with it", wrapper(name)(*args), out_k)
    out_p = KERNELS[name][0](*args)
    if name == "mxu_kernel":
        return (*search_agreement(label, out_k, out_p), lists)
    agree = (out_k == out_p).float().mean().item()
    check(agree >= 0.999, f"{label}: occlusion agreement {agree} < 0.999")
    if ov_buf is not None:
        _, oo, dd, _, eps_f, t_limit = wavefront
        r = oo.shape[0]
        over, folded = rt_tile._oversized_occl(oo, dd, t_limit, ov_buf, eps_f), out_k[:r] > 0
        check(torch.equal(folded, (wrapper(name)(*args[:4])[:r] > 0) | over), f"{label}: K2 "
              "with the oversized sub-block differs from K2 without it ORed with _oversized_occl")
        split = (KERNELS[name][0](*args[:4])[:r] > 0) | over
        agree_split = (folded == split).float().mean().item()
        say(f"{label}: K2 with the oversized sub-block against the plain segment sweep ORed "
            f"with _oversized_occl: agreement {agree_split:.6f}")
        check(agree_split >= 0.999, f"{label}: agreement {agree_split} with the plain segment "
              "sweep ORed with _oversized_occl < 0.999")
    return (agree, float((out_k - out_p).abs().max().item()), None, out_k.float().mean().item(),
            lists)


def list_split(aabbs, ids, cnt):
    """Per group: the padding-only blocks (inverted box) among its listed ones."""
    pad = (aabbs[0:3] > aabbs[3:6]).any(0)
    listed = torch.arange(aabbs.shape[1], device=cnt.device)[None] < cnt[:, None]
    return (pad[ids.long()] & listed).sum(1)


def mxtile_work(name, args, lists, ov_buf, wavefront):
    """(operations, bytes, operations by the full count) of K1 or K2 on args,
    from this run's data. K1: SLAB_OPS per (ray, box) test, every ray
    against every box of the segment, plus MXU_PAIR_OPS per (ray, triangle)
    pair of each group's listed blocks that are not padding-only. K2: the
    same slab tests, but only in groups with a ray that can be occluded
    (t_limit > eps); then, per such ray, PAIR_OPS per oversized slot of the
    sub-block's non-empty 32-slot runs, in order, up to the one that
    occludes it, and, if none does, MXU_PAIR_OPS per pair of its listed
    non-padding blocks, 4 columns at a time, up to the 4 columns in which
    it is first occluded (found with the plain version's window,
    `rt_mxu._window`). The full count: MXU_PAIR_OPS_FULL per pair of every
    listed block (K2 up to each ray's exit in the segment's blocks alone),
    no slab tests. Bytes: the inputs read once, the output written once."""
    eps, rays_, aabbs, tfq = args[:4]
    rf, ids, cnt, tl = lists
    nsub, g = aabbs.shape[1], cnt.shape[0]
    nbytes = tensor_bytes(*args) + rays_.shape[0] * (8 if name == "mxu_kernel" else 4)
    if name == "mxu_kernel":
        tests = rays_.shape[0] * nsub
        pairs = int((cnt - list_split(aabbs, ids, cnt)).sum()) * rt_mxu.RAY_TILE * rt_mxu.SUB
        full = int(cnt.sum()) * rt_mxu.RAY_TILE * rt_mxu.SUB * MXU_PAIR_OPS_FULL
        return tests * SLAB_OPS + pairs * MXU_PAIR_OPS, nbytes, full
    _, oo, dd, _, eps_f, t_limit = wavefront
    r = oo.shape[0]
    live = tl > float(eps)  # [G, 128]: the rays that can be occluded
    tests = int(live.any(1).sum()) * rt_mxu.RAY_TILE * nsub
    # The oversized sub-block: slots of the non-empty runs, up to the first hit.
    runs = (args[4][0, 12].reshape(-1, 32) != 0).any(1).repeat_interleave(32)
    ov_pairs = 0
    done = ~live  # then also the rays that the oversized triangles occlude
    for i in range(0, r, rt_tile._SWEEP_RAYS):
        sl = slice(i, i + rt_tile._SWEEP_RAYS)
        t, ok = rt_tile._oversized_hits(oo[sl], dd[sl], ov_buf, eps_f)
        hit = (ok & (t < t_limit[sl, None]))[:, runs]
        n = torch.where(hit.any(1), torch.argmax(hit.to(torch.int32), 1) + 1, hit.shape[1])
        ov_pairs += int((n * live.view(-1)[:r][sl]).sum())  # not the group's padding rays
        done.view(-1)[:r][sl] |= hit.any(1)
    pad = (aabbs[0:3] > aabbs[3:6]).any(0)
    full_occ = torch.zeros_like(live)
    pairs = full = 0
    for k in range(int(cnt.max()) if g else 0):
        jb = ids[:, k]
        _, ok = rt_mxu._window(torch.bmm(rf, tfq[jb.long()]), eps, tl)
        hit = ok.any(-1)
        first = torch.argmax(ok.to(torch.int32), dim=-1)  # the first accepted column
        cols = torch.where(hit, (first // 4 + 1) * 4, rt_mxu.SUB)
        listed = (k < cnt)[:, None]
        full += int((cols * (~full_occ & listed)).sum())
        full_occ |= hit & listed
        swept = listed & ~pad[jb.long()][:, None]
        pairs += int((cols * (~done & swept)).sum())
        done |= hit & swept
    return (tests * SLAB_OPS + ov_pairs * PAIR_OPS + pairs * MXU_PAIR_OPS, nbytes,
            full * MXU_PAIR_OPS_FULL)


def mxtile_kernels(card, seen, results, what="flagship 1080p", key=None):
    """K1 and K2 on a frame's camera and shadow wavefronts, as the entry
    points call them (`mxtile_check`), each timed beside its plain version
    and its bound, with the full count of the bound beside it. The entries
    go into the kernels line's own keys, or under `key`."""
    with torch.no_grad():
        for wavefront in seen[:2]:
            name, args, ov_buf = mxtile_args(wavefront)
            agree, max_abs, rel, share, lists = mxtile_check(
                name, f"{name} [{what}]", args, ov_buf, wavefront)
            if rel is None:
                say(f"{name} [{what}]: occlusion agrees {agree:.6f}, occluded {share:.4f}; "
                    "cnt_out equals _prep_mxu's cnt; the oversized fold equals _oversized_occl")
            else:
                say(f"{name} [{what}]: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                    f"max rel t err {rel:.3e}, hits {share:.4f}; cnt_out equals _prep_mxu's cnt")
            _, ids, cnt, _ = lists
            n_pad = list_split(args[2], ids, cnt).float()
            say(f"{name} [{what}]: groups {cnt.shape[0]}, blocks {args[2].shape[1]}, mean list "
                f"{cnt.float().mean().item():.2f} (max {int(cnt.max())}), of which padding-only "
                f"{n_pad.mean().item():.2f}, swept {(cnt - n_pad).mean().item():.2f}")
            ms, plain_ms = time_pair(name, lambda: wrapper(name)(*args),
                                     lambda: KERNELS[name][0](*args), 20, 2, card, what)
            ops, nbytes, full_ops = mxtile_work(name, args, lists, ov_buf, wavefront)
            bound_ms, bound_by = bound(ops, nbytes)
            full_ms, _ = bound(full_ops, nbytes)
            say(f"{name} [{what}]: bound {bound_ms:.3f} ms ({bound_by}; {ops:.4g} "
                f"operations); by the full count {full_ms:.3f} ms ({full_ops:.4g})")
            entry = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bound_ms_full_count=full_ms)
            if key is None:
                results[name].update(entry, at="flagship 1920x1080, depth 1")
            else:
                results[name][key] = dict(entry, at=what)


def mxtile_backward_kernels(card, scene, cam, w, h, cfg, results):
    """K1 and K2 on every wavefront of config 4's backward re-derivation:
    `_bwd_cfg`'s chunked mxtile, each 262,144-ray chunk of the frame's camera
    rays and their reflections at bounces 0-3. Every wavefront is held
    to `mxtile_check`; the first of each kernel in the chunk that holds the
    frame's centre is timed."""
    o, d, ids = rays(cam, w, h)
    fb = fused_pallas._bwd_cfg(scene, cfg, o.shape[0])
    check(fb.backend == "mxtile" and fb.ray_chunk > 0,
          f"config 4's backward runs {fb.backend!r} in chunks of {fb.ray_chunk}, "
          "not chunked mxtile")
    chunk, centre = fb.ray_chunk, o.shape[0] // 2
    stats = {name: dict(wavefronts=0, min_agreement=1.0, max_abs_err=0.0)
             for name in ("mxu_kernel", "mxu_occl_kernel")}
    for i in range(0, o.shape[0], chunk):
        sl = slice(i, i + chunk)
        seen = capture_wavefronts(o[sl], d[sl], scene, ids[sl], fb.replace(ray_chunk=0),
                                  rt_mxu.mxu_tile_search, rt_mxu.mxu_tile_occlusion)
        line, bounce = [], -1
        with torch.no_grad():
            for wavefront in seen:
                name, args, ov_buf = mxtile_args(wavefront)
                bounce += name == "mxu_kernel"
                label = f"{name} [config 4 backward, rays {i}+, bounce {bounce}]"
                agree, max_abs, rel, share, lists = mxtile_check(name, label, args, ov_buf,
                                                                 wavefront)
                s = stats[name]
                s["wavefronts"] += 1
                s["min_agreement"] = min(s["min_agreement"], agree)
                s["max_abs_err"] = max(s["max_abs_err"], max_abs)
                n_pad = list_split(args[2], lists[1], lists[2]).float().mean().item()
                line.append(f"b{bounce} {'K2' if rel is None else 'K1'} {agree:.6f}"
                            + ("" if rel is None else f"/{rel:.1e}") + f"/{share:.3f}"
                            + f"/{lists[2].float().mean().item():.2f}-{n_pad:.2f}")
                if "ms" not in s and i <= centre < i + chunk:
                    s["ms"], s["plain_ms"] = time_pair(
                        name, lambda: wrapper(name)(*args), lambda: KERNELS[name][0](*args),
                        20, 2, card, f"config 4 backward, rays {i}+, bounce {bounce}")
                    ops, nbytes, full_ops = mxtile_work(name, args, lists, ov_buf, wavefront)
                    s["bound_ms"], s["bound_by"] = bound(ops, nbytes)
                    s["bound_ms_full_count"] = bound(full_ops, nbytes)[0]
        say(f"config 4 backward, rays {i}+ (agreement/rel t err/hit or occluded share/mean "
            "list-padding-only in it; cnt_out and the oversized fold exact): " + ", ".join(line))
    for name, s in stats.items():
        check(s["wavefronts"] > 0, f"config 4's backward gave {name} no wavefront")
        results[name]["config4_backward"] = dict(
            s, at=f"config 4 backward, {-(-o.shape[0] // chunk)} chunks of {chunk} rays "
                  f"x {cfg.depth} bounces")
        say(f"{name} [config 4 backward]: {s['wavefronts']} wavefronts, min agreement "
            f"{s['min_agreement']:.6f}, max abs err {s['max_abs_err']:.3e}; timed "
            f"{s['ms']:.3f} ms, bound {s['bound_ms']:.3f} ms (the full count "
            f"{s['bound_ms_full_count']:.3f})  [{card}]")


def skipped_pairs(o, d, c, eps, step=262_144):
    """How many of the pairs of rays o, d with every row of c the exact
    division skip rejects (`lane_pallas.plane_skip`)."""
    n = 0
    for i in range(0, o.shape[0], step):
        n += int(lane_pallas.lane_plane_skips(o[i:i + step], d[i:i + step], c, eps).sum())
    return n


def lane_check(card, label, wavefront):
    """K4 on one captured wavefront, with the arguments `lane_tri_search`
    gives it: within the bars of its plain version on the card, its t and
    winners bit-identical to the plain version on a CPU copy (the constants
    rounded as on the CPU), timed beside the plain version and its bound.
    Returns the kernels-line entry."""
    _, oo, dd, tris, eps, _ = wavefront
    plain = KERNELS["lane_kernel"][0]
    with torch.no_grad():
        args = (eps, tris.v0, tris.v1, tris.v2, tris.valid, oo.contiguous(), dd.contiguous())
        out_k = lane_pallas.lane_kernel(*args)
        agree, max_abs, rel, share = search_agreement(f"lane_kernel [{label}]", out_k,
                                                      plain(*args))
        cpu = plain(*(x.cpu() if torch.is_tensor(x) else x for x in args))
        identical(f"lane_kernel [{label}] vs its plain version on a CPU copy",
                  tuple(x.cpu() for x in out_k), cpu)
        say(f"lane_kernel [{label}]: winners agree {agree:.6f} with the plain version on the "
            f"card, max abs t err {max_abs:.3e}, max rel t err {rel:.3e}, hits {share:.4f}; "
            "t and winners bit-identical to the plain version on a CPU copy")
        ms, plain_ms = time_pair("lane_kernel", lambda: lane_pallas.lane_kernel(*args),
                                 lambda: plain(*args), 20, 3, card, label)
        # Every ray against every triangle below the valid prefix; a pair
        # that the division skip rejects counts up to the skip.
        n = int(lane_pallas.valid_prefix(tris.valid))
        c = lane_pallas._constants(tris.v0, tris.v1, tris.v2, tris.valid)[:n]
        pairs = oo.shape[0] * n
        skipped = skipped_pairs(oo, dd, c, eps)
        ops = skipped * SKIP_PAIR_OPS + (pairs - skipped) * PAIR_OPS
        nbytes = tensor_bytes(*args[1:]) + oo.shape[0] * 8
        bound_ms, bound_by = bound(ops, nbytes)
        old_ms, _ = bound(pairs * PAIR_OPS, nbytes + 4 * lane_pallas.TCS_W * n)
        say(f"lane_kernel [{label}]: bound {bound_ms:.4f} ms ({bound_by}; {pairs} pairs, of "
            f"which the skip rejects {skipped / max(pairs, 1):.4f}); without the skip (40 per "
            f"pair) {old_ms:.4f} ms; launch {lane_pallas.launch_shape(oo.shape[0], n)}")
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_ms_no_skip_count=old_ms,
                skipped_share=skipped / max(pairs, 1), at=label)


def lane_kernels(card, o, d, scene, ids, results):
    """K4 on the Cornell frame's camera and shadow wavefronts (lane route),
    each held to `lane_check`."""
    seen = capture_wavefronts(o, d, scene, ids, RenderConfig(backend="lane"),
                              lane_pallas.lane_tri_search)
    check(len(seen) == 2, f"lane route made {len(seen)} searches, want 2 (camera, shadow)")
    results["lane_kernel"].update(lane_check(card, "Cornell 1024x768 camera wavefront",
                                             seen[0]))
    results["lane_kernel"]["shadow_wavefront"] = lane_check(
        card, "Cornell 1024x768 shadow wavefront", seen[1])


def winner_kernels(card, label, scene, cam, w, h, search):
    """The winner-row gather and scatter-add on the winners of a main path's
    camera wavefront, found by the route's own search, as closest_hit passes
    them (missed rays and sphere winners on row 0). The gather bit-equal to
    index_select of the [R, 32] row; the scatter, of normal gradients for
    every field but has_normals (which gets none on the main paths), within
    1e-5 of a float64 index_add_ relative to the float64 sum of the gradients'
    magnitudes (float32 sums in another order: its atomics', which
    index_add_ does not fix either), its group count equal to `warp_groups`.
    Each timed beside its plain version (an index_select / index_add_ per
    field), the library call the main path made before (index_select of the
    [R, 32] row; index_add_ of an [R, 32] gradient) and its bound (bytes:
    the fields written or the gradients read, the indices, one table).
    Returns the gather's and the scatter's entries."""
    o, d, _ = rays(cam, w, h)
    with torch.no_grad():
        _, prim, is_sphere = argmin_hit(o, d, scene, EPS, tri_search=search)
    prim = torch.where((prim >= 0) & ~is_sphere, prim, 0).long()
    table = packed_tri_table(scene.triangles).detach().contiguous()
    r, n, cols = prim.shape[0], table.shape[0], winner.COLS
    fields = winner.winner_gather(table, prim)
    rows = torch.index_select(table, 0, prim)
    for (name, a, wd), got in zip(winner.FIELDS, fields):
        check(torch.equal(got, rows[:, a] if wd == 1 else rows[:, a:a + wd]),
              f"winner_gather [{label}]: {name} differs from index_select")
    gen = torch.Generator(device="cuda").manual_seed(20)
    grads = [None if name == "has_normals" else torch.randn(f.shape, generator=gen, device="cuda")
             for (name, _, _), f in zip(winner.FIELDS, fields)]
    cnt = torch.full((-(-r // winner.WARP),), -1, dtype=torch.int32, device="cuda")
    got = winner.winner_scatter(grads, prim, n, cnt_out=cnt).double()
    want = torch.zeros((n, cols), dtype=torch.float64, device="cuda")
    mag = torch.zeros_like(want)
    for (_, a, wd), g in zip(winner.FIELDS, grads):
        if g is not None:
            want[:, a:a + wd].index_add_(0, prim, g.double().reshape(-1, wd))
            mag[:, a:a + wd].index_add_(0, prim, g.double().abs().reshape(-1, wd))
    err = (got - want).abs()
    rel = float((err / mag.clamp(min=1e-30)).max())
    check(bool((err <= 1e-5 * mag).all()),
          f"winner_scatter [{label}]: {rel:.3e} of the magnitudes' sum from float64 index_add_")
    check(torch.equal(cnt, winner.warp_groups(prim)),
          f"winner_scatter [{label}]: its group count differs from warp_groups")
    groups = int(cnt.sum())
    g_ms, g_plain = time_pair("winner_gather", lambda: winner.winner_gather(table, prim),
                              lambda: winner._gather_plain(table, prim), 50, 20, card, label)
    g_lib = elapsed_ms(lambda: torch.index_select(table, 0, prim), "cuda", 20)
    s_ms, s_plain = time_pair("winner_scatter", lambda: winner.winner_scatter(grads, prim, n),
                              lambda: winner._scatter_plain(grads, prim, n), 50, 3, card, label)
    g_row = torch.randn((r, cols), generator=gen, device="cuda")
    s_lib = elapsed_ms(lambda: torch.zeros((n, cols), device="cuda").index_add_(0, prim, g_row),
                       "cuda", 3)
    g_bound = bound(0, tensor_bytes(*fields, prim, table))
    s_bound = bound(0, tensor_bytes(*(g for g in grads if g is not None), prim, table))
    say(f"winner_gather [{label}]: bit-equal to index_select; {g_ms:.3f} ms, bound "
        f"{g_bound[0]:.3f} ms (bytes), plain {g_plain:.3f} ms, index_select of the [R, 32] row "
        f"{g_lib:.3f} ms  [{card}]")
    say(f"winner_scatter [{label}]: within {rel:.3e} of float64 index_add_ (bar 1e-5), "
        f"{groups} groups for {r} rays ({100.0 * groups / r:.2f}%); {s_ms:.3f} ms, bound "
        f"{s_bound[0]:.3f} ms (bytes), plain {s_plain:.3f} ms, index_add_ of an [R, 32] "
        f"gradient {s_lib:.3f} ms  [{card}]")
    common = dict(rays=r, rows=n)
    return (dict(common, max_abs_err=0.0, ms=g_ms, plain_ms=g_plain, library_ms=g_lib,
                 bound_ms=g_bound[0], bound_by=g_bound[1]),
            dict(common, max_abs_err=float(err.max()), max_rel_err=rel, groups=groups, ms=s_ms,
                 plain_ms=s_plain, library_ms=s_lib, bound_ms=s_bound[0], bound_by=s_bound[1]))


def adam_grads(params, gen):
    """Normal gradients with zeros, +-1e-30 and +-1e6 among them (5 of 16)."""
    special = torch.tensor([0.0, 1e-30, -1e-30, 1e6, -1e6], device="cuda")
    out = []
    for p in params:
        g = torch.randn(p.shape, generator=gen, device="cuda")
        pick = torch.randint(0, 16, p.shape, generator=gen, device="cuda")
        out.append(torch.where(pick < 5, special[pick.clamp(max=4)], g))
    return out


def bits(ts):
    return [t.view(torch.int32) for t in ts]


def adam_kernels(card, label, scene, steps=5, lr=0.05, b1=0.9, b2=0.999, eps=1e-8):
    """The Adam kernel over `scene`'s float leaves for `steps` steps from
    adam_init, through `optimize.adam_update`, with `adam_grads`: one launch a
    step, every leaf through it; its new parameters, m and v bit-equal to the
    tensor operations' (`adam._adam_plain`) on the card; its inputs unchanged;
    its outputs in one buffer that is none of theirs. Timed: the kernel's
    device time (50 launches in one CUDA graph), one eager call (host
    dispatch included) and the tensor operations beside its bound (bytes:
    four reads and three writes of each element)."""
    params = [p.detach().contiguous() for p in float_params(scene)]
    gen = torch.Generator(device="cuda").manual_seed(27)
    state = optimize.adam_init(params)
    for step in range(steps):
        grads = adam_grads(params, gen)
        ins = [t.clone() for t in params + grads + state["m"] + state["v"]]
        tf = (state["t"] + 1).to(torch.float32)
        c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf
        want = adam._adam_plain(params, grads, state["m"], state["v"], lr, b1, b2, eps, c1, c2)
        before = adam.adam_step.launches
        new, st = optimize.adam_update(params, grads, state, lr=lr, b1=b1, b2=b2, eps=eps)
        check(adam.adam_step.launches == before + 1,
              f"adam_step [{label}]: {adam.adam_step.launches - before} launches in step {step}")
        for what, got, ref in zip(("p", "m", "v"), (new, st["m"], st["v"]), want):
            check(all(torch.equal(a, b) for a, b in zip(bits(got), bits(ref))),
                  f"adam_step [{label}]: step {step}'s {what} differs from the tensor operations")
        check(all(torch.equal(a, b) for a, b in zip(
            bits(ins), bits(params + grads + state["m"] + state["v"]))),
              f"adam_step [{label}]: step {step} changed its inputs")
        storages = {t.untyped_storage().data_ptr() for t in new + st["m"] + st["v"]}
        check(len(storages) == 1 and not storages & {
            t.untyped_storage().data_ptr() for t in params + grads + state["m"] + state["v"]},
              f"adam_step [{label}]: the outputs are not one new buffer")
        params, state = new, st
    m, v = state["m"], state["v"]
    tf = (state["t"] + 1).to(torch.float32)
    c1, c2 = 1 - b1 ** tf, 1 - b2 ** tf

    def kernel():
        return adam.adam_step(params, grads, m, v, lr, b1, b2, eps, c1, c2)

    kernel()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(50):
            kernel()
    device_ms = statistics.median(elapsed_ms(graph.replay, "cuda", 3) for _ in range(3)) / 50
    del graph
    call_ms, plain_ms = time_pair("adam_step", kernel, lambda: adam._adam_plain(
        params, grads, m, v, lr, b1, b2, eps, c1, c2), 50, 20, card, label)
    n = sum(p.numel() for p in params)
    limit = bound(0, 28 * n)
    say(f"adam_step [{label}]: {len(params)} leaves, {n} elements, bit-equal to the tensor "
        f"operations over {steps} steps; device {device_ms:.4f} ms a launch, bound "
        f"{limit[0]:.4f} ms (bytes); eager call {call_ms:.3f} ms, tensor operations "
        f"{plain_ms:.3f} ms  [{card}]")
    return dict(leaves=len(params), elements=n, max_abs_err=0.0, ms=device_ms, call_ms=call_ms,
                plain_ms=plain_ms, bound_ms=limit[0], bound_by=limit[1])


def fused_tables_check(card, label, scene, results=None):
    """The table build on the card against its plain version on a CPU copy
    of the scene: every output equal bit for bit. The plain version run on
    the card is compared with the CPU's too (reported: CUDA's
    torch.linalg.cross may round otherwise). Timed beside the plain version
    on the card and the bound."""
    names = ("tcs", "shad", "sph", "lc", "cab", "counts", "n_tris")
    with torch.no_grad():
        got = fused_pallas.fused_tables(scene)
        want = fused_pallas._fused_tables_plain(scene.to("cpu"))
        for k, a, w in zip(names, got, want):
            a = a.cpu()
            same = a.dtype == w.dtype and a.shape == w.shape and torch.equal(
                *(x.view(torch.int32) if x.is_floating_point() else x for x in (a, w)))
            check(same, f"fused_tables [{label}]: {k} differs from the plain version on a CPU "
                  "copy")
        card_plain = fused_pallas._fused_tables_plain(scene)
        diffs = []
        for k, a, w in zip(names, card_plain, want):
            a = a.cpu()
            if a.is_floating_point():
                bits = int((a.view(torch.int32) != w.view(torch.int32)).sum())
                diffs.append(f"{k} {bits} of {a.numel()} differ, max abs "
                             f"{(a - w).abs().max().item() if a.numel() else 0.0:.3e}")
            else:
                diffs.append(f"{k} {'equal' if torch.equal(a, w) else 'DIFFER'}")
        g = got[4].shape[1] // 6
        say(f"fused_tables [{label}]: N {g * fused_pallas.FUSED_CHUNK}, G {g}, n_tris "
            f"{int(got[6])}: all seven outputs bit-equal to the plain version on a CPU copy")
        say(f"fused_tables [{label}]: the plain (tensor-op) version on the card vs the CPU: "
            + "; ".join(diffs))
        ms, plain_ms = time_pair("fused_tables", lambda: fused_pallas.fused_tables(scene),
                                 lambda: fused_pallas._fused_tables_plain(scene), 20, 5, card,
                                 label)
        tris, sph, lt = scene.triangles, scene.spheres, scene.lights
        leaves = [getattr(tris, k) for k in ("v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd", "ks",
                                             "ke", "ns", "has_normals", "valid")]
        leaves += [getattr(sph, k) for k in ("center", "radius", "ka", "kd", "ks", "ke", "ns",
                                             "valid")] + [lt.tri_idx, lt.face_count]
        nbytes = tensor_bytes(*leaves, *got)
        # Per triangle: centroid 9, AABB diagonal 20, Morton code 46, key 4,
        # constants 75, box 6; per compare-exchange of the two bitonic sorts 1.
        n = g * fused_pallas.FUSED_CHUNK
        p2 = 1 << (n - 1).bit_length()
        lg = p2.bit_length() - 1
        ops = n * 160 + 2 * (p2 // 2) * lg * (lg + 1) // 2
        bound_ms, bound_by = bound(ops, nbytes)
        say(f"fused_tables [{label}]: bound {bound_ms:.5f} ms ({bound_by})  [{card}]")
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               card_plain_vs_cpu="; ".join(diffs))
    if results is not None:
        results["fused_tables"].update(out, at=label)
    return out


def fused_work(record, tables, eps, lights):
    """(operations, pairs, skipped pairs) of K3 on one frame, from the
    wavefronts `_fused_plain` recorded (a least count of its work on this
    run's data). Per bounce: the pairs of each live ray with the valid
    triangles of the chunks that the ray's own slab test keeps
    (`block_cull_mask`; a conservative chunk cull of a ray group keeps at
    least those), the valid spheres, and FUSED_HIT_OPS per hit; per light,
    FUSED_DRAW_OPS per hit ray, and per masked shadow ray its pairs in
    ascending chunk order up to and including its first occluder (the
    chunks its own slab test keeps within t_limit), the valid spheres up to
    the first that occludes it if no triangle does, and FUSED_PHONG_OPS. A
    pair that the division skip rejects counts SKIP_PAIR_OPS, the others
    PAIR_OPS."""
    tcs, _, sph, _, cab, _, n_tris = tables
    n, chunk = int(n_tris), fused_pallas.FUSED_CHUNK
    c = tcs.reshape(-1, lane_pallas.TCS_W)
    boxes = cab.reshape(-1, 6).T.contiguous()  # [6, G]
    live_chunks = [k for k in range(boxes.shape[1])
                   if k * chunk < n and bool(boxes[0, k] <= boxes[3, k])]
    srows = sph.reshape(-1, fused_pallas.SPH_W)
    srows = srows[srows[:, 4] > 0.5]
    ops = pairs = skipped = 0
    step = 262_144
    for entry in record:
        if entry[0] == "camera":
            _, o, d, active, hit = entry
            idx = torch.nonzero(active)[:, 0]
            nh = int((hit & active).sum())
            ops += idx.numel() * srows.shape[0] * SPHERE_OPS + nh * (FUSED_HIT_OPS +
                                                                       lights * FUSED_DRAW_OPS)
            for i in range(0, idx.numel(), step):
                oo, dd = o[idx[i:i + step]], d[idx[i:i + step]]
                keep = block_cull_mask(oo, dd, boxes)
                for k in live_chunks:
                    rows = torch.nonzero(keep[:, k])[:, 0]
                    cc = c[k * chunk:min(k * chunk + chunk, n)]
                    pairs += rows.numel() * cc.shape[0]
                    skipped += int(lane_pallas.lane_plane_skips(oo[rows], dd[rows], cc, eps).sum())
            continue
        _, hp, ld, t_lim, mask = entry
        idx = torch.nonzero(mask)[:, 0]
        ops += idx.numel() * FUSED_PHONG_OPS
        for i in range(0, idx.numel(), step):
            sl = idx[i:i + step]
            oo, dd, tl = hp[sl], ld[sl], t_lim[sl]
            keep = block_cull_mask(oo, dd, boxes, tl)
            occ = torch.zeros_like(tl, dtype=torch.bool)
            for k in live_chunks:
                rows = torch.nonzero(keep[:, k] & ~occ)[:, 0]
                cc = c[k * chunk:min(k * chunk + chunk, n)]
                t, ok = lane_pallas.lane_plane_hits(oo[rows], dd[rows], cc, eps)
                hitm = ok & (t < tl[rows, None])
                anyh = hitm.any(1)
                n_eval = torch.where(anyh, torch.argmax(hitm.to(torch.int32), 1) + 1, cc.shape[0])
                prefix = torch.arange(cc.shape[0], device=tl.device)[None] < n_eval[:, None]
                pairs += int(n_eval.sum())
                skipped += int((lane_pallas.lane_plane_skips(oo[rows], dd[rows], cc, eps)
                                & prefix).sum())
                occ[rows] |= anyh
            free = torch.nonzero(~occ)[:, 0]
            if srows.shape[0] and free.numel():
                st = torch.stack([fused_pallas._sphere_t(oo[free], dd[free], row, eps)
                                  for row in srows], 1) < tl[free, None]
                n_s = torch.where(st.any(1), torch.argmax(st.to(torch.int32), 1) + 1,
                                  srows.shape[0])
                ops += int(n_s.sum()) * SPHERE_OPS
    ops += skipped * SKIP_PAIR_OPS + (pairs - skipped) * PAIR_OPS
    return ops, pairs, skipped


def fused_kernel_check(card, o, d, scene, ids, cfg, what, iters_p=1):
    """K3 on a whole frame, with the tables of the table build (held bit-equal
    to its plain version by `fused_tables_check`): the image bars of
    tests/test_fused.py against `_fused_plain`, its time beside the plain
    version's and its bound (`fused_work`, from the wavefronts the plain
    version records), with the first-bounce count beside it."""
    with torch.no_grad():
        tables = fused_pallas.fused_tables(scene)
        kw = dict(seed=cfg.seed, eps=float(cfg.eps), shadow_eps=float(cfg.shadow_eps),
                  depth=cfg.depth, lights=scene.lights.num_lights, faces=scene.lights.max_faces)
        a = fused_pallas.fused_kernel(o, d, ids, *tables, **kw)
        record = []
        p = fused_pallas._fused_plain(o, d, ids, *tables, **kw, record=record)
        diff = (a - p).abs()
        flipped = diff.amax(dim=1) > 1e-2
        share = flipped.float().mean().item()
        rest = diff[~flipped].max().item()
        max_abs = diff.max().item()
        g = tables[4].shape[1] // 6
        n = g * fused_pallas.FUSED_CHUNK
        shape = fused_pallas.launch_shape(o.shape[0], n, scene.spheres.capacity, kw["lights"],
                                          kw["faces"])
        say(f"fused_kernel [{what}]: G {g}, depth {cfg.depth}; pixels off by > 1e-2: "
            f"{share:.6f}, max abs err of the rest {rest:.3e}, max abs err "
            f"{max_abs:.3e}, image mean {a.mean().item():.4f}; launch {shape}")
        check(bool(torch.isfinite(a).all()), f"fused_kernel [{what}]: non-finite pixel")
        check(share <= 2e-3, f"fused_kernel [{what}]: {share} of pixels flipped > 0.002")
        check(rest <= 3e-5, f"fused_kernel [{what}]: max abs err {rest} > 3e-5")
        ms, plain_ms = time_pair("fused_kernel", lambda: fused_pallas.fused_kernel(o, d, ids,
                                                                                  *tables, **kw),
                                 lambda: fused_pallas._fused_plain(o, d, ids, *tables, **kw),
                                 10, iters_p, card, what)
        ops, pairs, skipped = fused_work(record, tables, float(cfg.eps), kw["lights"])
        del record
        nbytes = tensor_bytes(o, d, ids, *tables) + a.numel() * 4
        bound_ms, bound_by = bound(ops, nbytes)
        # The first-bounce count: the first bounce's camera rays against every
        # valid triangle, 40 operations each (neither an upper nor a lower count).
        old_ms, _ = bound(o.shape[0] * int(tables[-1]) * PAIR_OPS, nbytes)
        say(f"fused_kernel [{what}]: bound {bound_ms:.4f} ms ({bound_by}; {ops:.4g} operations, "
            f"{pairs} pairs of which the skip rejects {skipped / max(pairs, 1):.4f}); the "
            f"first-bounce count {old_ms:.4f} ms  [{card}]")
    return dict(max_abs_err=max_abs, max_abs_err_unflipped=rest, ms=ms, plain_ms=plain_ms,
                flipped_share=share, bound_ms=bound_ms, bound_by=bound_by,
                bound_ms_first_bounce_count=old_ms, pairs=pairs, skipped_share=skipped / max(pairs, 1),
                launch=shape)


def tile_args(wavefront):
    """K5's or K6's arguments on one captured wavefront, as the entry points
    pass them: (wrapper name, args, ov_buf or None). K6 gets the oversized
    sub-block, as tile_occlusion's first segment does."""
    occl, oo, dd, tris, eps, t_limit = wavefront
    found = tables.Tables(tris)
    (tc, aabbs, _), = found.segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT, occl)
    rays_, eps_t = tables.pad_rays(oo, dd, t_limit), tables.eps_tensor(eps, oo.device)
    if occl:
        return "tile_occl_kernel", (eps_t, rays_, aabbs, tc, found.oversized()), found.sort()[3]
    return "tile_kernel", (eps_t, rays_, aabbs, tc), None


def on_rays(args, rs):
    """K5's or K6's args with the rays cut to the slice rs."""
    return (args[0], args[1][rs], *args[2:])


def tile_sweeps(name, args):
    """The plain path's lists on args' whole wavefront, and what K5 or K6
    sweeps of them: (cnt [B] -- the list lengths, visits [B] -- the
    sub-blocks each bundle sweeps, live [B] -- the bundles that cull and
    sweep at all). K5: every bundle, every listed sub-block that is not
    padding-only. K6: the bundles with a ray that can be occluded
    (t_limit > eps); each tests the oversized sub-block, then its listed
    sub-blocks that are not padding-only, in order, up to the one after
    which every ray is occluded or cannot be: its exit, found with the
    plain sweep's pair test (`_block_pairs`), TILE_SLICE rays at a time."""
    eps, rays_, aabbs, tc = args[:4]
    ov = args[4] if len(args) > 4 else None
    C, eps_f = rt_tile.COHERENT, float(eps)
    ids, cnt = rt_tile._lists(rays_, aabbs)
    pad = (aabbs[0:3] > aabbs[3:6]).any(0)
    listed = torch.arange(aabbs.shape[1], device=cnt.device)
    visits = torch.zeros_like(cnt)
    live = torch.ones_like(cnt, dtype=torch.bool)
    n = TILE_SLICE // C
    for i in range(0, cnt.shape[0], n):
        idc, c = ids[i:i + n].long(), cnt[i:i + n]
        swept = ~pad[idc] & (listed[None] < c[:, None])
        if name == "tile_kernel":
            visits[i:i + n] = swept.sum(1)
            continue
        o, d, tl = rt_tile._bundle_rays(rays_[i * C:(i + n) * C])
        settled = ~(tl[..., 0] > eps_f)
        live[i:i + n] = ~settled.all(1)
        occ = torch.zeros_like(settled)
        if ov is not None:
            t, ok = rt_tile._block_pairs(ov, torch.zeros_like(c), o, d, eps_f)
            occ |= torch.any(ok & (t < tl), dim=-1)
        for k in range(int(c.max()) if c.numel() else 0):
            a = torch.nonzero(~(occ | settled).all(1) & swept[:, k])[:, 0]
            if a.numel():
                t, ok = rt_tile._block_pairs(tc, idc[a, k], tuple(x[a] for x in o),
                                             tuple(x[a] for x in d), eps_f)
                occ[a] |= torch.any(ok & (t < tl[a]), dim=-1)
                visits[i + a] += 1
    return cnt, visits, live


def tile_work(name, args, visits, live):
    """(operations, bytes) that K5 or K6 does on args, from this run's data
    (`tile_sweeps`' visits and live bundles). Per live bundle, the cull's
    slab tests, as the kernel decides them when it does not count: 8 rays
    against the union box of every group that holds a sub-block that is
    not padding-only (unless a direction component is zero), and against
    each box of the groups that the bundle keeps at that level (with
    `block_cull_mask` on `_group_boxes`); then 8 x 128 (ray, triangle)
    pairs per visited sub-block; K6 adds each live bundle against the runs
    of 32 oversized slots that hold a triangle (it skips the empty ones).
    Bytes: the rays, boxes and table read once, the output written once."""
    eps, rays_, aabbs, tc = args[:4]
    ov = args[4] if len(args) > 4 else None
    nsub, C = aabbs.shape[1], rt_tile.COHERENT
    gb = rt_tile._group_boxes(aabbs)
    ng = gb.shape[1]
    per_group = torch.clamp(nsub - 32 * torch.arange(ng, device=gb.device), max=32)
    tested = ~(gb[0:3] > gb[3:6]).any(0)  # groups that hold a non-padding sub-block
    unions = boxes = 0
    step = C << 17
    for i in range(0, rays_.shape[0], step):
        r, lv = rays_[i:i + step], live[i // C:(i + step) // C, None]
        finite = torch.isfinite(1.0 / r[:, 3:6]).all(1).reshape(-1, C).all(1)[:, None]
        keep = block_cull_mask(r[:, 0:3], r[:, 3:6], gb, r[:, 6]).reshape(-1, C, ng).any(1)
        keep = (keep | ~finite) & tested[None] & lv
        boxes += int((keep * per_group).sum())
        unions += int((finite & tested[None] & lv).sum())
    pairs = int(visits.sum()) * C * rt_tile.SUB
    out = 4 if name == "tile_occl_kernel" else 8  # occluded int32; t f32 and index int32
    nbytes = tensor_bytes(rays_, aabbs, gb, tc) + rays_.shape[0] * out
    if ov is not None:
        runs = int((ov[0, 12].reshape(-1, 32) != 0).any(1).sum())
        pairs += int(live.sum()) * C * 32 * runs
        nbytes += tensor_bytes(ov)
    return (unions + boxes) * C * SLAB_OPS + pairs * PAIR_OPS, nbytes


def identical(label, out_k, out_p):
    """Hold a kernel's outputs bit-identical to its plain version's."""
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for a, b in zip(out_k, out_p):
        check(torch.equal(a, b), f"{label}: {int((a != b).sum())} of {a.numel()} outputs "
              "differ from the plain version's")


def heavy_slice(cnts, r, w):
    """TILE_SLICE rays of whole image rows (whole bundles) of an r-ray,
    w-wide wavefront, centred on the row whose bundles have the longest
    mean list, summed over `cnts` (one per segment): (ray slice, bundle
    slice, heaviest row, its summed mean list)."""
    rows = sum(c[:r // rt_tile.COHERENT].reshape(-1, w // rt_tile.COHERENT).float().mean(1)
               for c in cnts)
    heavy = int(rows.argmax())
    start = min(max(heavy * w - TILE_SLICE // 2, 0), r - TILE_SLICE)
    start -= start % rt_tile.COHERENT
    return (slice(start, start + TILE_SLICE),
            slice(start // rt_tile.COHERENT, (start + TILE_SLICE) // rt_tile.COHERENT),
            heavy, rows.max().item())


def list_stats(cnt, bs):
    return (f"mean list {cnt.float().mean().item():.2f} (max {int(cnt.max())}), on the slice "
            f"{cnt[bs].float().mean().item():.2f} (max {int(cnt[bs].max())})")


def sweep_stats(visits, live):
    return (f"sub-blocks swept per live bundle {visits[live].float().mean().item():.2f}, live "
            f"bundles {live.float().mean().item():.4f}")


def tile_check(name, label, args, cnt, ov_buf, wavefront, rs):
    """K5 or K6 on a whole wavefront: its cnt_out equal to the plain path's
    list lengths `cnt`, its output the same without cnt_out (the cull then
    skips groups of padding only, and does not test their boxes), and on
    the slice rs bit-identical to the plain version's (K6: and to the plain
    segment sweep ORed with `_oversized_occl` when it tests the oversized
    sub-block). Returns (the kernel's whole output, the plain output on
    the slice)."""
    cnt_k = torch.full_like(cnt, -1)
    whole = wrapper(name)(*args, cnt_out=cnt_k)
    check(torch.equal(cnt_k, cnt), f"{label}: cnt_out differs from the lists' cnt on "
          f"{int((cnt_k != cnt).sum())} of {cnt.numel()} bundles")
    identical(f"{label} without cnt_out vs with it", wrapper(name)(*args), whole)
    plain = KERNELS[name][0](*on_rays(args, rs))
    if name == "tile_kernel":
        identical(label, (whole[0][rs], whole[1][rs]), plain)
    else:
        identical(label, whole[rs], plain)
        if ov_buf is not None:
            _, oo, dd, _, eps_f, t_limit = wavefront
            split = (KERNELS[name][0](*on_rays(args[:4], rs)) > 0) | rt_tile._oversized_occl(
                oo[rs], dd[rs], t_limit[rs], ov_buf, eps_f)
            check(torch.equal(whole[rs] > 0, split),
                  f"{label}: K6 with the oversized sub-block differs from the segment sweep "
                  "ORed with _oversized_occl")
    return whole, plain


def tile_kernels(card, seen, w, results, what="config 5 3840x2160", key=None, lights=1):
    """K5 and K6 on config 5's camera and shadow wavefronts (or another
    frame's, whose entries go under `key`), as the entry points call them
    (K5 culling by the hook's t_limit, K6 with the oversized sub-block).
    Each kernel runs on the whole wavefront with cnt_out, held equal to the
    plain path's list lengths there; its output on TILE_SLICE rays of whole
    image rows (a shadow row holds `lights` rays per pixel), centred on the
    row with the longest mean list, is held bit-identical to the plain
    version's on the same slice. Timed: the kernel on the whole wavefront
    and on the slice, the plain version on the slice, each beside its
    bound."""
    for wavefront in seen[:2]:
        with torch.no_grad():
            name, args, ov_buf = tile_args(wavefront)
            r = wavefront[1].shape[0]
            cnt, visits, live = tile_sweeps(name, args)
            rs, bs, heavy, mean = heavy_slice([cnt], r, w * (1 if name == "tile_kernel" else lights))
            whole, plain = tile_check(name, f"{name} [{what}]", args, cnt, ov_buf, wavefront,
                                      rs)
            say(f"{name} [{what}]: {cnt.shape[0]} bundles x {args[3].shape[0]} sub-blocks, "
                f"{list_stats(cnt, bs)}; {sweep_stats(visits, live)}; heaviest row {heavy} (mean "
                f"{mean:.2f}); slice rays "
                f"{rs.start}+{TILE_SLICE}; cnt_out equals the lists' cnt on the whole wavefront, "
                "output bit-identical to the plain version on the slice")
            if name == "tile_kernel":
                agree, max_abs, rel, share = search_agreement(
                    name, (whole[0][rs], whole[1][rs]), plain)
                say(f"{name}: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, hits "
                    f"{share:.4f} (slice), {(whole[1][:r] >= 0).float().mean().item():.4f} (whole)")
            else:
                max_abs = float((whole[rs] - plain).abs().max().item())
                say(f"{name}: occluded {whole[rs].float().mean().item():.4f} (slice), "
                    f"{whole[:r].float().mean().item():.4f} (whole)")
            del whole, plain
            sargs = on_rays(args, rs)
            ms, plain_ms = time_pair(name, lambda: wrapper(name)(*sargs),
                                     lambda: KERNELS[name][0](*sargs), 10, 1, card,
                                     f"{what} slice of {TILE_SLICE} rays")
            whole_ms = elapsed_ms(lambda: wrapper(name)(*args), "cuda", 3)
            bound_ms, bound_by = bound(*tile_work(name, sargs, visits[bs], live[bs]))
            whole_bound_ms, _ = bound(*tile_work(name, args, visits, live))
            say(f"{name} [{what}]: slice kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); whole wavefront ({r} rays) kernel {whole_ms:.3f} ms, bound "
                f"{whole_bound_ms:.3f} ms  [{card}]")
        entry = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, whole_ms=whole_ms, whole_bound_ms=whole_bound_ms,
                     at=f"{what} {'shadow' if name != 'tile_kernel' else 'camera'}"
                        f" wavefront, slice of {TILE_SLICE} rays from ray {rs.start} "
                        "(whole_*: the whole wavefront)")
        if key is None:
            results[name].update(entry)
        else:
            results[name][key] = entry


def tile_segment_kernels(card, seen, w, results):
    """K5 and K6 on the 500k soup's camera and shadow wavefronts, for each of
    the table's segments (`tables.Tables.segments`), as the entry points call
    them: each kernel runs on the whole wavefront against the segment's
    table (K6 with the oversized sub-block in segment 0), with cnt_out held
    equal to the plain path's list lengths, and its output on TILE_SLICE
    rays of whole image rows, centred on the row with the longest mean list
    over all segments, held bit-identical to the plain version's. The plain outputs, combined as
    the entry points combine segments (first-wins for the search, OR for
    the occlusion), are then held equal to `tile_tri_search` /
    `tile_occlusion` on the slice. Timed: the kernel on the whole wavefront
    beside its bound, the plain version on the slice."""
    for wavefront in seen[:2]:
        occl, oo, dd, tris, eps, t_limit = wavefront
        name = "tile_occl_kernel" if occl else "tile_kernel"
        what = "shadow" if occl else "camera"
        r, eps_t = oo.shape[0], tables.eps_tensor(eps, oo.device)
        with torch.no_grad():
            found = tables.Tables(tris)
            segs = found.segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT, occl)
            ov_buf, ov = found.sort()[3], found.oversized()
            rays_ = tables.pad_rays(oo, dd, t_limit)
            segs = [((eps_t, rays_, aabbs, tc) + ((ov if k == 0 else None,) if occl else ()),
                     perm_k) for k, (tc, aabbs, perm_k) in enumerate(segs)]
            sweeps = [tile_sweeps(name, args) for args, _ in segs]
            rs, bs, heavy, mean = heavy_slice([cnt for cnt, _, _ in sweeps], r, w)
            s = dict(segments=len(segs), ms=[], plain_ms=[], bound_ms=[], bound_by=[])
            comb = None
            for k, ((args, perm_k), (cnt, visits, live)) in enumerate(zip(segs, sweeps)):
                label = f"{name} [500k soup {what}, segment {k}]"
                whole, plain = tile_check(name, label, args, cnt,
                                          ov_buf if occl and k == 0 else None, wavefront, rs)
                del whole
                s["ms"].append(elapsed_ms(lambda: wrapper(name)(*args), "cuda"))
                tc = args[3]
                s["plain_ms"].append(elapsed_ms(lambda: KERNELS[name][0](*on_rays(args, rs)),
                                                "cuda"))
                b_ms, b_by = bound(*tile_work(name, args, visits, live))
                s["bound_ms"].append(b_ms)
                s["bound_by"].append(b_by)
                if occl:
                    comb = plain > 0 if comb is None else comb | (plain > 0)
                else:
                    t_k, i_k = plain[0], tables.orig_index(plain[1], perm_k)
                    if comb is None:
                        comb = (t_k, i_k)
                    else:
                        better = t_k < comb[0]
                        comb = (torch.where(better, t_k, comb[0]), torch.where(better, i_k, comb[1]))
                say(f"{label}: {cnt.shape[0]} bundles x {tc.shape[0]} sub-blocks, "
                    f"{list_stats(cnt, bs)}; {sweep_stats(visits, live)}; bit-identical on the "
                    "slice, cnt_out equal; kernel "
                    f"{s['ms'][-1]:.3f} ms whole, bound {b_ms:.3f} ms ({b_by}); plain "
                    f"{s['plain_ms'][-1]:.3f} ms on the slice  [{card}]")
                del plain
            if occl:
                identical(f"{name} [500k soup]: tile_occlusion vs the combined plain segments",
                          rt_tile.tile_occlusion(oo, dd, t_limit, tris, eps)[rs], comb)
            else:
                t_e, i_e = rt_tile.tile_tri_search(oo, dd, tris, eps, t_limit)
                identical(f"{name} [500k soup]: tile_tri_search vs the combined plain segments",
                          (t_e[rs], i_e[rs]), comb)
            del segs, sweeps
        say(f"{name} [500k soup {what}]: {s['segments']} segments, heaviest row {heavy} (summed "
            f"mean list {mean:.2f}), slice rays {rs.start}+{TILE_SLICE}: every segment "
            "bit-identical to its plain version; the entry point equals the combined plain "
            "segments")
        results[name]["soup500k"] = dict(
            s, at=f"random_scene(500_000) 1920x1080 {what} wavefront, per segment; slice of "
                  f"{TILE_SLICE} rays from ray {rs.start}")


# --------------------------------------------------------------------------
# Phase 4: the main paths
# --------------------------------------------------------------------------


def make_step(scene, o, d, ids, cfg):
    """step(i, backward): one frame of the rays with their ids shifted by i,
    through `trace_rays`, and the gradient of sum(color^2) with respect to
    every float scene leaf -> (color, loss, grads or None)."""
    base = float_params(scene)

    def step(i, backward=True):
        params = [p.detach().requires_grad_(backward) for p in base]
        color = trace_rays(o, d, merge_params(scene, params), ids + i, cfg)
        loss = torch.sum(color * color)
        if not backward:
            return color, loss, None
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return color, loss, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)]

    return step


def fetch_counts(forward, fwd_bwd):
    """path_phase's `fetch`: (gathers, scatters) of the forward and of the fwd+bwd."""
    return {what: dict(zip(FETCH, n)) for what, n in (("forward", forward), ("fwd+bwd", fwd_bwd))}


def path_phase(card, label, scene, cam, w, h, cfg, expect, fwd_kernels, bwd_kernels, results,
               min_nonzero=8, small=(192, 108), reps=5, min_launches=1, exact=None, lit=True,
               flip_bar=False, fetch=None):
    """Drive one main path: forward, then fwd+bwd, each with the launch
    counters reset just before and read just after; checks, and timings
    over `reps` steps. `exact` ({"forward": counts, "fwd+bwd": counts})
    holds every wrapper's count to its value, `fetch` (likewise) the winner
    fetch's; without it the forward launches no winner scatter and the
    fwd+bwd no more scatters than gathers. A scene that is not `lit`
    must render exactly black, with every gradient exactly zero. The small
    frame is held to the jnp backend's with the image bars; with `flip_bar`
    the pixels off by > 1e-2 (eps-window near-ties, where the jnp route and
    every search route of either package part) are set aside up to
    tests/test_fused.py's budget of 0.2% of the pixels, and the image bar's
    mean holds on the rest."""
    check(resolve_backend(cfg, scene) == expect,
          f"{label}: backend {cfg.backend!r} resolves to {resolve_backend(cfg, scene)!r}, "
          f"not {expect!r}")
    step = make_step(scene, *rays(cam, w, h), cfg)
    runs = [("forward", fwd_kernels, False)] + ([("fwd+bwd", bwd_kernels, True)]
                                               if bwd_kernels else [])
    for what, need, backward in runs:
        launches.reset()
        with torch.set_grad_enabled(backward):
            color, loss, grads = step(0, backward)
        counts = launches.read()
        say(f"{label} {what}: launches {counts}, loss {loss.item():.6e}")
        for name in need:
            check(counts[name] >= min_launches,
                  f"{label} {what}: {name} launched {counts[name]} times, < {min_launches}")
        if exact is not None:
            check(counts == exact[what], f"{label} {what}: launches {counts}, not {exact[what]}")
        got = launches.read(launches.FETCH)
        say(f"{label} {what}: winner fetch launches {got}")
        if fetch is not None:
            check(got == fetch[what], f"{label} {what}: winner fetch {got}, not {fetch[what]}")
        check(got["winner_scatter"] <= (got["winner_gather"] if backward else 0),
              f"{label} {what}: winner fetch {got}")
        for name, n in {**counts, **got}.items():
            results[name]["launches"] += n
        check(tuple(color.shape) == (w * h, 3), f"{label}: color shape {tuple(color.shape)}")
        check(bool(torch.isfinite(color).all()), f"{label}: non-finite pixel")
        if lit:
            check(color.mean().item() > 0.01, f"{label}: image is black")
        else:
            check(color.abs().max().item() == 0.0, f"{label}: an unlit image is not all zero")
        if backward:
            check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite grad")
            nonzero = sum(bool((g != 0).any()) for g in grads)
            say(f"{label}: {nonzero} of {len(grads)} float leaves have a non-zero gradient")
            if lit:
                check(nonzero >= min_nonzero,
                      f"{label}: {nonzero} non-zero gradients < {min_nonzero}")
            else:
                check(nonzero == 0, f"{label}: {nonzero} non-zero gradients of an unlit image")

    # A small frame through the kernels against the plain `jnp` backend.
    sw, sh = small
    a = render(scene, cam, sw, sh, cfg)
    b = render(scene, cam, sw, sh, cfg.replace(backend="jnp"))
    diff = (a - b).abs()
    flipped = diff.amax(-1) > 1e-2
    rest = diff[~flipped]
    rest_mean, rest_max = (rest.mean().item(), rest.max().item()) if rest.numel() else (0.0, 0.0)
    say(f"{label}: small frame {sw}x{sh} vs jnp backend: mean |diff| {diff.mean().item():.3e}, "
        f"share > 1e-2 {(diff > 1e-2).float().mean().item():.5f}; pixels off by > 1e-2 "
        f"{flipped.float().mean().item():.6f} ({int(flipped.sum())}), the rest's mean |diff| "
        f"{rest_mean:.3e}, max {rest_max:.3e}")
    if flip_bar:
        check(flipped.float().mean().item() <= 2e-3 and rest_mean < 1e-4,
              f"{label}: small frame disagrees with the jnp backend (flip budget, mean of the "
              "rest)")
    else:
        check(diff.mean().item() < 1e-4 and (diff > 1e-2).float().mean().item() < 5e-3,
              f"{label}: small frame disagrees with the jnp backend")

    with torch.no_grad():
        step(1, backward=False)
        torch.cuda.reset_peak_memory_stats()
        fwd = [elapsed_ms(lambda: step(2 + k, backward=False), "cuda") for k in range(reps)]
    timing = {"forward_ms": statistics.median(fwd),
              "forward_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    say(f"{label} forward    : {timing['forward_ms']:.2f} ms median of "
        f"{[round(x, 2) for x in fwd]} = {w * h / timing['forward_ms'] / 1e3:.3f} Mrays/s"
        f"  [{card}]")
    say(f"{label} peak device memory (forward): {timing['forward_peak_gib']:.2f} GiB  [{card}]")
    if bwd_kernels:
        step(2 + reps)
        torch.cuda.reset_peak_memory_stats()
        fb = [elapsed_ms(lambda: step(3 + reps + k), "cuda") for k in range(reps)]
        timing["fwd_bwd_ms"] = statistics.median(fb)
        timing["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        say(f"{label} forward+bwd: {timing['fwd_bwd_ms']:.2f} ms median of "
            f"{[round(x, 2) for x in fb]} = {w * h / timing['fwd_bwd_ms'] / 1e3:.3f} Mrays/s"
            f"  [{card}]")
        say(f"{label} peak device memory (fwd+bwd): {timing['peak_gib']:.2f} GiB  [{card}]")
    return timing


def layer_phase(card, seen):
    """Where the flagship forward's time goes: each layer of the search and
    the occlusion alone on the frame's wavefronts (CUDA events, median of
    3), with the peak memory of each entry point. `_prep_mxu` and the
    oversized sweep run only on the plain path (CPU tensors, and this
    script's checks); they are timed here for comparison."""
    _, po, pd, tris, eps, ptl = seen[0]
    _, so, sd, _, _, stl = seen[1]
    found = tables.Tables(tris)
    (tfq_p, ab_p, _), = found.segments(rt_mxu._pack_mxu, rt_mxu.MXU_TRI_LIMIT)
    (tfq_s, ab_s, _), = found.segments(rt_mxu._pack_mxu, rt_mxu.MXU_TRI_LIMIT, True)
    ov_buf = found.sort()[3]
    eps_t = tables.eps_tensor(eps, po.device)
    with torch.no_grad():
        ov = found.oversized()
        prim, shad = tables.pad_rays(po, pd, ptl), tables.pad_rays(so, sd, stl)
        entries = {"mxu_tile_search": lambda: rt_mxu.mxu_tile_search(po, pd, tris, eps, ptl),
                   "mxu_tile_occlusion": lambda: rt_mxu.mxu_tile_occlusion(so, sd, stl, tris,
                                                                           eps)}
        for what, fn in entries.items():
            say(f"layer flagship: {what}: peak {gib_above(fn):.2f} GiB above its inputs  [{card}]")
        layers = {
            "cluster sort + pack (per search)": lambda: mxu_segments(tris),
            "pad rays (per search)": lambda: tables.pad_rays(po, pd, ptl),
            "K1 alone (cull + sweep)": lambda: rt_mxu.mxu_kernel(eps_t, prim, ab_p, tfq_p),
            "mxu_tile_search (incl. K1)": entries["mxu_tile_search"],
            "K2 alone (cull + sweep + oversized)": lambda: rt_mxu.mxu_occl_kernel(
                eps_t, shad, ab_s, tfq_s, ov),
            "mxu_tile_occlusion (incl. K2)": entries["mxu_tile_occlusion"],
            "plain path only: cull pre-pass, primary": lambda: rt_mxu._prep_mxu(po, pd, ab_p, ptl),
            "plain path only: cull pre-pass, shadow": lambda: rt_mxu._prep_mxu(so, sd, ab_s, stl),
            "plain path only: oversized any-hit sweep": lambda: rt_tile._oversized_occl(
                so, sd, stl, ov_buf, eps),
        }
        for name, fn in layers.items():
            fn()
            t = statistics.median(elapsed_ms(fn, "cuda") for _ in range(3))
            say(f"layer {name:40s} {t:8.3f} ms  [{card}]")


def feeder_check(scene, cam, w, h, cfg):
    """One fwd+bwd step of the flagship on the card must call neither the
    plain path's list builder (`rt_mxu._prep_mxu`) nor its oversized sweep
    (`rt_tile._oversized_occl`): counting spies replace both for the step."""
    step = make_step(scene, *rays(cam, w, h), cfg)
    calls = {}
    saved = {(mod, name): getattr(mod, name)
             for mod, name in ((rt_mxu, "_prep_mxu"), (rt_tile, "_oversized_occl"))}

    def spy(key, fn):
        def counted(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return counted

    for (mod, name), fn in saved.items():
        setattr(mod, name, spy(name, fn))
    try:
        launches.reset()
        step(0)
        counts = launches.read()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    say(f"flagship fwd+bwd feeder check: launches {counts}, plain-path feeder calls {calls}")
    check(not calls, f"flagship fwd+bwd called the plain path's feeders: {calls}")
    check(counts["mxu_kernel"] > 0 and counts["mxu_occl_kernel"] > 0,
          "flagship fwd+bwd under the spies launched no K1 or K2")


def gib_above(fn):
    """fn()'s peak device memory above what was allocated before it, GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def tile_layer_phase(card, seen):
    """Where config 5's forward goes: each layer of the tile search and the
    occlusion alone on the frame's wavefronts (CUDA events, median of 3),
    with the peak memory of each entry point. The list builder runs only on
    the plain path (CPU tensors); it is timed here for comparison."""
    _, po, pd, tris, eps, ptl = seen[0]
    _, so, sd, _, _, stl = seen[1]
    found = tables.Tables(tris)
    (tc_p, ab_p, _), = found.segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT)
    (tc_s, ab_s, _), = found.segments(tables.pack_planes, rt_tile.TILE_TRI_LIMIT, True)
    eps_t = tables.eps_tensor(eps, po.device)
    with torch.no_grad():
        ov = found.oversized()
        prim, shad = tables.pad_rays(po, pd, ptl), tables.pad_rays(so, sd, stl)
        entries = {"tile_tri_search": lambda: rt_tile.tile_tri_search(po, pd, tris, eps, ptl),
                   "tile_occlusion": lambda: rt_tile.tile_occlusion(so, sd, stl, tris, eps)}
        for what, fn in entries.items():
            say(f"layer config 5: {what}: peak {gib_above(fn):.2f} GiB above its inputs  [{card}]")
        layers = {
            "cluster sort + pack (per search)": lambda: tile_segments(tris),
            "pad rays (per search)": lambda: tables.pad_rays(po, pd, ptl),
            "K5 alone (cull + sweep)": lambda: rt_tile.tile_kernel(eps_t, prim, ab_p, tc_p),
            "tile_tri_search (incl. K5)": entries["tile_tri_search"],
            "K6 alone (cull + sweep + oversized)": lambda: rt_tile.tile_occl_kernel(
                eps_t, shad, ab_s, tc_s, ov),
            "tile_occlusion (incl. K6)": entries["tile_occlusion"],
            "plain path only: list builder, primary": lambda: rt_tile._lists(prim, ab_p),
            "plain path only: list builder, shadow": lambda: rt_tile._lists(shad, ab_s),
        }
        for name, fn in layers.items():
            fn()
            t = statistics.median(elapsed_ms(fn, "cuda") for _ in range(3))
            say(f"layer config 5: {name:40s} {t:8.3f} ms  [{card}]")


def fused_feeder_check(card, scene, cam, w, h, cfg):
    """Cornell on the card, under counting spies on `build_clusters` and
    `lane_tri_constants`: the forward is exactly one table build and one K3
    launch and calls neither; the fwd+bwd step adds exactly two K4 launches
    (the backward's camera and shadow searches) and builds no constants on
    the host; `lane_tri_search` is one launch per call."""
    step = make_step(scene, *rays(cam, w, h), cfg)
    calls = {}
    saved = {(mod, name): getattr(mod, name)
             for mod, name in ((clusters, "build_clusters"), (lane_pallas, "lane_tri_constants"))}

    def spy(key, fn):
        def counted(*a, **kw):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **kw)
        return counted

    for (mod, name), fn in saved.items():
        setattr(mod, name, spy(name, fn))
    try:
        got = {}
        for what, backward in (("forward", False), ("fwd+bwd", True)):
            launches.reset()
            with torch.set_grad_enabled(backward):
                step(0, backward)
            got[what] = launches.read()
        o, d, _ = rays(cam, w, h)
        launches.reset()
        with torch.no_grad():
            lane_pallas.lane_tri_search(o, d, scene.triangles, float(cfg.eps))
        got["lane_tri_search"] = launches.read()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    say(f"Cornell feeder check [{card}]: launches {got}; host table builders called {calls}")
    want = {"forward": dict(fused_tables=1, fused_kernel=1),
            "fwd+bwd": dict(fused_tables=1, fused_kernel=1, lane_kernel=2),
            "lane_tri_search": dict(lane_kernel=1)}
    for what, counts in got.items():
        expect = {name: want[what].get(name, 0) for name in KERNELS}
        check(counts == expect, f"Cornell {what}: launches {counts}, want {expect}")
    check(not calls, f"Cornell on the card called the host table builders: {calls}")


def fused_layer_phase(card, label, scene, cam, w, h, cfg):
    """Where a fused path's time goes: the table build (one launch) and its
    plain tensor-op version on the card, K3 alone, `lane_tri_search` (one
    launch) on the frame's camera rays, and the backward's re-derivation
    forward alone on its route (CUDA events, median of 3)."""
    o, d, ids = rays(cam, w, h)
    with torch.no_grad():
        tables = fused_pallas.fused_tables(scene)
        kw = dict(seed=cfg.seed, eps=float(cfg.eps), shadow_eps=float(cfg.shadow_eps),
                  depth=cfg.depth, lights=scene.lights.num_lights, faces=scene.lights.max_faces)
        fb = fused_pallas._bwd_cfg(scene, cfg, o.shape[0])
        layers = {
            "fused_tables (per call: one launch)": lambda: fused_pallas.fused_tables(scene),
            "plain path only: tensor-op tables on the card":
                lambda: fused_pallas._fused_tables_plain(scene),
            "K3 alone": lambda: fused_pallas.fused_kernel(o, d, ids, *tables, **kw),
            "lane_tri_search (per call: one launch), camera rays":
                lambda: lane_pallas.lane_tri_search(o, d, scene.triangles, float(cfg.eps)),
            f"backward's re-derivation, forward only ({fb.backend}, chunk {fb.ray_chunk})":
                lambda: trace_rays(o, d, scene, ids, fb),
        }
        for name, fn in layers.items():
            fn()
            t = statistics.median(elapsed_ms(fn, "cuda") for _ in range(3))
            say(f"layer {label}: {name:58s} {t:8.3f} ms  [{card}]")


def profile_phase(card, cases):
    """Where each path's fwd+bwd step goes on the card. Per path: the host's
    wall time per step without the profiler (median of 3), then one step
    under torch.profiler: the device operations it ran (kernels, copies,
    fills), their summed device time, the share of the step's wall time the
    card was busy (one stream, so the operations do not overlap), and the
    costliest operations by name."""
    from torch.profiler import ProfilerActivity, profile

    for label, (scene, cam, w, h, cfg) in cases.items():
        o, d, ids = rays(cam, w, h)
        if label.endswith("(graphed)"):  # path M's step, one CUDA graph
            _, call = graphed_frame(scene, o, d, cfg)
            step = lambda k: call(ids + k * ids.shape[0])  # noqa: E731
            step(-1)  # the first call runs eagerly, the next captures
        else:
            step = make_step(scene, o, d, ids, cfg)
        step(0)
        walls = []
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(1 + k)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU]):
            step(4)  # a graphed step's first call under a profiler captures its spanned twin
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(4)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        check(len(ops) > 0, f"profile {label}: the profiler recorded no device operation")
        by_name = {}
        for e in ops:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy = sum(ms for ms, _ in by_name.values())
        wall = statistics.median(walls)
        say(f"profile {label}: {len(ops)} device operations and {busy:.2f} ms of device time "
            f"per fwd+bwd step; wall {wall:.2f} ms per step without the profiler (median of "
            f"{[round(x, 2) for x in walls]}), {prof_wall:.2f} ms under it; device busy "
            f"{busy / prof_wall:.1%} of the profiled step, {busy / wall:.1%} of the median "
            f"unprofiled one  [{card}]")
        for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
            say(f"profile {label}:   {ms:8.2f} ms x {n:5d}  {name[:100]}")
        graphs.clear()


# --------------------------------------------------------------------------
# Path G: the reference's own entry point (OBJ in, P3 PPM out)
# --------------------------------------------------------------------------


def cli_run(card, label, argv, mode, need, results):
    """cli.main(argv) with the launch counters set to 0 just before and read
    just after: exit 0, the stderr block's `Mode` and each kernel of `need`
    launched. Returns (wall ms, the CLI's own Duration line)."""
    err = io.StringIO()
    launches.reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = (time.perf_counter() - t0) * 1e3
    counts = launches.read()
    text = err.getvalue()
    say(f"{label}: python -m esctp1raytracer_tpu_torch {' '.join(argv)}: exit {rc}, "
        f"launches {counts}, wall {wall:.1f} ms  [{card}]")
    for line in text.strip("\n").splitlines():
        say(f"  stderr| {line}")
    check(rc == 0, f"{label}: the CLI exited {rc}")
    check(f"Mode      : {mode}" in text, f"{label}: stderr does not show Mode {mode}")
    for name in need:
        check(counts[name] > 0, f"{label}: {name} was not launched")
    for name, n in counts.items():
        results[name]["launches"] += n
    duration = [ln.strip() for ln in text.splitlines() if "Duration" in ln]
    return wall, duration[0] if duration else ""


def same_ppm(label, cli_ppm, scene, cam, w, h, cfg, tmp):
    """The CLI's PPM equals, byte for byte, the PPM of `render` called
    directly on the same scene and camera; returns the direct render's
    wall ms (the card synchronised) and its image on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render(scene, cam, w, h, cfg)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    direct = str(Path(tmp) / f"{label}-direct.ppm")
    write_ppm(direct, img)
    same = Path(cli_ppm).read_bytes() == Path(direct).read_bytes()
    say(f"{label}: CLI PPM vs direct render's PPM ({w}x{h}): "
        f"{'byte-identical' if same else 'DIFFERENT'}")
    check(same, f"{label}: the CLI's PPM differs from the direct render's")
    return ms, img.cpu().numpy()


def golden_leg(card, obj, results, seeds=8, scale=4):
    """The Cornell OBJ at 1024x768 in light_mode="reference_cpp" (auto ->
    lane: K4), one frame per seed, each clamped at 1, their mean and the
    golden (the reference C++ binary's 6-run mean) box-averaged by `scale`,
    held to tests/test_golden.py's bars."""
    scene = scene_from_mesh(load_obj_with_mat(obj))
    cam = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1024 / 768)
    cfgs = [RenderConfig(backend="auto", light_mode="reference_cpp", shadow_eps=1.1920929e-07,
                         seed=s) for s in range(seeds)]
    check(resolve_backend(cfgs[0], scene) == "lane",
          f"golden: auto resolves to {resolve_backend(cfgs[0], scene)!r}, not 'lane'")
    launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = [torch.clamp(render(scene, cam, 1024, 768, cfg), max=1.0) for cfg in cfgs]
    mean = torch.stack(frames).mean(0).cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    counts = launches.read()
    check(counts["lane_kernel"] > 0, "golden: K4 was not launched")
    for name, n in counts.items():
        results[name]["launches"] += n

    def box(img, k):
        hh, ww, c = img.shape
        return img.reshape(hh // k, k, ww // k, k, c).mean((1, 3))

    gold = box(np.load(GOLDEN)["image"].astype(np.float32) / 255.0, scale)
    mine = box(mean, scale)
    patch = np.abs(box(gold, 8) - box(mine, 8)).max(-1)
    hh, ww, _ = gold.shape
    regions = {"left wall": (slice(hh // 3, hh // 2), slice(0, ww // 12)),
               "right wall": (slice(hh // 3, hh // 2), slice(ww - ww // 12, ww)),
               "back wall top": (slice(2 * hh // 3, 3 * hh // 4), slice(ww // 3, 2 * ww // 3))}
    region_err = {name: float(np.abs(mine[rs, cs].mean((0, 1)) - gold[rs, cs].mean((0, 1))).max())
                  for name, (rs, cs) in regions.items()}
    out = {"mean_diff": float(abs(mine.mean() - gold.mean())),
           "patch_median": float(np.median(patch)), "patch_share_below_0.12":
           float((patch < 0.12).mean()), "region_max_err": region_err, "seeds": seeds,
           "frames_ms": ms, "launches": counts["lane_kernel"]}
    say(f"golden (Cornell OBJ, 1024x768, {seeds} seeds, reference_cpp, lane/K4, compared at "
        f"{1024 // scale}x{768 // scale}): |mean diff| {out['mean_diff']:.5f} (< 0.02), patch "
        f"median {out['patch_median']:.5f} (< 0.03), share of patches < 0.12 "
        f"{out['patch_share_below_0.12']:.4f} (> 0.9), region max errors "
        f"{ {k: round(v, 5) for k, v in region_err.items()} } (< 0.08); {seeds} frames + mean "
        f"{ms:.1f} ms wall  [{card}]")
    check(out["mean_diff"] < 0.02, f"golden: |mean diff| {out['mean_diff']} >= 0.02")
    check(out["patch_median"] < 0.03, f"golden: patch median {out['patch_median']} >= 0.03")
    check(out["patch_share_below_0.12"] > 0.9,
          f"golden: {out['patch_share_below_0.12']} of patches < 0.12, not > 0.9")
    for name, err in region_err.items():
        check(err < 0.08, f"golden: {name} colour off by {err} >= 0.08")
    return out


def entry_point_phase(card, results):
    """Path G: the host libraries built; the Cornell OBJ and the flagship's
    meshes (as an OBJ) through the CLI, each PPM equal to a direct render's;
    the golden leg."""
    for name, fn in NATIVE.items():
        check(fn(), f"native {name} is not available: {nativebuild.last_build_error()}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # Cornell, --ispc: auto -> fused (the table build and K3).
        obj, ppm = str(Path(tmp) / "cornell.obj"), str(Path(tmp) / "cornell.ppm")
        write_cornell_obj(obj)
        wall, duration = cli_run(card, "G Cornell", ["-m", obj, "-v", "0,1,2", "-l", "0,1,0",
                                                     "-w", "1024,768", "--ispc", "-o", ppm],
                                 "single/auto", ["fused_tables", "fused_kernel"], results)
        check(read_ppm(ppm).shape == (768, 1024, 3), "G Cornell: the PPM's shape")
        scene = scene_from_mesh(load_obj_with_mat(obj))
        cam = Camera.look_at((0.0, 1.0, 2.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1024 / 768)
        check(resolve_backend(RenderConfig(backend="auto"), scene) == "fused",
              "G Cornell: auto does not resolve to fused")
        same_ppm("G Cornell", ppm, scene, cam, 1024, 768, RenderConfig(backend="auto"), tmp)
        out["cornell"] = {"cli_wall_ms": wall, "cli_duration": duration}

        # The flagship's meshes written as an OBJ, --ispc: auto -> mxtile (K1, K2).
        obj, ppm = str(Path(tmp) / "bench.obj"), str(Path(tmp) / "bench.ppm")
        write_obj(obj, bench_meshes())
        t0 = time.perf_counter()
        meshes = native_loader.load_obj_native(obj)
        load_native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        scene = scene_from_mesh(load_obj_with_mat(obj))
        torch.cuda.synchronize()
        load_py_ms = (time.perf_counter() - t0) * 1e3
        n_valid, cap = int(scene.triangles.valid.sum()), scene.triangles.capacity
        say(f"G flagship OBJ: {sum(m.num_faces for m in meshes)} triangles; loaded table "
            f"{n_valid} valid in {cap} slots")
        check((n_valid, cap) == (10_244, 10_752), f"G flagship: table {n_valid}/{cap}")
        check(resolve_backend(RenderConfig(backend="auto"), scene) == "mxtile",
              "G flagship: auto does not resolve to mxtile")
        wall, duration = cli_run(card, "G flagship", ["-m", obj, "-v", "0,2,6", "-l", "0,1,0",
                                                      "-w", "1920,1080", "--ispc", "-o", ppm],
                                 "single/auto", ["mxu_kernel", "mxu_occl_kernel"], results)
        cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=1920 / 1080)
        render_ms, img = same_ppm("G flagship", ppm, scene, cam, 1920, 1080,
                                  RenderConfig(backend="auto"), tmp)
        t0 = time.perf_counter()
        native_ppm.write_ppm_native(str(Path(tmp) / "native.ppm"), img)
        write_native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        write_ppm_python(str(Path(tmp) / "python.ppm"), img)
        write_py_ms = (time.perf_counter() - t0) * 1e3
        check((Path(tmp) / "native.ppm").read_bytes() == (Path(tmp) / "python.ppm").read_bytes(),
              "G flagship: the native and Python PPM writers differ at 1920x1080")
        say(f"G flagship 1920x1080 [{card}]: native OBJ load {load_native_ms:.1f} ms (Python "
            f"loader + table to the card {load_py_ms:.1f} ms), render {render_ms:.1f} ms wall "
            f"(card synchronised), native PPM write {write_native_ms:.1f} ms (Python writer "
            f"{write_py_ms:.1f} ms, byte-identical); CLI wall {wall:.1f} ms, {duration}")
        out["flagship"] = {"cli_wall_ms": wall, "cli_duration": duration,
                           "native_load_ms": load_native_ms, "python_load_ms": load_py_ms,
                           "render_ms": render_ms, "native_write_ms": write_native_ms,
                           "python_write_ms": write_py_ms}
        out["golden"] = golden_leg(card, str(Path(tmp) / "cornell.obj"), results)
    return out


# --------------------------------------------------------------------------
# Path H: training on one rank (fit_scene: Adam and checkpoints)
# --------------------------------------------------------------------------


def training_phase(card, results, scene, cam, w, h, cfg, steps=6, every=3, lr=0.05):
    """Path H: `fit_scene` on the flagship, the target its true render, the
    start with the triangles' kd halved and `param_filter` fitting
    triangles.kd: `steps` Adam steps with a checkpoint every `every`, then a
    second run resumed from the step-`every` checkpoint (copied aside by a
    spy on `save_checkpoint` before the first run overwrites it). Checks:
    the loss falls; one K1, one K2 and one Adam launch per step (an eager
    first call's strided gradients made contiguous); the resumed run's
    losses and kd equal the uninterrupted run's within RESUME_RTOL and
    RESUME_ATOL (the backward's `index_add_` atomics make the card's
    gradients differ in the last bits from run to run); the checkpoint
    loaded into a fresh template equals `scene_to_numpy` of the fitted
    scene. Times: each step (host clock between the Adam updates, the card
    synchronised, checkpoint writes taken out), the Adam update alone,
    `save_checkpoint` and `load_checkpoint`, and the peak memory."""
    with torch.no_grad():
        target = render(scene, cam, w, h, cfg)
    start = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, kd=scene.triangles.kd * 0.5))

    def fit_kd(i, leaf):
        return leaf is start.triangles.kd

    real_adam, real_save = optimize.adam_update, optimize.save_checkpoint
    log = {"adam_ms": [], "ends": [], "saves": []}

    def adam_spy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_adam(*a, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        log["adam_ms"].append((t1 - t0) * 1e3)
        log["ends"].append(t1)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        path, aside = str(Path(tmp) / "fit.npz"), str(Path(tmp) / f"fit_step{every}.npz")

        def save_spy(where, sc, step, extra=None):
            t0 = time.perf_counter()
            real_save(where, sc, step, extra)
            log["saves"].append((t0, time.perf_counter()))
            if where == path and step == every:
                shutil.copy(path, aside)

        runs = {}
        optimize.adam_update, optimize.save_checkpoint = adam_spy, save_spy
        try:
            for what, ck in (("uninterrupted", path), ("resumed", aside)):
                for key in log:
                    log[key] = []
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                launches.reset()
                t_start = time.perf_counter()
                fit = fit_scene(start, target, cam, steps=steps, lr=lr, cfg=cfg,
                                param_filter=fit_kd, checkpoint_path=ck, checkpoint_every=every,
                                log_every=0)
                counts = launches.read()
                adam_counts = launches.read(launches.ADAM)
                ends = [t_start] + log["ends"]
                step_ms = [(b - a) * 1e3 - sum((s1 - s0) * 1e3 for s0, s1 in log["saves"]
                                                if a <= s0 < b)
                           for a, b in zip(ends, ends[1:])]
                runs[what] = dict(fit=fit, counts=counts, step_ms=step_ms,
                                  adam_ms=list(log["adam_ms"]),
                                  save_ms=[(s1 - s0) * 1e3 for s0, s1 in log["saves"]],
                                  peak_gib=torch.cuda.max_memory_allocated() / 2**30)
                n = fit.steps
                say(f"H {what}: {n} steps, losses {[f'{x:.6e}' for x in fit.losses]}, launches "
                    f"{counts}")
                for name in KERNELS:
                    want = n if name in ("mxu_kernel", "mxu_occl_kernel") else 0
                    check(counts[name] == want, f"H {what}: {name} launched {counts[name]} "
                          f"times in {n} steps, want {want}")
                    results[name]["launches"] += counts[name]
                check(adam_counts == {"adam_step": n}, f"H {what}: Adam launched "
                      f"{adam_counts} in {n} steps, want one a step")
                results["adam_step"]["launches"] += n
        finally:
            optimize.adam_update, optimize.save_checkpoint = real_adam, real_save
        whole, rest = runs["uninterrupted"]["fit"], runs["resumed"]["fit"]
        check(whole.steps == steps and rest.steps == steps - every,
              f"H: {whole.steps} and {rest.steps} steps, want {steps} and {steps - every}")
        check(whole.losses[-1] < whole.losses[0],
              f"H: the loss did not fall: {whole.losses[0]} -> {whole.losses[-1]}")
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(rest.losses, whole.losses[every:]))
        kd_err = (rest.scene.triangles.kd - whole.scene.triangles.kd).abs().max().item()
        kd_moved = (whole.scene.triangles.kd - start.triangles.kd).abs().max().item()
        say(f"H resumed vs uninterrupted: losses within {loss_rel:.3e} relative (< "
            f"{RESUME_RTOL}), kd within {kd_err:.3e} (< {RESUME_ATOL}; the fit moved kd by up "
            f"to {kd_moved:.4f})")
        check(loss_rel < RESUME_RTOL, f"H: resumed losses off by {loss_rel} relative")
        check(kd_err < RESUME_ATOL, f"H: resumed kd off by {kd_err}")

        fresh = bench_scene()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded, step, extra = load_checkpoint(path, fresh)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        check(step == steps and int(extra["adam_t"]) == steps, f"H: checkpoint at step {step}")
        want, got = scene_to_numpy(whole.scene), scene_to_numpy(loaded)
        check(list(got) == list(want), "H: the loaded checkpoint's leaves differ in name")
        for name in want:
            check(got[name].dtype == want[name].dtype and np.array_equal(got[name], want[name]),
                  f"H: loaded leaf {name} differs from the fitted scene's")
        check(all(a.device == b.device for (_, a), (_, b) in zip(loaded.leaves(), fresh.leaves())),
              "H: the loaded checkpoint's leaves are not on the template's device")
        size_mib = Path(path).stat().st_size / 2**20
    u = runs["uninterrupted"]
    out = {"steps": steps, "first_step_ms": u["step_ms"][0],
           "warm_step_ms": statistics.median(u["step_ms"][1:]), "step_ms": u["step_ms"],
           "adam_ms": statistics.median(u["adam_ms"]), "save_ms": u["save_ms"],
           "load_ms": load_ms, "checkpoint_mib": size_mib, "peak_gib": u["peak_gib"],
           "resumed_step_ms": runs["resumed"]["step_ms"], "losses": whole.losses,
           "resume_loss_rel": loss_rel, "resume_kd_err": kd_err}
    say(f"H flagship fit_scene {w}x{h} [{card}]: first step {out['first_step_ms']:.1f} ms, "
        f"warm step {out['warm_step_ms']:.1f} ms median of "
        f"{[round(x, 1) for x in u['step_ms'][1:]]}, Adam update {out['adam_ms']:.2f} ms, "
        f"save_checkpoint {[round(x, 1) for x in u['save_ms']]} ms ({size_mib:.2f} MiB), "
        f"load_checkpoint {load_ms:.1f} ms, peak {out['peak_gib']:.2f} GiB")
    return out


# --------------------------------------------------------------------------
# Path I: the sharded renderer and trainer, ranks on the one card
# --------------------------------------------------------------------------


def image_agreement(label, got, want, held=True):
    """tests/test_sharding.py's image bar: < 0.5% of pixels off by more than
    1e-3, the median within 1e-5 (held unless `held` is false: then only
    printed)."""
    diff = np.abs(got - want).max(-1)
    flipped, median = float((diff > 1e-3).mean()), float(np.median(diff))
    say(f"  {label}: image share of pixels off by > 1e-3 {flipped:.5f} (< 0.005), median "
        f"{median:.2e} (< 1e-5){'' if held else ', printed only'}")
    if held:
        check(flipped < 0.005 and median < 1e-5, f"{label}: the sharded image disagrees")
    return {"flipped": flipped, "median": median}


def grads_agreement(label, loss, grads, ref_loss, ref_grads):
    """The loss within 1e-5 relative (unless both are None) and each leaf
    within tests/test_sharding.py:150-155's bars: |g - ref| <= 3e-4 * max|ref|
    + 3e-3 * |ref|."""
    loss_rel = (0.0 if loss is None and ref_loss is None
                else abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)))
    worst = 0.0
    for g, r in zip(grads, ref_grads):
        scale = max(float(np.abs(r).max()), 1e-6)
        worst = max(worst, float((np.abs(g - r) / (3e-4 * scale + 3e-3 * np.abs(r))).max()))
    say(f"  {label}: loss within {loss_rel:.2e} relative (< 1e-5), worst gradient element at "
        f"{worst:.3f} of its bar")
    check(len(grads) == len(ref_grads) and loss_rel < 1e-5 and worst <= 1.0,
          f"{label}: the sharded loss or gradients disagree")
    return {"loss_rel": loss_rel, "worst_of_bar": worst}


def reference_grads(scene, cam, w, h, cfg):
    """Single device: mean(render^2) (target 0) and its gradients with
    respect to every float leaf, from torch.autograd.grad, on the host."""
    params = [p.detach().requires_grad_(True) for p in float_params(scene)]
    loss = torch.mean(render(merge_params(scene, params), cam, w, h, cfg) ** 2)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [np.zeros(tuple(p.shape), np.float32) if g is None
                         else g.cpu().numpy() for p, g in zip(params, grads)]


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_leg(leg, world, out_dir, timeout=600, path="I"):
    """Run `leg` as `world` ranks of this script (the torchrun environment,
    one shared deadline); any rank's failure or time-out fails the run."""
    port, procs = free_port(), []
    try:
        for rank in range(world):
            env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                       LOCAL_WORLD_SIZE=str(world))
            with open(Path(out_dir) / f"{leg}_rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--rank-leg", leg,
                     "--out", str(out_dir)], stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=str(Path(__file__).resolve().parent)))
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        check(False, f"{path} {leg}: a rank did not finish within {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, p in enumerate(procs):
        if p.returncode != 0:
            tail = (Path(out_dir) / f"{leg}_rank{rank}.log").read_text()[-4000:]
            print(tail, file=sys.stderr)
        check(p.returncode == 0, f"{path} {leg}: rank {rank} exited {p.returncode}")
    infos = [json.loads((Path(out_dir) / f"{leg}_rank{r}.json").read_text())
             for r in range(world)]
    with np.load(Path(out_dir) / f"{leg}.npz") as data:
        arrays = dict(data)
    return infos, arrays


def sharded_phase(card, results, flag, flag_cam, corn, corn_cam):
    """Path I: the sharded renderer and trainer, ranks of this script on the
    one card (`--rank-leg`): (a) one rank over NCCL, (b) two over gloo, rays
    = 2, on the flagship and on Cornell, (c) four over gloo, rays = 2 x
    prims = 2, on the flagship; each against the unsharded run computed
    here with the same search: "auto" for (a) and (b), and for (c), whose
    prims split scans with `_scan_blocks` (tensor ops, as the JAX package
    does), the unsharded "mxu" route, which runs that scan on one device
    (its image against "auto"'s mxtile is printed beside)."""
    (fw, fh), (cw, ch) = FLAG_WH, CORN_WH
    auto = RenderConfig(backend="auto")
    with torch.no_grad():
        ref = {"flag_image": render(flag, flag_cam, fw, fh, auto).cpu().numpy(),
               "corn_image": render(corn, corn_cam, cw, ch, auto).cpu().numpy(),
               "flag_image_mxu": render(flag, flag_cam, fw, fh, PRIMS_CFG.replace(
                   backend="mxu")).cpu().numpy()}
    ref["flag"] = reference_grads(flag, flag_cam, fw, fh, auto)
    ref["corn"] = reference_grads(corn, corn_cam, cw, ch, auto)
    ref["flag_mxu"] = reference_grads(flag, flag_cam, fw, fh, PRIMS_CFG.replace(backend="mxu"))
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for leg, world in (("nccl1", 1), ("gloo2", 2), ("gloo4", 4)):
            t0 = time.perf_counter()
            infos, arrays = spawn_leg(leg, world, tmp)
            wall = time.perf_counter() - t0
            info = infos[0]
            say(f"I {leg}: {world} rank(s), backend {info['backend']}, mesh {info['mesh']}, "
                f"wall {wall:.1f} s (process start included)  [{card}]")
            for r in infos:
                for sub, counts in r["launches"].items():
                    for name, n in counts.items():
                        results[name]["launches"] += n
            rec = {"world": world, "backend": info["backend"], "mesh": info["mesh"],
                   "wall_s": wall, "launches_rank0": info["launches"], "timings": info["timings"]}
            for key, t in info["timings"].items():
                say(f"  {key}: {t['ms']:.1f} ms median of {[round(x, 1) for x in t['runs']]}; "
                    f"all-reduce {t['all_reduce_ms']:.2f} ms in {t['all_reduce_calls']} calls = "
                    f"{100 * t['all_reduce_share']:.1f}% of a {t['spied_ms']:.1f} ms step "
                    f"timed with the card synchronised around each  [{card}]")
            say(f"  launches per call, rank 0: {info['launches']}")
            for what in [k for k in ("flag", "corn") if f"{k}_loss" in arrays]:
                n = len(ref[what][1])
                grads = [arrays[f"{what}_g{i}"] for i in range(n)]
                ref_key = "flag_mxu" if leg == "gloo4" else what
                rec[f"{what}_grads"] = grads_agreement(
                    f"{leg} {what} loss_and_grad_sharded vs unsharded ({ref_key})",
                    arrays[f"{what}_loss"], grads, *ref[ref_key])
            for what in [k for k in ("flag", "corn") if f"{k}_image" in arrays]:
                ref_key = "flag_image_mxu" if leg == "gloo4" else f"{what}_image"
                rec[f"{what}_image"] = image_agreement(
                    f"{leg} {what} render_sharded vs render ({ref_key})", arrays[f"{what}_image"],
                    ref[ref_key])
                if leg == "gloo4":
                    rec["flag_image_vs_auto"] = image_agreement(
                        f"{leg} {what} render_sharded vs render (auto: mxtile)",
                        arrays[f"{what}_image"], ref["flag_image"], held=False)
            for what in ("flag", "corn"):
                losses = {r.get(f"{what}_train_loss") for r in infos}
                if f"{what}_train_loss" in info:
                    say(f"  {leg} {what} train_step_sharded: loss {losses} on {world} ranks, "
                        f"parameters moved on every rank: {all(r[what + '_moved'] for r in infos)}")
                    check(len(losses) == 1, f"I {leg} {what}: the ranks' losses differ: {losses}")
                    check(all(r[what + "_moved"] for r in infos),
                          f"I {leg} {what}: a train step moved no parameter")
            expect_leg_launches(leg, infos)
            out[leg] = rec
    one, two = out["nccl1"]["timings"]["flag_grad"]["ms"], out["gloo2"]["timings"]["flag_grad"]["ms"]
    out["gloo2_over_nccl1_flag_grad"] = two / one
    say(f"I: the flagship's sharded loss+grad, two gloo ranks {two:.1f} ms vs one NCCL rank "
        f"{one:.1f} ms = {two / one:.2f}x  [{card}]")
    return out


def expect_leg_launches(leg, infos):
    """The kernels each rank launched per call: K1/K2 once each per flagship
    render or loss+grad on a rays-only mesh; Cornell's render one table
    build and one K3, its loss+grad also two K4 (the backward's searches);
    none on the prims split, which runs the tensor-op `_scan_blocks`."""
    flag = dict(mxu_kernel=1, mxu_occl_kernel=1)
    want = {"flag_render": flag, "flag_grad": flag,
            "corn_render": dict(fused_tables=1, fused_kernel=1),
            "corn_grad": dict(fused_tables=1, fused_kernel=1, lane_kernel=2)}
    for r, info in enumerate(infos):
        for sub, counts in info["launches"].items():
            expect = {name: 0 if leg == "gloo4" else want[sub].get(name, 0) for name in KERNELS}
            check(counts == expect, f"I {leg} rank {r} {sub}: launches {counts}, want {expect}")


def timed_call(fn, reps=3):
    """fn() once to warm, then `reps` timed runs (ranks lined up by a barrier,
    host clock, the card synchronised), then one run with every all-reduce
    timed alone (the card synchronised around each): its share of that run."""
    fn()
    runs = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    real, spent = dist.all_reduce, []

    def spy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return res

    dist.barrier()
    torch.cuda.synchronize()
    dist.all_reduce = spy
    try:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        spied = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce = real
    return {"ms": statistics.median(runs), "runs": runs, "spied_ms": spied,
            "all_reduce_ms": sum(spent), "all_reduce_calls": len(spent),
            "all_reduce_share": sum(spent) / spied}


def rank_main(leg, out_dir):
    """One rank of a path-I leg: join the group from the torchrun environment
    (the backend by `init_distributed`'s rule: NCCL for one rank on the one
    card, gloo for ranks that share it), run the leg's calls once with the
    launch counters set to 0 just before and read just after each, time
    them, and write the results (arrays from rank 0)."""
    check(torch.cuda.is_available(), "a path-I rank needs the CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = init_distributed()
    check(world == int(os.environ["WORLD_SIZE"]), f"init_distributed gave world {world}")
    backend = dist.get_backend()
    check(backend == ("nccl" if world == 1 else "gloo"), f"{world} rank(s) chose {backend}")
    rank = dist.get_rank()
    try:
        mesh = make_mesh(**LEG_MESH[leg])
        info = {"backend": backend, "mesh": mesh.shape, "launches": {}, "timings": {}}
        arrays = {}
        cases = [("flag", bench_scene(), camera((0.0, 2.0, 6.0), *FLAG_WH), *FLAG_WH)]
        if leg == "gloo2":
            cases.append(("corn", cornell_box(), camera((0.0, 1.0, 2.0), *CORN_WH), *CORN_WH))
        cfg = PRIMS_CFG if leg == "gloo4" else RenderConfig(backend="auto")
        for what, scene, cam, w, h in cases:
            target = torch.zeros((h, w, 3), device=scene.triangles.v0.device)
            calls = {"grad": lambda: loss_and_grad_sharded(scene, target, cam, cfg, mesh)}
            if leg != "nccl1":
                calls["render"] = lambda: render_sharded(scene, cam, w, h, cfg, mesh)
            for sub, fn in calls.items():
                launches.reset()
                res = fn()
                info["launches"][f"{what}_{sub}"] = launches.read()
                if sub == "render":
                    arrays[f"{what}_image"] = res.cpu().numpy()
                else:
                    arrays[f"{what}_loss"] = res[0].cpu().numpy()
                    arrays.update({f"{what}_g{i}": g.cpu().numpy() for i, g in enumerate(res[1])})
                info["timings"][f"{what}_{sub}"] = timed_call(fn)
            if leg == "gloo2":
                new, loss = train_step_sharded(scene, target, cam, lr=1e-3, cfg=cfg, mesh=mesh)
                info[f"{what}_train_loss"] = float(loss).hex()
                info[f"{what}_moved"] = any(not torch.equal(a, b) for (_, a), (_, b)
                                            in zip(scene.leaves(), new.leaves()))
        (Path(out_dir) / f"{leg}_rank{rank}.json").write_text(json.dumps(info))
        if rank == 0:
            np.savez(Path(out_dir) / f"{leg}.npz", **arrays)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# Path J: the benchmark and matrix scripts, each as a user runs it
# --------------------------------------------------------------------------


def script_run(card, label, argv, out_dir, timeout, path="J"):
    """`python <argv>` from the repository root, its output to out_dir:
    exit 0 within `timeout` s, or the run fails. Returns (stdout, wall s)."""
    log = Path(out_dir) / f"{label}.log"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, *argv], capture_output=True, text=True,
                              timeout=timeout, cwd=str(REPO))
    except subprocess.TimeoutExpired:
        check(False, f"{path} {label}: {' '.join(argv)} did not finish within {timeout} s")
    wall = time.perf_counter() - t0
    log.write_text(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    say(f"{path} {label}: python {' '.join(argv)}: exit {proc.returncode}, wall {wall:.1f} s "
        f"(process start included)  [{card}]")
    if proc.returncode != 0:
        print(proc.stdout[-3000:] + proc.stderr[-6000:], file=sys.stderr)
    check(proc.returncode == 0, f"{path} {label}: exit {proc.returncode}")
    return proc.stdout, wall


def expect_launches(label, counts, need, path="J"):
    """The kernels of `need` launched, every other kernel not."""
    for name in KERNELS:
        ok = counts[name] > 0 if name in need else counts[name] == 0
        check(ok, f"{path} {label}: {name} launched {counts[name]} times "
              f"({'want > 0' if name in need else 'want 0'}); all: {counts}")


def add_launches(results, counts):
    for name, n in counts.items():
        results[name]["launches"] += n


def bench_configs_leg(card, results, out_dir):
    """scripts/bench_configs_torch.py on all five configs (a subprocess
    each): the backends they resolve to, finite positive times, and the
    kernels each leg launched matched to its backend."""
    path = Path(out_dir) / "bench_configs.json"
    script_run(card, "bench_configs", ["scripts/bench_configs_torch.py", f"--json={path}"],
               out_dir, 900)
    records = json.loads(path.read_text())
    check([r["config"] for r in records] == list(BENCH_LEGS),
          f"J bench_configs: configs {[r['config'] for r in records]}")
    for r in records:
        backend, fwd_need, bwd_need = BENCH_LEGS[r["config"]]
        say(f"J bench_configs {r['config']}: backend {r['backend']}, {r['rays']} rays, "
            f"forward {r['forward_ms']:.3f} ms ({r['forward_rays_per_s'] / 1e6:.2f} Mrays/s, "
            f"peak {r['forward_peak_gib']:.2f} GiB), fwd+bwd {r['fwd_bwd_ms']:.3f} ms "
            f"({r['fwd_bwd_rays_per_s'] / 1e6:.2f} Mrays/s, peak {r['fwd_bwd_peak_gib']:.2f} "
            f"GiB); launches {r['launches']}  [{r['card']}]")
        check(r["backend"] == backend, f"J {r['config']}: backend {r['backend']}, not {backend}")
        for key in ("forward_ms", "fwd_bwd_ms", "forward_rays_per_s", "fwd_bwd_rays_per_s"):
            check(np.isfinite(r[key]) and r[key] > 0, f"J {r['config']}: {key} = {r[key]}")
        check(r["card"] == card, f"J {r['config']}: card {r['card']!r}")
        expect_launches(f"{r['config']} forward", r["launches"]["forward"], fwd_need)
        expect_launches(f"{r['config']} fwd+bwd", r["launches"]["fwd_bwd"], bwd_need)
        for leg in r["launches"].values():
            add_launches(results, leg)
    return records


def run_matrix_leg(card, results, out_dir):
    """scripts/run_matrix_torch.py at 1024x768, all five strategies, with the
    4-seed golden leg: every strategy matches the sequential one and the
    golden passes its bars."""
    path = Path(out_dir) / "run_matrix.json"
    stdout, _ = script_run(card, "run_matrix", [
        "scripts/run_matrix_torch.py", "--size", "1024x768", "--golden", str(GOLDEN),
        "--out", str(Path(out_dir) / "run_matrix"), "--json", str(path)], out_dir, 600)
    for line in stdout.strip().splitlines():
        say(f"  run_matrix| {line}")
    rec = json.loads(path.read_text())
    check(rec["backend_platform"] == "gpu" and rec["card"] == card,
          f"J run_matrix: platform {rec['backend_platform']}, card {rec['card']}")
    check([s["strategy"] for s in rec["strategies"]] == list(MATRIX_LEGS),
          f"J run_matrix: strategies {[s['strategy'] for s in rec['strategies']]}")
    for s in rec["strategies"]:
        expect_launches(f"run_matrix {s['strategy']}", s["launches"], MATRIX_LEGS[s["strategy"]])
        add_launches(results, s["launches"])
    g = rec["golden_vs_reference"]
    say(f"J run_matrix golden ({g['size']}, {g['seeds_averaged']} seeds, reference_cpp, jnp): "
        f"patch8 median {g['patch8_median']:.5f} (< 0.03), share < 0.12 "
        f"{g['patch8_frac_lt_0.12']:.5f} (> 0.9), |mean diff| {g['mean_lum_delta']:.5f} "
        f"(< 0.02), {g['render_4seed_ms']:.1f} ms for the 4 frames  [{card}]")
    check(g["pass"], f"J run_matrix: the golden leg misses its bars: {g}")
    check(rec["all_match"], f"J run_matrix: not all strategies match: "
          f"{rec['cross_check_flip_frac']}")
    return rec


def probe_leg(card, results, out_dir):
    """scripts/probe_device_loop_torch.py on the flagship and config 4,
    forward and --grad: the loop difference and the profiled device time
    per frame, and the kernels each frame launched."""
    out = {}
    for leg, extra in (("fwd", []), ("fwd+bwd", ["--grad"])):
        path = Path(out_dir) / f"probe_{'grad' if extra else 'fwd'}.json"
        script_run(card, f"probe {leg}", ["scripts/probe_device_loop_torch.py", "flagship",
                                          "mixed_1080p_d4", *extra, f"--json={path}"],
                   out_dir, 600)
        records = json.loads(path.read_text())
        check([r["config"] for r in records] == list(PROBE_LEGS),
              f"J probe {leg}: configs {[r['config'] for r in records]}")
        for r in records:
            say(f"J probe {r['config']} {r['leg']}: loop {r['frame_ms']:.3f} ms/frame (k "
                f"{r['loop_k']}, raw {r['raw_ms']}), profiled frame {r['device_frame_ms']:.3f} ms "
                f"of device time in {r['device_ops']} operations, busy "
                f"{r['busy_share']:.1%} of its {r['profiled_wall_ms']:.2f} ms; launches "
                f"{r['launches_per_frame']}  [{r['card']}]")
            check(r["leg"] == leg and r["device_frame_ms"] > 0 and r["device_ops"] > 0,
                  f"J probe {r['config']} {leg}: {r}")
            check(np.isfinite(r["frame_ms"]), f"J probe {r['config']} {leg}: frame_ms")
            expect_launches(f"probe {r['config']} {leg}", r["launches_per_frame"],
                            PROBE_LEGS[r["config"]][extra != []])
            add_launches(results, r["launches_per_frame"])
        out[leg] = records
    return out


def example_leg(card, out_dir):
    """examples/render_cornell_torch.py: its PPM byte-equal to the PPM of a
    direct render (Cornell 1024x768, backend mxu: tensor operations, no
    hand kernel)."""
    ppm = Path(out_dir) / "cornell_example.ppm"
    _, wall = script_run(card, "render_cornell", ["examples/render_cornell_torch.py", str(ppm)],
                         out_dir, 300)
    direct = Path(out_dir) / "cornell_direct.ppm"
    with torch.no_grad():
        img = render(cornell_box(), camera((0.0, 1.0, 2.0), 1024, 768), 1024, 768,
                     RenderConfig(backend="mxu"))
    write_ppm(str(direct), img)
    same = ppm.read_bytes() == direct.read_bytes()
    say(f"J render_cornell: the example's PPM vs a direct render's (1024x768, mxu): "
        f"{'byte-identical' if same else 'DIFFERENT'}")
    check(same, "J render_cornell: the example's PPM differs from a direct render's")
    return {"wall_s": wall}


def golden_pixels_leg(card, out_dir):
    """scripts/make_golden_pixels_torch.py with its render on the card: the
    grid equal to the committed tests/golden/cornell_pixels_48x36.npz."""
    path = Path(out_dir) / "cornell_pixels_48x36.npz"
    stdout, wall = script_run(card, "make_golden_pixels", [
        "scripts/make_golden_pixels_torch.py", "--out", str(path)], out_dir, 300)
    for line in stdout.strip().splitlines():
        say(f"  make_golden_pixels| {line}")
    with np.load(path) as got, np.load(REPO / "tests" / "golden" /
                                       "cornell_pixels_48x36.npz") as want:
        same = set(got.files) == set(want.files) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want.files)
    say(f"J make_golden_pixels: the card's grid vs the committed one: "
        f"{'equal' if same else 'DIFFERENT'}")
    check(same, "J make_golden_pixels: the grid differs from tests/golden/cornell_pixels_48x36.npz")
    return {"wall_s": wall}


def scaling_leg(card, out_dir):
    """scripts/bench_scaling_torch.py on the card: its ranks share the card
    (one by NCCL, two and four by gloo), every section in the report, and
    sharded(1) within its bar (exit 0)."""
    path = Path(out_dir) / "scaling.md"
    _, wall = script_run(card, "bench_scaling", ["scripts/bench_scaling_torch.py", "--out",
                                                 str(path)], out_dir, 600)
    text = path.read_text()
    for line in text.strip().splitlines():
        say(f"  bench_scaling| {line}")
    for row in ("1: nccl, 2: gloo, 4: gloo", "| sharded rays=4 | 4 |", "## Residual",
                "## Sharded fwd+bwd train step", "| 2 x 2 |", "| 1 x 4 |"):
        check(row in text, f"J bench_scaling: the report lacks {row!r}")
    check(text.rstrip().endswith("PASS"), "J bench_scaling: no PASS")
    return {"wall_s": wall}


def scripts_phase(card, results):
    """Path J: the benchmark and matrix scripts as subprocesses (reusing the
    kernels built in build/torch_kernels/), then, in this process, each
    kernel the scripts' new inputs reach against its plain version there:
    configs 1 and 2's table builds and K3 frames, the K4 wavefronts of
    their backward, and config 3's K1 and K2 wavefronts."""
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out["bench_configs"] = bench_configs_leg(card, results, tmp)
        out["run_matrix"] = run_matrix_leg(card, results, tmp)
        out["probe"] = probe_leg(card, results, tmp)
        out["example"] = example_leg(card, tmp)
        out["make_golden_pixels"] = golden_pixels_leg(card, tmp)
        out["bench_scaling"] = scaling_leg(card, tmp)
    auto = RenderConfig(backend="auto")
    for key, label, scene, eye, (w, h), depth in (
            ("config1", "config 1, sphere_plane 256x256, depth 1", sphere_plane_scene(),
             (0.0, 2.0, 6.0), (256, 256), 1),
            ("config2", "config 2, ten_sphere 512x512, depth 2", ten_sphere_scene(),
             (0.0, 4.0, 8.0), (512, 512), 2)):
        cfg = auto.replace(depth=depth)
        check(resolve_backend(cfg, scene) == "fused", f"J {label}: auto is not fused")
        results["fused_tables"][key] = fused_tables_check(card, label, scene)
        o, d, ids = rays(camera(eye, w, h), w, h)
        results["fused_kernel"][key] = fused_kernel_check(card, o, d, scene, ids, cfg, label,
                                                          iters_p=3)
        # The backward re-derives the frame on the lane route: K4 on each of
        # its wavefronts (camera and shadow rays per bounce).
        fb = fused_pallas._bwd_cfg(scene, cfg, o.shape[0])
        check(fb.backend == "lane" and not fb.ray_chunk,
              f"J {label}: the backward runs {fb.backend!r} in chunks of {fb.ray_chunk}")
        seen = capture_wavefronts(o, d, scene, ids, fb, lane_pallas.lane_tri_search)
        check(len(seen) == 2 * depth, f"J {label}: the backward made {len(seen)} searches, "
              f"want {2 * depth}")
        results["lane_kernel"][f"{key}_backward"] = [
            lane_check(card, f"{label} backward, search {k + 1} of {len(seen)}", wavefront)
            for k, wavefront in enumerate(seen)]
        del o, d, ids, seen
    scene3, w, h = mesh_scene(4), 1920, 1080
    check(resolve_backend(auto, scene3) == "mxtile", "J config 3: auto is not mxtile")
    o, d, ids = rays(camera((0.0, 2.0, 6.0), w, h), w, h)
    seen = capture_wavefronts(o, d, scene3, ids, auto, rt_mxu.mxu_tile_search,
                              rt_mxu.mxu_tile_occlusion)
    check(len(seen) == 2, f"J config 3 made {len(seen)} searches, want 2 (camera, shadow)")
    del o, d, ids
    mxtile_kernels(card, seen, results, "config 3, mesh_scene(4) 1920x1080", "config3")
    out["wall_s"] = time.perf_counter() - t0
    say(f"J: {out['wall_s']:.1f} s of smoke wall time  [{card}]")
    return out


# --------------------------------------------------------------------------
# Path K: the root entry points (bench_torch.py, entry_torch.py)
# --------------------------------------------------------------------------


# bench_torch.py's launches: one fwd+bwd step of the flagship (mxtile), one
# Cornell call (8 fused renders: a table build and K3 each).
BENCH_LAUNCHES = {"fwd_bwd": dict(mxu_kernel=1, mxu_occl_kernel=1),
                  "cornell": dict(fused_tables=8, fused_kernel=8)}
# entry_torch.dryrun_multichip: the kernels of each backend's sharded train
# step (jnp and mxu are tensor operations; auto is the fused route, its
# backward on lane). The legs: ranks of this script sharing the card.
DRYRUN_KERNELS = {"jnp": (), "mxu": (), "lane": K4, "tile": K56, "auto": K3 + K4}
DRYRUN_LEGS = {"dryrun2": 2, "dryrun4": 4}
DRYRUN_WH = 16  # the dry run's 16x16 target


def bench_leg(card, results, out_dir):
    """python3 bench_torch.py as a user runs it: exit 0, one JSON line with
    the mxtile headline, vs_baseline from the Cornell leg, the kernels
    already built (cache_hits), the launches of BENCH_LAUNCHES and no others."""
    stdout, wall = script_run(card, "bench_torch", ["bench_torch.py"], out_dir, 600, path="K")
    lines = stdout.strip().splitlines()
    check(len(lines) == 1, f"K bench_torch: {len(lines)} lines on stdout, want 1")
    rec = json.loads(lines[0])
    for line in (Path(out_dir) / "bench_torch.log").read_text().split("--- stderr ---")[1] \
            .strip().splitlines():
        say(f"  bench_torch| {line}")
    say(f"K bench_torch: {rec['value'] / 1e6:.3f} Mrays/s fwd+bwd ({rec['fwd_bwd_ms']:.3f} ms, "
        f"host {rec['host_ms']['fwd_bwd']:.3f}), forward {rec['fwd_ms']:.3f} ms (host "
        f"{rec['host_ms']['fwd']:.3f}), peaks {rec['peak_gib']['fwd']:.2f} / "
        f"{rec['peak_gib']['fwd_bwd']:.2f} GiB; Cornell {rec['cornell_ms']:.4f} ms per render "
        f"(host {rec['host_ms']['cornell']:.4f}), vs_baseline {rec['vs_baseline']}; setup "
        f"{rec['setup_compile_s']} s, libraries loaded built {rec['cache_hits']}, built now "
        f"{rec['cache_new_entries']}; launches {rec['launches']}  [{rec['card']}]")
    check(rec["metric"] == "rays_per_s_chip_fwd_bwd_1080p" and rec["backend"] == "auto"
          and rec["resolved_backend"] == "mxtile",
          f"K bench_torch: metric {rec['metric']}, backend {rec['backend']} -> "
          f"{rec['resolved_backend']}")
    check(rec["value"] > 0 and rec["vs_baseline"] is not None and rec["vs_baseline"] > 0,
          f"K bench_torch: value {rec['value']}, vs_baseline {rec['vs_baseline']}")
    check(rec["card"] == card and rec["device"] == {"platform": "gpu",
                                                    "kind": torch.cuda.get_device_name(0)},
          f"K bench_torch: card {rec['card']!r}, device {rec['device']}")
    check(rec["cache_hits"] == 2 and rec["cache_new_entries"] == 0,
          f"K bench_torch: {rec['cache_hits']} libraries loaded built, "
          f"{rec['cache_new_entries']} built (want rt_mxu and fused, built by phase 2)")
    for leg, want in BENCH_LAUNCHES.items():
        expect = {name: want.get(name, 0) for name in KERNELS}
        check(rec["launches"][leg] == expect,
              f"K bench_torch {leg}: launches {rec['launches'][leg]}, want {expect}")
        add_launches(results, rec["launches"][leg])
    rec["wall_s"] = wall
    return rec


def entry_leg(card, results):
    """entry_torch.entry() on the card: one K1 and one K2 launch, and the
    image against the same route's plain versions on a CPU copy of its
    inputs, under tests/test_rt_mxu.py's bar (mean difference < 1e-4, < 0.5%
    of values off by more than 1e-2)."""
    fn, args = entry_torch.entry()
    with torch.no_grad():
        img, counts = launches.counted(lambda: fn(*args))
    expect = {name: int(name in K12) for name in KERNELS}
    check(counts == expect, f"K entry: launches {counts}, want {expect}")
    add_launches(results, counts)
    scene, o, d, ids = args
    with torch.no_grad():
        plain = fn(scene.map(lambda _, t: t.cpu()), o.cpu(), d.cpu(), ids.cpu())
    diff = (img.cpu() - plain).abs()
    mean, off = diff.mean().item(), (diff > 1e-2).float().mean().item()
    check(bool(torch.isfinite(img).all()) and img.max().item() > 0, "K entry: the image")
    check(mean < 1e-4 and off < 5e-3, f"K entry: image vs the plain versions: mean {mean}, "
          f"share over 1e-2 {off}")
    with torch.no_grad():
        ms = statistics.median(elapsed_ms(lambda: fn(*args), "cuda", 5) for _ in range(3))
    say(f"K entry (mesh_scene(4), 128x128, auto -> {resolve_backend(RenderConfig(backend='auto'), scene)}): "
        f"{ms:.3f} ms per forward (median of 3 x 5); launches {counts}; vs the plain versions on "
        f"a CPU copy: mean diff {mean:.2e} (< 1e-4), share over 1e-2 {off:.5f} (< 0.005)  [{card}]")
    return {"ms": ms, "launches": counts, "image_mean_diff": mean, "image_share_over_1e-2": off}


def dryrun_rank_main(leg, out_dir):
    """One rank of a dry-run leg: join the group from the torchrun
    environment (gloo: the ranks share the card), run
    entry_torch.dryrun_multichip twice (the second warm, timed), write each
    backend's loss (hex) and launches of the first run; rank 0 also the
    losses as npz."""
    check(torch.cuda.is_available(), "a dry-run rank needs the CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = init_distributed()
    check(world == DRYRUN_LEGS[leg], f"init_distributed gave world {world}")
    check(dist.get_backend() == "gloo", f"{world} ranks chose {dist.get_backend()}")
    rank = dist.get_rank()
    try:
        t0 = time.perf_counter()
        res = entry_torch.dryrun_multichip(world)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        dist.barrier()
        t0 = time.perf_counter()
        again = entry_torch.dryrun_multichip(world)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) * 1e3
        info = {"first_ms": first, "warm_ms": warm,
                "losses": {b: float(r["loss"]).hex() for b, r in res.items()},
                "launches": {b: r["launches"] for b, r in res.items()},
                "warm_launches_same": all(again[b]["launches"] == r["launches"]
                                          for b, r in res.items())}
        (Path(out_dir) / f"{leg}_rank{rank}.json").write_text(json.dumps(info))
        if rank == 0:
            np.savez(Path(out_dir) / f"{leg}.npz",
                     **{b: np.float32(r["loss"]) for b, r in res.items()})
    finally:
        dist.destroy_process_group()


def dryrun_leg(card, results, leg, out_dir):
    """entry_torch.dryrun_multichip on DRYRUN_LEGS[leg] gloo ranks sharing
    the card: each backend's loss finite, equal on every rank and within
    1e-5 of jnp's, and each backend's kernels (DRYRUN_KERNELS) launched on
    every rank, no others."""
    world = DRYRUN_LEGS[leg]
    t0 = time.perf_counter()
    infos, _ = spawn_leg(leg, world, out_dir, timeout=300, path="K")
    wall = time.perf_counter() - t0
    losses = {b: float.fromhex(infos[0]["losses"][b]) for b in DRYRUN_KERNELS}
    say(f"K {leg}: {world} gloo ranks, wall {wall:.1f} s (process start included); rank 0's "
        f"dry run {infos[0]['first_ms']:.1f} ms, again {infos[0]['warm_ms']:.1f} ms (5 steps); "
        f"losses {losses}  [{card}]")
    for b, need in DRYRUN_KERNELS.items():
        seen = {info["losses"][b] for info in infos}
        check(len(seen) == 1, f"K {leg} {b}: the ranks' losses differ: {seen}")
        check(np.isfinite(losses[b]) and abs(losses[b] - losses["jnp"]) <= 1e-5 * abs(losses["jnp"]),
              f"K {leg} {b}: loss {losses[b]} against jnp's {losses['jnp']}")
        for r, info in enumerate(infos):
            expect_launches(f"{leg} rank {r} {b}", info["launches"][b], need, path="K")
            add_launches(results, info["launches"][b])
        check(all(info["warm_launches_same"] for info in infos),
              f"K {leg}: the second dry run launched other counts")
        say(f"  {leg} {b}: launches per rank {[info['launches'][b] for info in infos][0]}")
    return {"world": world, "wall_s": wall, "losses": losses,
            "first_ms": [info["first_ms"] for info in infos],
            "warm_ms": [info["warm_ms"] for info in infos],
            "launches_rank0": infos[0]["launches"]}


def dryrun_tile_kernels(card, results):
    """K5 and K6 on the dry run's tile wavefronts: each rank's shard of the
    16x16 sphere-plane frame (4 triangles in 4 sub-blocks of 128, three of
    them padding only; the shadow table's without the ground plane, which
    goes to the oversized sub-block) on 2 and 4 rays-split
    ranks, camera and shadow rays as the entry points call them; each held
    to tile_check's bars (cnt_out equal to the plain lists' lengths, the
    output bit-identical to the plain version's on the shard's rays).
    Timed on rank 0's shard of the 2-rank split, beside its bound."""
    scene = sphere_plane_scene()
    cam = camera((0.0, 2.0, 6.0), DRYRUN_WH, DRYRUN_WH)
    cfg = RenderConfig(backend="tile")
    out = {name: {"shards": [], "max_abs_err": 0.0} for name in K56}
    for world in DRYRUN_LEGS.values():
        for rank in range(world):
            mesh = sharding.Mesh(devices=np.arange(world).reshape(world, 1), rank=rank,
                                 coords={"rays": rank, "prims": 0},
                                 groups={"rays": None, "prims": None})
            o, d, ids, _, sl = sharding._shard_rays(cam, DRYRUN_WH, DRYRUN_WH, mesh)
            seen = capture_wavefronts(o[sl], d[sl], scene, ids[sl], cfg, rt_tile.tile_tri_search,
                                      rt_tile.tile_occlusion)
            check(len(seen) == 2, f"K dry run tile, rank {rank} of {world}: {len(seen)} "
                  "searches, want 2 (camera, shadow)")
            for wavefront in seen:
                with torch.no_grad():
                    name, args, ov_buf = tile_args(wavefront)
                    r = wavefront[1].shape[0]
                    cnt, visits, live = tile_sweeps(name, args)
                    label = f"{name} [dry run, rank {rank} of {world}]"
                    whole, plain = tile_check(name, label, args, cnt, ov_buf, wavefront,
                                              slice(0, r))
                    if name == "tile_kernel":
                        _, err, _, _ = search_agreement(name, (whole[0][:r], whole[1][:r]), plain)
                    else:
                        err = float((whole[:r] - plain).abs().max().item())
                rec = out[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["shards"].append({"world": world, "rank": rank, "rays": r,
                                      "sub_blocks": args[3].shape[0],
                                      "mean_list": cnt.float().mean().item(),
                                      "oversized": ov_buf is not None})
                if world == 2 and rank == 0:
                    ms, plain_ms = time_pair(name, lambda: wrapper(name)(*args),
                                             lambda: KERNELS[name][0](*args), 20, 3, card,
                                             f"dry run tile, rank 0 of 2, {r} rays")
                    bound_ms, bound_by = bound(*tile_work(name, args, visits, live))
                    # At this size the wrapper's host work (its checks, `_group_boxes`)
                    # can outlast the kernel: one call's device operations, profiled.
                    prof = profiling.device_time(lambda: wrapper(name)(*args))
                    rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               device_ops=prof["device_ops"], device_ms=prof["device_ms"],
                               at=f"sphere_plane_scene {DRYRUN_WH}x{DRYRUN_WH} tile, rank 0 of a "
                                  f"2-rank rays split ({r} rays)")
    for name, rec in out.items():
        say(f"{name} [dry run tile]: {len(rec['shards'])} shard wavefronts of 2 and 4 ranks, "
            f"{rec['shards'][0]['sub_blocks']} sub-block(s), each bit-identical to its plain "
            f"version with cnt_out equal; kernel {rec['ms']:.4f} ms per wrapper call (one call "
            f"profiled: {rec['device_ops']} device operations, {rec['device_ms']:.4f} ms of device "
            f"time), plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.6f} ms "
            f"({rec['bound_by']})  [{card}]")
        results[name]["dryrun"] = rec
    return out


def root_entries_phase(card, results):
    """Path K: bench_torch.py as a subprocess, entry() in this process, and
    dryrun_multichip on 2 and 4 gloo ranks sharing the card, with K5/K6 on
    the dry run's tile wavefronts against their plain versions."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["bench"] = bench_leg(card, results, tmp)
        out["entry"] = entry_leg(card, results)
        for leg in DRYRUN_LEGS:
            out[leg] = dryrun_leg(card, results, leg, tmp)
    out["tile_wavefronts"] = dryrun_tile_kernels(card, results)
    out["wall_s"] = time.perf_counter() - t0
    say(f"K: {out['wall_s']:.1f} s of smoke wall time  [{card}]")
    return out


# --------------------------------------------------------------------------
# Path L: two light sources of unequal face counts, and none
# --------------------------------------------------------------------------

# With no light the step launches its route's closest-hit search once, and
# no shadow query; "auto" and "fused" go to lane (the fused gate takes a
# scene with a light only, both packages' rule).
NOLIGHT_ROUTES = {"auto": "lane", "fused": "lane", "lane": "lane", "mxtile": "mxtile",
                  "tile": "tile"}
# Each search route's closest-hit kernel and its search and occlusion hooks.
SEARCH = {"lane": ("lane_kernel", lane_pallas.lane_tri_search, None),
          "mxtile": ("mxu_kernel", rt_mxu.mxu_tile_search, rt_mxu.mxu_tile_occlusion),
          "tile": ("tile_kernel", rt_tile.tile_tri_search, rt_tile.tile_occlusion)}
# Each route's launches in one depth-1 step of a lit scene: (forward, fwd+bwd).
LIT_LAUNCHES = {"fused": (dict(fused_tables=1, fused_kernel=1),
                          dict(fused_tables=1, fused_kernel=1, lane_kernel=2)),
                "mxtile": (dict(mxu_kernel=1, mxu_occl_kernel=1),) * 2,
                "tile": (dict(tile_kernel=1, tile_occl_kernel=1),) * 2}
VARIANT_WH = 512  # path L5's frames (tests/test_variants.py's camera, square)
# tests/test_round2_fixes.py:121-160's light of four faces (12 corners), for
# reference_cpp's corner draws.
FOUR_FACE_LIGHT = np.asarray([
    [[0.0, 5.0, 0.0], [1.0, 5.0, 0.0], [0.0, 5.0, 1.0]],
    [[9.0, 5.0, 9.0], [8.0, 5.0, 9.0], [9.0, 5.0, 8.0]],
    [[4.0, 5.0, 4.0], [5.0, 5.0, 4.0], [4.0, 5.0, 5.0]],
    [[7.0, 5.0, 1.0], [6.0, 5.0, 1.0], [7.0, 5.0, 2.0]],
], np.float32)


def counts_of(**kw):
    """Every wrapper's launch count: kw's, and 0 for the others."""
    return {name: kw.get(name, 0) for name in KERNELS}


def ceiling_light():
    """Path L2's second Cornell light: four triangles (two quads) on the
    ceiling beside the two-triangle light, with its material."""
    y = 1.98
    quads = [((0.4, y, -0.4), (0.4, y, -0.8), (0.6, y, -0.8), (0.6, y, -0.4)),
             ((0.6, y, -0.4), (0.6, y, -0.8), (0.8, y, -0.8), (0.8, y, -0.4))]
    return MeshData(name="light2", vertices=_quad_tris(quads), normals=None, uv=None,
                    material=_CORNELL_MATERIALS["light"])


def lights_line(label, scene, cfg):
    lt = scene.lights
    say(f"{label}: {int(scene.triangles.valid.sum())} triangles in {scene.triangles.capacity} "
        f"slots, lights {lt.num_lights} of faces {lt.face_count.tolist()}; backend "
        f"{cfg.backend!r} resolves to {resolve_backend(cfg, scene)!r}")


def shadow_rows(label, seen, r, lights):
    """The frame made a camera search and one shadow query of r x lights rays."""
    check(len(seen) == 2 and seen[1][0] and seen[1][1].shape[0] == r * lights,
          f"{label}: searches {[(w[0], w[1].shape[0]) for w in seen]}, want a camera search and "
          f"a shadow query of {r} x {lights} rays")


def draws_check(label, scene, mode, n=1 << 20):
    """sample_lights on the card equal bit for bit to the CPU's (points and
    light triangles), at bounce 1, seed 7."""
    ids = torch.arange(n, device=scene.triangles.v0.device) * 3 + 1
    got = sample_lights(scene, 7, ids, 1, mode)
    want = sample_lights(scene.to("cpu"), 7, ids.cpu(), 1, mode)
    identical(f"sample_lights [{label}, {mode}] on the card vs the CPU",
              (got[0].cpu(), got[1].cpu()), want[:2])
    say(f"sample_lights [{label}, {mode}]: {n} rays x {got[2]} lights, points and triangles "
        "bit-equal to the CPU's")
    return got[0]


def fused_identical(card, o, d, scene, ids, cfg, what):
    """`fused_kernel_check`, and K3 bit-identical to its plain version."""
    rec = fused_kernel_check(card, o, d, scene, ids, cfg, what)
    check(rec["max_abs_err"] == 0.0, f"fused_kernel [{what}]: max abs err {rec['max_abs_err']} "
          "from its plain version, not bit-identical")
    return dict(rec, at=what)


def two_light_flagship_leg(card, results, auto):
    """L1: the flagship's meshes and a second area light, 1920x1080, mxtile:
    K1 and K2 on the camera and the R x 2 shadow wavefronts against their
    plain versions, then the path (one K1 and one K2 per step)."""
    scene = scene_from_mesh(bench_meshes() + [_area_light(center=(0.0, 6.0, -2.0), half=1.5)])
    cam = camera((0.0, 2.0, 6.0), 1920, 1080)
    lights_line("L1 flagship, two lights", scene, auto)
    o, d, ids = rays(cam, 1920, 1080)
    seen = capture_wavefronts(o, d, scene, ids, auto, rt_mxu.mxu_tile_search,
                              rt_mxu.mxu_tile_occlusion)
    shadow_rows("L1", seen, o.shape[0], 2)
    del o, d, ids
    mxtile_kernels(card, seen, results, what="L1 flagship + 2nd light 1080p", key="two_lights")
    del seen
    fwd, bwd = LIT_LAUNCHES["mxtile"]
    return path_phase(card, "L1 flagship two lights", scene, cam, 1920, 1080, auto, "mxtile",
                      list(fwd), list(bwd), results, small=(64, 48),
                      exact={"forward": counts_of(**fwd), "fwd+bwd": counts_of(**bwd)})


def two_light_cornell_leg(card, results, auto):
    """L2: the Cornell shell and a four-face ceiling light (faces 2 and 4),
    1024x768, fused: the table build bit-equal to its plain version on a
    CPU copy, K3 bit-identical to its plain version at depth 1 and 3, K4 on
    the backward's camera and R x 2 shadow wavefronts, the light draws on
    the card equal to the CPU's, then the path at depth 1 and 3."""
    scene = scene_from_mesh(_cornell_shell() + [ceiling_light()])
    check(scene.lights.face_count.tolist() == [2, 4]
          and fused_pallas.fused_supported(scene, 3, "area"),
          "L2: the Cornell scene's lights are not of faces 2 and 4 within the fused gate")
    cam = camera((0.0, 1.0, 2.0), 1024, 768)
    lights_line("L2 Cornell, two lights", scene, auto)
    results["fused_tables"]["two_lights"] = fused_tables_check(card, "L2 Cornell two lights",
                                                               scene)
    o, d, ids = rays(cam, 1024, 768)
    for depth in (1, 3):
        what = f"L2 Cornell two lights 1024x768, depth {depth}"
        results["fused_kernel"][f"two_lights_depth{depth}"] = fused_identical(
            card, o, d, scene, ids, auto.replace(depth=depth), what)
    # The backward re-derives the frame on lane: its camera and shadow searches.
    seen = capture_wavefronts(o, d, scene, ids, auto.replace(backend="lane"),
                              lane_pallas.lane_tri_search)
    check(len(seen) == 2 and seen[1][1].shape[0] == 2 * o.shape[0],
          f"L2: the lane route made searches of {[w[1].shape[0] for w in seen]} rays, want "
          f"{o.shape[0]} and {2 * o.shape[0]}")
    for key, wavefront in zip(("camera", "shadow"), seen):
        results["lane_kernel"][f"two_lights_{key}"] = lane_check(
            card, f"L2 Cornell two lights {key} wavefront", wavefront)
    del seen, o, d, ids
    draws_check("L2 Cornell two lights", scene, "area")
    out = {}
    for depth in (1, 3):
        fwd, bwd = LIT_LAUNCHES["fused"]
        # The backward's lane route: a camera and a shadow search per bounce.
        bwd = dict(bwd, lane_kernel=2 * depth)
        out[f"depth{depth}"] = path_phase(
            card, f"L2 Cornell two lights, depth {depth}", scene, cam, 1024, 768,
            auto.replace(depth=depth), "fused", list(fwd), list(bwd), results, min_nonzero=7,
            small=(128, 96), exact={"forward": counts_of(**fwd), "fwd+bwd": counts_of(**bwd)})
    return out


def two_light_tile_leg(card, results, auto):
    """L3: a subdivision-6 icosphere, the ground plane and two area lights
    (one segment of the tile route), 1920x1080: K5 and K6 (on the R x 2
    shadow wavefront) bit-identical to their plain versions on a
    TILE_SLICE-ray slice, then the path (one K5 and one K6 per step)."""
    scene = scene_from_mesh([icosphere_mesh(subdivisions=6), _ground_plane(), _area_light(),
                             _area_light(center=(3.0, 4.0, 2.0), half=0.5)])
    n = scene.triangles.capacity
    check(rt_mxu.MXU_TRI_LIMIT < n <= rt_tile.TILE_TRI_LIMIT,
          f"L3: {n} triangle slots are not one tile segment above the mxtile limit")
    cam = camera((0.0, 2.0, 6.0), 1920, 1080)
    lights_line("L3 icosphere, two lights", scene, auto)
    o, d, ids = rays(cam, 1920, 1080)
    seen = capture_wavefronts(o, d, scene, ids, auto, rt_tile.tile_tri_search,
                              rt_tile.tile_occlusion)
    shadow_rows("L3", seen, o.shape[0], 2)
    del o, d, ids
    tile_kernels(card, seen, 1920, results, what="L3 icosphere(6) + 2 lights 1920x1080",
                 key="two_lights", lights=2)
    del seen
    fwd, bwd = LIT_LAUNCHES["tile"]
    return path_phase(card, "L3 tile two lights", scene, cam, 1920, 1080, auto, "tile",
                      list(fwd), list(bwd), results,
                      exact={"forward": counts_of(**fwd), "fwd+bwd": counts_of(**bwd)})


def nolight_leg(card, results):
    """L4: empty_nolight at 1024x768: each route's search kernel (K4, K1, K5)
    on the frame's camera wavefront, the only one (no shadow query), against
    its plain version; then each backend's path: exactly black, zero and
    finite gradients, its route's search launched once per step and no
    other kernel (no zero-size launch)."""
    scene = cornell_variant("empty_nolight")
    check(scene.lights.num_lights == 0, "L4: empty_nolight has a light")
    cam = camera((0.0, 1.0, 2.0), 1024, 768)
    o, d, ids = rays(cam, 1024, 768)
    for route, (_, search, occlusion) in SEARCH.items():
        seen = capture_wavefronts(o, d, scene, ids, RenderConfig(backend=route), search,
                                  occlusion)
        check(len(seen) == 1 and not seen[0][0], f"L4 {route}: {len(seen)} searches, want the "
              "camera search alone")
        what = f"L4 empty_nolight 1024x768 {route}"
        if route == "lane":
            results["lane_kernel"]["nolight"] = lane_check(card, what, seen[0])
        elif route == "mxtile":
            mxtile_kernels(card, seen, results, what=what, key="nolight")
        else:
            tile_kernels(card, seen, 1024, results, what=what, key="nolight")
    del o, d, ids, seen
    out = {}
    for backend, route in NOLIGHT_ROUTES.items():
        cfg = RenderConfig(backend=backend)
        lights_line(f"L4 empty_nolight, {backend}", scene, cfg)
        kernel = SEARCH[route][0]
        once = counts_of(**{kernel: 1})
        out[backend] = path_phase(card, f"L4 empty_nolight {backend}", scene, cam, 1024, 768, cfg,
                                  route, [kernel], [kernel], results,
                                  small=(128, 96), lit=False,
                                  exact={"forward": once, "fwd+bwd": once})
    return out


def variants_leg(card, results, auto):
    """L5: the ten Cornell variants at 512x512 through "auto": each held to
    path_phase's checks (its full frame against the jnp route on the card,
    `flip_bar`: the jnp route's eps-window near-ties at the shells' seams
    flip up to 49 pixels of a 512x512 frame from every search route's,
    lane's and mxu's too, 1.4e-4 to 2.5e-4 of mean |diff| on the empty
    shells, and the sphere variant's highlights differ by up to 1e-3 on
    the card), its route's kernels and no other, the Cornell
    signature (red left, green right) where tests/test_variants.py checks
    it; then reference_cpp's draws on a light of four faces equal to the
    CPU's."""
    cam = camera((0.0, 1.0, 2.0), VARIANT_WH, VARIANT_WH)
    out = {}
    for name in CORNELL_VARIANTS:
        scene = cornell_variant(name)
        route = resolve_backend(auto, scene)
        lights_line(f"L5 {name}", scene, auto)
        if scene.lights.num_lights:
            fwd, bwd = LIT_LAUNCHES[route]
            lit = dict(lit=True, min_nonzero=7)
        else:
            fwd = bwd = {SEARCH[route][0]: 1}
            lit = dict(lit=False)
        out[name] = dict(path_phase(card, f"L5 {name}", scene, cam, VARIANT_WH, VARIANT_WH, auto,
                                    route, list(fwd), list(bwd), results,
                                    small=(VARIANT_WH, VARIANT_WH), flip_bar=True,
                                    exact={"forward": counts_of(**fwd),
                                           "fwd+bwd": counts_of(**bwd)}, **lit),
                         backend=route)
        # Each route's kernels on the frame against their plain versions.
        what = f"L5 {name} {VARIANT_WH}x{VARIANT_WH}"
        o, d, ids = rays(cam, VARIANT_WH, VARIANT_WH)
        if route == "fused":
            results["fused_kernel"].setdefault("variants", {})[name] = fused_identical(
                card, o, d, scene, ids, auto, what)
        elif route == "mxtile":
            seen = capture_wavefronts(o, d, scene, ids, auto, rt_mxu.mxu_tile_search,
                                      rt_mxu.mxu_tile_occlusion)
            mxtile_kernels(card, seen, results, what=what, key=f"variant_{name}")
            del seen
        else:
            seen = capture_wavefronts(o, d, scene, ids, auto, lane_pallas.lane_tri_search)
            results["lane_kernel"][f"variant_{name}"] = lane_check(card, what, seen[0])
            del seen
        del o, d, ids
        if name in ("original", "mirror", "glossy", "sphere", "water"):
            # tests/test_variants.py's columns 1 and -2 of 24, at this width.
            img = render(scene, cam, VARIANT_WH, VARIANT_WH, auto)
            h, k = VARIANT_WH // 2, VARIANT_WH // 16
            left, right = img[h, k].tolist(), img[h, -k - 1].tolist()
            check(left[0] > left[1] and right[1] > right[0],
                  f"L5 {name}: left {left}, right {right}: not red left, green right")
    quad = MeshData(name="light", vertices=FOUR_FACE_LIGHT, normals=None, uv=None,
                    material=Material.make(ke=(10, 10, 10)))
    floor = MeshData(name="floor", vertices=np.asarray([[[-9, 0, -9], [9, 0, -9], [0, 0, 9]]],
                                                       np.float32),
                     normals=None, uv=None, material=Material.make(kd=(1, 1, 1)))
    p = draws_check("L5 four-face light", scene_from_mesh([floor, quad]), "reference_cpp")
    corners = torch.unique(p.reshape(-1, 3).cpu(), dim=0)
    want = torch.unique(torch.from_numpy(FOUR_FACE_LIGHT[[0, 0, 0, 1], [0, 1, 2, 0]]), dim=0)
    check(torch.equal(corners, want), f"L5: reference_cpp drew corners {corners.tolist()}, "
          f"not {{f0c0, f0c1, f0c2, f1c0}}")
    return out


def lights_phase(card, results, auto):
    """Path L: L1-L5."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"L1_flagship": two_light_flagship_leg(card, results, auto),
           "L2_cornell": two_light_cornell_leg(card, results, auto),
           "L3_tile": two_light_tile_leg(card, results, auto),
           "L4_nolight": nolight_leg(card, results),
           "L5_variants": variants_leg(card, results, auto)}
    out["wall_s"] = time.perf_counter() - t0
    say(f"L: {out['wall_s']:.1f} s of smoke wall time  [{card}]")
    return out


# --------------------------------------------------------------------------
# Path M: the JAX package's compiled steps as CUDA graphs (utils/graphs.py)
# --------------------------------------------------------------------------


def timed_calls(call, ids, stride, reps):
    """`reps` calls at ids moved on by `stride` per call: per call, the CUDA
    event ms from its start to its end and the host ms until it returned
    (the card synchronised before each) -> (event medians, host median)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev, host = [], []
    for k in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        call(ids + (100 + k) * stride)
        end.record()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        ev.append(start.elapsed_time(end))
    return statistics.median(ev), statistics.median(host), ev


def busy_share(call, ids):
    """One call under torch.profiler, after one more under it (a graphed
    call's first under a profiler captures its spanned twin): (device ms,
    busy share), or (None, None) when the profiler recorded no device
    operation in it."""
    profiling.device_time(lambda: call(ids))
    prof = profiling.device_time(lambda: call(ids))
    if not prof["device_ops"]:
        return None, None
    return prof["device_ms"], prof["busy_share"]


def held_outputs(label, got, want):
    """The image (or else the loss) bit-equal to the eager step's, and the
    gradients within grads_agreement's bars; returns that worst share."""
    key = next((k for k in ("image", "loss") if k in want), None)
    if key is not None:
        check(torch.equal(got[key], want[key]), f"{label}: the graphed {key} differs from the "
              "eager one")
    if "grads" not in want:
        return None
    to_np = lambda gs: [np.zeros(1, np.float32) if g is None else g.cpu().numpy() for g in gs]
    loss = (float(got["loss"]), float(want["loss"])) if "loss" in want else (None, None)
    return grads_agreement(label, loss[0], to_np(got["grads"]), loss[1],
                           to_np(want["grads"]))["worst_of_bar"]


def graph_step(card, results, label, graphed_fn, call, ids, stride, reps=5):
    """Path M for one step. `call(ids)` runs `graphed_fn` and returns a dict of
    "image" and / or "loss" and "grads"; under `graphs.disabled()` it is the
    eager step. Checks (a) the graphed outputs against the eager ones, (b)
    the launches per replay equal to the eager step's, (c) two replays at
    other ids give other images, each equal to the eager one at its ids;
    prints (d) the eager and graphed ms (CUDA events, median of `reps`, ids
    moved on per call), the host ms per call, the capture ms, the peak
    memory and the busy share of one step of each."""
    with graphs.disabled():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        want, eager = launches.counted(lambda: call(ids))
        eager_peak = torch.cuda.max_memory_allocated() / 2**30
        eager_ms, eager_host, eager_all = timed_calls(call, ids, stride, reps)
    call(ids + stride)  # the first graphed call runs eagerly: the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    call(ids + 2 * stride)  # the capture, then its replay
    torch.cuda.synchronize()
    capture_ms = (time.perf_counter() - t0) * 1e3
    check(len(graphed_fn.cache) == 1, f"M {label}: {len(graphed_fn.cache)} cache entries")
    got, replay = launches.counted(lambda: call(ids))
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    check(replay == eager and sum(eager.values()) > 0,
          f"M {label}: launches per replay {replay}, the eager step's {eager}")
    worst = held_outputs(f"M {label}", got, want)
    other = call(ids + 3 * stride)
    with graphs.disabled():
        other_want = call(ids + 3 * stride)
    held_outputs(f"M {label} at other ids", other, other_want)
    key = next((k for k in ("image", "loss") if k in want), None)
    moved = (not torch.equal(other[key], got[key]) if key else
             any(not torch.equal(a, b) for a, b in zip(other["grads"], got["grads"])
                 if a is not None))
    check(moved, f"M {label}: replays at other ray ids gave the same {key or 'gradients'}")
    graph_ms, graph_host, graph_all = timed_calls(call, ids, stride, reps)
    dev_graph, busy_graph = busy_share(call, ids)
    with graphs.disabled():
        dev_eager, busy_eager = busy_share(call, ids)
    for name in eager:
        results[name]["launches"] += eager[name] + replay[name]
    fmt = lambda x: "not measured" if x is None else f"{x:.1%}"
    say(f"M {label}: launches per step {dict((k, v) for k, v in eager.items() if v)}, equal "
        f"per replay; {key or 'gradients'} {'bit-equal to' if key else 'within the bars of'} "
        f"the eager step's, also at other ray ids (gradients: worst element at "
        f"{'-' if worst is None else f'{worst:.3f}'} of its bar)")
    say(f"M {label}: eager {eager_ms:.3f} ms (host {eager_host:.3f} ms per call), graphed "
        f"{graph_ms:.3f} ms (host {graph_host:.3f} ms per call), median of {reps}; capture "
        f"{capture_ms:.1f} ms; peak {eager_peak:.2f} GiB eager, {graph_peak:.2f} GiB with the "
        f"graph; busy {fmt(busy_eager)} eager, {fmt(busy_graph)} graphed  [{card}]")
    return {"eager_ms": eager_ms, "graphed_ms": graph_ms, "eager_host_ms": eager_host,
            "graphed_host_ms": graph_host, "eager_all_ms": eager_all, "graphed_all_ms": graph_all,
            "capture_ms": capture_ms, "eager_peak_gib": eager_peak, "graphed_peak_gib": graph_peak,
            "eager_device_ms": dev_eager, "graphed_device_ms": dev_graph,
            "eager_busy": busy_eager, "graphed_busy": busy_graph, "launches": eager,
            "grads_worst_of_bar": worst}


def graphed_frame(scene, o, d, cfg):
    """A fwd+bwd step as one graph: ids -> (image, loss, gradients of
    sum(color^2) with respect to every float leaf)."""
    params = [p.detach().requires_grad_(True) for p in float_params(scene)]

    @graphs.graphed
    def step(ids):
        color = trace_rays(o, d, merge_params(scene, params), ids, cfg)
        loss = torch.sum(color * color)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return color.detach(), loss.detach(), grads

    def call(ids):
        image, loss, grads = step(ids)
        return {"image": image, "loss": loss, "grads": grads}

    return step, call


def fit_graph_leg(card, results, scene, cam, w, h, cfg, steps=3, lr=0.05):
    """Three `fit_scene` steps on the flagship, graphed and eager (under
    `graphs.disabled()`): the same launches (one K1 and one K2 per step),
    the losses and the fitted kd within path H's bars; then the step's
    loss and gradients (`optimize.loss_and_grad`) through `graph_step`, new
    kd values in the place of new ray ids."""
    with torch.no_grad():
        target = render(scene, cam, w, h, cfg)
    start = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, kd=scene.triangles.kd * 0.5))
    kw = dict(steps=steps, lr=lr, cfg=cfg, log_every=0,
              param_filter=lambda i, leaf: leaf is start.triangles.kd)
    runs = {}
    for what in ("eager", "graphed"):
        with graphs.disabled() if what == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit, counts = launches.counted(lambda: fit_scene(start, target, cam, **kw))
            runs[what] = (fit, counts, (time.perf_counter() - t0) * 1e3)
            got = launches.read(launches.FETCH)
        check(got == dict.fromkeys(FETCH, steps), f"M fit_scene {what}: winner fetch {got}, "
              f"want one gather and one scatter a step")
        for name, n in {**counts, **got}.items():
            results[name]["launches"] += n
    (ef, ec, ems), (gf, gc_, gms) = runs["eager"], runs["graphed"]
    check(ec == gc_ and ec["mxu_kernel"] == steps and ec["mxu_occl_kernel"] == steps,
          f"M fit_scene: launches {gc_} graphed, {ec} eager")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(gf.losses, ef.losses))
    kd_err = (gf.scene.triangles.kd - ef.scene.triangles.kd).abs().max().item()
    say(f"M fit_scene {steps} steps: losses {[f'{x:.6e}' for x in gf.losses]} graphed, within "
        f"{loss_rel:.3e} relative of eager (< {RESUME_RTOL}), kd within {kd_err:.3e} (< "
        f"{RESUME_ATOL}); {ems:.1f} ms eager, {gms:.1f} ms graphed (first step eager, second "
        f"the capture)  [{card}]")
    check(loss_rel < RESUME_RTOL and kd_err < RESUME_ATOL, "M fit_scene: graphed and eager part")
    frozen = tuple(not (leaf is scene.triangles.kd) for leaf in float_params(scene))
    kd = scene.triangles.kd

    def call(scale):
        sc = dataclasses.replace(scene, triangles=dataclasses.replace(
            scene.triangles, kd=kd * scale))
        loss, grads = optimize.loss_and_grad(sc, target, cam, w, h, cfg, frozen)
        return {"loss": loss, "grads": [g for g in grads if g is not None]}

    graphs.clear()  # the fit above captured this key
    out = graph_step(card, results, "fit step (loss_and_grad)", optimize.loss_and_grad, call,
                     torch.full((), 0.5, device="cuda"), 0.001)
    out.update(fit_eager_ms=ems, fit_graphed_ms=gms, fit_loss_rel=loss_rel, fit_kd_err=kd_err)
    return out


def trace_capture_check():
    """(e): at TRACE level the first call runs eagerly and prints; the capture
    that would follow raises."""
    scene, cam = cornell_box(), camera((0.0, 1.0, 2.0), 64, 48)
    level = debug.current_level()
    debug.set_level(debug.TRACE)
    try:
        with torch.no_grad():
            render(scene, cam, 64, 48, RenderConfig(backend="auto"))
            try:
                render(scene, cam, 64, 48, RenderConfig(backend="auto"))
            except RuntimeError as exc:
                raised = str(exc)
            else:
                raised = None
    finally:
        debug.set_level(level)
    check(raised is not None and "TRACE" in raised, "M: a capture at TRACE level did not raise")
    say(f"M TRACE: the second render at TRACE raised: {raised[:90]}...")


def graph_phase(card, results, flag, flag_cam, corn, corn_cam, mixed, mixed_cam):
    """Path M: each step the JAX package jits, captured and replayed, against
    the eager port (`graph_step`): the flagship forward and fwd+bwd through
    `bench_torch.headline`, the Cornell call of 8 renders
    (`bench_torch.cornell_call`), config 4 fwd+bwd, config 5 fwd+bwd (one
    timed call each way), `fit_scene` on the flagship; then a capture at
    TRACE level, which must raise."""
    import bench_torch

    graphs.clear()
    auto = RenderConfig(backend="auto")
    out = {}
    o, d, ids = rays(flag_cam, 1920, 1080)
    fwd, fwd_bwd = bench_torch.headline(flag, o, d, auto)
    out["flagship fwd"] = graph_step(card, results, "flagship fwd (bench_torch.headline)", fwd,
                                     lambda i: {"loss": fwd(i)}, ids, ids.shape[0])
    out["flagship fwd+bwd"] = graph_step(
        card, results, "flagship fwd+bwd (bench_torch.headline)", fwd_bwd,
        lambda i: {"grads": fwd_bwd(i)}, ids, ids.shape[0])
    # What a replay keeps of the per-search table build (ROADMAP Queue 1 item
    # 9a): its device time, which no graph removes.
    with torch.no_grad():
        for what, exclude in (("search", False), ("occlusion", True)):
            mxu_segments(flag.triangles, exclude)
            prof = profiling.device_time(lambda: mxu_segments(flag.triangles, exclude))
            out[f"sort_pack_{what}"] = prof
            say(f"M flagship sort + pack per {what}: {prof['device_ms']:.3f} ms of device time "
                f"in {prof['device_ops']} operations, {prof['wall_ms']:.3f} ms of wall time "
                f"eagerly  [{card}]")
    graphs.clear()
    o, d, ids = rays(corn_cam, 1024, 768)
    cc = bench_torch.cornell_call(corn, o, d, auto.replace(backend="fused"))
    out["Cornell x8"] = graph_step(card, results, "Cornell x8 (bench_torch.cornell_call)", cc,
                                   lambda i: {"loss": cc(i)}, ids, ids.shape[0])
    graphs.clear()
    o, d, ids = rays(mixed_cam, 1920, 1080)
    step, call = graphed_frame(mixed, o, d, auto.replace(depth=4))
    out["config 4 fwd+bwd"] = graph_step(card, results, "config 4 fwd+bwd", step, call, ids,
                                         ids.shape[0])
    del step, call
    graphs.clear()
    soup = random_scene(100_000)
    o, d, ids = rays(camera((0.0, 18.0, 45.0), 3840, 2160), 3840, 2160)
    step, call = graphed_frame(soup, o, d, auto)
    out["config 5 fwd+bwd"] = graph_step(card, results, "config 5 fwd+bwd", step, call, ids,
                                         ids.shape[0], reps=1)
    del step, call, soup, o, d, ids
    graphs.clear()
    out["fit_scene"] = fit_graph_leg(card, results, flag, flag_cam, 1920, 1080, auto)
    graphs.clear()
    trace_capture_check()
    graphs.clear()
    return out


# --------------------------------------------------------------------------
# Path N: the JAX package's selectable pre-pass modes (rt_tile.CULL_MODE,
# OCCL_EARLY_EXIT; rt_mxu.CULL_MODE)
# --------------------------------------------------------------------------

MODE_SLICE = 65_536  # rays per wavefront held against the plain versions in each mode
# kernel: {label: keyword arguments of the wrapper}. K5 takes no "entry" lists
# (they are K6's, nearest-first).
MODE_CASES = {
    "mxu_kernel": {"exact": dict(mode="exact"), "interval": dict(mode="interval")},
    "mxu_occl_kernel": {"exact": dict(mode="exact"), "interval": dict(mode="interval")},
    "tile_kernel": {"exact": dict(mode="exact"), "interval": dict(mode="interval"),
                    "hier": dict(mode="hier")},
    "tile_occl_kernel": {"exact": dict(mode="exact"), "interval": dict(mode="interval"),
                         "hier": dict(mode="hier"), "entry": dict(mode="entry"),
                         "entry E=1": dict(mode="entry", early_exit=1),
                         "entry E=8": dict(mode="entry", early_exit=8)},
}
# The default instantiations as the tree before the modes built them (ptxas
# with this script's flags, sm_90a): (source, a piece of the kernel's mangled
# name, registers, spill stores, spill loads, bytes of shared memory). Path N
# requires the same: the modes leave the default code as it was.
DEFAULT_PTXAS = {
    "mxu_kernel": ("rt_mxu", "17mxu_search_kernelILi0EE", 79, 0, 0, 32832),
    "mxu_occl_kernel": ("rt_mxu", "15mxu_occl_kernelILi0EE", 80, 0, 0, 32832),
    "tile_kernel": ("rt_tile", "18tile_search_kernelE", 128, 0, 0, 0),
    "tile_occl_kernel": ("rt_tile", "16tile_occl_kernelE", 128, 0, 0, 0),
}
# The default instantiation's whole-wavefront ms over this script's sound runs
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): K1 and K2 on the flagship, K5
# and K6 on config 5. Path N reads them again, within DEFAULT_SLACK of the
# range's top: the spread between those runs, about 1%.
DEFAULT_MS = {"mxu_kernel": (1.599, 1.619), "mxu_occl_kernel": (1.685, 1.709),
              "tile_kernel": (21.281, 21.512), "tile_occl_kernel": (32.945, 33.275)}
DEFAULT_SLACK = 1.01


@contextlib.contextmanager
def switch(module, name, value):
    """A module switch set for the block, then restored."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def ptxas_entries(source):
    """{mangled kernel name: (registers, spill stores, spill loads, shared
    bytes)} from the ptxas log of csrc/<source>.cu's build."""
    out, name = {}, None
    spills = (0, 0)
    for line in _build.lib_path(source).with_suffix(".log").read_text().splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            out[name] = (int(m.group(1)), *spills, int(smem.group(1)) if smem else 0)
            name = None
    return out


def default_build_check():
    """The default instantiations of K1, K2, K5 and K6 built as before the
    modes: the same registers, spills and shared memory (DEFAULT_PTXAS)."""
    for kernel, (source, piece, *want) in DEFAULT_PTXAS.items():
        found = {n: v for n, v in ptxas_entries(source).items() if piece in n}
        check(len(found) == 1, f"N {kernel}: {len(found)} ptxas entries match {piece!r}")
        (name, got), = found.items()
        check(list(got) == want, f"N {kernel}: the default instantiation builds with (registers, "
              f"spill stores, spill loads, smem) {got}, not {tuple(want)}")
        say(f"N {kernel}: the default instantiation {name} builds as before: {got[0]} "
            f"registers, {got[1]}/{got[2]} bytes spilled, {got[3]} bytes of shared memory")


def mode_ms(fn, rays_, iters):
    """ms per call of fn(rays) (CUDA events, warm), alternating the wavefront
    and a copy of it rolled by half its bundles, so that no two calls in a
    row see the same ray order."""
    half = rays_.shape[0] // 2 // rt_mxu.RAY_TILE * rt_mxu.RAY_TILE
    variants = (rays_, torch.roll(rays_, half, 0))
    fn(rays_)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fn(variants[i % 2])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mode_slice(cnt, per, r, w):
    """MODE_SLICE rays (whole groups of `per` rays) centred on the image row
    whose groups have the longest lists (cnt per group) of an r-ray, w-wide
    wavefront."""
    rows = cnt[:r // per].float().reshape(-1, w // per).mean(1) if w % per == 0 else None
    heavy = int(rows.argmax()) if rows is not None else r // w // 2
    start = min(max(heavy * w - MODE_SLICE // 2, 0), r - MODE_SLICE)
    return slice(start - start % per, start - start % per + MODE_SLICE)


def mode_kernels(card, results, wavefront, tile, w, what, iters):
    """Path N, one kernel on one wavefront: each mode of MODE_CASES (1) on
    MODE_SLICE rays of the heaviest rows against its plain version in the
    same mode, its cnt_out equal to the plain lists' cnt (K5, K6:
    bit-identical; K1, K2: the bars of tests/test_rt_mxu.py); (2) on the
    whole wavefront bit-identical to the default (argsort) kernel; (3)
    timed beside the default on the whole wavefront, in turns (default,
    mode, mode, default). Then the default alone, against DEFAULT_MS."""
    name, args, _ = tile_args(wavefront) if tile else mxtile_args(wavefront)
    per = rt_tile.COHERENT if tile else rt_mxu.RAY_TILE
    r = wavefront[1].shape[0]
    base_cnt = torch.full((args[1].shape[0] // per,), -1, dtype=torch.int32, device="cuda")
    base = wrapper(name)(*args, cnt_out=base_cnt)
    rs = mode_slice(base_cnt, per, r, w)
    sargs = (args[0], args[1][rs], *args[2:])

    def call(kw):
        return lambda rr: wrapper(name)(args[0], rr, *args[2:], **kw)

    out = {}
    for label, kw in MODE_CASES[name].items():
        cnt_k = torch.full((sargs[1].shape[0] // per,), -1, dtype=torch.int32, device="cuda")
        cnt_p = torch.full_like(cnt_k, -1)
        got = wrapper(name)(*sargs, cnt_out=cnt_k, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = KERNELS[name][0](*sargs, cnt_out=cnt_p, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        tag = f"N {name} [{what}, {label}]"
        check(torch.equal(cnt_k, cnt_p), f"{tag}: cnt_out differs from the plain lists' cnt "
              f"on {int((cnt_k != cnt_p).sum())} of {cnt_k.numel()} groups")
        if tile:
            identical(f"{tag} vs its plain version on the slice", got, plain)
        elif name == "mxu_kernel":
            search_agreement(f"{tag} vs its plain version", got, plain)
        else:
            agree = (got == plain).float().mean().item()
            check(agree >= 0.999, f"{tag}: occlusion agreement {agree} < 0.999")
        whole = wrapper(name)(*args, **kw)
        identical(f"{tag} vs the default (argsort) kernel on the whole wavefront", whole, base)
        a1 = mode_ms(call({}), args[1], iters)
        m1 = mode_ms(call(kw), args[1], iters)
        m2 = mode_ms(call(kw), args[1], iters)
        a2 = mode_ms(call({}), args[1], iters)
        ms, argsort_ms = (m1 + m2) / 2, (a1 + a2) / 2
        say(f"{tag}: mean list {cnt_k.float().mean().item():.2f} on the slice (argsort "
            f"{base_cnt[rs.start // per:rs.stop // per].float().mean().item():.2f}), cnt_out "
            f"equal, bit-identical to the default on the whole wavefront; whole wavefront "
            f"{ms:.3f} ms ({m1:.3f}, {m2:.3f}) vs argsort {argsort_ms:.3f} ({a1:.3f}, {a2:.3f}), "
            f"x{ms / argsort_ms:.3f}; plain on the slice {plain_ms:.1f} ms  [{card}]")
        out[label] = dict(ms=ms, argsort_ms=argsort_ms, ratio=ms / argsort_ms, plain_ms=plain_ms,
                          mean_list_slice=cnt_k.float().mean().item(), at=what)
        del got, plain, whole
    # The default read as PERF.md's numbers were (time_pair: the same rays, median of 3).
    lo, hi = DEFAULT_MS[name]
    default_ms = statistics.median(elapsed_ms(lambda: wrapper(name)(*args), "cuda", iters)
                                   for _ in range(3))
    say(f"N {name} [{what}]: the default instantiation {default_ms:.3f} ms, the range of "
        f"earlier runs {lo}-{hi} ms  [{card}]")
    check(default_ms <= hi * DEFAULT_SLACK, f"N {name}: the default instantiation reads "
          f"{default_ms:.3f} ms, above the earlier runs' {hi} ms by more than {DEFAULT_SLACK}x")
    results[name].setdefault("modes", {}).update(out)
    results[name]["default_ms_path_n"] = default_ms


# Path N's graphed renders: (label, backend, module, switch, value, the spied kernels).
GRAPH_FLIPS = (
    ("mxtile interval", "mxtile", rt_mxu, "CULL_MODE", "interval", ("mxu_kernel", "mxu_occl_kernel")),
    ("tile hier", "tile", rt_tile, "CULL_MODE", "hier", ("tile_kernel", "tile_occl_kernel")),
    ("tile early exit 8", "tile", rt_tile, "OCCL_EARLY_EXIT", 8, ("tile_occl_kernel",)),
)


def plain_cnt(name, args, kw):
    """The plain lists' cnt of a wrapper call's arguments in its mode."""
    rays_, aabbs = args[1], args[2]
    if name.startswith("mxu"):
        return rt_mxu._prep_mxu(rays_[:, 0:3], rays_[:, 3:6], aabbs, rays_[:, 6],
                                cull_mode=kw.get("mode", "argsort"))[2]
    return rt_tile._lists(rays_, aabbs, kw.get("mode", "argsort"))[1]


def graph_flip_leg(card, results, flag, flag_cam):
    """Path N: `render` (a CUDA graph per key) on the flagship at 1920x1080,
    a switch flipped between calls. Three calls before the flip (eager,
    capture, replay), three after: the flip makes a new key, whose eager
    call and capture pass the new mode to the kernel (a spy on the wrapper
    records its keywords and adds a cnt_out), and whose replay equals the
    eager render under the switch, launches the eager call's kernels, and
    leaves in the captured cnt_out the plain lists' cnt in the new mode, on
    the replay's own rays. Counts set to 0 just before each call and read
    just after."""
    o, d, ids = rays(flag_cam, 1920, 1080)
    out = {}
    for label, backend, module, name, value, spied in GRAPH_FLIPS:
        graphs.clear()
        cfg = RenderConfig(backend=backend)
        records = []
        originals = {k: wrapper(k) for k in spied}
        mods = {k: rt_mxu if k.startswith("mxu") else rt_tile for k in spied}

        def make_spy(k):
            def spy(*args, **kw):
                per = rt_mxu.RAY_TILE if k.startswith("mxu") else rt_tile.COHERENT
                if kw.get("cnt_out") is None:  # the searches pass None while spans are off
                    kw["cnt_out"] = torch.full((args[1].shape[0] // per,), -1,
                                               dtype=torch.int32, device=args[1].device)
                records.append((k, args, kw))
                out = originals[k](*args, **kw)
                # The wrapper counts on its module's name, which is this spy: pass it on.
                originals[k].launches += spy.launches
                spy.launches = 0
                return out
            spy.launches = 0
            return spy

        for k in spied:
            setattr(mods[k], k, make_spy(k))
        try:
            with torch.no_grad():
                for _ in range(3):
                    before, counts = launches.counted(lambda: render(flag, flag_cam, 1920, 1080, cfg))
                    add_launches(results, counts)
                with switch(module, name, value):
                    records.clear()
                    calls = []
                    for _ in range(3):
                        img, counts = launches.counted(lambda: render(flag, flag_cam, 1920, 1080, cfg))
                        add_launches(results, counts)
                        calls.append((img, counts))
                    n_keys = len(render.cache)
                    with graphs.disabled():
                        want = render(flag, flag_cam, 1920, 1080, cfg)
                    tag = f"N graphed render [{label}]"
                    check(n_keys == 2, f"{tag}: {n_keys} graph keys after the flip, want 2")
                    check(torch.equal(calls[2][0], want), f"{tag}: the replay differs from the "
                          "eager render under the switch")
                    check(calls[2][1] == calls[0][1] and sum(calls[2][1].values()) > 0,
                          f"{tag}: launches per replay {calls[2][1]} vs eager {calls[0][1]}")
                    key = {"CULL_MODE": "mode", "OCCL_EARLY_EXIT": "early_exit"}[name]
                    check(len(records) >= 2 * len(spied)
                          and all(kw.get(key) == value for _, _, kw in records),
                          f"{tag}: the new key's calls passed "
                          f"{[kw.get(key) for _, _, kw in records]}")
                    capture = records[len(records) // 2:]  # the capture's calls
                    for k, args, kw in capture:
                        cnt = plain_cnt(k, args, kw)
                        check(torch.equal(kw["cnt_out"], cnt), f"{tag}: {k}'s cnt_out after the "
                              "replay differs from the plain lists' cnt in the new mode")
                    changed = not torch.equal(want, before)
                    say(f"{tag}: a new key; the replay equals the eager render under the switch "
                        f"({'another image' if changed else 'the same image'} as before the "
                        f"flip), launches {calls[2][1]}, the captured cnt_out equal to the plain "
                        f"lists' in the new mode  [{card}]")
                    out[label] = dict(launches=calls[2][1], image_changed=changed)
        finally:
            for k in spied:
                setattr(mods[k], k, originals[k])
            graphs.clear()
    return out


def modes_phase(card, results, seen, seen5):
    """Path N's kernel legs: the default instantiations' build
    (`default_build_check`), then K1 and K2 in each mode on the flagship's
    camera and shadow wavefronts, K5 and K6 on config 5's (`mode_kernels`)."""
    t0 = time.perf_counter()
    default_build_check()
    out = {}
    with torch.no_grad():
        for wavefront in seen[:2]:
            mode_kernels(card, results, wavefront, False, 1920, "flagship 1920x1080", 20)
        for wavefront in seen5[:2]:
            mode_kernels(card, results, wavefront, True, 3840, "config 5 3840x2160", 3)
    out["seconds"] = time.perf_counter() - t0
    say(f"N kernel legs: {out['seconds']:.1f} s")
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="instead of the smoke run: build, then profile one fwd+bwd step "
                             "of the flagship, Cornell, config 4 and config 5 under "
                             "torch.profiler")
    parser.add_argument("--rank-leg", choices=list(LEG_MESH) + list(DRYRUN_LEGS),
                        help="run as one rank of a path-I leg or of a path-K dry run (started "
                             "by that path itself, in the torchrun environment)")
    parser.add_argument("--out", help="with --rank-leg: the directory for the rank's results")
    args = parser.parse_args()
    if args.rank_leg in DRYRUN_LEGS:
        dryrun_rank_main(args.rank_leg, args.out)
        return
    if args.rank_leg:
        rank_main(args.rank_leg, args.out)
        return
    t_start = time.perf_counter()
    card = device_phase()
    build_phase()
    results = {name: {"name": name, "route": "cuda", "source": CSRC + src, "replaces": rep,
                      "launches": 0, "library_ms": None}
               for name, (_, src, rep) in {**KERNELS, **FETCH, **ADAM}.items()}

    # Scenes and frames of the six paths.
    flag = bench_scene()
    flag_cam = camera((0.0, 2.0, 6.0), 1920, 1080)
    corn = cornell_box()
    corn_cam = camera((0.0, 1.0, 2.0), 1024, 768)
    mixed = mixed_scene()
    mixed_cam = camera((0.0, 2.5, 7.0), 1920, 1080)
    soup = random_scene(100_000)
    soup_cam = camera((0.0, 18.0, 45.0), 3840, 2160)
    soup_cam_1080 = camera((0.0, 18.0, 45.0), 1920, 1080)
    auto = RenderConfig(backend="auto")
    d4 = auto.replace(depth=4)
    if args.profile:
        profile_phase(card, {"flagship": (flag, flag_cam, 1920, 1080, auto),
                             "flagship (graphed)": (flag, flag_cam, 1920, 1080, auto),
                             "Cornell": (corn, corn_cam, 1024, 768, auto),
                             "config 4": (mixed, mixed_cam, 1920, 1080, d4),
                             "config 4 (graphed)": (mixed, mixed_cam, 1920, 1080, d4),
                             "config 5": (soup, soup_cam, 3840, 2160, auto)})
        return

    # Phase 3: kernels vs plain versions on their paths' inputs.
    o, d, ids = rays(flag_cam, 1920, 1080)
    seen = capture_wavefronts(o, d, flag, ids, auto, rt_mxu.mxu_tile_search,
                              rt_mxu.mxu_tile_occlusion)
    mxtile_kernels(card, seen, results)
    results["winner_gather"]["flagship"], results["winner_scatter"]["flagship"] = winner_kernels(
        card, "flagship 1920x1080", flag, flag_cam, 1920, 1080, rt_mxu.mxu_tile_search)
    fused_tables_check(card, "Cornell", corn, results)
    results["fused_tables"]["config4"] = fused_tables_check(card, "config 4", mixed)
    limit = random_scene(2044, extent=4.0)  # 2,048 valid triangles: the limit
    check(fused_pallas.fused_supported(limit, 1, "area") and limit.triangles.capacity == 2048,
          "the 2,048-triangle table is not fused-eligible")
    results["fused_tables"]["limit"] = fused_tables_check(card, "random_scene(2044), 2048 "
                                                          "triangles", limit)
    del limit
    o, d, ids = rays(corn_cam, 1024, 768)
    results["fused_kernel"].update(fused_kernel_check(card, o, d, corn, ids, auto,
                                                      "Cornell 1024x768, depth 1"),
                                   at="Cornell 1024x768, depth 1")
    lane_kernels(card, o, d, corn, ids, results)
    results["winner_gather"]["cornell"], results["winner_scatter"]["cornell"] = winner_kernels(
        card, "Cornell 1024x768", corn, corn_cam, 1024, 768, lane_pallas.lane_tri_search)
    for name in FETCH:  # the kernels line's numbers: the flagship's
        results[name].update({k: v for k, v in results[name]["flagship"].items()
                              if k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")})
    results["adam_step"].update(adam_kernels(card, "flagship", flag))
    results["adam_step"]["cornell"] = adam_kernels(card, "Cornell", corn)
    o, d, ids = rays(mixed_cam, 1920, 1080)
    results["fused_kernel"]["config4"] = fused_kernel_check(
        card, o, d, mixed, ids, d4, "config 4, mixed 1920x1080, depth 4")
    del o, d, ids
    mxtile_backward_kernels(card, mixed, mixed_cam, 1920, 1080, d4, results)
    o, d, ids = rays(soup_cam, 3840, 2160)
    seen5 = capture_wavefronts(o, d, soup, ids, auto, rt_tile.tile_tri_search,
                               rt_tile.tile_occlusion)
    check(len(seen5) == 2, f"config 5 made {len(seen5)} searches, want 2 (camera, shadow)")
    del o, d, ids
    tile_kernels(card, seen5, 3840, results)
    tile_layer_phase(card, seen5)
    modes = modes_phase(card, results, seen, seen5)  # path N's kernel legs
    del seen5  # ~0.5 GiB that would count in every later path's peak memory
    soup500 = random_scene(500_000)
    nseg = -(-soup500.triangles.capacity // rt_tile.TILE_TRI_LIMIT)
    check(nseg == 4, f"random_scene(500_000) goes through {nseg} segments, not 4")
    o, d, ids = rays(soup_cam_1080, 1920, 1080)
    seen500 = capture_wavefronts(o, d, soup500, ids, auto, rt_tile.tile_tri_search,
                                 rt_tile.tile_occlusion)
    check(len(seen500) == 2, f"the 500k soup made {len(seen500)} searches, want 2")
    del o, d, ids
    tile_segment_kernels(card, seen500, 1920, results)
    del seen500

    # Phase 4: the main paths, from the same host and allocator state whatever
    # phase 3 did before them.
    gc.collect()
    torch.cuda.empty_cache()
    k12, k3 = ["mxu_kernel", "mxu_occl_kernel"], ["fused_tables", "fused_kernel"]
    k56 = ["tile_kernel", "tile_occl_kernel"]
    paths = {
        "flagship": path_phase(card, "flagship", flag, flag_cam, 1920, 1080, auto, "mxtile",
                               k12, k12, results, fetch=fetch_counts((1, 0), (1, 1))),
        # Cornell's float leaves that can carry gradient: v0, v1, v2, ka, kd, ks, ke.
        # Its forward is the fused kernel; the backward's lane re-derivation fetches.
        "cornell": path_phase(card, "Cornell", corn, corn_cam, 1024, 768, auto, "fused", k3,
                              k3 + ["lane_kernel"], results, min_nonzero=7, small=(128, 96),
                              fetch=fetch_counts((0, 0), (1, 1))),
        "config4": path_phase(card, "config 4", mixed, mixed_cam, 1920, 1080, d4, "fused", k3,
                              k3 + k12, results),
        "cornell_reference_cpp": path_phase(
            card, "Cornell reference_cpp", corn, corn_cam, 1024, 768,
            auto.replace(light_mode="reference_cpp"), "lane", ["lane_kernel"], None, results,
            small=(128, 96)),
        "config5": path_phase(card, "config 5", soup, soup_cam, 3840, 2160, auto, "tile", k56,
                              k56, results),
    }
    del soup
    paths["soup500k"] = path_phase(card, "soup 500k", soup500, soup_cam_1080, 1920, 1080, auto,
                                   "tile", k56, k56, results, reps=3, min_launches=nseg)
    del soup500
    paths["entry_point"] = entry_point_phase(card, results)
    paths["training"] = training_phase(card, results, flag, flag_cam, 1920, 1080, auto)
    paths["sharded"] = sharded_phase(card, results, flag, flag_cam, corn, corn_cam)
    paths["scripts"] = scripts_phase(card, results)
    paths["root_entries"] = root_entries_phase(card, results)
    paths["lights"] = lights_phase(card, results, auto)
    paths["graphs"] = graph_phase(card, results, flag, flag_cam, corn, corn_cam, mixed,
                                  mixed_cam)
    t_n = time.perf_counter()
    paths["modes"] = dict(modes, graph_flips=graph_flip_leg(card, results, flag, flag_cam))
    paths["modes"]["seconds"] += time.perf_counter() - t_n
    say(f"N: {paths['modes']['seconds']:.1f} s in all")
    feeder_check(flag, flag_cam, 1920, 1080, auto)
    fused_feeder_check(card, corn, corn_cam, 1024, 768, auto)
    layer_phase(card, seen)
    fused_layer_phase(card, "Cornell", corn, corn_cam, 1024, 768, auto)
    fused_layer_phase(card, "config 4", mixed, mixed_cam, 1920, 1080, d4)
    say(json.dumps({"paths": paths}))
    say(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name in {**KERNELS, **FETCH, **ADAM}:
        check(all(k in results[name] for k in keys), f"{name}: the kernels line lacks "
              f"{[k for k in keys if k not in results[name]]}")
    check(all(results[name]["launches"] > 0 for name in {**FETCH, **ADAM}),
          f"the winner and Adam kernels' launches: "
          f"{[results[name]['launches'] for name in {**FETCH, **ADAM}]}")
    say(json.dumps({"kernels": [results[name] for name in {**KERNELS, **FETCH, **ADAM}]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
