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
   through four 131,072-triangle segments (`_sliced`).

Phases, any failure exits non-zero (no phase catches its own failure):
1. device: needs a CUDA device (there is no CPU path); prints the card's
   name and power limit (nvidia-smi), the torch and CUDA versions, and
   turns TF32 off;
2. build: builds the four CUDA sources from csrc/ with nvcc, one process
   each, all started together; prints each kernel's registers, spills
   and shared memory;
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
   of a bound taken at 67 TFLOP/s;
4. main paths A-F: for each, every kernel's launch counter set to 0 just
   before a run and read just after (forward, then forward + backward),
   checks (finite, non-black image, finite gradients, counters > 0, a
   small frame agreeing with the plain `jnp` backend), then forward and
   fwd+bwd times from CUDA events (median of 5, ray ids varied per
   iteration) and the peak device memory; the flagship's fwd+bwd step
   calls neither `_prep_mxu` nor `_oversized_occl` (counting spies);
   Cornell's forward is one table build and one K3 launch and calls
   neither `build_clusters` nor `lane_tri_constants`, its fwd+bwd launches
   K4 twice and builds no constants on the host, and `lane_tri_search` is
   one launch (counting spies); the layers of the flagship's forward, and
   of the Cornell and config-4 steps, timed alone;
5. prints the wall time, {"kernels": [...]} and, as the last line, the
   result line.

Usage: python3 chip_smoke.py   (from the repository root)
       python3 chip_smoke.py --profile   (instead: one fwd+bwd step each of
       the flagship, Cornell, config 4 and config 5 under torch.profiler: device
       operations, device time, busy share of the step, costliest kernels)
"""

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from esctp1raytracer_tpu_torch.accel import clusters
from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, resolve_backend, trace_rays
from esctp1raytracer_tpu_torch.kernels import _build, fused_pallas, lane_pallas, rt_mxu, rt_tile
from esctp1raytracer_tpu_torch.kernels.cull import block_cull_mask
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params
from esctp1raytracer_tpu_torch.scene.builders import (
    bench_scene, cornell_box, mixed_scene, random_scene,
)

CSRC = "esctp1raytracer_tpu_torch/csrc/"
TPU = "esctp1raytracer_tpu/kernels/"
# wrapper name: (module, plain version, its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "mxu_kernel": (rt_mxu, rt_mxu._mxu_search_plain, "rt_mxu.cu", TPU + "rt_mxu.py:153"),
    "mxu_occl_kernel": (rt_mxu, rt_mxu._mxu_occl_plain, "rt_mxu.cu", TPU + "rt_mxu.py:215"),
    "fused_tables": (fused_pallas, fused_pallas._fused_tables_plain, "fused.cu",
                     TPU + "fused_pallas.py:91 fused_tables (XLA ops, not a Pallas kernel)"),
    "fused_kernel": (fused_pallas, fused_pallas._fused_plain, "fused.cu",
                     TPU + "fused_pallas.py:162"),
    "lane_kernel": (lane_pallas, lane_pallas._lane_plain, "lane.cu",
                    TPU + "lane_pallas.py:69"),
    "tile_kernel": (rt_tile, rt_tile._tile_search_plain, "rt_tile.cu", TPU + "rt_tile.py:241"),
    "tile_occl_kernel": (rt_tile, rt_tile._tile_occl_plain, "rt_tile.cu",
                         TPU + "rt_tile.py:328"),
}
SOURCES = ("rt_mxu", "lane", "fused", "rt_tile")
TILE_SLICE = 262_144  # rays of config 5's wavefronts held against the plain versions
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


def cuda_ms(fn, iters=1):
    """Mean milliseconds per call of fn() over iters calls, from CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wrapper(name):
    return getattr(KERNELS[name][0], name)


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, nbytes):
    """(bound_ms, "operations" or "bytes"): the larger of ops over PEAK_F32
    and nbytes over PEAK_BYTES."""
    by_ops, by_bytes = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def reset_counts():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_counts():
    torch.cuda.synchronize()
    return {name: wrapper(name).launches for name in KERNELS}


def device_phase():
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0 = {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def build_phase():
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source, in parallel
        libs = dict(zip(SOURCES, pool.map(_build.build, SOURCES)))
    for mod in (rt_mxu, lane_pallas, fused_pallas, rt_tile):
        mod._lib()
    say(f"build: {time.perf_counter() - t0:.2f} s ({len(SOURCES)} sources in parallel)")
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
    ms = statistics.median(cuda_ms(fn_k, iters_k) for _ in range(3))
    plain_ms = cuda_ms(fn_p, iters_p)
    say(f"{name} [{what}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    return ms, plain_ms


def mxtile_args(wavefront):
    """K1's or K2's arguments on one captured wavefront, as the entry points
    pass them: (wrapper name, args, ov_buf or None). K2 gets the oversized
    sub-block, as mxu_tile_occlusion's first segment does."""
    occl, oo, dd, tris, eps, t_limit = wavefront
    segs, ov_buf, _ = rt_mxu._segments(tris, occl)
    (tfq, aabbs, _), = list(segs)
    rays_, eps_t = rt_tile._pad_rays(oo, dd, t_limit), rt_mxu._eps_tensor(eps, oo.device)
    if occl:
        return "mxu_occl_kernel", (eps_t, rays_, aabbs, tfq, rt_tile._pack_sub(ov_buf)[0]), ov_buf
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
    out_p = KERNELS[name][1](*args)
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
        split = (KERNELS[name][1](*args[:4])[:r] > 0) | over
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
        ov_pairs += int((n * live.view(-1)[sl]).sum())
        done.view(-1)[sl] |= hit.any(1)
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


def mxtile_kernels(card, seen, results):
    """K1 and K2 on the flagship's camera and shadow wavefronts, as the entry
    points call them (`mxtile_check`), each timed beside its plain version
    and its bound, with the full count of the bound beside it."""
    with torch.no_grad():
        for wavefront in seen[:2]:
            name, args, ov_buf = mxtile_args(wavefront)
            agree, max_abs, rel, share, lists = mxtile_check(name, name, args, ov_buf, wavefront)
            if rel is None:
                say(f"{name}: occlusion agrees {agree:.6f}, occluded {share:.4f}; cnt_out "
                    "equals _prep_mxu's cnt; the oversized fold equals _oversized_occl")
            else:
                say(f"{name}: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                    f"max rel t err {rel:.3e}, hits {share:.4f}; cnt_out equals _prep_mxu's cnt")
            _, ids, cnt, _ = lists
            n_pad = list_split(args[2], ids, cnt).float()
            say(f"{name}: groups {cnt.shape[0]}, blocks {args[2].shape[1]}, mean list "
                f"{cnt.float().mean().item():.2f} (max {int(cnt.max())}), of which padding-only "
                f"{n_pad.mean().item():.2f}, swept {(cnt - n_pad).mean().item():.2f}")
            ms, plain_ms = time_pair(name, lambda: wrapper(name)(*args),
                                     lambda: KERNELS[name][1](*args), 20, 2, card,
                                     "flagship 1080p")
            ops, nbytes, full_ops = mxtile_work(name, args, lists, ov_buf, wavefront)
            bound_ms, bound_by = bound(ops, nbytes)
            full_ms, _ = bound(full_ops, nbytes)
            say(f"{name} [flagship 1080p]: bound {bound_ms:.3f} ms ({bound_by}; {ops:.4g} "
                f"operations); by the full count {full_ms:.3f} ms ({full_ops:.4g})")
            results[name].update(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 bound_ms_full_count=full_ms, at="flagship 1920x1080, depth 1")


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
                        name, lambda: wrapper(name)(*args), lambda: KERNELS[name][1](*args),
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


def lane_kernels(card, o, d, scene, ids, results):
    """K4 on the Cornell frame's camera and shadow wavefronts (lane route),
    with the arguments `lane_tri_search` gives it: within the bars of its
    plain version on the card, and its t and winners bit-identical to the
    plain version on a CPU copy (the constants rounded as on the CPU)."""
    seen = capture_wavefronts(o, d, scene, ids, RenderConfig(backend="lane"),
                              lane_pallas.lane_tri_search)
    check(len(seen) == 2, f"lane route made {len(seen)} searches, want 2 (camera, shadow)")
    plain = KERNELS["lane_kernel"][1]
    for k, what in enumerate(("camera", "shadow")):
        _, oo, dd, tris, eps, _ = seen[k]
        with torch.no_grad():
            args = (eps, tris.v0, tris.v1, tris.v2, tris.valid, oo.contiguous(), dd.contiguous())
            out_k = lane_pallas.lane_kernel(*args)
            agree, max_abs, rel, share = search_agreement(f"lane_kernel ({what})", out_k,
                                                          plain(*args))
            cpu = plain(*(x.cpu() if torch.is_tensor(x) else x for x in args))
            identical(f"lane_kernel ({what}) vs its plain version on a CPU copy",
                      tuple(x.cpu() for x in out_k), cpu)
            say(f"lane_kernel ({what}): winners agree {agree:.6f} with the plain version on the "
                f"card, max abs t err {max_abs:.3e}, max rel t err {rel:.3e}, hits {share:.4f}; "
                "t and winners bit-identical to the plain version on a CPU copy")
            ms, plain_ms = time_pair("lane_kernel", lambda: lane_pallas.lane_kernel(*args),
                                     lambda: plain(*args), 20, 3, card,
                                     f"Cornell 1024x768 {what} wavefront")
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
            say(f"lane_kernel [{what}]: bound {bound_ms:.4f} ms ({bound_by}; {pairs} pairs, of "
                f"which the skip rejects {skipped / max(pairs, 1):.4f}); without the skip (40 per "
                f"pair) {old_ms:.4f} ms; launch {lane_pallas.launch_shape(oo.shape[0], n)}")
        entry = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, bound_ms_no_skip_count=old_ms,
                     skipped_share=skipped / max(pairs, 1))
        if what == "camera":
            results["lane_kernel"].update(entry, at="Cornell 1024x768 camera wavefront")
        else:
            results["lane_kernel"]["shadow_wavefront"] = entry


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
    tc, aabbs, _, ov_buf, _ = rt_tile.tri_constants_sub(tris, exclude_oversized=occl)
    rays_, eps_t = rt_tile._pad_rays(oo, dd, t_limit), rt_tile._eps_tensor(eps, oo.device)
    if occl:
        return "tile_occl_kernel", (eps_t, rays_, aabbs, tc, rt_tile._pack_sub(ov_buf)[0]), ov_buf
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
    plain = KERNELS[name][1](*on_rays(args, rs))
    if name == "tile_kernel":
        identical(label, (whole[0][rs], whole[1][rs]), plain)
    else:
        identical(label, whole[rs], plain)
        if ov_buf is not None:
            _, oo, dd, _, eps_f, t_limit = wavefront
            split = (KERNELS[name][1](*on_rays(args[:4], rs)) > 0) | rt_tile._oversized_occl(
                oo[rs], dd[rs], t_limit[rs], ov_buf, eps_f)
            check(torch.equal(whole[rs] > 0, split),
                  f"{label}: K6 with the oversized sub-block differs from the segment sweep "
                  "ORed with _oversized_occl")
    return whole, plain


def tile_kernels(card, seen, w, results):
    """K5 and K6 on config 5's camera and shadow wavefronts, as the entry
    points call them (K5 culling by the hook's t_limit, K6 with the
    oversized sub-block). Each kernel runs on the whole wavefront with
    cnt_out, held equal to the plain path's list lengths there; its output
    on TILE_SLICE rays of whole image rows, centred on the row with the
    longest mean list, is held bit-identical to the plain version's on the
    same slice. Timed: the kernel on the whole wavefront and on the slice,
    the plain version on the slice, each beside its bound."""
    for wavefront in seen[:2]:
        with torch.no_grad():
            name, args, ov_buf = tile_args(wavefront)
            r = wavefront[1].shape[0]
            cnt, visits, live = tile_sweeps(name, args)
            rs, bs, heavy, mean = heavy_slice([cnt], r, w)
            whole, plain = tile_check(name, f"{name} [config 5]", args, cnt, ov_buf, wavefront,
                                      rs)
            say(f"{name} [config 5]: {cnt.shape[0]} bundles x {args[3].shape[0]} sub-blocks, "
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
                                     lambda: KERNELS[name][1](*sargs), 10, 1, card,
                                     f"config 5 slice of {TILE_SLICE} rays")
            whole_ms = cuda_ms(lambda: wrapper(name)(*args), 3)
            bound_ms, bound_by = bound(*tile_work(name, sargs, visits[bs], live[bs]))
            whole_bound_ms, _ = bound(*tile_work(name, args, visits, live))
            say(f"{name} [config 5]: slice kernel {ms:.3f} ms, bound {bound_ms:.3f} ms "
                f"({bound_by}); whole wavefront ({r} rays) kernel {whole_ms:.3f} ms, bound "
                f"{whole_bound_ms:.3f} ms  [{card}]")
        results[name].update(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, whole_ms=whole_ms, whole_bound_ms=whole_bound_ms,
                             at=f"config 5 3840x2160 {'shadow' if name != 'tile_kernel' else 'camera'}"
                                f" wavefront, slice of {TILE_SLICE} rays from ray {rs.start} "
                                "(whole_*: the whole wavefront)")


def tile_segment_kernels(card, seen, w, results):
    """K5 and K6 on the 500k soup's camera and shadow wavefronts, for each of
    `_sliced`'s segments, as the entry points call them: each kernel runs on
    the whole wavefront against the segment's table (K6 with the oversized
    sub-block in segment 0), with cnt_out held equal to the plain path's
    list lengths, and its output on TILE_SLICE rays of whole image rows,
    centred on the row with the longest mean list over all segments, held
    bit-identical to the plain version's. The plain outputs, combined as
    the entry points combine segments (first-wins for the search, OR for
    the occlusion), are then held equal to `tile_tri_search` /
    `tile_occlusion` on the slice. Timed: the kernel on the whole wavefront
    beside its bound, the plain version on the slice."""
    for wavefront in seen[:2]:
        occl, oo, dd, tris, eps, t_limit = wavefront
        name = "tile_occl_kernel" if occl else "tile_kernel"
        what = "shadow" if occl else "camera"
        r, eps_t = oo.shape[0], rt_tile._eps_tensor(eps, oo.device)
        with torch.no_grad():
            segs, ov_buf, _ = rt_tile._sliced(tris, exclude_oversized=occl)
            ov = rt_tile._pack_sub(ov_buf)[0]
            rays_ = rt_tile._pad_rays(oo, dd, t_limit)
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
                s["ms"].append(cuda_ms(lambda: wrapper(name)(*args)))
                tc = args[3]
                s["plain_ms"].append(cuda_ms(lambda: KERNELS[name][1](*on_rays(args, rs))))
                b_ms, b_by = bound(*tile_work(name, args, visits, live))
                s["bound_ms"].append(b_ms)
                s["bound_by"].append(b_by)
                if occl:
                    comb = plain > 0 if comb is None else comb | (plain > 0)
                else:
                    t_k, i_k = plain[0], rt_tile._orig(plain[1], perm_k)
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


def path_phase(card, label, scene, cam, w, h, cfg, expect, fwd_kernels, bwd_kernels, results,
               min_nonzero=8, small=(192, 108), reps=5, min_launches=1):
    """Drive one main path: forward, then fwd+bwd, each with the launch
    counters reset just before and read just after; checks, and timings
    over `reps` steps."""
    check(resolve_backend(cfg, scene) == expect,
          f"{label}: backend {cfg.backend!r} resolves to {resolve_backend(cfg, scene)!r}, "
          f"not {expect!r}")
    step = make_step(scene, *rays(cam, w, h), cfg)
    runs = [("forward", fwd_kernels, False)] + ([("fwd+bwd", bwd_kernels, True)]
                                               if bwd_kernels else [])
    for what, need, backward in runs:
        reset_counts()
        with torch.set_grad_enabled(backward):
            color, loss, grads = step(0, backward)
        counts = read_counts()
        say(f"{label} {what}: launches {counts}, loss {loss.item():.6e}")
        for name in need:
            check(counts[name] >= min_launches,
                  f"{label} {what}: {name} launched {counts[name]} times, < {min_launches}")
        for name, n in counts.items():
            results[name]["launches"] += n
        check(tuple(color.shape) == (w * h, 3), f"{label}: color shape {tuple(color.shape)}")
        check(bool(torch.isfinite(color).all()), f"{label}: non-finite pixel")
        check(color.mean().item() > 0.01, f"{label}: image is black")
        if backward:
            check(all(bool(torch.isfinite(g).all()) for g in grads), f"{label}: non-finite grad")
            nonzero = sum(bool((g != 0).any()) for g in grads)
            say(f"{label}: {nonzero} of {len(grads)} float leaves have a non-zero gradient")
            check(nonzero >= min_nonzero, f"{label}: {nonzero} non-zero gradients < {min_nonzero}")

    # A small frame through the kernels against the plain `jnp` backend.
    sw, sh = small
    a = render(scene, cam, sw, sh, cfg)
    b = render(scene, cam, sw, sh, cfg.replace(backend="jnp"))
    diff = (a - b).abs()
    say(f"{label}: small frame {sw}x{sh} vs jnp backend: mean |diff| {diff.mean().item():.3e}, "
        f"share > 1e-2 {(diff > 1e-2).float().mean().item():.5f}")
    check(diff.mean().item() < 1e-4 and (diff > 1e-2).float().mean().item() < 5e-3,
          f"{label}: small frame disagrees with the jnp backend")

    with torch.no_grad():
        step(1, backward=False)
        torch.cuda.reset_peak_memory_stats()
        fwd = [cuda_ms(lambda: step(2 + k, backward=False)) for k in range(reps)]
    timing = {"forward_ms": statistics.median(fwd),
              "forward_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    say(f"{label} forward    : {timing['forward_ms']:.2f} ms median of "
        f"{[round(x, 2) for x in fwd]} = {w * h / timing['forward_ms'] / 1e3:.3f} Mrays/s"
        f"  [{card}]")
    say(f"{label} peak device memory (forward): {timing['forward_peak_gib']:.2f} GiB  [{card}]")
    if bwd_kernels:
        step(2 + reps)
        torch.cuda.reset_peak_memory_stats()
        fb = [cuda_ms(lambda: step(3 + reps + k)) for k in range(reps)]
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
    (tfq_p, ab_p, _), = list(rt_mxu._segments(tris, False)[0])
    segs, ov_buf, _ = rt_mxu._segments(tris, True)
    (tfq_s, ab_s, _), = list(segs)
    eps_t = rt_mxu._eps_tensor(eps, po.device)
    with torch.no_grad():
        ov = rt_tile._pack_sub(ov_buf)[0]
        prim, shad = rt_tile._pad_rays(po, pd, ptl), rt_tile._pad_rays(so, sd, stl)
        entries = {"mxu_tile_search": lambda: rt_mxu.mxu_tile_search(po, pd, tris, eps, ptl),
                   "mxu_tile_occlusion": lambda: rt_mxu.mxu_tile_occlusion(so, sd, stl, tris,
                                                                           eps)}
        for what, fn in entries.items():
            say(f"layer flagship: {what}: peak {gib_above(fn):.2f} GiB above its inputs  [{card}]")
        layers = {
            "cluster sort + pack (per search)": lambda: list(rt_mxu._segments(tris, False)[0]),
            "pad rays (per search)": lambda: rt_tile._pad_rays(po, pd, ptl),
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
            t = statistics.median(cuda_ms(fn) for _ in range(3))
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
        reset_counts()
        step(0)
        counts = read_counts()
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
    tc_p, ab_p, _, _, _ = rt_tile.tri_constants_sub(tris)
    tc_s, ab_s, _, ov_buf, _ = rt_tile.tri_constants_sub(tris, exclude_oversized=True)
    eps_t = rt_tile._eps_tensor(eps, po.device)
    with torch.no_grad():
        ov = rt_tile._pack_sub(ov_buf)[0]
        prim, shad = rt_tile._pad_rays(po, pd, ptl), rt_tile._pad_rays(so, sd, stl)
        entries = {"tile_tri_search": lambda: rt_tile.tile_tri_search(po, pd, tris, eps, ptl),
                   "tile_occlusion": lambda: rt_tile.tile_occlusion(so, sd, stl, tris, eps)}
        for what, fn in entries.items():
            say(f"layer config 5: {what}: peak {gib_above(fn):.2f} GiB above its inputs  [{card}]")
        layers = {
            "cluster sort + pack (per search)": lambda: rt_tile.tri_constants_sub(tris),
            "pad rays (per search)": lambda: rt_tile._pad_rays(po, pd, ptl),
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
            t = statistics.median(cuda_ms(fn) for _ in range(3))
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
            reset_counts()
            with torch.set_grad_enabled(backward):
                step(0, backward)
            got[what] = read_counts()
        o, d, _ = rays(cam, w, h)
        reset_counts()
        with torch.no_grad():
            lane_pallas.lane_tri_search(o, d, scene.triangles, float(cfg.eps))
        got["lane_tri_search"] = read_counts()
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
            t = statistics.median(cuda_ms(fn) for _ in range(3))
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
        step = make_step(scene, *rays(cam, w, h), cfg)
        step(0)
        walls = []
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(1 + k)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="instead of the smoke run: build, then profile one fwd+bwd step "
                             "of the flagship, Cornell, config 4 and config 5 under "
                             "torch.profiler")
    args = parser.parse_args()
    t_start = time.perf_counter()
    card = device_phase()
    build_phase()
    results = {name: {"name": name, "route": "cuda", "source": CSRC + src, "replaces": rep,
                      "launches": 0, "library_ms": None}
               for name, (_, _, src, rep) in KERNELS.items()}

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
                             "Cornell": (corn, corn_cam, 1024, 768, auto),
                             "config 4": (mixed, mixed_cam, 1920, 1080, d4),
                             "config 5": (soup, soup_cam, 3840, 2160, auto)})
        return

    # Phase 3: kernels vs plain versions on their paths' inputs.
    o, d, ids = rays(flag_cam, 1920, 1080)
    seen = capture_wavefronts(o, d, flag, ids, auto, rt_mxu.mxu_tile_search,
                              rt_mxu.mxu_tile_occlusion)
    mxtile_kernels(card, seen, results)
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
                               k12, k12, results),
        # Cornell's float leaves that can carry gradient: v0, v1, v2, ka, kd, ks, ke.
        "cornell": path_phase(card, "Cornell", corn, corn_cam, 1024, 768, auto, "fused", k3,
                              k3 + ["lane_kernel"], results, min_nonzero=7, small=(128, 96)),
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
    feeder_check(flag, flag_cam, 1920, 1080, auto)
    fused_feeder_check(card, corn, corn_cam, 1024, 768, auto)
    layer_phase(card, seen)
    fused_layer_phase(card, "Cornell", corn, corn_cam, 1024, 768, auto)
    fused_layer_phase(card, "config 4", mixed, mixed_cam, 1920, 1080, d4)
    say(json.dumps({"paths": paths}))
    say(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name in KERNELS:
        check(all(k in results[name] for k in keys), f"{name}: the kernels line lacks "
              f"{[k for k in keys if k not in results[name]]}")
    say(json.dumps({"kernels": [results[name] for name in KERNELS]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
