"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main paths at full size, through `trace_rays` /
`render` with backend "auto", and holds every CUDA kernel on them
against its plain PyTorch version:

A. the flagship (bench.py): 1920x1080 camera rays over the 10,244-triangle
   benchmark scene, depth 1, forward and the gradient of sum(color^2)
   with respect to every float scene leaf; "auto" resolves to mxtile
   (kernels K1, K2);
B. the Cornell box (bench.py's Cornell leg), 1024x768, depth 1: "auto"
   resolves to the fused whole-frame kernel K3, whose backward
   re-derives the frame on the lane route (K4);
C. BASELINE config 4: mixed_scene(), 1920x1080, depth 4: "auto" resolves
   to K3, whose backward re-derives the frame through chunked mxtile (K1,
   K2);
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
   the time of each (CUDA events): K1/K2 on the flagship's wavefronts and
   on every wavefront of config 4's chunked backward, K3 on the Cornell
   and config-4 frames, K4 on Cornell's camera and shadow wavefronts, K5
   and K6 on config 5's camera and shadow wavefronts and, per segment, on
   the 500k soup's (the kernel on the whole wavefront, held against the
   plain version on a 262,144-ray slice across the horizon rows, where the
   lists are longest; for the 500k soup, the plain segments combined are
   also held against the entry points' own output); the layers of config
   5's forward timed alone;
4. main paths A-F: for each, every kernel's launch counter set to 0 just
   before a run and read just after (forward, then forward + backward),
   checks (finite, non-black image, finite gradients, counters > 0, a
   small frame agreeing with the plain `jnp` backend), then forward and
   fwd+bwd times from CUDA events (median of 5, ray ids varied per
   iteration) and the peak device memory; the layers of the flagship's
   forward, and of the Cornell and config-4 steps, timed alone;
5. prints the wall time, {"kernels": [...]} and, as the last line, the
   result line.

Usage: python3 chip_smoke.py   (from the repository root)
       python3 chip_smoke.py --profile   (instead: one fwd+bwd step each of
       the flagship, Cornell, config 4 and config 5 under torch.profiler: device
       operations, device time, busy share of the step, costliest kernels)
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, resolve_backend, trace_rays
from esctp1raytracer_tpu_torch.kernels import _build, fused_pallas, lane_pallas, rt_mxu, rt_tile
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
    "fused_kernel": (fused_pallas, fused_pallas._fused_plain, "fused.cu",
                     TPU + "fused_pallas.py:162"),
    "lane_kernel": (lane_pallas, lane_pallas._lane_search_plain, "lane.cu",
                    TPU + "lane_pallas.py:69"),
    "tile_kernel": (rt_tile, rt_tile._tile_search_plain, "rt_tile.cu", TPU + "rt_tile.py:241"),
    "tile_occl_kernel": (rt_tile, rt_tile._tile_occl_plain, "rt_tile.cu",
                         TPU + "rt_tile.py:328"),
}
SOURCES = ("rt_mxu", "lane", "fused", "rt_tile")
TILE_SLICE = 262_144  # rays of config 5's wavefronts held against the plain versions


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
        say(f"  {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("    ptxas:", line.strip())


def camera(eye, w, h, dev):
    return Camera.look_at(eye, (0.0, 1.0, 0.0), vfov=60.0, aspect=w / h, device=dev)


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
    fn_k()
    ms = cuda_ms(fn_k, iters_k)
    plain_ms = cuda_ms(fn_p, iters_p)
    say(f"{name} [{what}]: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
    return ms, plain_ms


def mxtile_args(wavefront):
    """K1's or K2's arguments on one captured wavefront: (wrapper name, args)."""
    occl, oo, dd, tris, eps, t_limit = wavefront
    (tfq, aabbs, _), = list(rt_mxu._segments(tris, occl)[0])
    rf, gids, cnt, tl, _, _ = rt_mxu._prep_mxu(oo, dd, aabbs, t_limit)
    eps = rt_mxu._eps_tensor(eps, oo.device)
    if occl:
        return "mxu_occl_kernel", (eps, gids, cnt, rf, tl, tfq)
    return "mxu_kernel", (eps, gids, cnt, rf, tfq)


def mxtile_agreement(name, args, label):
    """K1 or K2 against its plain version on args, with the bars of the JAX
    package's tests (K2: occlusion agrees on >= 99.9% of the rays). Returns
    (agreement, max abs error, max relative t error or None, hit share)."""
    out_k, out_p = wrapper(name)(*args), KERNELS[name][1](*args)
    if name == "mxu_kernel":
        return search_agreement(label, out_k, out_p)
    agree = (out_k == out_p).float().mean().item()
    check(agree >= 0.999, f"{label}: occlusion agreement {agree} < 0.999")
    return agree, float((out_k - out_p).abs().max().item()), None, out_k.float().mean().item()


def mxtile_kernels(card, seen, results):
    """K1 and K2 on the flagship's camera and shadow wavefronts."""
    with torch.no_grad():
        for wavefront in seen[:2]:
            name, args = mxtile_args(wavefront)
            agree, max_abs, rel, share = mxtile_agreement(name, args, name)
            if rel is None:
                say(f"{name}: occlusion agrees {agree:.6f}, occluded {share:.4f}")
            else:
                say(f"{name}: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                    f"max rel t err {rel:.3e}, hits {share:.4f}")
            gids, cnt = args[1], args[2]
            say(f"{name}: groups {gids.shape[0]}, blocks {gids.shape[1]}, mean list "
                f"{cnt.float().mean().item():.2f} (max {int(cnt.max())})")
            ms, plain_ms = time_pair(name, lambda: wrapper(name)(*args),
                                     lambda: KERNELS[name][1](*args), 20, 2, card,
                                     "flagship 1080p")
            results[name].update(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                                 at="flagship 1920x1080, depth 1")


def mxtile_backward_kernels(card, scene, cam, w, h, cfg, results):
    """K1 and K2 on every wavefront of config 4's backward re-derivation:
    `_bwd_cfg`'s chunked mxtile, each 262,144-ray chunk of the frame's camera
    rays and their reflections at bounces 0-3. Every wavefront is held
    against the plain versions; the first of each kernel in the chunk that
    holds the frame's centre is timed."""
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
                name, args = mxtile_args(wavefront)
                bounce += name == "mxu_kernel"
                label = f"{name} [config 4 backward, rays {i}+, bounce {bounce}]"
                agree, max_abs, rel, share = mxtile_agreement(name, args, label)
                s = stats[name]
                s["wavefronts"] += 1
                s["min_agreement"] = min(s["min_agreement"], agree)
                s["max_abs_err"] = max(s["max_abs_err"], max_abs)
                line.append(f"b{bounce} {'K2' if rel is None else 'K1'} {agree:.6f}"
                            + ("" if rel is None else f"/{rel:.1e}") + f"/{share:.3f}")
                if "ms" not in s and i <= centre < i + chunk:
                    s["ms"], s["plain_ms"] = time_pair(
                        name, lambda: wrapper(name)(*args), lambda: KERNELS[name][1](*args),
                        20, 2, card, f"config 4 backward, rays {i}+, bounce {bounce}")
        say(f"config 4 backward, rays {i}+ (agreement/rel t err/hit or occluded share): "
            + ", ".join(line))
    for name, s in stats.items():
        check(s["wavefronts"] > 0, f"config 4's backward gave {name} no wavefront")
        results[name]["config4_backward"] = dict(
            s, at=f"config 4 backward, {-(-o.shape[0] // chunk)} chunks of {chunk} rays "
                  f"x {cfg.depth} bounces")
        say(f"{name} [config 4 backward]: {s['wavefronts']} wavefronts, min agreement "
            f"{s['min_agreement']:.6f}, max abs err {s['max_abs_err']:.3e}")


def lane_kernels(card, o, d, scene, ids, results):
    """K4 on the Cornell frame's camera and shadow wavefronts (lane route)."""
    seen = capture_wavefronts(o, d, scene, ids, RenderConfig(backend="lane"),
                              lane_pallas.lane_tri_search)
    check(len(seen) == 2, f"lane route made {len(seen)} searches, want 2 (camera, shadow)")
    plain = KERNELS["lane_kernel"][1]
    for k, what in enumerate(("camera", "shadow")):
        _, oo, dd, tris, eps, _ = seen[k]
        with torch.no_grad():
            args = (torch.tensor([eps], dtype=torch.float32, device=oo.device),
                    lane_pallas.valid_prefix(tris.valid),
                    lane_pallas.lane_tri_constants(tris).contiguous(),
                    oo.contiguous(), dd.contiguous())
            agree, max_abs, rel, share = search_agreement(
                f"lane_kernel ({what})", lane_pallas.lane_kernel(*args), plain(*args))
            say(f"lane_kernel ({what}): winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                f"max rel t err {rel:.3e}, hits {share:.4f}")
            ms, plain_ms = time_pair("lane_kernel", lambda: lane_pallas.lane_kernel(*args),
                                     lambda: plain(*args), 20, 3, card,
                                     f"Cornell 1024x768 {what} wavefront")
        entry = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
        if what == "camera":
            results["lane_kernel"].update(entry, at="Cornell 1024x768 camera wavefront")
        else:
            results["lane_kernel"]["shadow_wavefront"] = entry


def fused_kernel_check(card, o, d, scene, ids, cfg, what, iters_p=1):
    """K3 on a whole frame: the image bars of tests/test_fused.py."""
    with torch.no_grad():
        tables = [t.contiguous() for t in fused_pallas.fused_tables(scene)]
        kw = dict(seed=cfg.seed, eps=float(cfg.eps), shadow_eps=float(cfg.shadow_eps),
                  depth=cfg.depth, lights=scene.lights.num_lights, faces=scene.lights.max_faces)
        a = fused_pallas.fused_kernel(o, d, ids, *tables, **kw)
        p = fused_pallas._fused_plain(o, d, ids, *tables, **kw)
        diff = (a - p).abs()
        flipped = diff.amax(dim=1) > 1e-2
        share = flipped.float().mean().item()
        rest = diff[~flipped].max().item()
        max_abs = diff.max().item()
        g = tables[4].shape[1] // 6
        say(f"fused_kernel [{what}]: G {g}, depth {cfg.depth}; pixels off by > 1e-2: "
            f"{share:.6f}, max abs err of the rest {rest:.3e}, max abs err "
            f"{max_abs:.3e}, image mean {a.mean().item():.4f}")
        check(bool(torch.isfinite(a).all()), f"fused_kernel [{what}]: non-finite pixel")
        check(share <= 2e-3, f"fused_kernel [{what}]: {share} of pixels flipped > 0.002")
        check(rest <= 3e-5, f"fused_kernel [{what}]: max abs err {rest} > 3e-5")
        ms, plain_ms = time_pair("fused_kernel", lambda: fused_pallas.fused_kernel(o, d, ids,
                                                                                  *tables, **kw),
                                 lambda: fused_pallas._fused_plain(o, d, ids, *tables, **kw),
                                 10, iters_p, card, what)
    return dict(max_abs_err=max_abs, max_abs_err_unflipped=rest, ms=ms, plain_ms=plain_ms,
                flipped_share=share)


def tile_args(wavefront):
    """K5's or K6's arguments on one captured wavefront: (wrapper name, args)."""
    occl, oo, dd, tris, eps, t_limit = wavefront
    tc, aabbs, _, _, _ = rt_tile.tri_constants_sub(tris, exclude_oversized=occl)
    rays_, ids_, cnt = rt_tile._prep(oo, dd, aabbs, t_limit)
    return ("tile_occl_kernel" if occl else "tile_kernel",
            (rt_tile._eps_tensor(eps, oo.device), rays_, ids_, cnt, tc))


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


def tile_kernels(card, seen, w, results):
    """K5 and K6 on config 5's camera and shadow wavefronts. Each kernel runs
    on the whole wavefront; its output on TILE_SLICE rays of whole image
    rows, centred on the row with the longest mean list, is held against
    the plain version on the same slice (the bars of tests/test_rt_mxu.py).
    Timed: the kernel on the whole wavefront, kernel and plain on the slice."""
    for wavefront in seen[:2]:
        with torch.no_grad():
            name, args = tile_args(wavefront)
            eps, rays_, ids_, cnt, tc = args
            r = wavefront[1].shape[0]
            rs, bs, heavy, mean = heavy_slice([cnt], r, w)
            start = rs.start
            sargs = (eps, rays_[rs], ids_[bs], cnt[bs], tc)
            whole = wrapper(name)(*args)
            plain = KERNELS[name][1](*sargs)
            say(f"{name} [config 5]: {cnt.shape[0]} bundles x {tc.shape[0]} sub-blocks, "
                f"{list_stats(cnt, bs)}; heaviest row {heavy} (mean {mean:.2f}); slice rays "
                f"{start}+{TILE_SLICE}")
            if name == "tile_kernel":
                agree, max_abs, rel, share = search_agreement(
                    name, (whole[0][rs], whole[1][rs]), plain)
                say(f"{name}: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                    f"max rel t err {rel:.3e}, hits {share:.4f} (slice), "
                    f"{(whole[1][:r] >= 0).float().mean().item():.4f} (whole)")
            else:
                agree = (whole[rs] == plain).float().mean().item()
                max_abs = float((whole[rs] - plain).abs().max().item())
                check(agree >= 0.999, f"{name}: occlusion agreement {agree} < 0.999")
                say(f"{name}: occlusion agrees {agree:.6f}, occluded {whole[rs].float().mean().item():.4f}"
                    f" (slice), {whole[:r].float().mean().item():.4f} (whole)")
            del whole, plain
            ms, plain_ms = time_pair(name, lambda: wrapper(name)(*sargs),
                                     lambda: KERNELS[name][1](*sargs), 10, 1, card,
                                     f"config 5 slice of {TILE_SLICE} rays")
            whole_ms = cuda_ms(lambda: wrapper(name)(*args), 3)
            say(f"{name} [config 5 whole wavefront, {r} rays]: kernel {whole_ms:.3f} ms  [{card}]")
        results[name].update(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, whole_ms=whole_ms,
                             at=f"config 5 3840x2160 {'shadow' if name != 'tile_kernel' else 'camera'}"
                                f" wavefront, slice of {TILE_SLICE} rays from ray {start}")


def tile_segment_kernels(card, seen, w, results):
    """K5 and K6 on the 500k soup's camera and shadow wavefronts, for each of
    `_sliced`'s segments: the kernel runs on the whole wavefront against the
    segment's table, and its output on TILE_SLICE rays of whole image rows,
    centred on the row with the longest mean list over all segments, is held
    against the plain version (the bars of tests/test_rt_mxu.py). The plain
    outputs, combined as the entry points combine segments (first-wins for
    the search; OR, and the oversized sweep, for the occlusion), are then
    held against `tile_tri_search` / `tile_occlusion` on the whole wavefront.
    Timed: the kernel on the whole wavefront, the plain version on the slice."""
    for occl, oo, dd, tris, eps, t_limit in seen[:2]:
        name = "tile_occl_kernel" if occl else "tile_kernel"
        what = "shadow" if occl else "camera"
        r, eps_t = oo.shape[0], rt_tile._eps_tensor(eps, oo.device)
        with torch.no_grad():
            segs, ov_buf, _ = rt_tile._sliced(tris, exclude_oversized=occl)
            segs = [(tc, rt_tile._prep(oo, dd, aabbs, t_limit), perm_k)
                    for tc, aabbs, perm_k in segs]
            rs, bs, heavy, mean = heavy_slice([prep[2] for _, prep, _ in segs], r, w)
            s = dict(segments=len(segs), min_agreement=1.0, max_abs_err=0.0, ms=[], plain_ms=[])
            comb = None
            for k, (tc, (rays_, ids_, cnt), perm_k) in enumerate(segs):
                label = f"{name} [500k soup {what}, segment {k}]"
                args = (eps_t, rays_, ids_, cnt, tc)
                sargs = (eps_t, rays_[rs], ids_[bs], cnt[bs], tc)
                whole = wrapper(name)(*args)
                s["ms"].append(cuda_ms(lambda: wrapper(name)(*args)))
                out = []
                s["plain_ms"].append(cuda_ms(lambda: out.append(KERNELS[name][1](*sargs))))
                plain, = out
                if occl:
                    agree = (whole[rs] == plain).float().mean().item()
                    max_abs = float((whole[rs] - plain).abs().max().item())
                    check(agree >= 0.999, f"{label}: occlusion agreement {agree} < 0.999")
                    comb = plain > 0 if comb is None else comb | (plain > 0)
                else:
                    agree, max_abs, _, _ = search_agreement(
                        label, (whole[0][rs], whole[1][rs]), plain)
                    t_k, i_k = plain[0], rt_tile._orig(plain[1], perm_k)
                    if comb is None:
                        comb = (t_k, i_k)
                    else:
                        better = t_k < comb[0]
                        comb = (torch.where(better, t_k, comb[0]), torch.where(better, i_k, comb[1]))
                s["min_agreement"] = min(s["min_agreement"], agree)
                s["max_abs_err"] = max(s["max_abs_err"], max_abs)
                say(f"{label}: {cnt.shape[0]} bundles x {tc.shape[0]} sub-blocks, "
                    f"{list_stats(cnt, bs)}; agreement {agree:.6f}, max abs err {max_abs:.3e}; "
                    f"kernel {s['ms'][-1]:.3f} ms whole, plain {s['plain_ms'][-1]:.3f} ms on the "
                    f"slice  [{card}]")
                del whole, plain
            if occl:
                comb = comb | rt_tile._oversized_occl(oo[rs], dd[rs], t_limit[rs], ov_buf, eps)
                entry = rt_tile.tile_occlusion(oo, dd, t_limit, tris, eps)[rs]
                s["combined_agreement"] = (entry == comb).float().mean().item()
                check(s["combined_agreement"] >= 0.999,
                      f"{name} [500k soup]: tile_occlusion agrees {s['combined_agreement']} "
                      "< 0.999 with the combined plain segments")
            else:
                t_e, i_e = rt_tile.tile_tri_search(oo, dd, tris, eps, t_limit)
                s["combined_agreement"] = search_agreement(
                    f"{name} [500k soup]: tile_tri_search vs the combined plain segments",
                    (t_e[rs], i_e[rs]), comb)[0]
            del segs
        say(f"{name} [500k soup {what}]: {s['segments']} segments, heaviest row {heavy} (summed "
            f"mean list {mean:.2f}), slice rays {rs.start}+{TILE_SLICE}: min agreement "
            f"{s['min_agreement']:.6f}, max abs err {s['max_abs_err']:.3e}; the entry point vs "
            f"the combined plain segments {s['combined_agreement']:.6f}")
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
    the occlusion alone on the frame's wavefronts (CUDA events, median of 3)."""
    _, po, pd, tris, eps, ptl = seen[0]
    _, so, sd, _, _, stl = seen[1]
    (_, ab_p, _), = list(rt_mxu._segments(tris, False)[0])
    segs, ov_buf, _ = rt_mxu._segments(tris, True)
    (_, ab_s, _), = list(segs)
    layers = {
        "cluster sort + pack (per search)": lambda: list(rt_mxu._segments(tris, False)[0]),
        "cull pre-pass, primary": lambda: rt_mxu._prep_mxu(po, pd, ab_p, ptl),
        "mxu_tile_search (incl. K1)": lambda: rt_mxu.mxu_tile_search(po, pd, tris, eps, ptl),
        "cull pre-pass, shadow": lambda: rt_mxu._prep_mxu(so, sd, ab_s, stl),
        "oversized any-hit sweep": lambda: rt_mxu._oversized_occl(so, sd, stl, ov_buf, eps),
        "mxu_tile_occlusion (incl. K2)": lambda: rt_mxu.mxu_tile_occlusion(so, sd, stl, tris, eps),
    }
    with torch.no_grad():
        for name, fn in layers.items():
            fn()
            t = statistics.median(cuda_ms(fn) for _ in range(3))
            say(f"layer {name:34s} {t:8.3f} ms  [{card}]")


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
    and the peak memory of each cull pre-pass."""
    _, po, pd, tris, eps, ptl = seen[0]
    _, so, sd, _, _, stl = seen[1]
    tc_p, ab_p, _, _, _ = rt_tile.tri_constants_sub(tris)
    tc_s, ab_s, _, ov_buf, _ = rt_tile.tri_constants_sub(tris, exclude_oversized=True)
    eps_t = rt_tile._eps_tensor(eps, po.device)
    with torch.no_grad():
        for what, (oo, dd, ab, tl) in {"primary": (po, pd, ab_p, ptl),
                                       "shadow": (so, sd, ab_s, stl)}.items():
            gib = gib_above(lambda: rt_tile._prep(oo, dd, ab, tl))
            say(f"layer config 5: cull pre-pass, {what}: peak {gib:.2f} GiB above its inputs "
                f"({oo.shape[0] // rt_tile.COHERENT * ab.shape[1] * 4 / 2**30:.2f} GiB of it "
                f"the lists), chunks of {rt_tile._PREPASS_ELEMS // ab.shape[1] // 128 * 128} "
                f"rays  [{card}]")
        prim = rt_tile._prep(po, pd, ab_p, ptl)
        shad = rt_tile._prep(so, sd, ab_s, stl)
        layers = {
            "cluster sort + pack (per search)": lambda: rt_tile.tri_constants_sub(tris),
            "cull pre-pass, primary": lambda: rt_tile._prep(po, pd, ab_p, ptl),
            "K5 alone": lambda: rt_tile.tile_kernel(eps_t, *prim, tc_p),
            "tile_tri_search (incl. K5)": lambda: rt_tile.tile_tri_search(po, pd, tris, eps, ptl),
            "cull pre-pass, shadow": lambda: rt_tile._prep(so, sd, ab_s, stl),
            "K6 alone": lambda: rt_tile.tile_occl_kernel(eps_t, *shad, tc_s),
            "oversized any-hit sweep": lambda: rt_tile._oversized_occl(so, sd, stl, ov_buf, eps),
            "tile_occlusion (incl. K6)": lambda: rt_tile.tile_occlusion(so, sd, stl, tris, eps),
        }
        for name, fn in layers.items():
            fn()
            t = statistics.median(cuda_ms(fn) for _ in range(3))
            say(f"layer config 5: {name:34s} {t:8.3f} ms  [{card}]")


def fused_layer_phase(card, label, scene, cam, w, h, cfg):
    """Where a fused path's time goes: the tables, K3 alone, and the
    backward's re-derivation forward alone on its route (CUDA events,
    median of 3)."""
    o, d, ids = rays(cam, w, h)
    with torch.no_grad():
        tables = [t.contiguous() for t in fused_pallas.fused_tables(scene)]
        kw = dict(seed=cfg.seed, eps=float(cfg.eps), shadow_eps=float(cfg.shadow_eps),
                  depth=cfg.depth, lights=scene.lights.num_lights, faces=scene.lights.max_faces)
        fb = fused_pallas._bwd_cfg(scene, cfg, o.shape[0])
        layers = {
            "fused_tables (per call)": lambda: fused_pallas.fused_tables(scene),
            "K3 alone": lambda: fused_pallas.fused_kernel(o, d, ids, *tables, **kw),
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
    dev = torch.device("cuda")
    results = {name: {"name": name, "route": "cuda", "source": CSRC + src, "replaces": rep,
                      "launches": 0}
               for name, (_, _, src, rep) in KERNELS.items()}

    # Scenes and frames of the six paths.
    flag = bench_scene().to(dev)
    flag_cam = camera((0.0, 2.0, 6.0), 1920, 1080, dev)
    corn = cornell_box().to(dev)
    corn_cam = camera((0.0, 1.0, 2.0), 1024, 768, dev)
    mixed = mixed_scene().to(dev)
    mixed_cam = camera((0.0, 2.5, 7.0), 1920, 1080, dev)
    soup = random_scene(100_000).to(dev)
    soup_cam = camera((0.0, 18.0, 45.0), 3840, 2160, dev)
    soup_cam_1080 = camera((0.0, 18.0, 45.0), 1920, 1080, dev)
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
    soup500 = random_scene(500_000).to(dev)
    nseg = -(-soup500.triangles.capacity // rt_tile.TILE_TRI_LIMIT)
    check(nseg == 4, f"random_scene(500_000) goes through {nseg} segments, not 4")
    o, d, ids = rays(soup_cam_1080, 1920, 1080)
    seen500 = capture_wavefronts(o, d, soup500, ids, auto, rt_tile.tile_tri_search,
                                 rt_tile.tile_occlusion)
    check(len(seen500) == 2, f"the 500k soup made {len(seen500)} searches, want 2")
    del o, d, ids
    tile_segment_kernels(card, seen500, 1920, results)
    del seen500

    # Phase 4: the main paths.
    k12, k3 = ["mxu_kernel", "mxu_occl_kernel"], ["fused_kernel"]
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
    layer_phase(card, seen)
    fused_layer_phase(card, "Cornell", corn, corn_cam, 1024, 768, auto)
    fused_layer_phase(card, "config 4", mixed, mixed_cam, 1920, 1080, d4)
    say(json.dumps({"paths": paths}))
    say(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": [results[name] for name in KERNELS]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
