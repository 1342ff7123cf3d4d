"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main path once at full size: the benchmark workload of
bench.py — 1920x1080 camera rays over the 10,244-triangle benchmark
scene, depth 1, the forward render plus the gradient of sum(color^2)
with respect to every float scene parameter, with backend "auto" (which
resolves to mxtile). Phases, any failure exits non-zero:

1. device: needs a CUDA device (there is no CPU path); prints the card's
   name and power limit (nvidia-smi), the torch and CUDA versions, and
   turns TF32 off;
2. build: builds the CUDA kernels from csrc/ with nvcc, timed;
3. kernels: each kernel against its plain PyTorch version on the inputs
   the main path gives it (captured from one forward of the frame), with
   the bars of tests/test_rt_mxu.py, and the time of each (CUDA events);
4. main path: forward + backward with every kernel's launch counter set
   to 0 first, checks (finite image and gradients, counters > 0, a small
   render agreeing with the plain `jnp` backend), then forward and
   fwd+bwd times from CUDA events over warm iterations with the ray ids
   varied per iteration, and the peak device memory; then the forward's
   layers timed alone on the frame's wavefronts;
5. prints {"kernels": [...]} and, as the last line, the result line.

Usage: python3 chip_smoke.py   (from the repository root)
"""

import json
import statistics
import subprocess
import sys
import time

import torch

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, resolve_backend, trace_rays
from esctp1raytracer_tpu_torch.kernels import _build, rt_mxu
from esctp1raytracer_tpu_torch.parallel.sharding import float_params, merge_params
from esctp1raytracer_tpu_torch.scene.builders import bench_scene

WIDTH, HEIGHT = 1920, 1080
SOURCE = "esctp1raytracer_tpu_torch/csrc/rt_mxu.cu"
KERNELS = {  # wrapper in kernels/rt_mxu.py: (its plain version, the TPU kernel it replaces)
    "mxu_kernel": (rt_mxu._mxu_search_plain, "esctp1raytracer_tpu/kernels/rt_mxu.py:153"),
    "mxu_occl_kernel": (rt_mxu._mxu_occl_plain, "esctp1raytracer_tpu/kernels/rt_mxu.py:215"),
}


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
    rt_mxu._lib()
    lib = _build.build("rt_mxu")
    say(f"build: {time.perf_counter() - t0:.2f} s -> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("  ptxas:", line.strip())


def capture_wavefronts(o, d, scene, ids, cfg):
    """The primary and shadow wavefronts of one forward of the frame, as the
    search and occlusion hooks receive them: {name: (o, d, tris, eps, t_limit)}."""
    seen = {}

    def search(oo, dd, tris, eps, t_limit=None):
        seen["primary"] = (oo, dd, tris, eps, t_limit)
        return rt_mxu.mxu_tile_search(oo, dd, tris, eps, t_limit)

    def occlusion(oo, dd, t_limit, tris, eps):
        seen["shadow"] = (oo, dd, tris, eps, t_limit)
        return rt_mxu.mxu_tile_occlusion(oo, dd, t_limit, tris, eps)

    search.occlusion = occlusion
    with torch.no_grad():
        trace_rays(o, d, scene, ids, cfg, tri_search=search)
    torch.cuda.synchronize()
    return seen


def kernel_args(seen):
    """Each kernel's arguments, packed from the wavefronts the way
    mxu_tile_search / mxu_tile_occlusion pack them (one segment here)."""
    args = {}
    with torch.no_grad():
        for attr, wave, occl in (("mxu_kernel", "primary", False),
                                 ("mxu_occl_kernel", "shadow", True)):
            oo, dd, tris, eps, t_limit = seen[wave]
            (tfq, aabbs, _), = list(rt_mxu._segments(tris, occl)[0])
            rf, gids, cnt, tl, _, _ = rt_mxu._prep_mxu(oo, dd, aabbs, t_limit)
            eps = rt_mxu._eps_tensor(eps, oo.device)
            args[attr] = (eps, gids, cnt, rf, tl, tfq) if occl else (eps, gids, cnt, rf, tfq)
    torch.cuda.synchronize()
    return args


def kernel_phase(card, seen):
    captured = kernel_args(seen)
    results = {}
    for name, (plain, replaces) in KERNELS.items():
        args = captured[name]
        wrapper = getattr(rt_mxu, name)
        out_k = wrapper(*args)
        torch.cuda.synchronize()
        out_p = plain(*args)
        torch.cuda.synchronize()
        g, nsub = args[1].shape
        cnt = args[2]
        if name == "mxu_kernel":
            (t_k, i_k), (t_p, i_p) = out_k, out_p
            same = i_k == i_p
            agree = same.float().mean().item()
            hit = same & (t_p < 1e29)
            err = (t_k - t_p).abs()[hit]
            max_abs = err.max().item() if err.numel() else 0.0
            rel = (err / t_p[hit].abs().clamp(min=1.0)).max().item() if err.numel() else 0.0
            say(f"{name}: winners agree {agree:.6f}, max abs t err {max_abs:.3e}, "
                f"max rel t err {rel:.3e}, hits {(i_k >= 0).float().mean().item():.4f}")
            check(agree >= 0.999, f"{name}: winner agreement {agree} < 0.999")
            check(rel < 1e-5, f"{name}: relative t error {rel} >= 1e-5")
        else:
            agree = (out_k == out_p).float().mean().item()
            max_abs = float((out_k - out_p).abs().max().item())
            say(f"{name}: occlusion agrees {agree:.6f}, occluded {out_k.float().mean().item():.4f}")
            check(agree >= 0.999, f"{name}: occlusion agreement {agree} < 0.999")
        ms = cuda_ms(lambda: wrapper(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 2)
        say(f"{name}: groups {g}, blocks {nsub}, mean list {cnt.float().mean().item():.2f} "
            f"(max {int(cnt.max())}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms  [{card}]")
        results[name] = {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                         "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms}
    return results


def main_path_phase(card, o, d, scene, cfg, results):
    check(resolve_backend(RenderConfig(backend="auto"), scene) == "mxtile",
          "backend 'auto' does not resolve to mxtile on the benchmark scene")
    num_rays = o.shape[0]
    ids = torch.arange(num_rays, dtype=torch.int64, device=o.device)
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

    for name in KERNELS:
        getattr(rt_mxu, name).launches = 0
    color, loss, grads = step(0)
    torch.cuda.synchronize()
    launches = {name: getattr(rt_mxu, name).launches for name in KERNELS}
    say(f"main path fwd+bwd: launches {launches}, loss {loss.item():.6e}")
    for attr, n in launches.items():
        check(n > 0, f"{attr} was not launched by the main path")
        results[attr]["launches"] = n
    check(tuple(color.shape) == (num_rays, 3), f"color shape {tuple(color.shape)}")
    check(bool(torch.isfinite(color).all()), "non-finite pixel")
    check(color.mean().item() > 0.01, "image is black")
    check(all(bool(torch.isfinite(g).all()) for g in grads), "non-finite gradient")
    check(sum(bool((g != 0).any()) for g in grads) >= 8, "too few gradients are non-zero")

    # A small frame through the kernels against the plain `jnp` backend.
    w, h = 192, 108
    small = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0, aspect=w / h,
                           device=o.device)
    a = render(scene, small, w, h, cfg)
    b = render(scene, small, w, h, cfg.replace(backend="jnp"))
    diff = (a - b).abs()
    say(f"small frame vs jnp backend: mean |diff| {diff.mean().item():.3e}, "
        f"share > 1e-2 {(diff > 1e-2).float().mean().item():.5f}")
    check(diff.mean().item() < 1e-4 and (diff > 1e-2).float().mean().item() < 5e-3,
          "small frame disagrees with the jnp backend")

    with torch.no_grad():
        step(1, backward=False)
        fwd = [cuda_ms(lambda: step(2 + k, backward=False)) for k in range(5)]
    step(7)
    torch.cuda.reset_peak_memory_stats()
    fb = [cuda_ms(lambda: step(8 + k)) for k in range(5)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    f_ms, fb_ms = statistics.median(fwd), statistics.median(fb)
    say(f"forward    : {f_ms:.2f} ms median of {[round(x, 2) for x in fwd]} "
        f"= {num_rays / f_ms / 1e3:.3f} Mrays/s  [{card}]")
    say(f"forward+bwd: {fb_ms:.2f} ms median of {[round(x, 2) for x in fb]} "
        f"= {num_rays / fb_ms / 1e3:.3f} Mrays/s  [{card}]")
    say(f"peak device memory (fwd+bwd): {peak:.2f} GiB  [{card}]")


def layer_phase(card, seen):
    """Where the forward's time goes: each layer of the search and the
    occlusion alone on the frame's wavefronts (CUDA events, median of 3)."""
    po, pd, tris, eps, ptl = seen["primary"]
    so, sd, _, _, stl = seen["shadow"]
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


def main():
    card = device_phase()
    build_phase()
    dev = torch.device("cuda")
    scene = bench_scene().to(dev)
    cam = Camera.look_at((0.0, 2.0, 6.0), (0.0, 1.0, 0.0), vfov=60.0,
                         aspect=WIDTH / HEIGHT, device=dev)
    o, d = (x.reshape(-1, 3) for x in cam.ray_grid(WIDTH, HEIGHT))
    ids = torch.arange(o.shape[0], dtype=torch.int64, device=dev)
    cfg = RenderConfig(backend="auto", ray_chunk=0, block_size=512, depth=1)
    seen = capture_wavefronts(o, d, scene, ids, cfg)
    results = kernel_phase(card, seen)
    main_path_phase(card, o, d, scene, cfg, results)
    layer_phase(card, seen)
    say(json.dumps({"kernels": [results[name] for name in KERNELS]}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
