#!/usr/bin/env python
"""Sharded-render scaling of the PyTorch port, ranks of torch.distributed.

Counterpart of scripts/bench_scaling.py. The JAX script shards over
virtual XLA devices of one process; here the 'devices' are ranks of
`torch.distributed`, each a process of this script, spawned in the
environment torchrun sets, as tests/test_torch_parallel.py spawns them.
On the card (the default) the ranks share the one card: one rank joins by
NCCL, two or four by gloo (`init_distributed`'s rule); with
`--device cpu` they are gloo ranks of one torch thread each. Sections, as
there:

* unsharded `render` against `render_sharded` over rays = n ranks
  (n = 1, 2, 4), Cornell 512x384, backend mxu: the number that must hold
  is sharded(1) ~= unsharded (the script FAILs below 0.6x);
* the residual: the same frame (W x H/4 * n) unsharded in this process
  (on the CPU on n torch threads) and sharded over n ranks, so the delta
  is the partition's own cost (process group, the frame's SUM
  all-reduce);
* the sharded fwd+bwd train step (`loss_and_grad_sharded`, gradients
  all-reduced) at 256x192, at every world;
* the ('rays' x 'prims') splits of the largest world on the ~5.1k-triangle
  `mesh_scene(4)` at 256x256 (the prims split scans with `_scan_blocks`
  and combines two MIN all-reduces per search).

The ranks share one host (and on the card one card), so the numbers
price dispatch, the process group and the collectives, not an
interconnect. The JAX script's analytic ICI model is left out: its
constants are TPU v5e assumptions (link rate, hop latency, a TPU step
time), and the port states no TPU number.

Writes a markdown report to --out (stdout by default; never SCALING.md).

Usage: python scripts/bench_scaling_torch.py [--out PATH] [--device cpu]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from esctp1raytracer_tpu_torch import Camera, RenderConfig, cornell_box, render  # noqa: E402
from esctp1raytracer_tpu_torch.parallel import (  # noqa: E402
    init_distributed, loss_and_grad_sharded, make_mesh, render_sharded,
)
from esctp1raytracer_tpu_torch.scene.builders import mesh_scene  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402

CFG = RenderConfig(backend="mxu", ray_chunk=0)
W, H = 512, 384  # the Cornell frame, as in the JAX script
GRAD_WH = (256, 192)  # the train step's frame
PRIMS_WH = (256, 256)  # the rays x prims splits' frame of mesh_scene(4)
RANKS = (1, 2, 4)
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE")
RANK_TIMEOUT = 1800  # seconds for every rank of one world to finish


def timed(fn, device, reps=5):
    """Best ms of `reps` calls after one warm call (ranks lined up by a
    barrier before each call when a process group exists; the card
    synchronised before and after each)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dist.is_initialized():
            dist.barrier()
        dev.synchronize(device)
        t0 = time.perf_counter()
        fn()
        dev.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def cornell_cam(w, h, device):
    return Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=w / h, device=device)


def splits(n):
    """(rays, prims) factorizations of n ranks: all rays first, then each
    with prims > 1."""
    return [(n, 1)] + [(n // p, p) for p in range(2, n + 1) if n % p == 0]


def worker(device, w, h, grad_wh, prims, out):
    """One rank: every sharded timing of this world (with `prims`, the
    (w, h) of the rays x prims splits, else none); rank 0 writes them."""
    torch.set_num_threads(1)
    world = init_distributed()
    try:
        scene = cornell_box(device=device)
        res = {"backend": dist.get_backend() if dist.is_initialized() else None}
        mesh = make_mesh()
        cam = cornell_cam(w, h, device)
        res["sharded_ms"] = timed(lambda: render_sharded(scene, cam, w, h, CFG, mesh), device)
        h_n = h // 4 * world
        cam_n = cornell_cam(w, h_n, device)
        res["residual_ms"] = timed(lambda: render_sharded(scene, cam_n, w, h_n, CFG, mesh),
                                   device)
        gw, gh = grad_wh
        tgt, gcam = torch.zeros((gh, gw, 3), device=device), cornell_cam(gw, gh, device)
        res["grad_ms"] = timed(lambda: loss_and_grad_sharded(scene, tgt, gcam, CFG, mesh),
                               device, reps=3)
        if prims:
            pw, ph = prims
            pscene = mesh_scene(subdivisions=4, device=device)
            pcam = Camera.look_at((0, 2, 6), (0, 1, 0), vfov=60.0, aspect=pw / ph,
                                  device=device)
            res["prims"] = []
            for rn, pn in splits(world):
                m = make_mesh(rays=rn, prims=pn)
                ms = timed(lambda: render_sharded(pscene, pcam, pw, ph, CFG, m), device, reps=2)
                res["prims"].append([rn, pn, ms])
        if dist.get_rank() == 0:
            with open(out, "w") as fh:
                json.dump(res, fh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(device, world, w, h, grad_wh, prims, tmp):
    """Run `world` ranks of this script on `device`; rank 0's results."""
    out = os.path.join(tmp, f"world{world}.json")
    port, procs = _free_port(), []
    try:
        for rank in range(world):
            env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_ENV}
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       OMP_NUM_THREADS="1")
            if device == "cpu":
                env["CUDA_VISIBLE_DEVICES"] = ""
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", out, "--device", device,
                 "--size", f"{w}x{h}", "--grad-size", "x".join(map(str, grad_wh))]
                + (["--prims", "x".join(map(str, prims))] if prims else []),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
        deadline = time.perf_counter() + RANK_TIMEOUT
        logs = [p.communicate(timeout=max(1.0, deadline - time.perf_counter()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"rank {rank} of {world} exited {p.returncode}:\n{log[-4000:]}")
    with open(out) as fh:
        return json.load(fh)


def report(where, w, h, grad_wh, prims_wh, base_ms, worlds, residual_base):
    """The markdown report, and whether sharded(1) holds."""
    backends = ", ".join(f"{n}: {res['backend']}" for n, res in worlds.items())
    lines = [f"# Sharded-render scaling of the PyTorch port ({where})", "",
             f"Cornell {w}x{h}, backend mxu, `scripts/bench_scaling_torch.py`: ranks "
             f"sharing one host (process group by world size: {backends}); an overhead "
             "check, not an interconnect measurement (see the script's docstring).", "",
             "| Mode | Ranks | ms/frame | Mrays/s | vs unsharded |", "|---|---|---|---|---|",
             f"| unsharded | 1 | {base_ms:.1f} | {w * h / base_ms / 1e3:.2f} | 1.00x |"]
    for n, res in worlds.items():
        ms = res["sharded_ms"]
        lines.append(f"| sharded rays={n} | {n} | {ms:.1f} | {w * h / ms / 1e3:.2f} | "
                     f"{base_ms / ms:.2f}x |")
    lines += ["", "## Residual (compute-controlled)", "",
              "The same frame unsharded in one process and sharded over n ranks: the "
              "delta is the partition's own cost.", "",
              "| Ranks | rays | unsharded ms | sharded ms | residual |", "|---|---|---|---|---|"]
    for n, res in worlds.items():
        if n == 1:
            continue
        h_n = h // 4 * n
        mj, ms = residual_base[n], res["residual_ms"]
        lines.append(f"| {n} | {w * h_n} | {mj:.1f} | {ms:.1f} | {ms - mj:+.1f} ms "
                     f"({(ms / mj - 1) * 100:+.0f}%) |")
    gw, gh = grad_wh
    lines += ["", f"## Sharded fwd+bwd train step ({gw}x{gh}, gradients all-reduced)", "",
              "| Ranks | ms/step |", "|---|---|"]
    lines += [f"| {n} | {res['grad_ms']:.1f} |" for n, res in worlds.items()]
    for n, res in worlds.items():
        if "prims" in res:
            lines += ["", f"## ('rays' x 'prims') splits of {n} ranks, mesh_scene(4), "
                      f"{prims_wh[0]}x{prims_wh[1]}",
                      "", "| rays x prims | ms/frame |", "|---|---|"]
            lines += [f"| {rn} x {pn} | {ms:.1f} |" for rn, pn, ms in res["prims"]]
    ok = 1 in worlds and base_ms / worlds[1]["sharded_ms"] >= 0.6
    lines += ["", "PASS" if ok else "FAIL: sharded(1) slower than 1.7x unsharded"]
    return "\n".join(lines) + "\n", ok


def measure(device, size=(W, H), grad_wh=GRAD_WH, prims_wh=PRIMS_WH, ranks=RANKS):
    """Every section at these sizes, the ranks spawned world by world on
    `device`; returns (the markdown report, whether sharded(1) holds)."""
    w, h = size
    scene = cornell_box(device=device)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        base_ms = timed(lambda: render(scene, cornell_cam(w, h, device), w, h, CFG), device)
        print(f"unsharded: {base_ms:.1f} ms", file=sys.stderr, flush=True)
        residual_base, worlds = {}, {}
        with tempfile.TemporaryDirectory() as tmp:
            for n in ranks:
                h_n = h // 4 * n
                if device == "cpu":  # n cores, as the n one-thread ranks use
                    torch.set_num_threads(n)
                residual_base[n] = timed(
                    lambda: render(scene, cornell_cam(w, h_n, device), w, h_n, CFG), device)
                worlds[n] = spawn(device, n, w, h, grad_wh,
                                  prims_wh if n == ranks[-1] else None, tmp)
                print(f"{n} rank(s): {worlds[n]}", file=sys.stderr, flush=True)
    finally:
        torch.set_num_threads(threads)
    where = dev.card(device) or "the CPU, one torch thread per rank"
    return report(where, w, h, grad_wh, prims_wh, base_ms, worlds, residual_base)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the markdown report here (default stdout)")
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES)
    # A rank's arguments, set by spawn().
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--size", help=argparse.SUPPRESS)
    ap.add_argument("--grad-size", help=argparse.SUPPRESS)
    ap.add_argument("--prims", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    dev.require(args.device)
    if args.worker:
        w, h = (int(x) for x in args.size.split("x"))
        grad_wh = tuple(int(x) for x in args.grad_size.split("x"))
        prims = tuple(int(x) for x in args.prims.split("x")) if args.prims else None
        worker(args.device, w, h, grad_wh, prims, args.worker)
        return 0
    text, ok = measure(args.device)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
