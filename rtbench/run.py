"""Run one cell of the port's benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`) names
a configuration (`rtbench/configs/<config>.json`: the scene, the size, the
camera, the render settings) and a traffic mix (`rtbench/traffic/<mix>.json`:
the loop and its parameters); its limits are in `rtbench/cells/<cell>.json`
and each per-layer metric has a reader `rtbench/metrics/<metric>.py`. A
render cell's file may also give `reference_share`: the share of each checked
frame's pixels that the reference traces, drawn from the seed (1 when absent:
every pixel). A run
builds the scene, warms up every shape it will use (set-up), runs the closed
loop for `--seconds` (the window), then checks what the window produced
against the plain reference (`rtbench/reference/`) and prints, as the last
line of stdout, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device`, with `--trace 1` `breakdown`, then
`card` and, last, `checks` (each number compared beside its limit; also the
last lines of stderr). It exits non-zero, and prints no result, with no
card, with fewer cards than the cell asks for, without the port beside it,
or when `jax`, `jaxlib`, `flax` or the JAX package is loaded at its end,
after the window, the check and the per-layer readers.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here: the process's start

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "esctp1raytracer_tpu")
PROFILE_SPAN_S = 1.0  # the traced stretch: the window's first second (3 to 40 steps)
PROFILE_STEPS = 40

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@dataclass
class Cell:
    name: str
    chips: int
    root: Path
    config: dict
    mix: dict
    limits: dict
    share: float
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell `name` with every file it names, found by name under root/rtbench/."""
    bench = bench or json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    here = root / "rtbench"
    own = json.loads((here / "cells" / f"{name}.json").read_text())
    return Cell(name=name, chips=cell["chips"], root=root,
                config=json.loads((root / conf["file"]).read_text()),
                mix=json.loads((here / "traffic" / f"{cell['traffic']}.json").read_text()),
                limits=own["limits"], share=float(own.get("reference_share", 1.0)),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def reader(metric: str, root: Path = ROOT):
    """The `read(traced)` function of root/rtbench/metrics/<metric>.py."""
    path = root / "rtbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("rtbench_metric_" + metric.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def percentile(values, q):
    """The q-th percentile of `values`, linear between the closest ranks."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _say(msg: str) -> None:
    print(f"rtbench: {msg}", file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             size=None, bench: dict = None, control: bool = False, fault: str = None,
             root: Path = ROOT) -> dict:
    """One run of the cell; returns its result (the line's object). `size`
    (width, height) and `device="cpu"` are for tests at a size the CPU holds;
    `control` puts the reference in TF32 in the program's place for the check;
    `fault` plants one of rtbench/faults.py's faults under the timed path; `bench`
    and `root` stand for BENCHMARK.json and the checkout it lies in."""
    import contextlib

    import torch

    from rtbench import faults, loops, trace as tracing

    cell = load_cell(name, bench, root)
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cuda":
        torch.set_num_threads(1)  # the host's load: one process, one intra-op thread
    _say(f"imports done at {time.perf_counter() - T0:.3f} s")
    with faults.planted(fault) if fault else contextlib.nullcontext():
        loop = loops.make(cell.config, cell.mix, seed, device, size, cell.share)
        _say(f"scene and inputs made at {time.perf_counter() - T0:.3f} s "
             f"(the reference's target {loop.reference_s:.3f} s of it)")
        if device == "cuda":  # the program's peak from its first step on
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(cell.mix["warm_steps"]):
            loop.step()
        if device == "cuda":
            torch.cuda.synchronize()
        loop.traced(trace)
        loop.sampling = True
        setup_s = time.perf_counter() - T0 - loop.reference_s  # the reference is not set-up
        _say(f"warm steps done; setup_s {setup_s:.3f} s")

        prof, profiled = None, []
        if trace:  # the profiler starts before the window; its first step is not counted
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
            loop.profiling = True
            loop.step()
        lat, rays = [], 0
        start = time.perf_counter()
        while True:
            now = time.perf_counter() - start
            if now >= seconds:
                break
            if loop.profiling and len(profiled) >= 3 and (
                    now >= PROFILE_SPAN_S or len(profiled) >= PROFILE_STEPS):
                prof.stop()
                loop.profiling = False
            t0 = time.perf_counter()
            if loop.profiling:
                profiled.append(loop.steps)
                with torch.profiler.record_function("rtbench.step"):
                    rays += loop.step()
            else:
                rays += loop.step()
            lat.append(time.perf_counter() - t0)
            loop.settle()
        window_s = time.perf_counter() - start
        if loop.profiling:
            prof.stop()
            loop.profiling = False
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    loop.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    readings = loop.check(tf32_control=control)
    _say(f"window {window_s:.3f} s, {len(lat)} steps; check {time.perf_counter() - t_check:.3f} s")
    checks = {k: {"value": v, "limit": cell.limits[k]} for k, v in readings.items()}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])

    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": failed == 0, "attempted": len(lat), "failed": failed}
    if not trace:
        values = {"rays_per_s": rays / window_s,
                  "step_ms_p95": percentile([x * 1e3 for x in lat], 95),
                  "peak_gib": peak / 2**30,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    else:
        t_read = time.perf_counter()
        traced = tracing.Traced(prof, profiled, loop, loop.timing)
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["device"] = dict(dev, busy_s=traced.busy_us() * 1e-6,
                                window_s=traced.window_us() * 1e-6)
        result["breakdown"] = traced.breakdown()
        _say(f"{len(profiled)} steps traced; read in {time.perf_counter() - t_read:.3f} s")
    result["card"] = card() if device == "cuda" else "cpu"
    result["checks"] = checks
    found = forbidden_modules()  # after the check and the readers, just before the result
    if found:
        _say(f"loaded in the measuring process: {', '.join(found)}")
        raise SystemExit(3)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    # Every cache of a build stays inside the checkout, at a fixed path.
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    emit(run_cell(args.workload, args.seed, args.seconds, bool(args.trace)))
    return 0


def emit(result: dict) -> None:
    """The checks as the last lines of stderr, the result as the last line of stdout."""
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
