"""The general generator: one traffic file's loop over one configuration.

A traffic file names its loop (`fit` or `render`) and gives its parameters;
a configuration file gives the scene, the resolution, the depth, the camera
and the render settings. Both loops are closed: each step waits for its
result on the host, as the port's users do. The port is driven through its
public entries only (imported here by name, so that a test can break one
underneath a run). Each loop also keeps what the correctness check needs
(`check`) and rebuilds any step's wavefronts for the work counts
(`wavefronts`), both through the plain reference in `rtbench/reference/`.
A render loop at a `share` below 1 has the reference trace only a seeded
share of each frame's pixels, for the check and for the work counts alike.
"""

from __future__ import annotations

import contextlib
import math
import random
import sys
from time import perf_counter

import numpy as np
import torch

from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, trace_rays
from esctp1raytracer_tpu_torch.grad.optimize import adam_init, adam_update, loss_and_grad
from esctp1raytracer_tpu_torch.scene.types import float_params, merge_params
from esctp1raytracer_tpu_torch.utils import graphs
from rtbench import scenes
from rtbench.reference import render as ref

PIXEL_TOL = 1e-3  # a pixel is off when a channel differs from the reference by more
B1 = 0.9          # Adam's first-moment decay (the port's default), to read g from m


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


class Loop:
    """What both loops share: the configuration's sizes, the seed's draws, marks."""

    def __init__(self, config: dict, mix: dict, seed: int, device: str, size=None):
        self.config, self.mix, self.device = config, mix, device
        self.width, self.height = size or (config["width"], config["height"])
        self.rays = self.width * self.height
        self.depth = config["render"]["depth"]
        self.seed = seed % 2**32  # the light draws' seed
        self.arrays = scenes.scene_arrays(config["scene"])
        self.n_tri = len(self.arrays.v)
        self.n_sph = len(self.arrays.spheres["radius"])
        self.rcfg = RenderConfig(backend=config["render"]["backend"], depth=self.depth,
                                 light_mode=config["render"]["light_mode"], seed=self.seed)
        self.mark = lambda _: contextlib.nullcontext()
        self.timing = None  # a dict of lists while the layers are timed
        self.profiling = False  # the profiler runs: keep what a step's work count needs,
        # and synchronise nothing, so that the profiled steps run as the untraced loop does
        self.reference_s = 0.0  # set-up seconds spent in the reference (not in setup_s)
        self.work_scale = 1.0  # a step's rays over the rays its work-count records hold
        self.sampling = False  # the window: sample its answers for the check

    def traced(self, on: bool):
        """Time the layers on the host clock and name the harness's ranges in the trace.
        What needs the card synchronised is timed only outside the profiled stretch."""
        self.mark = torch.profiler.record_function if on else (lambda _: contextlib.nullcontext())
        self.timing = {"host_ms": [], "adam_ms": []} if on else None

    def settle(self):
        """After a step, outside its latency (the render loop samples its frames here)."""

    def camera(self, spec):
        return Camera.look_at(spec["lookfrom"], spec["lookat"], spec.get("vup", (0.0, 1.0, 0.0)),
                              spec["vfov"], self.width / self.height, device=self.device)

    def ref_leaves(self, leaves: dict):
        """The reference's leaves from a Scene's padded leaves (the rows that hold data)."""
        rows = {"triangles": self.n_tri, "spheres": self.n_sph}
        return {k: t.detach()[:rows[k.split(".")[0]]] for k, t in leaves.items()
                if k.split(".")[1] in ref.TRI_LEAVES + ref.SPHERE_LEAVES}


class Fit(Loop):
    """Inverse rendering: loss_and_grad, adam_update, float(loss) per step."""

    def __init__(self, config, mix, seed, device, size=None, share=1.0):
        if share != 1.0:
            raise ValueError("a fit's check compares whole frames: no reference_share")
        super().__init__(config, mix, seed, device, size)
        self.lr = mix["lr"]
        rng = np.random.default_rng(seed % 2**63)
        lo, hi = 1.0 - mix["perturb"], 1.0 + mix["perturb"]
        factors = {k: rng.uniform(lo, hi, (self.n_tri, 3)).astype(np.float32)
                   for k in mix["perturb_leaves"]}
        base = ref.scene_from_arrays(self.arrays, device)
        self.ids = torch.arange(self.rays, dtype=torch.int64, device=device)  # render()'s ids
        _sync(device)
        t0 = perf_counter()
        with ref.precision(False):
            self.target = ref.image(base, config["camera"], self.width, self.height, self.ids,
                                    self.seed, self.depth).detach()
        _sync(device)
        self.reference_s = perf_counter() - t0
        self.ref_start = base.replace({
            k: t * torch.from_numpy(factors[k.split(".")[1]]).to(device)
            if k.split(".")[0] == "triangles" and k.split(".")[1] in factors else t
            for k, t in base.leaves.items()})
        del base

        scene = scenes.port_scene(config["scene"], device)
        cap = scene.triangles.capacity

        def perturb(name, t):
            part, leaf = name.split(".")
            if part != "triangles" or leaf not in factors:
                return t
            f = np.ones((cap, 3), np.float32)
            f[:self.n_tri] = factors[leaf]
            return t * torch.from_numpy(f).to(device)

        self.scene = scene.map(perturb)
        self.names = [n for n, t in self.scene.leaves() if t.is_floating_point()]
        self.cam = self.camera(config["camera"])
        self.params = float_params(self.scene)
        self.state = adam_init(self.params)
        self.frozen = tuple(False for _ in self.params)
        self.start = self.params
        self.steps = 0
        self.losses, self.first_m, self.after = [], None, None
        self.kept = {}  # step -> the params it started from (for the work counts)

    def step(self) -> int:
        """One fit step; returns the camera rays it traced."""
        if self.profiling:
            self.kept[self.steps] = self.params
        with self.mark("rtbench.call"):
            t0 = perf_counter()
            loss, grads = loss_and_grad(merge_params(self.scene, self.params), self.target,
                                        self.cam, self.width, self.height, self.rcfg, self.frozen)
            host_ms = (perf_counter() - t0) * 1e3
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        timed = self.timing is not None and not self.profiling
        if self.timing is not None:
            self.timing["host_ms"].append(host_ms)
        if timed:
            _sync(self.device)
            t0 = perf_counter()
        with self.mark("rtbench.adam"):
            self.params, self.state = adam_update(self.params, grads, self.state, lr=self.lr)
        if timed:
            _sync(self.device)
            self.timing["adam_ms"].append((perf_counter() - t0) * 1e3)
        with self.mark("rtbench.readback"):
            value = float(loss)
        self.steps += 1
        if self.steps <= self.mix["checked_steps"]:
            self.losses.append(value)
            if self.steps == 1:
                self.first_m = self.state["m"]
            if self.steps == self.mix["checked_steps"]:
                self.after = self.params
        return self.rays

    def release(self):
        """Free the program's state but what the check reads."""
        self.first_m = [m.detach().cpu() for m in self.first_m]
        self.after = [p.detach().cpu() for p in self.after]
        self.start = [p.detach().cpu() for p in self.start]
        self.scene = self.params = self.state = self.cam = None
        graphs.clear()

    def reference_steps(self, tf32=False):
        """The reference's own run from the same start: its losses, its first
        gradient and its leaves after `checked_steps` Adam steps."""
        scene, state, losses, first = self.ref_start, {}, [], None
        with ref.precision(tf32):
            for _ in range(self.mix["checked_steps"]):
                loss, grads = ref.loss_and_grad(scene, self.target, self.config["camera"],
                                                self.width, self.height, self.ids, self.seed,
                                                self.depth)
                losses.append(float(loss))
                first = grads if first is None else first
                leaves, state = ref.adam(scene.leaves, grads, state, self.lr)
                scene = scene.replace(leaves)
        return losses, first, scene.leaves

    def readings(self, run: tuple, ref_run: tuple) -> dict:
        """The three numbers compared, each against the reference's: the first step's
        loss; leaf by leaf, the first gradient's norm (the worst leaf) and the norm of
        the change after the checked steps (the median leaf). The later steps' losses
        and the worst leaf's change are not compared: Adam's first step moves every
        element by the learning rate whatever its gradient's size, so a few pixels that
        differ at shadow edges turn some vertices the other way, and what follows
        reads that geometry, on a few seeds by far more than the rest. Leaves whose
        reference gradient is under a thousandth of the median leaf's are left out, and
        within a leaf the change leaves out the elements whose reference gradient is
        under a thousandth of the leaf's median element: Adam moves those by round-off
        alone."""
        losses, first, after = run
        r_losses, r_first, r_after = ref_run
        g_ref = {k: float(torch.linalg.vector_norm(g)) for k, g in r_first.items()}
        nonzero = sorted(v for v in g_ref.values() if v > 0.0)
        med = nonzero[len(nonzero) // 2] if nonzero else 0.0
        kept = [k for k, v in g_ref.items() if v >= 1e-3 * med and v > 0.0]
        d_ours, d_ref = {}, {}
        for k in kept:
            g = r_first[k].abs().cpu()
            moved = g >= 1e-3 * g[g > 0].median()
            start = self.ref_start.leaves[k].cpu()
            d_ref[k] = float(torch.linalg.vector_norm((r_after[k].cpu() - start)[moved]))
            d_ours[k] = float(torch.linalg.vector_norm(after[k][:len(g)][moved]))

        def leaf_gaps(ours, theirs, what):
            m = sorted(theirs.values())[len(theirs) // 2]
            gaps = {k: abs(ours[k] - theirs[k]) / max(theirs[k], m) for k in theirs}
            k = max(gaps, key=gaps.get)
            print(f"rtbench: {what}: worst leaf {k} ({ours[k]!r} against {theirs[k]!r})",
                  file=sys.stderr)
            return sorted(gaps.values())

        grad = leaf_gaps({k: first[k] for k in kept}, {k: g_ref[k] for k in kept}, "gradient")
        change = leaf_gaps(d_ours, d_ref, "change")
        return {"first_loss_gap": abs(losses[0] - r_losses[0]) / abs(r_losses[0]),
                "grad_gap": grad[-1], "median_change_gap": change[len(change) // 2]}

    def program_run(self) -> tuple:
        by_name = dict(zip(self.names, range(len(self.names))))
        first = {k: float(torch.linalg.vector_norm(self.first_m[i] / (1 - B1)))
                 for k, i in by_name.items()}
        change = {k: self.after[i] - self.start[i] for k, i in by_name.items()}
        return self.losses, first, change

    def check(self, tf32_control=False) -> dict:
        ref_run = self.reference_steps()
        if tf32_control:  # the reference in TF32 in the program's place
            losses, first, after = self.reference_steps(tf32=True)
            run = (losses, {k: float(torch.linalg.vector_norm(g)) for k, g in first.items()},
                   {k: (after[k] - self.ref_start.leaves[k]).cpu() for k in after})
        else:
            run = self.program_run()
        return self.readings(run, ref_run)

    def wavefronts(self, step: int):
        """The triangles and searches of step `step`, its scene as the program held
        it, rebuilt by the reference."""
        leaves = self.ref_leaves(dict(zip(self.names, self.kept[step])))
        rec = []
        with torch.no_grad(), ref.precision(False):
            ref.image(self.ref_start.replace(leaves), self.config["camera"], self.width,
                      self.height, self.ids, self.seed, self.depth, record=rec)
        return tuple(leaves[f"triangles.{c}"] for c in ("v0", "v1", "v2")), rec


class Render(Loop):
    """Frames of a static scene: one graphed call per step, the image to the host."""

    def __init__(self, config, mix, seed, device, size=None, share=1.0):
        super().__init__(config, mix, seed, device, size)
        self.picked = self.rays if share >= 1.0 else max(1, round(share * self.rays))
        self.work_scale = self.rays / self.picked
        self.pixel_seed = seed % 2**63
        self.passes = mix["passes"]
        orbit = mix["orbit_deg_per_step"] != 0.0
        self.angle0 = (seed % 3600) / 10.0 if orbit else 0.0  # an orbit starts where the seed says
        self.id_base = (seed * 2654435761) % 2**32
        self.scene = scenes.port_scene(config["scene"], device)
        self.ids0 = torch.arange(self.rays, dtype=torch.int64, device=device)
        self.steps = 0
        self.sample = []  # (step, host image): a reservoir drawn from the seed
        self.sample_rng = random.Random(seed)
        # The frame is read back into a pinned buffer, as a client streaming frames
        # would (a fresh pageable copy faults its pages in on every step). A sampled
        # frame keeps its buffer and the loop takes a free one: no copy in the window.
        self.free = [torch.empty((self.height, self.width, 3), dtype=torch.float32,
                                 pin_memory=device == "cuda")
                     for _ in range(mix["sampled_frames"] + 1)]
        self.host = self.free.pop()
        self.fixed = None if orbit else self.camera(config["camera"])  # a fixed view: one camera
        self.seen = 0
        scene, rcfg, w, h, rays, passes = self.scene, self.rcfg, self.width, self.height, \
            self.rays, self.passes

        @graphs.graphed
        def frame(camera, ids):
            with torch.no_grad():
                o, d = camera.ray_grid(w, h)
                o, d = o.reshape(-1, 3), d.reshape(-1, 3)
                acc = trace_rays(o, d, scene, ids, rcfg)
                for i in range(1, passes):
                    acc = acc + trace_rays(o, d, scene, ids + i * rays, rcfg)
                return (acc / passes if passes > 1 else acc).reshape(h, w, 3)

        self.frame = frame

    def camera_spec(self, step: int) -> dict:
        """The configuration's camera turned by the step's angle about the vertical
        axis through its look-at point."""
        c = self.config["camera"]
        a = math.radians(self.angle0 + step * self.mix["orbit_deg_per_step"])
        if a == 0.0:
            return c
        (x, y, z), (lx, _, lz) = c["lookfrom"], c["lookat"]
        dx, dz = x - lx, z - lz
        c_, s_ = math.cos(a), math.sin(a)
        eye = [lx + dx * c_ + dz * s_, y, lz - dx * s_ + dz * c_]
        return dict(c, lookfrom=eye)

    def step_ids(self, step: int) -> int:
        return self.id_base + step * self.passes * self.rays

    def step(self) -> int:
        k = self.steps
        with self.mark("rtbench.camera"):
            camera = self.fixed or self.camera(self.camera_spec(k))
            ids = self.ids0 + self.step_ids(k)
        with self.mark("rtbench.call"):
            t0 = perf_counter()
            img = self.frame(camera, ids)
            host_ms = (perf_counter() - t0) * 1e3
        with self.mark("rtbench.readback"):
            self.host.copy_(img)
        if self.timing is not None:
            self.timing["host_ms"].append(host_ms)
        self.steps += 1
        return self.rays * self.passes

    def settle(self):
        """After a step, outside its latency: reservoir-sample the window's frames."""
        if not self.sampling:
            return
        n, k = self.mix["sampled_frames"], self.steps - 1
        if len(self.sample) < n:
            self.sample.append((k, self.host))
            self.host = self.free.pop()
        else:
            j = self.sample_rng.randrange(self.seen + 1)
            if j < n:
                self.sample[j], self.host = (k, self.host), self.sample[j][1]
        self.seen += 1

    def release(self):
        self.scene = self.frame = self.fixed = None
        graphs.clear()

    def pixels(self, step: int):
        """The flat indices of the pixels of step `step` that the reference traces:
        None (every pixel) at share 1, else `picked` of them drawn without
        replacement from the seed and the step, in order."""
        if self.picked == self.rays:
            return None
        rng = np.random.default_rng([self.pixel_seed, step])
        idx = np.sort(rng.choice(self.rays, self.picked, replace=False))
        return torch.from_numpy(idx).to(self.device)

    def reference_frame(self, step: int, record=None, pixels=None):
        base = ref.scene_from_arrays(self.arrays, self.device)
        ids = torch.arange(self.rays, dtype=torch.int64, device=self.device) + self.step_ids(step)
        return ref.image(base, self.camera_spec(step), self.width, self.height, ids, self.seed,
                         self.depth, self.passes, record, pixels)

    def check(self, tf32_control=False) -> dict:
        bad = total = 0
        for step, host in self.sample:
            px = self.pixels(step)
            with torch.no_grad():
                with ref.precision(False):
                    want = self.reference_frame(step, pixels=px)
                if tf32_control:
                    with ref.precision(True):
                        got = self.reference_frame(step, pixels=px)
                else:
                    got = host.to(self.device)
                    if px is not None:
                        got = got.reshape(-1, 3)[px]
                off = (got - want).abs().amax(-1) > PIXEL_TOL
            bad += int(off.sum())
            total += off.numel()
        return {"bad_px": bad / total}

    def wavefronts(self, step: int):
        rec = []
        with torch.no_grad(), ref.precision(False):
            self.reference_frame(step, record=rec, pixels=self.pixels(step))
        tris = tuple(torch.as_tensor(self.arrays.v[:, i], device=self.device) for i in range(3))
        return tris, rec


LOOPS = {"fit": Fit, "render": Render}


def make(config: dict, mix: dict, seed: int, device: str, size=None, share=1.0) -> Loop:
    return LOOPS[mix["loop"]](config, mix, seed, device, size, share)
