"""The plain reference against the port's CPU path, at sizes the CPU holds."""

import itertools
import json

import pytest
import torch

from rtbench import run, scenes
from rtbench.reference import render as ref

CONFIGS = {"flagship-10k-1080p": (24, 16), "cornell-original-1024x768": (24, 18),
           "soup100k-4k": (32, 18)}
MIXES = ("fit-all-leaves", "render-orbit-1spp", "render-fixed-8spp")


def _bench(config, mix):
    """BENCHMARK.json with one more cell: `config` under `mix`."""
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    name = next((w["name"] for w in bench["workloads"]
                 if w["config"] == config and w["traffic"] == mix), None)
    return bench, name


def test_scenes_are_the_port_builders_tables():
    from esctp1raytracer_tpu_torch.scene import builders

    for name, built in (("flagship-10k-1080p", builders.bench_scene(device="cpu")),
                        ("cornell-original-1024x768", builders.cornell_box(device="cpu")),
                        ("soup100k-4k", builders.random_scene(100_000, device="cpu"))):
        spec = json.loads((run.ROOT / "rtbench" / "configs" / f"{name}.json").read_text())
        ours = scenes.port_scene(spec["scene"], "cpu")
        for (n, a), (m, b) in zip(ours.leaves(), built.leaves()):
            assert n == m and a.shape == b.shape and torch.equal(a, b), n


@pytest.mark.parametrize("config,mix", list(itertools.product(CONFIGS, MIXES)))
def test_reference_agrees_with_the_port(config, mix, tmp_path):
    """Every configuration under every mix, through a whole run of the harness:
    the program's answers held to the reference by the cell's own check."""
    bench, name = _bench(config, mix)
    root = run.ROOT
    if name is None:  # a cell the benchmark does not run: made here from files
        name = f"{config}.{mix}"
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                   "why": "test"})
        root = tmp_path
        (root / "rtbench" / "cells").mkdir(parents=True)
        (root / "rtbench" / "traffic").mkdir()
        (root / "rtbench" / "configs").mkdir()
        for sub, fname in (("traffic", f"{mix}.json"), ("configs", f"{config}.json")):
            (root / "rtbench" / sub / fname).write_text(
                (run.ROOT / "rtbench" / sub / fname).read_text())
        kind = json.loads((run.ROOT / "rtbench" / "traffic" / f"{mix}.json").read_text())["loop"]
        twin = next(w["name"] for w in bench["workloads"]
                    if json.loads((run.ROOT / "rtbench" / "traffic" / f"{w['traffic']}.json")
                                  .read_text())["loop"] == kind)
        (root / "rtbench" / "cells" / f"{name}.json").write_text(
            (run.ROOT / "rtbench" / "cells" / f"{twin}.json").read_text())
    r = run.run_cell(name, 2**31 + 11, 0.3, False, device="cpu", size=CONFIGS[config],
                     bench=bench, root=root)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1
    for c in r["checks"].values():
        assert c["value"] < 1e-3


def test_reference_gradients_match_the_port():
    from esctp1raytracer_tpu_torch import Camera, RenderConfig
    from esctp1raytracer_tpu_torch.grad.optimize import loss_and_grad

    spec = json.loads((run.ROOT / "rtbench" / "configs" / "cornell-original-1024x768.json")
                      .read_text())
    w, h = 16, 12
    arrays = scenes.scene_arrays(spec["scene"])
    rs = ref.scene_from_arrays(arrays, "cpu")
    ps = scenes.port_scene(spec["scene"], "cpu")
    c = spec["camera"]
    ids = torch.arange(w * h)
    target = ref.image(rs, c, w, h, ids, 3, 1).detach() * 0.9
    cam = Camera.look_at(c["lookfrom"], c["lookat"], c["vup"], c["vfov"], w / h, device="cpu")
    names = [n for n, t in ps.leaves() if t.is_floating_point()]
    lp, gp = loss_and_grad(ps, target, cam, w, h, RenderConfig(backend="auto", seed=3),
                           tuple(False for _ in names))
    lr, gr = ref.loss_and_grad(rs, target, c, w, h, ids, 3, 1)
    assert abs(float(lp) - float(lr)) <= 1e-6 * float(lr)
    for n, g in zip(names, gp):
        ours = 0.0 if g is None else float(g.norm())
        theirs = float(gr[n].norm()) if n in gr else 0.0
        assert abs(ours - theirs) <= 1e-5 * max(theirs, 1e-12), n


def test_control_rounds_to_tf32():
    x = torch.tensor([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 3.14159265])
    with ref.precision(True):
        y = ref._operand(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2.0 ** -9
    assert abs(float(y[2]) - 3.14159265) < 2.0 ** -9 * 4
    assert torch.equal(ref._operand(x), x)  # outside the block: float32
