"""Port vs JAX package: the command-line driver.

The parser gives the JAX CLI's namespace for the same argv (the port adds
only --device); the port's CLI, on the CPU, renders the Cornell OBJ into
a PPM that agrees with the JAX CLI's for the same argv, and prints the
same stderr fields.

Image bar, per argv: mean |port - JAX| < 1e-3 over the PPM's values read
back, and at most 0.5% of pixels off by more than 1/255 (one count).
The two cameras' directions differ by up to 4 * 2^-24 (XLA contracts
FMAs on the CPU), which moves a few edge pixels by the eps window.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu import cli as jcli  # noqa: E402
from esctp1raytracer_tpu.scene.builders import write_cornell_obj  # noqa: E402
from esctp1raytracer_tpu_torch import cli  # noqa: E402
from esctp1raytracer_tpu_torch.core import render as prender  # noqa: E402
from esctp1raytracer_tpu_torch.io.ppm import read_ppm  # noqa: E402
from esctp1raytracer_tpu_torch.utils import debug  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def cornell_obj(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "cornell.obj")
    write_cornell_obj(path)
    return path


@pytest.fixture(autouse=True)
def restore_levels():
    yield
    debug.set_level(debug.INFO)


def stderr_fields(err):
    """{field: value} of the timing block, without the measured duration."""
    out = {}
    for line in err.splitlines():
        key, sep, value = line.partition(":")
        if sep and line.startswith(" ") and key.strip() != "Duration":
            out[key.strip()] = value.strip()
    return out


PARSER_ARGVS = [
    [],
    ["-m", "x.obj", "-o", "y.ppm", "-v", "0,1,2", "-l", "3,4,5", "-w", "320,200"],
    ["--thread", "--bvh", "--ispc", "--test", "--debug", "--trace"],
    ["--mode", "sharded", "--backend", "tile", "--depth", "3", "--seed", "7"],
    ["--mode", "lane", "--vfov", "45.5", "--chunk", "4096", "--light-mode", "reference_cpp"],
    ["--scene", "cornell_empty_squashed"],
    ["--scene", "random100k", "--backend", "pallas"],
]


@pytest.mark.parametrize("argv", PARSER_ARGVS)
def test_parser_namespace_matches_jax(argv):
    mine = vars(cli.build_parser().parse_args(argv))
    assert mine.pop("device") == "cuda"
    assert mine == vars(jcli.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [["-v", "1,2"], ["--bogus"], ["--mode", "bogus"],
                                  ["--device", "tpu"], ["-w", "1,2,3"]])
def test_parser_rejects_what_jax_rejects(argv):
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv)
    if argv[0] != "--device":
        with pytest.raises(SystemExit):
            jcli.build_parser().parse_args(argv)


def test_parser_choices_match_jax():
    def choices(parser):
        return {a.dest: a.choices for a in parser._actions if a.choices}

    mine = choices(cli.build_parser())
    assert mine.pop("device") == ["cuda", "cpu"]
    assert mine == choices(jcli.build_parser())


RENDER_FLAGS = {
    "none": [],
    "bvh": ["--bvh"],
    "ispc": ["--ispc"],
    "lane": ["--mode", "lane"],
    "mxtile": ["--mode", "mxtile"],
    "tile": ["--mode", "tile"],
    "fused": ["--mode", "fused"],
    "auto": ["--mode", "auto"],
}


@pytest.mark.parametrize("name", list(RENDER_FLAGS))
def test_cli_render_matches_jax(cornell_obj, tmp_path, capsys, name):
    argv = ["-m", cornell_obj, "-v", "0,1,2", "-l", "0,1,0", "-w", "32,24"] + RENDER_FLAGS[name]
    mine, ref = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    assert jcli.main(argv + ["-o", ref]) == 0
    jax_out = capsys.readouterr()
    assert cli.main(argv + CPU + ["-o", mine]) == 0
    out = capsys.readouterr()
    assert f"Rendered image in: {mine}" in out.out
    a, b = read_ppm(mine), read_ppm(ref)
    assert a.shape == b.shape == (24, 32, 3) and a.max() > 0.1
    diff = np.abs(a - b)
    off = (diff.max(-1) > 1.5 / 255).mean()
    assert diff.mean() < 1e-3 and off <= 5e-3, (diff.mean(), off)
    got, want = stderr_fields(out.err), stderr_fields(jax_out.err)
    assert got.pop("Devices") == "1"
    want.pop("Devices")
    assert got == want, (got, want)
    assert set(got) == {"Threaded", "Flattened", "ISPC", "Mode"}


@pytest.mark.parametrize("argv", [["--thread"], ["--mode", "sharded"], ["--bvh", "--thread"],
                                  ["--mode", "sharded", "--backend", "tile"]])
def test_cli_refuses_sharded(cornell_obj, tmp_path, capsys, argv):
    """The sharded modes render (one rank here; the JAX CLI shards over its
    8 virtual devices): the same PPM and report as the JAX CLI's, Threaded."""
    argv = ["-m", cornell_obj, "-w", "8,6"] + argv
    mine, ref = str(tmp_path / "port.ppm"), str(tmp_path / "jax.ppm")
    assert jcli.main(argv + ["-o", ref]) == 0
    jax_out = capsys.readouterr()
    assert cli.main(argv + CPU + ["-o", mine]) == 0
    out = capsys.readouterr()
    assert f"Rendered image in: {mine}" in out.out
    a, b = read_ppm(mine), read_ppm(ref)
    assert a.shape == b.shape == (6, 8, 3) and a.max() > 0.1
    diff = np.abs(a - b)
    assert diff.mean() < 1e-3 and (diff.max(-1) > 1.5 / 255).mean() <= 5e-3
    got, want = stderr_fields(out.err), stderr_fields(jax_out.err)
    got.pop("Devices")
    want.pop("Devices")
    assert got == want and got["Threaded"] == "true", (got, want)
    assert got["Mode"].startswith("sharded/")


def test_cli_without_a_model_exits_2(capsys):
    assert cli.main(CPU) == 2
    assert "No model" in capsys.readouterr().err


def test_cli_without_a_card_fails(cornell_obj, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "c.ppm"
    assert cli.main(["-m", cornell_obj, "-w", "8,6", "-o", str(out)]) == 1
    assert "--device cpu" in capsys.readouterr().err
    assert not out.exists()


def test_cli_self_test(capsys):
    assert cli.main(["--test"] + CPU) == 0
    assert "4/4 passed" in capsys.readouterr().out


def test_cli_procedural_scene_and_no_output(tmp_path, capsys):
    out = str(tmp_path / "s.ppm")
    argv = ["--scene", "sphere_plane", "-v", "0,2,6", "-l", "0,1,0", "-w", "16,16"] + CPU
    assert cli.main(argv + ["-o", out]) == 0
    assert read_ppm(out).shape == (16, 16, 3)
    assert cli.main(argv) == 0
    assert "Nothing saved" in capsys.readouterr().out


def test_trace_summary_only_at_trace(cornell_obj, monkeypatch, capsys):
    argv = ["-m", cornell_obj, "-w", "8,6", "--mode", "lane"] + CPU
    calls = []
    real = prender._trace_summary
    monkeypatch.setattr(prender, "_trace_summary", lambda *a: calls.append(a) or real(*a))
    assert cli.main(argv + ["--debug"]) == 0
    assert calls == [] and "trace[" not in capsys.readouterr().out
    assert cli.main(argv + ["--trace", "--depth", "2"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("trace[")]
    assert [ln.split("]")[0] for ln in lines] == ["trace[bounce 0", "trace[bounce 1"]
    assert "hits=" in lines[0] and "/48 t[0]=" in lines[0]
