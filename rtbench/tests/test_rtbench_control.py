"""The control and the planted faults come out as not correct; sound runs do not.

The control is the reference computed in TF32 (its search's operands rounded to
10 mantissa bits) in the program's place; the faults are rtbench/faults.py's,
planted under the timed path. At sizes the CPU holds, each cell at its own
reference share; the card's readings at the cells' own sizes are in PERF.md."""

import pytest
import torch

from rtbench import faults, run

SIZES = {"flagship-fit": (32, 18), "cornell-fit": (32, 24), "flagship-render": (32, 18),
         "cornell-render": (32, 24), "soup100k-4k-render": (64, 36)}


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("seed", [2**31 + 21, 2**31 + 22, 2**31 + 23])
def test_control_is_not_correct(cell, seed):
    r = run.run_cell(cell, seed, 0.3, False, device="cpu", size=SIZES[cell], control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    r = run.run_cell(cell, 2**31 + 31, 0.3, False, device="cpu", size=SIZES[cell], fault=fault)
    assert not r["correct"], (fault, r["checks"])
    sound = run.run_cell(cell, 2**31 + 31, 0.3, False, device="cpu", size=SIZES[cell])
    assert sound["correct"], sound["checks"]


@pytest.mark.cuda
def test_cells_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU mode")
    for cell in sorted(SIZES):
        r = run.run_cell(cell, 2**31 + 41, 1.0, False)
        assert r["correct"], (cell, r["checks"])
