"""The reference's seeded share of each frame's pixels (a cell's `reference_share`):
the share's colours are the whole frame's at those pixels, a share of 1 reads and
counts as every pixel did, and the work counted on a share comes near the count
on every pixel. At sizes the CPU holds."""

import pytest
import torch

from rtbench import loops, run, trace
from rtbench.reference import render as ref
from rtbench.work import count as work

SIZE = (64, 36)
SHARE = 0.25
SIZES = {"flagship-fit": (32, 18), "cornell-fit": (32, 24), "flagship-render": (32, 18),
         "cornell-render": (32, 24)}


def _render(cell, seed, share):
    c = run.load_cell(cell)
    return loops.make(c.config, c.mix, seed, "cpu", SIZE, share)


def _every_pixel(loop):
    """The render check on every pixel of each sampled frame, as it read before the share."""
    bad = total = 0
    for step, host in loop.sample:
        with torch.no_grad(), ref.precision(False):
            want = loop.reference_frame(step)
        off = (host - want).abs().amax(-1) > loops.PIXEL_TOL
        bad += int(off.sum())
        total += off.numel()
    return {"bad_px": bad / total}


@pytest.mark.parametrize("cell", ["flagship-render", "soup100k-4k-render"])
def test_share_colours_are_the_whole_frames(cell):
    loop = _render(cell, 2**31 + 51, SHARE)
    drawn = []
    for step in (0, 7):
        px = loop.pixels(step)
        assert len(px) == round(SHARE * loop.rays) and torch.all(px[1:] > px[:-1])
        with torch.no_grad(), ref.precision(False):
            whole = loop.reference_frame(step).reshape(-1, 3)
            part = loop.reference_frame(step, pixels=px)
        assert torch.equal(part, whole[px])
        drawn.append(px)
    assert not torch.equal(drawn[0], drawn[1])  # each step draws its own pixels
    assert not torch.equal(_render(cell, 2**31 + 52, SHARE).pixels(0), drawn[0])


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("seed", [2**31 + 61, 2**31 + 62, 2**31 + 63])
def test_share_one_reads_as_every_pixel(cell, seed, monkeypatch):
    """The four cells without a share: their checks read exactly the numbers that
    the whole-frame check (render) and the three-step comparison (fit) give."""
    made, make = [], loops.make
    monkeypatch.setattr(loops, "make", lambda *a: made.append(make(*a)) or made[-1])
    r = run.run_cell(cell, seed, 0.3, False, device="cpu", size=SIZES[cell])
    loop = made[0]
    assert loop.work_scale == 1.0
    if isinstance(loop, loops.Render):
        assert loop.pixels(0) is None
        today = _every_pixel(loop)
    else:
        today = loop.readings(loop.program_run(), loop.reference_steps())
    assert {k: c["value"] for k, c in r["checks"].items()} == today


def test_counts_at_share_one_are_every_pixels():
    loop = _render("flagship-render", 2**31 + 71, 1.0)
    tris, records = loop.wavefronts(3)
    whole = []
    with torch.no_grad(), ref.precision(False):
        loop.reference_frame(3, record=whole)
    for job in work.JOBS:
        assert work.count(job, tris, records, loop.work_scale) == work.count(job, tris, whole)


@pytest.mark.parametrize("step", [0, 9])
def test_counts_on_a_share_are_its_pixels_scaled(step):
    """On a share the counts are exactly every pixel's records at the drawn pixels,
    scaled; what a roofline reads of them (the bytes, the least time) comes within
    3% of every pixel's. Its pairs alone swing more at this size (a few hundred
    shadow pairs over 2,304 rays)."""
    exact = _render("flagship-render", 2**31 + 81, 1.0)
    shared = _render("flagship-render", 2**31 + 81, SHARE)
    assert shared.work_scale == 1 / SHARE
    tris, whole = exact.wavefronts(step)
    _, part = shared.wavefronts(step)
    px = shared.pixels(step)
    assert len(part[0][1]) == len(px) == SHARE * exact.rays
    at_px = [(r[0],) + tuple(x[px] for x in r[1:4]) + r[4:] if r[0] == "closest_hit"
             else (r[0],) + tuple(x[px] for x in r[1:]) for r in whole]
    for job in work.JOBS:
        want = work.count(job, tris, whole)
        got = work.count(job, tris, part, shared.work_scale)
        assert got == work.count(job, tris, at_px, shared.work_scale)
        assert abs(got["bytes"] - want["bytes"]) <= 0.03 * want["bytes"], (job, got, want)
        least = [work.least_seconds(w, trace.PEAKS) for w in (got, want)]
        assert abs(least[0] - least[1]) <= 0.03 * least[1], (job, got, want)


def test_a_fit_takes_no_share():
    c = run.load_cell("cornell-fit")
    with pytest.raises(ValueError):
        loops.make(c.config, c.mix, 1, "cpu", (8, 6), 0.5)
