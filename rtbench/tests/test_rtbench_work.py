"""rtbench/work/'s counts against a brute-force count, pair by pair, on a tiny scene."""

import math
import random

import torch

from rtbench.work import count as work


def _slab(o, d, lo, hi):
    """(near, far) of the ray's slab test against one box, written out per axis."""
    near, far = -math.inf, math.inf
    for a in range(3):
        if d[a] == 0.0:
            if not lo[a] <= o[a] <= hi[a]:
                return math.inf, -math.inf
            continue
        t1, t2 = (lo[a] - o[a]) / d[a], (hi[a] - o[a]) / d[a]
        near, far = max(near, min(t1, t2)), min(far, max(t1, t2))
    return max(near, 0.0), far


def _brute(o, d, tris, t_max, strict):
    out = []
    for r in range(len(o)):
        n = 0
        for v0, v1, v2 in tris:
            lo = [min(v0[a], v1[a], v2[a]) for a in range(3)]
            hi = [max(v0[a], v1[a], v2[a]) for a in range(3)]
            near, far = _slab(o[r], d[r], lo, hi)
            ok = near < t_max[r] if strict else near <= t_max[r]
            n += int(near <= far and ok)
        out.append(n)
    return out


def _scene(seed=0, n=24, rays=40):
    g = random.Random(seed)
    tris = [[[g.uniform(-2, 2), g.uniform(0, 2), g.uniform(-2, 2)] for _ in range(3)]
            for _ in range(n)]
    tris.append([[-5, 0, 5], [5, 0, 5], [5, 0, -5]])  # a flat box: one axis of zero extent
    o = [[g.uniform(-1, 1), g.uniform(1, 3), 6.0] for _ in range(rays)]
    d = []
    for _ in range(rays):
        v = [g.uniform(-0.5, 0.5), g.uniform(-0.6, 0.1), -1.0]
        s = math.sqrt(sum(x * x for x in v))
        d.append([x / s for x in v])
    d[0] = [0.0, 0.0, -1.0]  # axis-parallel: a zero component in two axes
    t_max = [g.choice([math.inf, g.uniform(1, 8)]) for _ in range(rays)]
    return o, d, tris, t_max


def test_entered_matches_the_slab_test_pair_by_pair():
    o, d, tris, t_max = _scene()
    T = lambda x: torch.tensor(x, dtype=torch.float32)
    v = T(tris)
    lo, hi = work.boxes(v[:, 0], v[:, 1], v[:, 2])
    for strict in (False, True):
        got = work.entered(T(o), T(d), lo, hi, T(t_max), strict).tolist()
        assert got == _brute(o, d, tris, t_max, strict)


def test_jobs_sum_their_searches():
    o, d, tris, t_max = _scene(seed=1)
    T = lambda x: torch.tensor(x, dtype=torch.float32)
    v = T(tris)
    tris_t = (v[:, 0], v[:, 1], v[:, 2])
    occ = torch.tensor([i % 3 == 0 for i in range(len(o))])
    hit = torch.tensor([i % 4 != 0 for i in range(len(o))])
    t_hit = T([(t if t < math.inf else 5.0) if h else math.inf for t, h in zip(t_max, hit.tolist())])
    records = [("closest_hit", T(o), T(d), t_hit, 0),
               ("any_hit", T(o), T(d), T(t_max), occ, hit)]
    closest = sum(_brute(o, d, tris, t_hit.tolist(), False))
    shadow = sum(1 if occ[i] else n for i, n in enumerate(_brute(o, d, tris, t_max, True)))
    n, r = len(tris), len(o)
    c = work.count("closest_hit", tris_t, records)
    a = work.count("any_hit", tris_t, records)
    s = work.count("search", tris_t, records)
    f = work.count("frame", tris_t, records)
    assert c["pairs"] == closest and a["pairs"] == shadow and s["pairs"] == closest + shadow
    assert c["flops"] == closest * work.MT_PAIR_FLOPS
    assert c["bytes"] == r * (work.RAY_BYTES + work.HIT_OUT_BYTES) + n * work.TRI_GEOM_BYTES
    assert f["flops"] == ((closest + shadow) * work.MT_PAIR_FLOPS
                          + int(hit.sum()) * (work.SHADE_HIT_FLOPS + work.SHADE_DRAW_FLOPS))
    assert f["bytes"] == r * (work.RAY_BYTES + work.ID_BYTES + work.COLOR_BYTES) \
        + n * work.TRI_ALL_BYTES
    peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    assert work.least_seconds(c, peaks) == max(c["flops"] / 67e12, c["bytes"] / 3.35e12)
