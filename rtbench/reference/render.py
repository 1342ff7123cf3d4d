"""The plain reference renderer: brute force, float32, in blocks.

What a frame is, written from the renderer's description and not from its
code: pinhole camera rays, the closest hit over every triangle (Möller–
Trumbore acceptance window) and every sphere, Phong/Blinn shading against
each area light at one point drawn per (ray, light) by the counter hash
(`rng.py`), a shadow ray from the backed-off hit point, and Whitted
reflections for depth > 1. The triangle search is the Möller–Trumbore test
written as one float32 contraction per block, [rays, 16] @ [16, 4 * tris]
(det, t*det, u*det, v*det are trilinear in the ray and the triangle): with
TF32 allowed it runs in TF32, which is the control (`precision(tf32=True)`).
The winner's t, u, v are then recomputed by the classic test, differentiably,
so the gradient of a frame with respect to the scene's float leaves flows
through the winners only.

Imports torch alone; takes the scene as the benchmark's own arrays.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from .rng import randint, uniform01

EPS = float(np.finfo(np.float32).eps)  # the acceptance window's epsilon
SHADOW_EPS = 1e-4                      # the back-off along the ray before shading
BIG = 1e30                             # t of a miss
TINY = 1e-12
FAR = 3e7                              # where a missed ray's shadow origin is parked
PAIRS_PER_BLOCK = 1 << 24              # (ray, triangle) pairs per contraction block
TRI_BLOCK = 16384

TRI_LEAVES = ("v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd", "ks", "ke", "ns")
SPHERE_LEAVES = ("center", "radius", "ka", "kd", "ks", "ke", "ns")


_TF32 = [False]


@contextlib.contextmanager
def precision(tf32: bool):
    """Inside the block the search's contraction takes its operands in TF32 (10
    mantissa bits, rounded to nearest, as the tensor cores take them; the sums
    stay float32) when `tf32`, else in float32 with TF32 off. The rounding is
    done here, so the control reads the same on the CPU and on the card."""
    old = (_TF32[0], torch.backends.cuda.matmul.allow_tf32)
    _TF32[0], torch.backends.cuda.matmul.allow_tf32 = tf32, False
    try:
        yield
    finally:
        _TF32[0], torch.backends.cuda.matmul.allow_tf32 = old


def _operand(x):
    """x as the contraction takes it: float32, or rounded to TF32 inside `precision(True)`."""
    if not _TF32[0]:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclass
class Scene:
    """Float leaves by the renderer's dotted names, and the fixed parts."""

    leaves: Dict[str, torch.Tensor]
    has_n: torch.Tensor          # [N] bool
    lights: List[torch.Tensor]   # per light source: its triangle indices (int64)

    def replace(self, leaves: Dict[str, torch.Tensor]) -> "Scene":
        return Scene(leaves, self.has_n, self.lights)

    def detach(self) -> "Scene":
        return self.replace({k: t.detach() for k, t in self.leaves.items()})


def scene_from_arrays(a, device) -> Scene:
    """`rtbench.scenes.SceneArrays` as a reference Scene on `device`."""
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)
    leaves = {"triangles.v0": t(a.v[:, 0]), "triangles.v1": t(a.v[:, 1]),
              "triangles.v2": t(a.v[:, 2]), "triangles.n0": t(a.n[:, 0]),
              "triangles.n1": t(a.n[:, 1]), "triangles.n2": t(a.n[:, 2])}
    leaves.update({f"triangles.{k}": t(a.mat[k]) for k in ("ka", "kd", "ks", "ke", "ns")})
    leaves.update({f"spheres.{k}": t(a.spheres[k]) for k in SPHERE_LEAVES})
    return Scene(leaves, torch.as_tensor(a.has_n, device=device),
                 [torch.as_tensor(l, dtype=torch.int64, device=device) for l in a.lights])


# --- camera ------------------------------------------------------------------

def _unit(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def camera_rays(cam: dict, width: int, height: int, device):
    """Pinhole look-at rays, row h of the image at t = h / (H - 1): (o, d) [H*W, 3]."""
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.as_tensor(cam["lookfrom"], **f32)
    w = _unit(eye - torch.as_tensor(cam["lookat"], **f32))
    u = _unit(torch.linalg.cross(torch.as_tensor(cam.get("vup", (0.0, 1.0, 0.0)), **f32), w))
    v = torch.linalg.cross(w, u)
    half_h = torch.tensor(np.tan(np.float32(cam["vfov"] * math.pi / 180.0 / 2.0)), **f32)
    half_w = (width / height) * half_h
    corner = eye - u * half_w - v * half_h - w
    horiz, vert = u * 2.0 * half_w, v * 2.0 * half_h
    s = (torch.arange(width, **f32) / float(width - 1))[None, :, None]
    t = (torch.arange(height, **f32) / float(height - 1))[:, None, None]
    d = _unit(corner + horiz * s + vert * t - eye).reshape(-1, 3)
    return torch.broadcast_to(eye, d.shape), d


# --- the search --------------------------------------------------------------

def _skew(e):
    """C(e)_ij = sum_k eps_ijk e_k, flattened row-major: [..., 9]."""
    x, y, z = e[..., 0], e[..., 1], e[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([zero, z, -y, -z, zero, x, y, -x, zero], dim=-1)


def _tri_columns(v0, v1, v2):
    """[16, 4 * B]: per triangle the columns of det, t*det, u*det, v*det against
    the ray features [d, o, o (x) d, 1]."""
    e1, e2 = v1 - v0, v2 - v0
    n = torch.linalg.cross(e1, e2)
    z3, z9 = torch.zeros_like(n), torch.zeros(n.shape[0], 9, device=n.device)
    z1 = torch.zeros(n.shape[0], 1, device=n.device)
    det = torch.cat([-n, z3, z9, z1], 1)
    tdet = torch.cat([z3, n, z9, -torch.sum(v0 * n, 1, keepdim=True)], 1)
    udet = torch.cat([torch.linalg.cross(v0, e2), z3, _skew(e2), z1], 1)
    vdet = torch.cat([-torch.linalg.cross(v0, e1), z3, -_skew(e1), z1], 1)
    return torch.stack([det, tdet, udet, vdet], 2).permute(1, 0, 2).reshape(16, -1)


def _ray_features(o, d):
    od = (o[:, :, None] * d[:, None, :]).reshape(-1, 9)
    return torch.cat([d, o, od, torch.ones_like(o[:, :1])], 1)


@torch.no_grad()
def closest_triangle(o, d, v0, v1, v2, eps=EPS):
    """Brute-force closest triangle hit per ray: (t [R] (BIG on a miss), index [R] (-1))."""
    r, n = o.shape[0], v0.shape[0]
    best_t = torch.full((r,), BIG, device=o.device)
    best_i = torch.full((r,), -1, dtype=torch.int64, device=o.device)
    cols = [(b, _tri_columns(v0[b:b + TRI_BLOCK], v1[b:b + TRI_BLOCK], v2[b:b + TRI_BLOCK]))
            for b in range(0, n, TRI_BLOCK)]
    rb = max(1, PAIRS_PER_BLOCK // min(n, TRI_BLOCK))
    for a in range(0, r, rb):
        rf = _ray_features(o[a:a + rb], d[a:a + rb])
        for b, tc in cols:
            s = (_operand(rf) @ _operand(tc)).reshape(rf.shape[0], -1, 4)
            det = s[..., 0]
            ok = det.abs() >= eps
            inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
            t, u, v = s[..., 1] * inv, s[..., 2] * inv, s[..., 3] * inv
            ok &= (u >= eps) & (u <= 1.0) & (v >= eps) & (u + v <= 1.0) & (t >= eps)
            tmin, arg = torch.min(torch.where(ok, t, BIG), 1)
            better = tmin < best_t[a:a + rb]
            best_t[a:a + rb] = torch.where(better, tmin, best_t[a:a + rb])
            best_i[a:a + rb] = torch.where(better, arg + b, best_i[a:a + rb])
    return best_t, best_i


def _sphere_t(o, d, center, radius, eps=EPS):
    """Analytic ray-sphere t for unit d, broadcast; BIG on a miss."""
    oc = o - center
    b = torch.sum(oc * d, -1)
    disc = b * b - (torch.sum(oc * oc, -1) - radius * radius)
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    t = torch.where(-b - sq >= eps, -b - sq, -b + sq)
    return torch.where((disc >= 0.0) & (t >= eps), t, BIG)


@torch.no_grad()
def closest_sphere(o, d, center, radius):
    if center.shape[0] == 0:
        return (torch.full((o.shape[0],), BIG, device=o.device),
                torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device))
    t = _sphere_t(o[:, None], d[:, None], center[None], radius[None])
    best, arg = torch.min(t, 1)
    return best, torch.where(best < BIG, arg, -1)


@torch.no_grad()
def search(o, d, scene: Scene):
    """(t, prim, is_sphere) of the closest hit over triangles and spheres."""
    p = scene.leaves
    tt, ti = closest_triangle(o, d, p["triangles.v0"], p["triangles.v1"], p["triangles.v2"])
    st, si = closest_sphere(o, d, p["spheres.center"], p["spheres.radius"])
    is_s = st < tt
    t = torch.where(is_s, st, tt)
    return t, torch.where(t < BIG, torch.where(is_s, si, ti), -1), is_s & (t < BIG)


@torch.no_grad()
def occluded(o, d, t_limit, scene: Scene):
    """Any triangle or sphere at eps <= t < t_limit; rays with t_limit <= 0 are not traced."""
    out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    live = torch.nonzero(t_limit > 0.0).squeeze(1)
    if live.numel():
        t, _, _ = search(o[live], d[live], scene)
        out[live] = t < t_limit[live]
    return out


# --- shading -----------------------------------------------------------------

def _normalize(v):
    return v * torch.rsqrt(torch.clamp(torch.sum(v * v, -1, keepdim=True), min=TINY))


def _mt(o, d, v0, v1, v2, eps=EPS):
    """The classic Möller–Trumbore test at one triangle per ray: (t (BIG if rejected), u, v)."""
    e1, e2 = v1 - v0, v2 - v0
    pv = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * pv, -1)
    okd = det.abs() >= eps
    inv = torch.where(okd, 1.0 / torch.where(okd, det, 1.0), 0.0)
    tv = o - v0
    u = torch.sum(tv * pv, -1) * inv
    q = torch.linalg.cross(tv, e1)
    v = torch.sum(d * q, -1) * inv
    t = torch.sum(e2 * q, -1) * inv
    ok = okd & (u >= eps) & (u <= 1.0) & (v >= eps) & (u + v <= 1.0) & (t >= eps)
    return torch.where(ok, t, BIG), u, v


def _rows(x, idx):
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(idx.shape + x.shape[1:])


def bounce(o, d, ids, seed: int, k: int, scene: Scene, record: list | None = None):
    """One bounce of a wavefront: (color [R,3], hit point, normal, ks, hit mask)."""
    p = scene.leaves
    r = o.shape[0]
    t_s, prim, is_s = search(o.detach(), d.detach(), scene.detach())
    hit = prim >= 0
    tri = torch.where(hit & ~is_s, prim, 0)
    g = {k_: _rows(p[f"triangles.{k_}"], tri) for k_ in TRI_LEAVES}
    t_mt, u, v = _mt(o, d, g["v0"], g["v1"], g["v2"])
    t = torch.where(t_mt < BIG, t_mt, t_s)
    if p["spheres.center"].shape[0]:
        sph = torch.where(is_s, prim, 0)
        sg = {k_: _rows(p[f"spheres.{k_}"], sph) for k_ in SPHERE_LEAVES}
        m = is_s[:, None]
        os_ = torch.where(m, o, torch.tensor([0.0, 0.0, 3.0], device=o.device))
        ds_ = torch.where(m, d, torch.tensor([0.0, 0.0, -1.0], device=o.device))
        t_sph = _sphere_t(os_, ds_, torch.where(m, sg["center"], 0.0),
                          torch.where(is_s, sg["radius"], 1.0))
        t = torch.where(is_s, torch.where(t_sph < BIG, t_sph, t_s), t)
    u = torch.where(hit & ~is_s, u, 0.0)
    v = torch.where(hit & ~is_s, v, 0.0)
    if record is not None:
        record.append(("closest_hit", o.detach(), d.detach(), torch.where(hit, t_s, math.inf), k))

    # Surface at the winner: hit point backed off along the ray, normal, material.
    t_safe = torch.where(hit, t, 1.0)[:, None]
    hit_p = o + d * (t_safe - SHADOW_EPS)
    n_geom = _normalize(torch.linalg.cross(g["v1"] - g["v0"], g["v2"] - g["v0"]))
    n_smooth = _normalize(g["n1"] * u[:, None] + g["n2"] * v[:, None]
                          + g["n0"] * (1.0 - u - v)[:, None])
    normal = torch.where(scene.has_n[tri][:, None], n_smooth, n_geom)
    mat = {k_: g[k_] for k_ in ("ka", "kd", "ks", "ke", "ns")}
    if p["spheres.center"].shape[0]:
        r_safe = torch.where(is_s, torch.clamp(sg["radius"], min=1e-6), 1.0)
        n_sph = torch.where(is_s[:, None], hit_p - sg["center"], 0.0) / r_safe[:, None]
        normal = torch.where(is_s[:, None], n_sph, normal)
        for k_ in mat:
            cond = is_s[:, None] if mat[k_].dim() == 2 else is_s
            mat[k_] = torch.where(cond, sg[k_], mat[k_])
    hit_p = torch.where(hit[:, None], hit_p, 0.0)
    normal = torch.where(hit[:, None], normal, 0.0)

    # One point per (ray, light): a face drawn by the hash, then a parallelogram point on it.
    n_l = len(scene.lights)
    if n_l == 0:
        return torch.sum(hit_p[:, None, :][:, :0], 1), hit_p, normal, mat["ks"], hit
    colors = []
    for li, faces in enumerate(scene.lights):
        stream = torch.full((1,), (k * 1024 + li) * 4, dtype=torch.int64, device=o.device)
        face = randint(seed, ids, stream, torch.tensor(faces.numel(), device=o.device))
        r1 = uniform01(seed, ids, stream + 1)[:, None]
        r2 = uniform01(seed, ids, stream + 2)[:, None]
        lt = faces[face.long()]
        lv0, lv1, lv2 = (_rows(p[f"triangles.{c}"], lt) for c in ("v0", "v1", "v2"))
        pl = lv0 + (lv1 - lv0) * r1 + (lv2 - lv0) * r2
        lvec = pl - hit_p
        dist = torch.sqrt(torch.clamp(torch.sum(lvec * lvec, -1), min=TINY))
        ldir = lvec / dist[:, None]
        d_nl = torch.sum(normal * ldir, -1)
        t_lim = torch.where(d_nl > 0.0, dist - SHADOW_EPS, -1.0).detach()
        so = torch.where(hit[:, None], hit_p, FAR).detach()
        t_lim = torch.where(hit, t_lim, -1.0)
        occ = occluded(so, ldir.detach(), t_lim, scene.detach())
        if record is not None:
            record.append(("any_hit", so, ldir.detach(), t_lim, occ, hit))
        h = _normalize((normal + ldir) * 2.0)
        spec = torch.pow(torch.clamp(torch.clamp(torch.sum(normal * h, -1), min=0.0), min=TINY),
                         mat["ns"])
        base = (mat["ka"] * 0.5 + mat["ke"]) / n_l
        lit = (mat["kd"] * d_nl[:, None] + mat["ks"] * spec[:, None]) / n_l
        vis = hit & ~occ & (d_nl > 0.0)
        colors.append(torch.where(vis[:, None], base + lit, 0.0))
    color = colors[0]
    for c in colors[1:]:
        color = color + c
    return color, hit_p, normal, mat["ks"], hit


def trace(o, d, ids, seed: int, depth: int, scene: Scene, record: list | None = None):
    """Colors [R, 3] of a wavefront, with `depth - 1` Whitted reflections."""
    color = torch.zeros_like(o)
    through = torch.ones_like(o)
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for k in range(depth):
        local, hit_p, normal, ks, hit = bounce(o, d, ids, seed, k, scene, record)
        color = color + through * torch.where(active[:, None], local, 0.0)
        if k + 1 < depth:
            active = active & hit & (torch.amax(ks, -1) > 0.0)
            through = torch.where(active[:, None], through * ks, 0.0)
            refl = d - 2.0 * torch.sum(d * normal, -1, keepdim=True) * normal
            refl = refl * torch.rsqrt(torch.clamp(torch.sum(refl * refl, -1, keepdim=True),
                                                  min=TINY))
            o = torch.where(active[:, None], hit_p, o)
            d = torch.where(active[:, None], refl, d)
    return color


def image(scene: Scene, cam: dict, width: int, height: int, ids, seed: int, depth: int,
          passes: int = 1, record: list | None = None, pixels=None):
    """The frame [H, W, 3]: the mean of `passes` passes, pass i at ray ids + i * H * W.
    With `pixels` (flat indices into the frame) only those pixels' rays are traced,
    and their colors [P, 3] returned: a ray's color depends on its own ray and id
    alone, so they are the whole frame's at those pixels."""
    o, d = camera_rays(cam, width, height, ids.device)
    rays = o.shape[0]
    if pixels is not None:
        o, d, ids = o[pixels], d[pixels], ids[pixels]
    acc = None
    for i in range(passes):
        c = trace(o, d, ids + i * rays, seed, depth, scene, record)
        acc = c if acc is None else acc + c
    acc = acc / passes if passes > 1 else acc
    return acc if pixels is not None else acc.reshape(height, width, 3)


def loss_and_grad(scene: Scene, target, cam, width, height, ids, seed, depth):
    """mean((image - target)^2) and its gradient with respect to every float leaf."""
    leaves = {k: t.detach().requires_grad_(True) for k, t in scene.leaves.items()}
    with torch.enable_grad():
        img = image(scene.replace(leaves), cam, width, height, ids, seed, depth)
        loss = torch.mean((img - target) ** 2)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
    return loss.detach(), {k: (g if g is not None else torch.zeros_like(leaves[k]))
                           for k, g in zip(names, grads)}


@torch.no_grad()
def adam(params: dict, grads: dict, state: dict, lr: float, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam step (the bias-corrected form); returns (params, state)."""
    t = state.get("t", 0) + 1
    m = {k: b1 * state["m"][k] + (1 - b1) * grads[k] if "m" in state else (1 - b1) * grads[k]
         for k in params}
    v = {k: b2 * state["v"][k] + (1 - b2) * grads[k] * grads[k] if "v" in state
         else (1 - b2) * grads[k] * grads[k] for k in params}
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    new = {k: params[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) for k in params}
    return new, {"m": m, "v": v, "t": t}
