"""Pure-NumPy pixel-level oracle for the depth-1 render pipeline.

The port's own copy of `esctp1raytracer_tpu/testing/oracle.py`, with the
same signature and arithmetic: an independent re-implementation of the
reference algorithm — the per-pixel `scan_row` structure (reference
src/main.cpp:698-882: camera ray, brute force closest hit, per-light
sample + occlusion + Phong accumulate) — in scalar-per-pixel NumPy
float32, sharing NO code with the renderer except the counter-RNG
definition (which is part of the framework's deterministic-sampling
contract and is re-derived here in NumPy uint32).

Because sampling is deterministic on (seed, ray_id, stream), the oracle
and the renderer draw identical light points, so agreement is pixel-level
(f32 rounding + the eps acceptance window are the only divergence
sources). tests/test_torch_oracle.py requires >= 99% of pixels within
1e-3. The scene is the port's `Scene`, whose tensors may live on the
card: `_NpScene` copies them to the host.
"""

from __future__ import annotations

import numpy as np

_EPS = np.float32(np.finfo(np.float32).eps)
_BIG = np.float32(1e30)
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)


# -------------------------- counter RNG (numpy) --------------------------

def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * _C1
    h = h ^ (h >> np.uint32(13))
    h = h * _C2
    h = h ^ (h >> np.uint32(16))
    return h


def _hash_u32(seed: int, ray_id: np.ndarray, stream: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = ray_id.astype(np.uint32)
        h = _fmix32(h ^ (np.uint32(seed) + _GOLDEN))
        h = _fmix32(h ^ (np.uint32(stream) * _C1 + _GOLDEN))
    return h


def _uniform01(seed, ray_id, stream) -> np.ndarray:
    bits = _hash_u32(seed, ray_id, stream)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))


def _randint(seed, ray_id, stream, maxval: int) -> np.ndarray:
    u = _uniform01(seed, ray_id, stream)
    return np.minimum((u * np.float32(maxval)).astype(np.int32), maxval - 1)


# ------------------------------ geometry ---------------------------------

def _normalize(v):
    n = np.sqrt(np.maximum(np.sum(v * v, axis=-1, keepdims=True), 1e-12))
    return (v / n).astype(np.float32)


def _mt_all(o, d, v0, v1, v2):
    """Möller–Trumbore of one ray against all triangles [N]. Returns
    (t, u, v, ok) with the reference acceptance window (quirk-16 band)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(d, e2)
    det = np.sum(e1 * pvec, axis=-1)
    ok_det = np.abs(det) >= _EPS
    inv = np.where(ok_det, np.float32(1.0) / np.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1)
    v = np.sum(d * qvec, axis=-1) * inv
    t = np.sum(e2 * qvec, axis=-1) * inv
    ok = (ok_det & (u >= _EPS) & (u <= 1.0) & (v >= _EPS)
          & (u + v <= 1.0) & (t >= _EPS))
    return (np.where(ok, t, _BIG).astype(np.float32), u.astype(np.float32),
            v.astype(np.float32), ok)


def _sphere_all(o, d, center, radius):
    oc = o - center
    b = np.sum(oc * d, axis=-1)
    c0 = np.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - c0
    ok_disc = disc >= 0.0
    sq = np.sqrt(np.where(disc > 0.0, disc, 0.0)).astype(np.float32)
    t_near = -b - sq
    t_far = -b + sq
    t = np.where(t_near >= _EPS, t_near, t_far)
    ok = ok_disc & (t >= _EPS)
    return np.where(ok, t, _BIG).astype(np.float32), ok


def _camera_rays(lookfrom, lookat, vup, vfov, aspect, width, height):
    lookfrom = np.asarray(lookfrom, np.float32)
    lookat = np.asarray(lookat, np.float32)
    vup = np.asarray(vup, np.float32)
    theta = np.float32(vfov * np.pi / 180.0)
    hh = np.tan(theta / 2.0, dtype=np.float32)
    hw = np.float32(aspect) * hh
    w = _normalize(lookfrom - lookat)
    u = _normalize(np.cross(vup, w))
    v = np.cross(w, u).astype(np.float32)
    llc = lookfrom - u * hw - v * hh - w
    horiz = u * np.float32(2.0) * hw
    vert = v * np.float32(2.0) * hh
    ws = (np.arange(width, dtype=np.float32) / np.float32(width - 1))
    hs = (np.arange(height, dtype=np.float32) / np.float32(height - 1))
    s = np.broadcast_to(ws[None, :, None], (height, width, 1))
    t = np.broadcast_to(hs[:, None, None], (height, width, 1))
    dirs = _normalize(llc + horiz * s + vert * t - lookfrom)
    return lookfrom, dirs.reshape(-1, 3)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class _NpScene:
    """The port's Scene copied to host numpy."""

    def __init__(self, scene):
        tb = scene.triangles
        valid = _host(tb.valid)
        self.tri_valid = valid
        for f in ("v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd", "ks",
                  "ke", "ns", "has_normals"):
            setattr(self, f, _host(getattr(tb, f)))
        sp = scene.spheres
        self.s_valid = _host(sp.valid)
        self.s_center = _host(sp.center)
        self.s_radius = _host(sp.radius)
        self.s_mat = {k: _host(getattr(sp, k))
                      for k in ("ka", "kd", "ks", "ke", "ns")}
        self.light_tri = _host(scene.lights.tri_idx)
        self.light_count = _host(scene.lights.face_count)


def oracle_render(scene, lookfrom, lookat, width, height, vup=(0, 1, 0),
                  vfov=60.0, aspect=None, seed=0, shadow_eps=1e-4):
    """Depth-1 oracle render -> [H, W, 3] float32.

    Camera parameters are given explicitly (the oracle does not import the
    framework's Camera); `aspect` defaults to width/height.
    """
    if aspect is None:
        aspect = width / height
    sc = _NpScene(scene)
    origin, dirs = _camera_rays(lookfrom, lookat, vup, vfov, aspect,
                                width, height)
    L = sc.light_tri.shape[0]
    img = np.zeros((height * width, 3), np.float32)

    def closest(o, d):
        t, u, v, _ = _mt_all(o, d, sc.v0, sc.v1, sc.v2)
        t = np.where(sc.tri_valid, t, _BIG)
        it = int(np.argmin(t))
        tt = t[it]
        ts, _ = _sphere_all(o, d, sc.s_center, sc.s_radius)
        ts = np.where(sc.s_valid, ts, _BIG)
        is_ = int(np.argmin(ts)) if ts.size else -1
        tsb = ts[is_] if ts.size else _BIG
        if tsb < tt:
            return tsb, is_, True, np.float32(0), np.float32(0)
        return tt, (it if tt < _BIG else -1), False, u[it], v[it]

    def occluded(o, d, t_limit):
        t, _, _, _ = _mt_all(o, d, sc.v0, sc.v1, sc.v2)
        t = np.where(sc.tri_valid, t, _BIG)
        best = np.min(t) if t.size else _BIG
        ts, _ = _sphere_all(o, d, sc.s_center, sc.s_radius)
        ts = np.where(sc.s_valid, ts, _BIG)
        if ts.size:
            best = min(best, float(np.min(ts)))
        return best < t_limit

    for rid in range(height * width):
        d = dirs[rid]
        t, prim, is_sphere, u, v = closest(origin, d)
        if prim < 0:
            continue
        hit_p = origin + d * np.float32(t - shadow_eps)
        if is_sphere:
            n = (hit_p - sc.s_center[prim]) / max(sc.s_radius[prim], 1e-6)
            mat = {k: sc.s_mat[k][prim] for k in sc.s_mat}
        else:
            e1 = sc.v1[prim] - sc.v0[prim]
            e2 = sc.v2[prim] - sc.v0[prim]
            n = _normalize(np.cross(e1, e2))
            if sc.has_normals[prim]:
                n = _normalize(sc.n1[prim] * u + sc.n2[prim] * v
                               + sc.n0[prim] * (1.0 - u - v))
            mat = {k: getattr(sc, k)[prim] for k in ("ka", "kd", "ks", "ke", "ns")}
        rid_arr = np.asarray([rid], np.uint32)
        color = np.zeros(3, np.float32)
        for l in range(L):
            stream = l * 4
            face = int(_randint(seed, rid_arr, stream, int(sc.light_count[l]))[0])
            r1 = _uniform01(seed, rid_arr, stream + 1)[0]
            r2 = _uniform01(seed, rid_arr, stream + 2)[0]
            tri = int(sc.light_tri[l, face])
            p = (sc.v0[tri] + (sc.v1[tri] - sc.v0[tri]) * r1
                 + (sc.v2[tri] - sc.v0[tri]) * r2)
            lv = p - hit_p
            dist = np.float32(np.sqrt(max(float(np.sum(lv * lv)), 1e-12)))
            ldir = (lv / dist).astype(np.float32)
            if occluded(hit_p, ldir, dist - np.float32(shadow_eps)):
                continue
            dnl = float(n @ ldir)
            if dnl <= 0.0:
                continue
            h = _normalize((n + ldir) * np.float32(2.0))
            spec = max(float(n @ h), 0.0) ** float(mat["ns"])
            color += ((mat["ka"] * np.float32(0.5) + mat["ke"]) / L
                      + (mat["kd"] * np.float32(dnl)
                         + mat["ks"] * np.float32(spec)) / L)
        img[rid] = color
    return img.reshape(height, width, 3)
