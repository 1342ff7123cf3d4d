"""Fused whole-frame kernel (K3): scene and rays in, shaded colors out.

Counterpart of `esctp1raytracer_tpu/kernels/fused_pallas.py` (the file
name is kept so a reader finds it), here CUDA kernels: `csrc/fused.cu`.
For small tables (<= FUSED_TRI_LIMIT triangles) the frame's cost is the
glue around the search (the tables, winner gathers, light draws, the
shadow pass), so a frame is two launches. The first builds the tables
(`fused_tables`: the Morton sort of accel/clusters.py, the constants, the
attribute rows, the chunk boxes). The second runs the whole per-pixel
loop for each ray in one thread:

* closest hit over the 13 plane constants of the Morton-sorted triangles
  (the lane search, K4's arithmetic) plus the analytic sphere table,
  sweeping only the 128-triangle chunks that some masked ray of the warp
  can reach (each ray's own slab test, ORed over the warp);
* the winner's attributes, the classic Möller–Trumbore recompute of
  t/u/v and the shading normal, as `closest_hit`/`surface_attributes` do;
* per light, the murmur3 counter draws of utils/rng.py (draw for draw),
  a shadow any-hit against the same chunks, and the Phong term;
* up to FUSED_DEPTH_LIMIT Whitted bounces with the ray state in registers.

`fused_tables` and `fused_kernel` launch their kernels on CUDA tensors and
run the plain PyTorch versions `_fused_tables_plain` and `_fused_plain` on
CPU tensors, counting launches in `.launches`. `fused_trace_diff` is
differentiable: its backward re-derives the frame through `trace_rays` on
the non-fused route `_bwd_cfg` picks, at the same draws.
"""

from __future__ import annotations

import ctypes

import torch

from esctp1raytracer_tpu_torch.accel import clusters
from esctp1raytracer_tpu_torch.core.intersect import BIG, NO_HIT, take_rows
from esctp1raytracer_tpu_torch.kernels import _build, lane_pallas, tables
from esctp1raytracer_tpu_torch.kernels.lane_pallas import (
    PLAIN_BLOCK, TCS_W, _lane_search_plain, lane_plane_hits, valid_prefix,
)
from esctp1raytracer_tpu_torch.scene.types import Scene, TriangleBuffer, float_params, merge_params
from esctp1raytracer_tpu_torch.utils import profiling, rng

RAYS_PER_STEP = 1024  # the TPU kernel's tile of rays (its cull granularity)
FUSED_TRI_LIMIT = 2048
FUSED_CHUNK = 128  # triangles per cullable sweep chunk (= clusters.CLUSTER)
FUSED_DEPTH_LIMIT = 4
FUSED_SPHERE_LIMIT = 32
FUSED_LIGHT_FACE_LIMIT = 64
SHAD_W = 32  # v0 v1 v2 n0 n1 n2 has_n ka kd ks ke ns
SPH_W = 18  # center radius valid ka kd ks ke ns
_TINY = 1e-12
# The backward re-derives wavefronts of at least BWD_MIN_RAYS rays at depth
# >= 2 through mxtile in chunks of BWD_RAY_CHUNK rays (one chunk's graph in
# memory at a time), the rest through the lane/tile rule.
BWD_MIN_RAYS = 1_000_000
BWD_RAY_CHUNK = 262_144


def fused_supported(scene: Scene, depth: int, light_mode: str) -> bool:
    """Static gate of the fused kernel (Python on shapes only)."""
    return (
        1 <= depth <= FUSED_DEPTH_LIMIT
        and light_mode == "area"
        and scene.lights.num_lights >= 1
        and scene.triangles.capacity <= FUSED_TRI_LIMIT
        and scene.spheres.capacity <= FUSED_SPHERE_LIMIT
        and scene.lights.num_lights * scene.lights.max_faces <= FUSED_LIGHT_FACE_LIMIT
    )


def _fallback_cfg(scene: Scene, cfg):
    """The non-fused backend for an explicit "fused" the gate refuses."""
    return cfg.replace(backend="lane" if scene.triangles.capacity <= 4096 else "tile")


def _bwd_cfg(scene: Scene, cfg, num_rays: int):
    """Backend of the backward's re-derivation: chunked mxtile for large deep
    wavefronts (>= BWD_MIN_RAYS rays, depth >= 2), else the lane/tile rule."""
    if num_rays >= BWD_MIN_RAYS and cfg.depth >= 2:
        return cfg.replace(backend="mxtile", ray_chunk=BWD_RAY_CHUNK)
    return _fallback_cfg(scene, cfg)


def _fused_tables_plain(scene: Scene):
    """Plain version of the table build: the kernel's tables, equal to the
    JAX package's.

    Returns (tcs [1, 13N], shad [1, 32N], sph [1, 18S], lc [1, L*F*9],
    cab [1, 6G] chunk AABBs, counts [L] int32, n_tris [1] int32), with the
    triangles Morton-sorted and padded to N = G * FUSED_CHUNK. Invalid
    triangles sort last, so n_tris (one past the last valid) bounds every
    sweep; an all-invalid chunk keeps an inverted box. The light corners
    index the original buffer, so they are gathered before the sort.
    """
    assert clusters.CLUSTER == FUSED_CHUNK, "the chunk AABBs are build_clusters' clusters"
    tris0 = scene.triangles
    packed0 = torch.cat([tris0.v0, tris0.v1, tris0.v2], dim=1)
    pad = (-tris0.capacity) % FUSED_CHUNK
    tpad = tris0
    if pad:
        filler = TriangleBuffer.empty(pad, device=tris0.v0.device)
        tpad = tris0.map(lambda name, a: torch.cat([a, getattr(filler, name)]))
    clustered = clusters.build_clusters(tpad)
    tris = clustered.tris
    cab = torch.cat([clustered.cluster_min, clustered.cluster_max], dim=1)  # [G, 6]
    tcs = lane_pallas.lane_tri_constants(tris)
    shad = torch.cat([tris.v0, tris.v1, tris.v2, tris.n0, tris.n1, tris.n2,
                      tris.has_normals[:, None].to(torch.float32),
                      tris.ka, tris.kd, tris.ks, tris.ke, tris.ns[:, None]], dim=1)
    sph = scene.spheres
    spht = torch.cat([sph.center, sph.radius[:, None], sph.valid[:, None].to(torch.float32),
                      sph.ka, sph.kd, sph.ks, sph.ke, sph.ns[:, None]], dim=1)
    lt = scene.lights
    lc = take_rows(packed0, lt.tri_idx)  # [L, F, 9]
    return (tcs, shad.reshape(1, -1), spht.reshape(1, -1), lc.reshape(1, -1),
            cab.reshape(1, -1), lt.face_count.to(torch.int32), valid_prefix(tris.valid))


class _TableArgs(ctypes.Structure):
    """csrc/fused.cu:TableArgs: the scene's leaves, the outputs, the sizes."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd", "ks", "ke", "ns", "has_n", "valid",
        "s_center", "s_radius", "s_ka", "s_kd", "s_ks", "s_ke", "s_ns", "s_valid",
        "tri_idx", "face_count", "tcs", "shad", "sph", "lc", "cab", "counts", "n_tris")] + [
        (name, ctypes.c_int) for name in ("cap", "S", "L", "F")]


def fused_tables(scene: Scene):
    """The kernel's tables (`_fused_tables_plain` documents them): on CUDA
    tensors one launch of csrc/fused.cu's table build, equal bit for bit to
    the plain version on a CPU copy of the scene; on CPU tensors the plain
    version. The scene must pass `fused_supported`'s table limits."""
    tris, sph, lt = scene.triangles, scene.spheres, scene.lights
    dev = tris.v0.device
    if dev.type == "cpu":
        return _fused_tables_plain(scene)
    if dev.type != "cuda":
        raise ValueError(f"the fused table build takes CUDA or CPU tensors, got {dev}")
    cap, s, nl, nf = tris.capacity, sph.capacity, lt.num_lights, lt.max_faces
    n = -(-cap // FUSED_CHUNK) * FUSED_CHUNK
    if not (1 <= cap <= FUSED_TRI_LIMIT and s <= FUSED_SPHERE_LIMIT and nl >= 1
            and nl * nf <= FUSED_LIGHT_FACE_LIMIT):
        raise ValueError(f"fused table limits exceeded: N={cap}, S={s}, L={nl}, F={nf}")
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    leaves = {name: getattr(tris, name).contiguous() for name in (
        "v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd", "ks", "ke", "ns", "valid")}
    leaves["has_n"] = tris.has_normals.contiguous()
    leaves.update({"s_" + name: getattr(sph, name).contiguous() for name in (
        "center", "radius", "ka", "kd", "ks", "ke", "ns", "valid")})
    leaves["tri_idx"], leaves["face_count"] = lt.tri_idx.contiguous(), lt.face_count.contiguous()
    want = {name: (f32, (cap, 3)) for name in ("v0", "v1", "v2", "n0", "n1", "n2", "ka", "kd",
                                                "ks", "ke")}
    want.update(ns=(f32, (cap,)), valid=(b8, (cap,)), has_n=(b8, (cap,)),
                s_center=(f32, (s, 3)), s_radius=(f32, (s,)), s_ns=(f32, (s,)),
                s_valid=(b8, (s,)), tri_idx=(i32, (nl, nf)), face_count=(i32, (nl,)))
    want.update({"s_" + k: (f32, (s, 3)) for k in ("ka", "kd", "ks", "ke")})
    _build.check_tensors({k: (leaves[k], *v) for k, v in want.items()}, dev)
    widths = (TCS_W * n, SHAD_W * n, SPH_W * s, 9 * nl * nf, 6 * (n // FUSED_CHUNK))
    buf = torch.empty((sum(widths),), dtype=f32, device=dev)  # shad 16-byte aligned
    outs = [x.view(1, -1) for x in torch.split(buf, widths)]
    ints = torch.empty((nl + 1,), dtype=i32, device=dev)
    counts, n_tris = ints[:nl], ints[nl:]
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    ptrs.update(zip(("tcs", "shad", "sph", "lc", "cab"), (x.data_ptr() for x in outs)))
    ptrs.update(counts=counts.data_ptr(), n_tris=n_tris.data_ptr())
    args = _TableArgs(**ptrs, cap=cap, S=s, L=nl, F=nf)
    lib = _lib()
    _build.check_launch(lib, "fused", lib.fused_tables_build(
        ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream))
    fused_tables.launches += 1
    return (*outs, counts, n_tris)


fused_tables.launches = 0


def _stream_const(stream: int) -> int:
    """Stream mixing constant (stream * C1 + GOLDEN) mod 2^32."""
    return (stream * rng._C1 + rng._GOLDEN) & rng._M32


def _seed_const(seed: int) -> int:
    return (int(seed) + rng._GOLDEN) & rng._M32


def _uniform(h0: torch.Tensor, stream: int) -> torch.Tensor:
    bits = rng._fmix32(h0 ^ _stream_const(stream))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# Dots and cross products as the backward's re-derivation takes them
# (core/intersect.py, core/shading.py), so that on either device the plain
# version rounds as the re-derivation there does. On the card torch.sum adds
# a [..., 3] product as (x + z) + y, the order csrc/fused.cu adds in (built
# with -fmad=false); on the CPU it adds ((0 + x) + y) + z.
def _dot(a, b):
    return torch.sum(a * b, dim=1)


def _cross(a, b):
    """torch.linalg.cross: a fused multiply-add per component, on the CPU and
    on the card alike (the kernel's cross_fma)."""
    return torch.linalg.cross(a, b)


def _unit(v):
    return v * torch.rsqrt(torch.clamp(_dot(v, v), min=_TINY))[:, None]


def _sphere_t(o, d, row, eps):
    """The kernel's sphere test for one sphere row [18] -> t [R] (BIG on miss)."""
    oc = o - row[0:3]
    b = _dot(oc, d)
    c0 = _dot(oc, oc) - row[3] * row[3]
    disc = b * b - c0
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    tn = -b - sq
    t = torch.where(tn >= eps, tn, -b + sq)
    ok = (disc >= 0.0) & (t >= eps) & (row[4] > 0.5)
    return torch.where(ok, t, BIG)


def _occluded_plain(o, d, t_lim, c, eps):
    """Any triangle hit with t < t_lim, an OR over the constants c [n, 13]."""
    occ = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    for b0 in range(0, c.shape[0], PLAIN_BLOCK):
        t, ok = lane_plane_hits(o, d, c[b0:b0 + PLAIN_BLOCK], eps)
        occ |= torch.any(ok & (t < t_lim[:, None]), dim=1)
    return occ


def _fused_plain(o, d, ids, tcs, shad, sph, lc, cab, counts, n_tris, *, seed, eps,
                 shadow_eps, depth, lights, faces, record=None):
    """Plain version of K3: colors [R, 3], all rays at once in tensor ops.

    The same arithmetic as the kernel, step for step (its dots and cross
    products those of the backward's re-derivation: on the card it rounds as
    the kernel does, on the CPU as the re-derivation does), with two
    shortcuts that change no result: it sweeps every triangle instead of the
    culled chunks (the cull is conservative: it drops no accepted hit of a
    ray whose result is used), and it gathers rows directly. With a list
    `record`, it appends the wavefronts the kernel sweeps, for counting its
    work: ("camera", o, d, active, hit) per bounce and ("shadow", hp, ld,
    t_lim, mask) per bounce and light.
    """
    r = o.shape[0]
    dev = o.device
    n = int(n_tris.reshape(-1)[0])
    c = tcs.reshape(-1, TCS_W)[:n]
    shad = shad.reshape(-1, SHAD_W)
    sph = sph.reshape(-1, SPH_W)
    lc = lc.reshape(lights, faces, 9)
    eps_t = torch.tensor([eps], dtype=torch.float32, device=dev)
    inv_l = 1.0 / lights
    h0 = rng._fmix32((ids.to(torch.int64) & rng._M32) ^ _seed_const(seed))

    col = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((r, 3), dtype=torch.float32, device=dev)
    active = torch.ones((r,), dtype=torch.bool, device=dev)
    for b in range(depth):
        bt, bi = _lane_search_plain(eps_t, n_tris, tcs, o, d)
        bst = torch.full((r,), BIG, dtype=torch.float32, device=dev)
        bsi = torch.full((r,), NO_HIT, dtype=torch.int32, device=dev)
        for j in range(sph.shape[0]):
            t = _sphere_t(o, d, sph[j], eps)
            better = t < bst
            bst = torch.where(better, t, bst)
            bsi = torch.where(better, j, bsi)
        is_s = bst < bt  # strict: triangles win ties
        bt_comb = torch.where(is_s, bst, bt)
        hit = bt_comb < BIG
        if record is not None:
            record.append(("camera", o, d, active, hit))

        row = torch.where((bi >= 0)[:, None], shad[torch.clamp(bi, min=0).long()], 0.0)
        v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        n0, n1, n2 = row[:, 9:12], row[:, 12:15], row[:, 15:18]
        has_n = row[:, 18]
        ka, kd, ks, ke, ns = (row[:, 19:22], row[:, 22:25], row[:, 25:28], row[:, 28:31],
                              row[:, 31])

        # t/u/v recompute on the winning triangle (closest_hit's MT form).
        e1, e2 = v1 - v0, v2 - v0
        pv = _cross(d, e2)
        det = _dot(e1, pv)
        ok_det = torch.abs(det) >= eps
        inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
        tv = o - v0
        u_r = _dot(tv, pv) * inv_det
        qv = _cross(tv, e1)
        v_r = _dot(d, qv) * inv_det
        t_r = _dot(e2, qv) * inv_det
        ok_r = (ok_det & (u_r >= eps) & (u_r <= 1.0) & (v_r >= eps)
                & (u_r + v_r <= 1.0) & (t_r >= eps))
        t_r = torch.where(ok_r, t_r, BIG)
        t_tri = torch.where(t_r < BIG, t_r, bt_comb)
        t_fin = torch.where(is_s, bst, t_tri)

        t_safe = torch.where(hit, t_fin, 1.0)
        hp = torch.where(hit[:, None], o + d * (t_safe - shadow_eps)[:, None], 0.0)
        ng = _unit(_cross(e1, e2))
        u_sh = torch.where(hit & ~is_s, u_r, 0.0)[:, None]
        v_sh = torch.where(hit & ~is_s, v_r, 0.0)[:, None]
        w_sh = 1.0 - u_sh - v_sh
        nt = torch.where((has_n > 0.5)[:, None], _unit(n1 * u_sh + n2 * v_sh + n0 * w_sh), ng)

        srow = torch.where((bsi >= 0)[:, None], sph[torch.clamp(bsi, min=0).long()], 0.0)
        s2 = is_s[:, None]
        ka = torch.where(s2, srow[:, 5:8], ka)
        kd = torch.where(s2, srow[:, 8:11], kd)
        ks = torch.where(s2, srow[:, 11:14], ks)
        ke = torch.where(s2, srow[:, 14:17], ke)
        ns = torch.where(is_s, srow[:, 17], ns)
        r_safe = torch.where(is_s, torch.clamp(srow[:, 3], min=1e-6), 1.0)
        nsp = torch.where(s2, hp - srow[:, 0:3], 0.0) / r_safe[:, None]
        nrm = torch.where(hit[:, None], torch.where(s2, nsp, nt), 0.0)

        lcol = torch.zeros((r, 3), dtype=torch.float32, device=dev)
        for li in range(lights):
            cnt = counts[li]
            stream = 4 * (b * 1024 + li)
            u_face = _uniform(h0, stream)
            r1 = _uniform(h0, stream + 1)[:, None]
            r2 = _uniform(h0, stream + 2)[:, None]
            face = torch.minimum((u_face * cnt.to(torch.float32)).to(torch.int32), cnt - 1)
            lv = torch.where((face >= 0)[:, None], lc[li][torch.clamp(face, min=0).long()], 0.0)
            lp = lv[:, 0:3] + (lv[:, 3:6] - lv[:, 0:3]) * r1 + (lv[:, 6:9] - lv[:, 0:3]) * r2
            lvec = lp - hp
            dist = torch.sqrt(torch.clamp(_dot(lvec, lvec), min=_TINY))
            ld = lvec / dist[:, None]
            t_lim = dist - shadow_eps
            d_nl = _dot(nrm, ld)
            if record is not None:
                record.append(("shadow", hp, ld, t_lim, active & hit & (d_nl > 0.0)))
            occ = _occluded_plain(hp, ld, t_lim, c, eps)
            for j in range(sph.shape[0]):
                occ |= _sphere_t(hp, ld, sph[j], eps) < t_lim
            hv = (nrm + ld) * 2.0
            spec_dot = torch.clamp(_dot(nrm, hv) * torch.rsqrt(torch.clamp(_dot(hv, hv),
                                                                          min=_TINY)), min=0.0)
            spec = torch.exp(ns * torch.log(torch.clamp(spec_dot, min=_TINY)))
            vis = (hit & ~occ & (d_nl > 0.0))[:, None]
            cc = (ka * 0.5 + ke + kd * d_nl[:, None] + ks * spec[:, None]) * inv_l
            lcol = lcol + torch.where(vis, cc, 0.0)

        col = col + torch.where(active[:, None], thr * lcol, 0.0)
        if b + 1 < depth:
            active = active & hit & (torch.amax(ks, dim=1) > 0.0)
            thr = torch.where(active[:, None], thr * ks, 0.0)
            refl = d - 2.0 * _dot(d, nrm)[:, None] * nrm
            o = torch.where(active[:, None], hp, o)
            d = torch.where(active[:, None], _unit(refl), d)
    return col


# --------------------------------------------------------------------------
# The CUDA kernel (csrc/fused.cu), bound with ctypes
# --------------------------------------------------------------------------

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("fused")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_frame.argtypes = [vp] * 11 + [ci] * 6 + [ctypes.c_uint, cf, cf, vp]
        lib.fused_frame.restype = ci
        lib.fused_tables_build.argtypes = [ctypes.POINTER(_TableArgs), vp]
        lib.fused_tables_build.restype = ci
        lib.fused_launch_shape.argtypes = [ci] * 5 + [ctypes.POINTER(ci)] * 4
        lib.fused_launch_shape.restype = ci
        _LIB = lib
    return _LIB


def launch_shape(rays: int, n: int, spheres: int, lights: int, faces: int) -> dict:
    """K3's launch over `rays` rays and an n-triangle table on the current
    card: threads per block, blocks resident per SM (from the kernel's
    registers and its shared memory), the persistent grid, shared memory."""
    lib = _lib()
    out = [ctypes.c_int() for _ in range(4)]
    _build.check_launch(lib, "fused", lib.fused_launch_shape(
        rays, n, spheres, lights, faces, *map(ctypes.byref, out)))
    return dict(zip(("threads", "blocks_per_sm", "blocks", "smem_bytes"), (x.value for x in out)))


def fused_kernel(o, d, ids, tcs, shad, sph, lc, cab, counts, n_tris, *, seed, eps,
                 shadow_eps, depth, lights, faces):
    """K3: the whole frame for rays o, d [R, 3] (f32) with ids [R] -> colors [R, 3].

    The tables are `fused_tables`' outputs; seed, eps, shadow_eps, depth,
    lights (L) and faces (F) are the render's static parameters.
    """
    dev = o.device
    kw = dict(seed=seed, eps=eps, shadow_eps=shadow_eps, depth=depth, lights=lights,
              faces=faces)
    if dev.type == "cpu":
        return _fused_plain(o, d, ids, tcs, shad, sph, lc, cab, counts, n_tris, **kw)
    if dev.type != "cuda":
        raise ValueError(f"the fused kernel takes CUDA or CPU tensors, got {dev}")
    r = o.shape[0]
    n, s, g = tcs.shape[-1] // TCS_W, sph.shape[-1] // SPH_W, cab.shape[-1] // 6
    if not (n <= FUSED_TRI_LIMIT and n == g * FUSED_CHUNK and s <= FUSED_SPHERE_LIMIT
            and 1 <= lights and lights * faces <= FUSED_LIGHT_FACE_LIMIT
            and 1 <= depth <= FUSED_DEPTH_LIMIT):
        raise ValueError(f"fused kernel limits exceeded: N={n}, G={g}, S={s}, L={lights}, "
                         f"F={faces}, depth={depth}")
    ids64 = ids.to(torch.int64).contiguous()  # the kernel takes the low 32 bits
    _build.check_tensors({
        "o": (o, torch.float32, (r, 3)), "d": (d, torch.float32, (r, 3)),
        "ids": (ids64, torch.int64, (r,)), "tcs": (tcs, torch.float32, (1, TCS_W * n)),
        "shad": (shad, torch.float32, (1, SHAD_W * n)), "sph": (sph, torch.float32, (1, SPH_W * s)),
        "lc": (lc, torch.float32, (1, lights * faces * 9)), "cab": (cab, torch.float32, (1, 6 * g)),
        "counts": (counts, torch.int32, (lights,)), "n_tris": (n_tris, torch.int32, (1,)),
    }, dev)
    if shad.data_ptr() % 16:
        raise ValueError("shad must be 16-byte aligned (float4 row loads)")
    out = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    lib = _lib()
    _build.check_launch(lib, "fused", lib.fused_frame(
        o.data_ptr(), d.data_ptr(), ids64.data_ptr(), tcs.data_ptr(), shad.data_ptr(),
        sph.data_ptr(), lc.data_ptr(), cab.data_ptr(), counts.data_ptr(), n_tris.data_ptr(),
        out.data_ptr(), r, n, s, lights, faces, depth, _seed_const(seed), eps, shadow_eps,
        torch.cuda.current_stream(dev).cuda_stream))
    fused_kernel.launches += 1
    return out


fused_kernel.launches = 0


def fused_trace(o, d, scene: Scene, ray_ids, cfg) -> torch.Tensor:
    """One wavefront through the fused kernel -> colors [R, 3] (no gradient).

    The caller checks `fused_supported` first. On the card: two launches,
    the table build and K3.
    """
    with torch.no_grad(), profiling.annotate("fused.frame"):
        tables = fused_tables(scene.detach())
        return fused_kernel(o.detach().contiguous(), d.detach().contiguous(), ray_ids, *tables,
                            seed=cfg.seed, eps=float(cfg.eps),
                            shadow_eps=float(cfg.shadow_eps), depth=cfg.depth,
                            lights=scene.lights.num_lights, faces=scene.lights.max_faces)


class _FusedTraceDiff(torch.autograd.Function):
    """Forward: the fused kernel. Backward: re-derive the frame through
    `trace_rays` on `_bwd_cfg`'s backend at the same draws, one ray chunk
    at a time (only one chunk's graph is alive at once), and sum; the
    search's scene tables are built once for every chunk
    (`tables.search_tables`). While spans are on, the re-derivation is the
    span `fused.rederive`, with the counters `fused.rederive_chunks` and
    `fused.rederive_rays`."""

    @staticmethod
    def forward(ctx, o, d, ray_ids, cfg, scene, *leaves):
        ctx.cfg, ctx.scene = cfg, scene
        ctx.save_for_backward(o, d, ray_ids, *leaves)
        return fused_trace(o, d, merge_params(scene, leaves), ray_ids, cfg)

    @staticmethod
    def backward(ctx, grad):
        from esctp1raytracer_tpu_torch.core.render import trace_rays

        o, d, ray_ids, *leaves = ctx.saved_tensors
        need_o, need_d = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        need_leaf = ctx.needs_input_grad[5:]
        fb = _bwd_cfg(ctx.scene, ctx.cfg, o.shape[0])
        chunk = fb.ray_chunk or o.shape[0]
        fb = fb.replace(ray_chunk=0)
        g_o, g_d, g_leaf = [], [], [None] * len(leaves)
        with torch.enable_grad(), profiling.annotate("fused.rederive"), tables.search_tables():
            profiling.count("fused.rederive_chunks", -(-o.shape[0] // chunk))
            profiling.count("fused.rederive_rays", o.shape[0])
            ps = [p.detach().requires_grad_(need) for p, need in zip(leaves, need_leaf)]
            scene = merge_params(ctx.scene, ps)
            for i in range(0, o.shape[0], chunk):
                sl = slice(i, i + chunk)
                oc = o[sl].detach().requires_grad_(need_o)
                dc = d[sl].detach().requires_grad_(need_d)
                inputs = [x for x in (oc, dc, *ps) if x.requires_grad]
                color = trace_rays(oc, dc, scene, ray_ids[sl], fb)
                gs = torch.autograd.grad(color, inputs, grad[sl], allow_unused=True)
                gs = iter(torch.zeros_like(x) if g is None else g for x, g in zip(inputs, gs))
                if need_o:
                    g_o.append(next(gs))
                if need_d:
                    g_d.append(next(gs))
                for k, p in enumerate(ps):
                    if p.requires_grad:
                        gk = next(gs)
                        g_leaf[k] = gk if g_leaf[k] is None else g_leaf[k] + gk
        return (torch.cat(g_o) if need_o else None, torch.cat(g_d) if need_d else None,
                None, None, None, *g_leaf)


def fused_trace_diff(o, d, scene: Scene, ray_ids, cfg) -> torch.Tensor:
    """`fused_trace` with gradients with respect to o, d and every float
    scene leaf (the autograd counterpart of the JAX custom VJP)."""
    return _FusedTraceDiff.apply(o, d, ray_ids, cfg, scene, *float_params(scene))
