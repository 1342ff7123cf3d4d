"""Variants of the fused frame kernel (K3) and the lane kernel (K4) on the card.

Builds variants of csrc/fused.cu and csrc/lane.cu, made by text
substitution of the sources as they stand, into build/probe/ with the
port's nvcc flags, and times each through the port's own wrappers (the
variant library swapped in) on the inputs of chip_smoke.py's paths: K4 on
the Cornell frame's camera and shadow wavefronts (lane route), K3 on the
Cornell frame and config 4's (mixed_scene(), 1920x1080, depth 4). Every
variant's output is held equal to the source's own, bit for bit. Prints
each variant's time (CUDA events, mean of 20 calls, median of 3), its
ptxas registers and spills.

Variants: "src" the sources as they are; "noskip" the closest-hit sweep
without the division skip; "skip_both" (K3) the any-hit sweep with it
too; "hull_cull" (K3) the chunk cull of the TPU kernel (the interval hull
of the warp's rays) in place of each ray's own slab test;
"threads256_no_unroll" (K4) blocks of 256 and the sweep not unrolled.

Usage (on the machine with the card, from the repository root):
    python3 scripts/probe_k3k4.py
"""

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from esctp1raytracer_tpu_torch.core.render import RenderConfig  # noqa: E402
from esctp1raytracer_tpu_torch.kernels import _build, fused_pallas, lane_pallas  # noqa: E402
from esctp1raytracer_tpu_torch.scene.builders import cornell_box, mixed_scene  # noqa: E402

OUT = _build.BUILD_DIR.parent / "probe"

HULL = r'''
// The cull of the TPU kernel (and of this port before its redesign): the
// interval hull of the warp's masked rays (-min/max of o and d, the largest
// t_limit), tested by lane g against chunk g's box, balloted.
__device__ __forceinline__ unsigned warp_cull_hull(const float* cab, int G, bool mask, Vec o,
                                                   Vec d, float tl) {
  const int lane = threadIdx.x & 31;
  float h[13] = {o.x, o.y, o.z, d.x, d.y, d.z, -o.x, -o.y, -o.z, -d.x, -d.y, -d.z, -tl};
#pragma unroll
  for (int k = 0; k < 13; ++k) {
    h[k] = mask ? h[k] : 3.4e38f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) h[k] = fminf(h[k], __shfl_xor_sync(kFull, h[k], off));
  }
  const bool live = __any_sync(kFull, mask);
  bool keep = false;
  if (lane < G) {
    const float* box = cab + 6 * lane;
    keep = live && box[0] <= box[3];
    if (keep && G > 1) {
      float near_all = -3.4e38f, far_all = 3.4e38f;
      bool unsure = false;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o_lo = h[a], o_hi = -h[6 + a], d_lo = h[3 + a], d_hi = -h[9 + a];
        const bool unb = d_lo <= 0.0f && d_hi >= 0.0f;
        const float ia = 1.0f / (unb ? 1.0f : d_hi), ib = 1.0f / (unb ? 1.0f : d_lo);
        const float il = fminf(ia, ib), ih = fmaxf(ia, ib);
        const float lo1 = box[a] - o_hi, hi1 = box[a] - o_lo;
        const float lo2 = box[3 + a] - o_hi, hi2 = box[3 + a] - o_lo;
        const float p[8] = {lo1 * il, lo1 * ih, hi1 * il, hi1 * ih,
                            lo2 * il, lo2 * ih, hi2 * il, hi2 * ih};
        float nr = p[0], fr = p[0];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          unsure |= isnan(p[k]);
          nr = fminf(nr, p[k]);
          fr = fmaxf(fr, p[k]);
        }
        if (!unb) {
          near_all = fmaxf(near_all, nr);
          far_all = fminf(far_all, fr);
        }
      }
      keep = unsure || !(near_all > far_all || far_all < 0.0f || near_all > -h[12]);
    }
  }
  return __ballot_sync(kFull, keep);
}
'''

LANE_LOOP = "#pragma unroll 4\n    for (int i = 0; i < n; ++i) {"
CAMERA = "plane_t_skip(c.c0, c.c1, c.c2, o, d, eps)"
SHADOW = "plane_t4(c.c0, c.c1, c.c2, hp, ld, eps)"


def variants():
    lane = (_build.CSRC / "lane.cu").read_text()
    fused = (_build.CSRC / "fused.cu").read_text()
    for src, text in ((lane, LANE_LOOP), (lane, CAMERA), (fused, CAMERA), (fused, SHADOW),
                      (fused, "warp_cull(s_cab"), (lane, "kThreads = 512;")):
        assert text in src, text
    kernel = "__global__ void __launch_bounds__(kThreads)\nfused_frame_kernel"
    assert kernel in fused
    return {
        ("lane", "src"): lane,
        ("lane", "noskip"): lane.replace(CAMERA, CAMERA.replace("plane_t_skip", "plane_t4")),
        ("lane", "threads256_no_unroll"): lane.replace(LANE_LOOP, LANE_LOOP.split("\n")[1])
        .replace("kThreads = 512;", "kThreads = 256;"),
        ("fused", "src"): fused,
        ("fused", "noskip"): fused.replace(CAMERA, CAMERA.replace("plane_t_skip", "plane_t4")),
        ("fused", "skip_both"): fused.replace(SHADOW, SHADOW.replace("plane_t4", "plane_t_skip")),
        ("fused", "hull_cull"): fused.replace(kernel, HULL + "\n" + kernel)
        .replace("warp_cull(s_cab", "warp_cull_hull(s_cab"),
    }


def build(key, src):
    kind, name = key
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{kind}_{name}.cu", OUT / f"{kind}_{name}.so"
    cu.write_text(src)
    flags = _build.NVCC_FLAGS + _build.SOURCE_FLAGS[kind] + ["-I", str(_build.CSRC)]
    proc = subprocess.run([_build._nvcc(), *flags, "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {cu}:\n{proc.stderr[-3000:]}")
    regs = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
            if "registers" in line or "spill" in line]
    return key, so, regs


def load(kind, so):
    """The variant library with the production wrapper's argtypes."""
    mod = lane_pallas if kind == "lane" else fused_pallas
    saved = mod._LIB
    mod._LIB = None
    real = _build.load
    _build.load = lambda name: ctypes.CDLL(str(so))
    try:
        lib = mod._lib()
    finally:
        _build.load = real
        mod._LIB = saved
    err = getattr(lib, f"{kind}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def timed(fn):
    fn()
    return statistics.median(cs.cuda_ms(fn, 20) for _ in range(3))


def main():
    card = cs.device_phase()
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(lambda kv: build(*kv), variants().items()))
    libs = {key: load(key[0], so) for key, so, _ in built}
    for key, _, regs in built:
        print(f"{key}: {' | '.join(regs)}", flush=True)

    corn, mixed = cornell_box(), mixed_scene()
    co, cd, cids = cs.rays(cs.camera((0.0, 1.0, 2.0), 1024, 768), 1024, 768)
    seen = cs.capture_wavefronts(co, cd, corn, cids, RenderConfig(backend="lane"),
                                 lane_pallas.lane_tri_search)
    cases = {}
    for (_, oo, dd, tris, eps, _), what in zip(seen, ("camera", "shadow")):
        args = (eps, tris.v0, tris.v1, tris.v2, tris.valid, oo.contiguous(), dd.contiguous())
        cases[("lane", f"Cornell {what}")] = (lambda a=args: lane_pallas.lane_kernel(*a))
    mo, md, mids = cs.rays(cs.camera((0.0, 2.5, 7.0), 1920, 1080), 1920, 1080)
    for label, sc, (o, d, ids), depth in (("Cornell", corn, (co, cd, cids), 1),
                                          ("config 4", mixed, (mo, md, mids), 4)):
        tables = fused_pallas.fused_tables(sc)
        cfg = RenderConfig()
        kw = dict(seed=0, eps=float(cfg.eps), shadow_eps=float(cfg.shadow_eps), depth=depth,
                  lights=sc.lights.num_lights, faces=sc.lights.max_faces)
        cases[("fused", label)] = (lambda a=(o, d, ids, *tables), k=kw:
                                   fused_pallas.fused_kernel(*a, **k))
    for (kind, label), fn in cases.items():
        mod = lane_pallas if kind == "lane" else fused_pallas
        ref = None
        line = []
        for key, lib in libs.items():
            if key[0] != kind:
                continue
            mod._LIB = lib
            out = fn()
            out = out if isinstance(out, tuple) else (out,)
            if ref is None:
                ref = out
            same = all(torch.equal(a, b) for a, b in zip(out, ref))
            line.append(f"{key[1]} {timed(fn):.4f} ms{'' if same else ' (DIFFERS)'}")
        mod._LIB = None
        print(f"{kind} [{label}]: " + ", ".join(line) + f"  [{card}]", flush=True)


if __name__ == "__main__":
    main()
