#!/usr/bin/env python
"""Inverse rendering on the PyTorch port: recover a sphere's color and
specular from a target image by gradient descent through the renderer
(the analogue of examples/inverse_rendering.py).

    python examples/inverse_rendering_torch.py                 # on the card
    python examples/inverse_rendering_torch.py --device cpu    # on the CPU

Fits 100 Adam steps at lr 0.02 with a checkpoint every 50, prints the
losses and the true and recovered values, and writes the before and
after images as PPMs into --out-dir (default: the temporary directory).
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import esctp1raytracer_tpu_torch as rt  # noqa: E402
from esctp1raytracer_tpu_torch.grad import fit_scene  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out-dir", default=tempfile.gettempdir())
    args = parser.parse_args(argv)

    true_scene = rt.sphere_plane_scene(device=args.device)
    cam = rt.Camera.look_at((0, 2, 6), (0, 1, 0), vfov=60.0, aspect=1.0, device=args.device)
    cfg = rt.RenderConfig()
    target = rt.render(true_scene, cam, 96, 96, cfg)

    # Perturb the sphere's color and specular. (Geometry can be fitted too,
    # but position gradients flow only through shading: the fixed-winner
    # hit selection is silhouette-blind, so materials make the crisp demo.)
    start = dataclasses.replace(
        true_scene,
        spheres=dataclasses.replace(
            true_scene.spheres,
            kd=true_scene.spheres.kd * 0.4,
            ks=true_scene.spheres.ks * 0.1,
        ),
    )

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt = os.path.join(args.out_dir, "inverse_demo.npz")
    if os.path.exists(ckpt):
        os.unlink(ckpt)  # a fresh run (fit_scene would resume otherwise)
    result = fit_scene(
        start, target, cam, steps=100, lr=0.02, cfg=cfg,
        param_filter=lambda i, p: p is start.spheres.kd or p is start.spheres.ks,
        checkpoint_path=ckpt, checkpoint_every=50, log_every=20,
    )

    print(f"loss: {result.losses[0]:.5f} -> {result.losses[-1]:.5f}")
    print("kd: true", true_scene.spheres.kd[0].cpu().numpy(),
          "recovered", result.scene.spheres.kd[0].cpu().numpy())
    print("ks: true", true_scene.spheres.ks[0].cpu().numpy(),
          "recovered", result.scene.spheres.ks[0].cpu().numpy())
    before = os.path.join(args.out_dir, "inverse_before.ppm")
    after = os.path.join(args.out_dir, "inverse_after.ppm")
    rt.write_ppm(before, rt.render(start, cam, 96, 96, cfg))
    rt.write_ppm(after, rt.render(result.scene, cam, 96, 96, cfg))
    print(f"wrote {before} and {after}")


if __name__ == "__main__":
    main()
