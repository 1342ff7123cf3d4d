#!/usr/bin/env python
"""Render the Cornell box to a PPM with the PyTorch port — the reference's
canonical workload (scripts/run.sh there), in a few lines here.

Counterpart of examples/render_cornell.py: 1024x768, backend "mxu", on the
card unless --device cpu is given.

    python examples/render_cornell_torch.py [out.ppm] [--device cpu]
"""

import argparse
import os as _os
import sys

sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import esctp1raytracer_tpu_torch as rt  # noqa: E402
from esctp1raytracer_tpu_torch.utils import device as dev  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="cornell.ppm")
    ap.add_argument("--device", default="cuda", choices=dev.DEVICES)
    args = ap.parse_args(argv)
    dev.require(args.device)
    scene = rt.cornell_box(device=args.device)
    cam = rt.Camera.look_at((0, 1, 2), (0, 1, 0), vfov=60.0, aspect=1024 / 768,
                            device=args.device)
    img = rt.render(scene, cam, 1024, 768, rt.RenderConfig(backend="mxu"))
    rt.write_ppm(args.out, img)
    print(f"Rendered image in: {args.out}")


if __name__ == "__main__":
    main()
