import sys

from esctp1raytracer_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
