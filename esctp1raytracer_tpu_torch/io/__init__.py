from esctp1raytracer_tpu_torch.io.ppm import read_ppm, write_ppm

__all__ = ["write_ppm", "read_ppm"]
