"""Test oracles and verification utilities (counterpart of `esctp1raytracer_tpu/testing`)."""

from esctp1raytracer_tpu_torch.testing.oracle import oracle_render  # noqa: F401
