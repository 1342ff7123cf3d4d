"""esctp1raytracer_tpu_torch — the PyTorch / CUDA port of esctp1raytracer_tpu.

The package mirrors the JAX package's module paths and public names. It
imports `torch` and `numpy` only; its CUDA kernels (`csrc/`) are built
with nvcc at first use and bound with ctypes. Ported so far: rendering
and differentiating on every backend (`jnp`, `mxu`, `mxtile`, `lane`,
`fused`, `tile` and `auto`), both light modes, and the benchmark, Cornell
and BASELINE config 1 to 5 scenes (see ROADMAP.md for what is still to
port).
"""

from esctp1raytracer_tpu_torch.scene.types import (
    LightTable,
    Material,
    MeshData,
    Scene,
    SphereBuffer,
    TriangleBuffer,
    scene_from_numpy,
    scene_to_numpy,
)
from esctp1raytracer_tpu_torch.scene.builders import (
    bench_scene,
    cornell_box,
    cornell_variant,
    mesh_scene,
    mixed_scene,
    random_scene,
    scene_from_mesh,
    sphere_plane_scene,
    ten_sphere_scene,
)
from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, trace_rays

__all__ = [
    "Scene",
    "TriangleBuffer",
    "SphereBuffer",
    "LightTable",
    "Material",
    "MeshData",
    "scene_from_numpy",
    "scene_to_numpy",
    "scene_from_mesh",
    "bench_scene",
    "cornell_box",
    "cornell_variant",
    "mesh_scene",
    "mixed_scene",
    "random_scene",
    "sphere_plane_scene",
    "ten_sphere_scene",
    "Camera",
    "render",
    "trace_rays",
    "RenderConfig",
]
