"""esctp1raytracer_tpu_torch — the PyTorch / CUDA port of esctp1raytracer_tpu.

The package mirrors the JAX package's module paths and public names. It
imports `torch` and `numpy` only; its CUDA kernels (`csrc/`) are built
with nvcc at first use and bound with ctypes; its host C++ (`native/`:
the OBJ loader, the PPM writer, the BVH builder) with g++. Ported so far:
rendering and differentiating on every backend (`jnp`, `mxu`, `mxtile`,
`lane`, `fused`, `tile` and `auto`), both light modes, the benchmark,
Cornell and BASELINE config 1 to 5 scenes, OBJ/MTL loading, the PPM writer,
the BVH and the CLI (`python -m esctp1raytracer_tpu_torch -m model.obj -o
out.ppm`), training (`grad.fit_scene`, checkpoints), the sharded renderer
(`parallel/`), the NumPy test oracle (`testing/`) and the benchmark and matrix scripts
(`scripts/*_torch.py`); see ROADMAP.md for what is left.
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
    water_surface_mesh,
    write_obj,
)
from esctp1raytracer_tpu_torch.scene.objloader import load_obj
from esctp1raytracer_tpu_torch.core.camera import Camera
from esctp1raytracer_tpu_torch.core.render import RenderConfig, render, trace_rays
from esctp1raytracer_tpu_torch.io.ppm import read_ppm, write_ppm

__all__ = [
    "Scene",
    "TriangleBuffer",
    "SphereBuffer",
    "LightTable",
    "Material",
    "MeshData",
    "load_obj",
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
    "water_surface_mesh",
    "write_obj",
    "Camera",
    "render",
    "trace_rays",
    "RenderConfig",
    "write_ppm",
    "read_ppm",
]
