"""Port vs JAX package: the PPM writers and reader, the OBJ/MTL loaders
(Python and native), the JSON material overrides and the OBJ writers.

Tolerances: none, with one exception. Every file is byte-identical, every
loaded array equal bit for bit (the same numpy or C++ arithmetic on the same
text), and every failure the same exception type. The exception: the C++
loader normalises normals in its own arithmetic, so its normals meet the
Python loader's within 1e-6, the bar of tests/test_native_loader.py, and
so do the JAX package's C++ loader's (built with -march=native, which lets
g++ contract FMAs; the port builds with plain -O3).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one intra-op thread: the suite's parallel workers share the cores

from esctp1raytracer_tpu.io import ppm as j_ppm  # noqa: E402
from esctp1raytracer_tpu.scene import builders as jb  # noqa: E402
from esctp1raytracer_tpu.scene import matjson as j_matjson  # noqa: E402
from esctp1raytracer_tpu.scene.native_loader import (  # noqa: E402
    load_obj_native as j_load_obj_native,
)
from esctp1raytracer_tpu.scene.objloader import load_mtl as j_load_mtl  # noqa: E402
from esctp1raytracer_tpu.scene.objloader import load_obj as j_load_obj  # noqa: E402
from esctp1raytracer_tpu_torch.io import native_ppm, ppm  # noqa: E402
from esctp1raytracer_tpu_torch.scene import builders as pb  # noqa: E402
from esctp1raytracer_tpu_torch.scene import matjson  # noqa: E402
from esctp1raytracer_tpu_torch.scene.native_loader import (  # noqa: E402
    load_obj_native, native_available,
)
from esctp1raytracer_tpu_torch.scene.objloader import load_mtl, load_obj  # noqa: E402
from esctp1raytracer_tpu_torch.utils.nativebuild import last_build_error  # noqa: E402


def native(check):
    """The native path must build here (the sandbox has g++)."""
    assert check(), f"native build failed: {last_build_error()}"


# --------------------------------------------------------------------------
# PPM
# --------------------------------------------------------------------------


def ppm_image(shape, seed):
    """Values in [0, 1.3): some above 1, and a third on the count boundaries k/255."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(*shape) * 1.3).astype(np.float32)
    flat = img.reshape(-1)
    k = rng.randint(0, 256, size=flat.size // 3)
    flat[: k.size] = (k / 255.0).astype(np.float32)
    flat[-1] = 1.0
    return img


@pytest.mark.parametrize("shape", [(1, 1, 3), (2, 3, 3), (17, 31, 3), (64, 48, 3)])
def test_ppm_writers_byte_identical(tmp_path, shape):
    native(native_ppm.native_available)
    img = ppm_image(shape, seed=shape[0] * 100 + shape[1])
    paths = {k: str(tmp_path / f"{k}.ppm") for k in ("py", "native", "tensor", "jax_py", "jax")}
    ppm.write_ppm_python(paths["py"], img)
    assert native_ppm.write_ppm_native(paths["native"], img)
    ppm.write_ppm(paths["tensor"], torch.from_numpy(img))
    j_ppm.write_ppm_python(paths["jax_py"], img)
    j_ppm.write_ppm(paths["jax"], img)
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    assert all(v == data["jax_py"] for v in data.values()), {k: len(v) for k, v in data.items()}
    back = ppm.read_ppm(paths["py"])
    np.testing.assert_array_equal(back, j_ppm.read_ppm(paths["py"]))
    assert back.shape == img.shape and back.dtype == np.float32


def test_ppm_header_row_order_and_truncation(tmp_path):
    img = np.zeros((2, 3, 3), np.float32)
    img[0, 0] = (1.0, 0.999, 0.5004)  # framebuffer row 0 (bottom), col 0
    img[1, 2] = (0.0, 2.0, 0.0)  # framebuffer row 1 (top), col 2
    p = str(tmp_path / "x.ppm")
    ppm.write_ppm(p, img)
    lines = open(p).read().splitlines()
    assert lines[:3] == ["P3", "3 2", "255"]
    assert lines[3:6] == ["0 0 0", "0 0 0", "0 255 0"]  # row H-1 first
    assert lines[6] == f"255 254 {int(np.float32(0.5004) * 255)}"


# --------------------------------------------------------------------------
# OBJ / MTL loaders
# --------------------------------------------------------------------------

_BIG = np.random.RandomState(0).randn(3000, 3, 3)

OBJ_FIXTURES = {
    "cornell": None,  # write_cornell_obj
    "indices": {"t.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"
                         "v 0 0 1\nv 1 0 1\nv 0 1 1\nf -3 -2 -1\n"},
    "quad": {"q.obj": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"},
    "normals": {"n.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 2\nf 1//1 2//1 3//1\n"},
    "groups": {"g.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\ng a\nf 1 2 3\ng b\nf 1 2 3\n"},
    "group_quirk": {"g.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                             "g a\nf 1 2 3\nf 1 2 3\ng b\nf 1 2 3\n"},
    "first_face_material": {
        "m.mtl": "newmtl one\nKd 1 0 0\nnewmtl two\nKd 0 1 0\n",
        "mm.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                  "g s\nusemtl one\nf 1 2 3\nusemtl two\nf 1 2 3\n"},
    "mixed_formats": {
        "m.mtl": "newmtl red\nKa 0.1 0 0\nKd 0.9 0 0\nNs 32\nnewmtl glow\nKe 5 4 3\n",
        "t.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\nvt 0.5 0.5\n"
                 "g quad\nusemtl red\nf 1/1/1 2/1/1 4/1/1 3/1/1\n"
                 "g tri\nusemtl glow\nf -4//-1 -3//-1 -2//-1\ng plain\nf 1 2 3\n"},
    "large_synthetic": {"big.obj": "".join("v %f %f %f\nv %f %f %f\nv %f %f %f\nf -3 -2 -1\n"
                                           % tuple(t.reshape(-1)) for t in _BIG)},
    "missing": {},
    "empty": {"e.obj": "v 0 0 0\n"},
}


def write_fixture(tmp_path, name):
    if name == "cornell":
        path = str(tmp_path / "cornell.obj")
        jb.write_cornell_obj(path)
        return path
    obj = str(tmp_path / "missing.obj")
    for fname, text in OBJ_FIXTURES[name].items():
        (tmp_path / fname).write_text(text)
        if fname.endswith(".obj"):
            obj = str(tmp_path / fname)
    return obj


def assert_material_equal(a, b):
    for f in ("ka", "kd", "ks", "ke"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.ns == b.ns


def assert_meshes_equal(a, b, normals_atol=0.0):
    assert len(a) == len(b)
    for ma, mb in zip(a, b):
        assert ma.name == mb.name
        for f in ("vertices", "normals", "uv"):
            x, y = getattr(ma, f), getattr(mb, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.shape == y.shape, f
                if f == "normals" and normals_atol:
                    np.testing.assert_allclose(x, y, rtol=0, atol=normals_atol)
                else:
                    assert np.array_equal(x, y), f
        assert_material_equal(ma.material, mb.material)


def load_or_error(fn, path):
    try:
        return fn(path), None
    except (OSError, ValueError) as exc:
        return None, type(exc)


@pytest.mark.parametrize("name", list(OBJ_FIXTURES))
def test_loaders_match_jax(tmp_path, name):
    native(native_available)
    path = write_fixture(tmp_path, name)
    ref, ref_err = load_or_error(j_load_obj, path)
    ref_native, ref_native_err = load_or_error(j_load_obj_native, path)
    assert ref_native_err == ref_err
    got, err = load_or_error(load_obj, path)
    got_native, native_err = load_or_error(load_obj_native, path)
    assert err == native_err == ref_err, (err, native_err, ref_err)
    if ref is not None:
        assert_meshes_equal(got, ref)
        assert_meshes_equal(got_native, ref_native, normals_atol=1e-6)
        assert_meshes_equal(got_native, ref, normals_atol=1e-6)
    if name in ("missing", "empty"):
        assert ref_err is (FileNotFoundError if name == "missing" else ValueError)
    if name == "cornell":
        assert sum(m.num_faces for m in ref) == 36
        assert [m.material.is_light for m in got].count(True) == 1


def test_mtl_fields_match_jax(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text("newmtl red\nNs 10.0\nNi 1.5\nillum 2\n"
                 "Ka 0.63 0.065 0.05 # comment\nKd 0.6 0.1 0.1\nKs 0 0 0\nKe 0 0 0\n"
                 "newmtl lamp\nKe 17 12 4\n")
    mine, ref = load_mtl(str(p)), j_load_mtl(str(p))
    assert list(mine) == list(ref) == ["red", "lamp"]
    for k in mine:
        assert_material_equal(mine[k], ref[k])
    assert mine["lamp"].is_light and not mine["red"].is_light


# --------------------------------------------------------------------------
# JSON material overrides
# --------------------------------------------------------------------------

MAT_CASES = {
    "phong": {"floor_0": {"kd": [0.1, 0.2, 0.3], "Ns": 99.0}, "nonexistent": {"kd": [1, 1, 1]}},
    "principled": {"red": {"Type": "principled", "baseColor": [1.0, 0.0, 0.0],
                           "metallic": 0.0, "diffuse": 0.8, "specular": 0.0}},
    "metallic": {"gold": {"Type": "principled", "baseColor": [1.0, 0.8, 0.2],
                          "metallic": 1.0, "diffuse": 0.8, "specular": 1.0}},
    "alloy_luminous": {"blue": {"Type": "alloy", "color": [0.0, 0.0, 0.5],
                                "edgeColor": [0.0, 0.0, 0.8], "roughness": 0.1},
                       "light": {"Type": "luminous", "color": [1.0, 1.0, 1.0]}},
    "thinglass": {"glass": {"Type": "thinGlass", "eta": 1.5, "attenuationColor": [0.5, 0.0, 0.0],
                            "attenuationDistance": 1.0, "thickness": 0.1}},
    "unknown_type": {"x": {"Type": "hair", "color": [1, 1, 1]}},
    "reference_mat": {"light_17": {"Type": "luminous", "color": [1.0, 1.0, 1.0], "power": 10.0},
                      "leftWall_4": {"Type": "principled", "baseColor": [0.6, 0.1, 0.1]}},
    "no_mat_file": None,
    "bad_json": [1, 2, 3],
}


@pytest.mark.parametrize("case", list(MAT_CASES))
def test_material_overrides_match_jax(tmp_path, case):
    obj = str(tmp_path / "c.obj")
    jb.write_cornell_obj(obj)
    payload = MAT_CASES[case]
    if payload is not None:
        (tmp_path / "c.mat").write_text(json.dumps(payload))
        if case == "bad_json":
            for fn in (matjson.load_material_overrides, j_matjson.load_material_overrides):
                with pytest.raises(ValueError):
                    fn(str(tmp_path / "c.mat"))
            return
        mine = matjson.load_material_overrides(str(tmp_path / "c.mat"))
        ref = j_matjson.load_material_overrides(str(tmp_path / "c.mat"))
        assert list(mine) == list(ref)
        for name in mine:
            assert list(mine[name]) == list(ref[name])
            for key, value in mine[name].items():
                np.testing.assert_array_equal(np.asarray(value), np.asarray(ref[name][key]))
                assert np.asarray(value).dtype == np.asarray(ref[name][key]).dtype
    assert_meshes_equal(matjson.load_obj_with_mat(obj), j_matjson.load_obj_with_mat(obj))


# --------------------------------------------------------------------------
# OBJ writers, and the float32 round trip
# --------------------------------------------------------------------------


def bench_meshes(b):
    return [b.icosphere_mesh(subdivisions=2, radius=1.0, center=(-1.3, 1.0, 0.0)),
            b.icosphere_mesh(subdivisions=2, radius=1.0, center=(1.3, 1.0, 0.0), smooth=False),
            b._ground_plane(), b._area_light(center=(0.0, 6.0, 2.0), half=1.5)]


@pytest.mark.parametrize("what", ["cornell_obj", "cornell_meshes", "bench_meshes"])
def test_obj_writers_byte_identical_and_round_trip(tmp_path, what):
    native(native_available)
    (tmp_path / "mine").mkdir()
    (tmp_path / "ref").mkdir()
    mine, ref = str(tmp_path / "mine" / "s.obj"), str(tmp_path / "ref" / "s.obj")
    if what == "cornell_obj":
        pb.write_cornell_obj(mine)
        jb.write_cornell_obj(ref)
    else:
        fn = "cornell_meshes" if what == "cornell_meshes" else None
        pm = getattr(pb, fn)() if fn else bench_meshes(pb)
        jm = getattr(jb, fn)() if fn else bench_meshes(jb)
        pb.write_obj(mine, pm)
        jb.write_obj(ref, jm)
    for ext in (".obj", ".mtl"):
        a = open(mine[:-4] + ext, "rb").read()
        assert a == open(ref[:-4] + ext, "rb").read(), ext
    loaded = load_obj(mine)
    assert_meshes_equal(loaded, j_load_obj(ref))
    assert_meshes_equal(load_obj_native(mine), j_load_obj_native(ref), normals_atol=1e-6)
    assert_meshes_equal(load_obj_native(mine), loaded, normals_atol=1e-6)
    if what == "bench_meshes":  # str(np.float32) reads back to the same bits
        for m_in, m_out in zip(pm, loaded):
            np.testing.assert_array_equal(m_out.vertices, m_in.vertices)
            assert_material_equal(m_out.material, m_in.material)
