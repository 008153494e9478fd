"""Port models and transforms vs the JAX package's.

The port copies the NumPy generators (importing the originals pulls in
JAX); the copies must give the originals' arrays exactly, and the scene
conversion must hand both packages identical inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer.geometry import transform as jtf
from tpu_renderer.models import obj as jobj
from tpu_renderer.models import primitives as jp
from tpu_renderer.models import scenes as js
from tpu_renderer.models import sphere as jsph
from tpu_renderer.models import teapot as jtea
from tpu_renderer.models import textures as jtex
from tpu_renderer_torch.geometry import transform as ttf
from tpu_renderer_torch.models import obj as tobj
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import sphere as tsph
from tpu_renderer_torch.models import teapot as ttea
from tpu_renderer_torch.models import textures as ttex
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32


def assert_mesh_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("lat,lon", [(46, 45), (160, 160), (3, 5)])
def test_sphere_grid_copy_equal(lat, lon):
    assert_mesh_equal(tp.construct_sphere_grid(lat, lon),
                      jp.construct_sphere_grid(lat, lon))


@pytest.mark.parametrize("size", [1.0, 2.2])
def test_quad_copy_equal(size):
    assert_mesh_equal(tp.construct_quad(size), jp.construct_quad(size))


@pytest.mark.parametrize("config", [1, 4, 5])
@pytest.mark.parametrize("hw", [(128, 128), (1080, 1920)])
def test_camera_and_lights_equal(config, hw):
    _, jtr, jli = js.baseline_scene(config, *hw)
    ttr, tli = ts.baseline_camera_lights(*hw)
    assert ttr == jtr
    assert sorted(tli) == sorted(jli)
    for k in jli:
        np.testing.assert_array_equal(tli[k], jli[k])
    assert ts.camera_for(*hw) == js.camera_for(*hw)


def test_to_torch_scene_matches_to_jax_scene():
    h = w = 128
    _, tr_d, li_d = js.baseline_scene(4, h, w)
    mesh = tp.merge_meshes(tp.construct_sphere_grid(8, 9),
                           tp.construct_quad(1.2))
    scene_g = [(dict(p=(0.1, -0.2, 0.0), **mesh), {"phong": True})]
    sj, trj, lij = js.to_jax_scene(scene_g, tr_d, li_d)
    st, trt, lit = ts.to_torch_scene(scene_g, tr_d, li_d, device="cpu")
    (oj, cj), (ot, ct) = sj[0], st[0]
    assert ct == type(ct)(**cj.__dict__)
    for name in ("p", "vertices", "colors", "normals", "uvs"):
        np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                      np.asarray(getattr(oj, name)))
    for a, b in zip(trt, trj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(lit, lij):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert lit.count == lij.count == 2


@pytest.mark.parametrize("angle", [0.0, 0.3, -1.7, 2.9])
def test_rotation_and_rotate_object(angle):
    """rotation_y: cos/sin come from two libraries, so entries agree to
    1 ulp (rtol 2e-7 / atol 1e-7 near 0). rotate_object: the same matrix in
    gives the same vertices out, except where XLA's CPU backend contracts
    a + b * c into an FMA (golden divergence #8): rtol 1e-6."""
    rj = np.asarray(jtf.rotation_y(angle))
    rt = ttf.rotation_y(angle, device="cpu").numpy()
    np.testing.assert_allclose(rt, rj, rtol=2e-7, atol=1e-7)

    rng = np.random.default_rng(11)
    T = 300
    arrs = dict(
        vertices=rng.normal(size=(3 * T, 3)).astype(F),
        colors=rng.uniform(size=(3 * T, 4)).astype(F),
        normals=rng.normal(size=(3 * T, 3)).astype(F),
        uvs=rng.uniform(size=(3 * T, 2)).astype(F),
    )
    from tpu_renderer.core.types import make_object as jmake
    from tpu_renderer_torch.core.types import make_object as tmake

    oj = jtf.rotate_object(jmake((0, 0, 0), **arrs), jnp.asarray(rj))
    ot = ttf.rotate_object(tmake((0, 0, 0), **arrs, device="cpu"),
                            torch.tensor(rj))
    for name in ("vertices", "normals"):
        np.testing.assert_allclose(getattr(ot, name).numpy(),
                                   np.asarray(getattr(oj, name)),
                                   rtol=1e-6, atol=1e-7)
    # Against the same formula in NumPy f32 (no contraction): bit-exact.
    v = arrs["vertices"].reshape(T, 3, 3).transpose(2, 1, 0)
    want = np.stack([rj[i, 0] * v[0] + rj[i, 1] * v[1] + rj[i, 2] * v[2]
                     for i in range(3)])
    np.testing.assert_array_equal(ot.vertices.numpy(), want)
    for name in ("colors", "uvs"):
        np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                      np.asarray(getattr(oj, name)))


@pytest.mark.parametrize("steps", [24, 12, 5])
def test_sphere_copy_equal(steps):
    assert_mesh_equal(tsph.construct_sphere(steps),
                      jsph.construct_sphere(steps))


@pytest.mark.parametrize("size", [1.0, 0.7])
def test_cube_copy_equal(size):
    assert_mesh_equal(tp.construct_cube(size), jp.construct_cube(size))


@pytest.mark.parametrize("kw", [{}, dict(major_steps=16, minor_steps=8),
                                dict(major=0.5, minor=0.1)])
def test_torus_copy_equal(kw):
    assert_mesh_equal(tp.construct_torus(**kw), jp.construct_torus(**kw))


OBJ_TEXT = """# fans, negative indices, missing normals and uvs
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1 4
f -1 -2 -3
f 1//1 5//1 2//1
"""


@pytest.mark.parametrize("ramp", [False, True])
def test_load_obj_copy_equal(ramp):
    assert_mesh_equal(tobj.load_obj(OBJ_TEXT, color_ramp=ramp),
                      jobj.load_obj(OBJ_TEXT, color_ramp=ramp))


def test_teapot_copy_equal_without_the_asset():
    """The copy generates the OBJ in memory and equals the original, which
    reads the committed tpu_renderer/models/assets/teapot.obj."""
    import os

    text = ttea.generate_teapot_obj()
    with open(jtea._ASSET) as f:
        assert text == f.read()
    mesh = ttea.construct_teapot()
    assert_mesh_equal(mesh, jtea.construct_teapot())
    assert mesh["vertices"].shape[0] // 3 == 5428
    assert not hasattr(ttea, "_ASSET") and "os" not in vars(ttea)
    assert os.path.exists(jtea._ASSET)


def test_checkerboard_copy_equal():
    for args in ((), (32, 64, 4), (16, 16, 2)):
        a, b = ttex.checkerboard(*args), jtex.checkerboard(*args)
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("angle", [0.3, -0.3, 1.1])
def test_rotate_y_copy_equal(angle):
    mesh = tp.construct_torus(major_steps=8, minor_steps=4)
    assert_mesh_equal(ts.rotate_y(mesh, angle), js.rotate_y(mesh, angle))


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_baseline_scene_copy_equal(config):
    """Every config's objects, switches and textures (carried as data),
    camera and lights equal the JAX package's."""
    sg_t, tr_t, li_t = ts.baseline_scene(config, 96, 128)
    sg_j, tr_j, li_j = js.baseline_scene(config, 96, 128)
    assert tr_t == tr_j and len(sg_t) == len(sg_j)
    for k in li_j:
        np.testing.assert_array_equal(li_t[k], li_j[k])
    for (ot, ct), (oj, cj) in zip(sg_t, sg_j):
        assert sorted(ot) == sorted(oj) and sorted(ct) == sorted(cj)
        assert ot["p"] == oj["p"]
        assert_mesh_equal({k: ot[k] for k in ot if k != "p"},
                          {k: oj[k] for k in oj if k != "p"})
        for k in cj:
            np.testing.assert_array_equal(ct[k], cj[k])
