"""The port's small modules against the JAX package, continued from
tests/test_torch_extras.py (whose module docstring states the bars): the
rotations' device default, supersampling, image IO, scene and framebuffer
files, ``no_lights`` / ``classic_arrays`` and the texture helpers. (Split
from that file, which keeps the rotations against JAX, so that each file
keeps under ten cases.)"""

import jax
import numpy as np
import pytest
import torch

from test_torch_extras import F
from tpu_renderer.core import types as jt
from tpu_renderer.engine import antialias as jaa
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.models import textures as jtx
from tpu_renderer.utils import checkpoint as jck
from tpu_renderer.utils import image as jim
from tpu_renderer_torch.core import types as tt
from tpu_renderer_torch.core.math import INV255
from tpu_renderer_torch.engine import antialias as taa
from tpu_renderer_torch.geometry import transform as ttf
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import textures as ttx
from tpu_renderer_torch.utils import checkpoint as tck
from tpu_renderer_torch.utils import image as tim
from test_torch_render import assert_frame_parity
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotations_need_a_card_unless_asked_for_the_cpu(monkeypatch, axis):
    """A Python angle builds the matrix on the card by default and raises
    without one; device='cpu' builds it on the CPU; a tensor angle keeps
    its own device whatever ``device`` says."""
    rot = getattr(ttf, f"rotation_{axis}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rot(0.3)
    assert rot(0.3, device="cpu").device.type == "cpu"
    assert rot(torch.tensor(0.3)).device.type == "cpu"


def test_ssaa_vs_golden_and_jax():
    """render_scene_ssaa, factor 2, on config 5 (the kernels backend, one
    launch): the golden frame at 2x with the scaled camera, box-filtered
    in f32 (two samples summed, then two, times 1/4), bit for bit; JAX's
    within the budgets."""
    h, w, f = 48, 64, 2
    sg, tr_d, li_d = js.baseline_scene(5, h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = taa.render_scene_ssaa(scene_t, tr, li, h, w, f)
    hi_d = dict(tr_d, meters_to_pixels=F(tr_d["meters_to_pixels"]) * F(f),
                screen_center=tuple(F(c) * F(f)
                                    for c in tr_d["screen_center"]))
    gc, gd = gold.render(sg, hi_d, li_d, h * f, w * f)
    rgba = np.stack([((gc >> s) & 0xFF).astype(F) * F(INV255)
                     for s in (16, 8, 0, 24)], -1).reshape(h, f, w, f, 4)
    want = gold.pack_argb(rgba.sum(3).sum(1) * F(0.25))
    np.testing.assert_array_equal(fb.color.numpy(), want)
    np.testing.assert_array_equal(
        fb.depth.numpy(), gd.reshape(h, f, w, f).max(3).max(1))
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    cfgs = [c for _, c in scene_j]
    jfb = jax.jit(lambda objs, trj, lij: jaa.render_scene_ssaa(
        list(zip(objs, cfgs)), trj, lij, h, w, f))(
            tuple(o for o, _ in scene_j), trj, lij)
    assert_frame_parity(fb.color.numpy(), fb.depth.numpy(),
                        np.asarray(jfb.color), np.asarray(jfb.depth))
    st = taa.scale_transform(tr, 3)
    assert float(st.meters_to_pixels) == F(tr_d["meters_to_pixels"]) * 3


def test_image_files_equal_jax(tmp_path):
    """PPM and PNG bytes equal to the JAX package's; read_png of either
    file gives the same ARGB; the writers take a framebuffer's colour
    tensor too."""
    rng = np.random.default_rng(3)
    argb = rng.integers(0, 2 ** 32, (17, 23), dtype=np.uint64).astype(
        np.uint32)
    tensor = torch.from_numpy(argb.view(np.int32)).view(torch.uint32)
    for name, t_fn, j_fn, kw in (
            ("a.ppm", tim.write_ppm, jim.write_ppm, {}),
            ("b.png", tim.write_png, jim.write_png, {}),
            ("c.png", tim.write_png, jim.write_png, {"alpha": True})):
        t_fn(str(tmp_path / f"t{name}"), tensor, **kw)
        j_fn(str(tmp_path / f"j{name}"), argb, **kw)
        assert (tmp_path / f"t{name}").read_bytes() == (
            tmp_path / f"j{name}").read_bytes()
    got = tim.read_png(str(tmp_path / "tc.png"))
    np.testing.assert_array_equal(got, jim.read_png(str(tmp_path / "jc.png")))
    np.testing.assert_array_equal(got, argb)
    np.testing.assert_array_equal(tim.argb_to_rgba(tensor),
                                  jim.argb_to_rgba(argb))


def assert_scenes_equal(scene_t, tr, li, scene_j, trj, lij):
    for (ot, ct), (oj, cj) in zip(scene_t, scene_j, strict=True):
        assert (ct.phong, ct.textured, ct.uv_mode, ct.filter_mode) == (
            cj.phong, cj.textured, cj.uv_mode, cj.filter_mode)
        for name in ("p", "vertices", "colors", "normals", "uvs"):
            np.testing.assert_array_equal(getattr(ot, name).numpy(),
                                          np.asarray(getattr(oj, name)))
        assert (ot.texture is None) == (oj.texture is None)
        if ot.texture is not None:
            np.testing.assert_array_equal(
                ot.texture.view(torch.int32).numpy().view(np.uint32),
                np.asarray(oj.texture))
    for a, b in zip(tuple(tr) + tuple(li), tuple(trj) + tuple(lij)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_checkpoints_load_in_either_package(tmp_path):
    """Config 5 (with its textured quad) saved by the port loads in JAX and
    the other way round; framebuffers the same."""
    sg, tr_d, li_d = js.baseline_scene(5, 64, 64)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    tck.save_scene(str(tmp_path / "t.npz"), scene_t, tr, li)
    jck.save_scene(str(tmp_path / "j.npz"), scene_j, trj, lij)
    assert_scenes_equal(scene_t, tr, li,
                        *jck.load_scene(str(tmp_path / "t.npz")))
    assert_scenes_equal(*tck.load_scene(str(tmp_path / "j.npz"),
                                        device="cpu"), scene_j, trj, lij)
    fb = tt.make_framebuffer(5, 7, 0xFF102030, device="cpu")
    jfb = jt.make_framebuffer(5, 7, 0xFF102030)
    tck.save_framebuffer(str(tmp_path / "tf.npz"), fb)
    jck.save_framebuffer(str(tmp_path / "jf.npz"), jfb)
    for got, want in ((jck.load_framebuffer(str(tmp_path / "tf.npz")), fb),
                      (tck.load_framebuffer(str(tmp_path / "jf.npz"),
                                            device="cpu"), jfb)):
        for a, b in zip(got, want):
            a = a.view(torch.int32).numpy() if isinstance(
                a, torch.Tensor) else np.asarray(a).view(np.int32)
            b = b.view(torch.int32).numpy() if isinstance(
                b, torch.Tensor) else np.asarray(b).view(np.int32)
            np.testing.assert_array_equal(a, b)


def test_no_lights_and_classic_arrays_vs_jax(monkeypatch):
    lt, lj = tt.no_lights(device="cpu"), jt.no_lights()
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.shape == b.shape
    assert lt.count == 0
    sg, tr_d, li_d = js.baseline_scene(5, 64, 64)
    scene_t, _, _ = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene_j, _, _ = js.to_jax_scene(sg, tr_d, li_d)
    for (ot, _), (oj, _), (obj_d, _) in zip(scene_t, scene_j, sg):
        got, want = tt.classic_arrays(ot), jt.classic_arrays(oj)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(got["vertices"],
                                      np.asarray(obj_d["vertices"], F))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.no_lights()


def test_texture_copies_equal_jax(tmp_path):
    """gradient_texture equal; save_bmp bytes equal; load_bmp reads
    either file (32-bit, top-down) and a 24-bit bottom-up one the same."""
    for hw in ((64, 64), (5, 9), (1, 1)):
        np.testing.assert_array_equal(ttx.gradient_texture(*hw),
                                      jtx.gradient_texture(*hw))
    tex = ttx.checkerboard(12, 20, 3) ^ np.uint32(0x01020300)
    ttx.save_bmp(str(tmp_path / "t.bmp"), tex)
    jtx.save_bmp(str(tmp_path / "j.bmp"), tex)
    assert (tmp_path / "t.bmp").read_bytes() == (
        tmp_path / "j.bmp").read_bytes()
    np.testing.assert_array_equal(ttx.load_bmp(str(tmp_path / "j.bmp")), tex)
    h, w = tex.shape
    row = (w * 3 + 3) & ~3
    px = np.zeros((h, row), np.uint8)
    for y in range(h):  # bottom-up rows of B, G, R
        src = tex[h - 1 - y]
        px[y, :3 * w] = np.stack([src & 0xFF, (src >> 8) & 0xFF,
                                  (src >> 16) & 0xFF], -1).reshape(-1)
    import struct
    header = struct.pack("<2sIHHI", b"BM", 54 + px.size, 0, 0, 54) + (
        struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, px.size, 0, 0, 0,
                    0))
    (tmp_path / "b24.bmp").write_bytes(header + px.tobytes())
    got = ttx.load_bmp(str(tmp_path / "b24.bmp"))
    np.testing.assert_array_equal(got, jtx.load_bmp(str(tmp_path / "b24.bmp")))
    np.testing.assert_array_equal(got, tex | np.uint32(0xFF000000))
