"""The port's fused texturing (K1's textured fields, K5 in the raster
kernels' finalize) against the JAX package and the NumPy golden.

Inputs come from seeded NumPy generators or the suite's scenes. The JAX
side renders through its jitted Renderer(backend="pallas"), its Pallas
kernels in interpret mode as its own tests run them, each reference once
per module at 128x128; the port runs its kernels' plain versions.

Bars:
- bit-exact against JAX: the saturating ``to_i32`` (XLA's convert),
  ``unpack_argb``, ``pack_texture_atlas``'s offsets, dimensions and
  texels, nearest ``sample_texture``. Bilinear ``sample_texture`` is
  bit-exact against the golden; against JAX it holds to an absolute
  2.4e-7, because XLA's CPU backend contracts the lerp's c0 + f * (c1 -
  c0) into an FMA (golden divergence #8);
- textured setup (``setup_records`` and K1's plain version): every lane
  bit-exact against the golden; against JAX the lane budgets of
  tests/test_torch_setup.py, and the u/z and v/z gradients ug, vg to rtol
  1e-3: XLA contracts u1 - u0 = u_max * (1/z_max) - u0 into an FMA, and
  the difference amplifies the product's rounding; u0, v0, 1/z and its
  gradient exact;
- frames, route asserted: coverage exact, colour mismatch <= 0.2%, depth
  within rtol 1e-6 on >= 99.5% of pixels against JAX; bit-exact against
  the golden.

This file holds the helpers and the first three frames; the other tests
sit in files of at most nine cases, which pytest-xdist's ``--dist
loadfile`` hands out after tests/test_parallel.py, the suite's longest
file: test_torch_texture_pieces.py (to_i32, ARGB, the atlas, the scene
planes), test_torch_texture_k1.py (sampling, the textured setup),
test_torch_texture_frames.py (the other frames, batched textures, the
atlas limit) and test_torch_texture_routes.py (the route scenes).
"""

import numpy as np
import pytest

from test_torch_render import assert_frame_parity
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.models.textures import checkerboard
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
F = np.float32
SIX = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5], F)


# ---------------------------------------------------------------------------
# Textured setup: K1's plain version and the small-object chain (the tests:
# test_torch_texture_k1.py)
# ---------------------------------------------------------------------------

UV_LANES = range(7, 13)  # oz0, ozg, u0, ug, v0, vg


def assert_setup_vs_golden(rows, obj_d, tr_d, li_d, phong):
    """rows: (T, 85) record rows; every lane bit-exact against the golden's
    textured edge setup."""
    ge = gold.setup_edges(obj_d, tr_d, li_d, phong=phong, textured=True)
    names = ["valid", "ymin", "ymax", "x0", "xg", "z0", "zg", "oz0", "ozg",
             "u0", "ug", "v0", "vg", "left"]
    vec = (("col0", 14, 4), ("colg", 18, 4), ("n0", 22, 3), ("ng", 25, 3))
    for e in range(3):
        v = ge["valid"][:, e]
        for f, name in enumerate(names):
            want = np.where(v, ge[name][:, e], 0).astype(F)
            np.testing.assert_array_equal(rows[:, e * 28 + f].view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"edge {e} {name}")
        for name, off, c in vec:
            want = np.where(v[:, None], ge[name][:, e], 0).astype(F)
            np.testing.assert_array_equal(
                rows[:, e * 28 + off:e * 28 + off + c].view(np.uint32),
                want.view(np.uint32), err_msg=f"edge {e} {name}")


def assert_setup_vs_jax(rows, jrows, phong):
    """The lane budgets of tests/test_torch_setup.py (x0 rtol 1e-6, xg rtol
    2e-2, Gouraud colour lanes rtol 1e-6 / colg atol 2.4e-7) and ug, vg
    rtol 1e-3, all from XLA's FMA contraction; every other lane exact."""
    for lane in range(85):
        a, b = rows[:, lane], jrows[:, lane]
        e, f = divmod(lane, 28)
        rtol = {3: 1e-6, 4: 2e-2, 10: 1e-3, 12: 1e-3}.get(f) if (
            lane < 84) else None
        if not phong and lane < 84 and 14 <= f < 22:
            rtol = 1e-6
        if rtol is None:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32),
                                          err_msg=f"lane {lane}")
        else:
            atol = 2.4e-7 if 18 <= f < 22 else 0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"lane {lane}")


def textured_sphere_scene(phong, filter_mode="bilinear"):
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    cfg = {"phong": phong, "texture": checkerboard(16, 16, 2),
           "filter_mode": filter_mode}
    return [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
             cfg)], tr_d, li_d


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

FRAMES = {  # name -> (scene_golden, (strategy, tile_h, rows), K1 or chain)
    "config3": lambda: (js.baseline_scene(3, H, W)[0], ("mask", 16, 1)),
    "config5": lambda: (js.baseline_scene(5, H, W)[0], ("sorted", 8, 2)),
    "sphere-gouraud": lambda: (textured_sphere_scene(False)[0],
                               ("sorted", 8, 2)),
    "sphere-phong": lambda: (textured_sphere_scene(True)[0],
                             ("sorted", 8, 2)),
    "mixed-filters": lambda: (route_scene("k6multi", "textured")[0],
                              ("mask", 8, 1)),
}


def make_frame(name):
    """The port's frame of a FRAMES scene with the golden's and JAX's."""
    sg, route = FRAMES[name]()
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(H, W, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb = JRenderer(H, W, backend="pallas").render(scene_j, trj, lij)
    return dict(name=name, route=route, stats=stats,
                launch=tre.prepare_scene(scene, tr, li, H, W),
                port=(fb.color.numpy(), fb.depth.numpy()),
                jax=(np.asarray(jfb.color), np.asarray(jfb.depth)),
                gold=gold.render(sg, tr_d, li_d, H, W))


@pytest.fixture(scope="module", params=list(FRAMES)[:3])
def frame(request):
    """The first three FRAMES (the others: test_torch_texture_frames.py)."""
    return make_frame(request.param)


def test_frame_route(frame):
    """The fused route the JAX gates pick, with the textures in the atlas
    and the Renderer's frame that launch's output."""
    launch = frame["launch"]
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == frame["route"]
    texs = launch.texs.numpy()
    assert (texs[:, 1] > 0).any()
    z, _, color = (a[:H, :W].numpy() for a in launch.run())
    np.testing.assert_array_equal(color, frame["port"][0])
    np.testing.assert_array_equal(z, frame["port"][1])
    assert int(frame["stats"]["bins_dropped"]) == 0


def test_frame_vs_jax(frame):
    assert_frame_parity(*frame["port"], *frame["jax"])
    assert (frame["port"][1] > -3.0e38).sum() > 1000


def test_frame_vs_golden(frame):
    np.testing.assert_array_equal(frame["port"][0], frame["gold"][0])
    np.testing.assert_array_equal(frame["port"][1], frame["gold"][1])
