"""Textured frames through Renderer, continued from tests/
test_torch_texture.py (whose module docstring states the bars): the last
FRAMES against JAX and the golden, one launch of several textures against
the objects drawn one by one, and an atlas over the fused limit. (Split
from that file so that each file keeps under ten cases; its three frame
tests are collected here on this file's frames, so each frame's JAX
reference is made once.)"""

import numpy as np
import pytest
import torch

from test_torch_texture import (  # noqa: F401 (tests collected here)
    FRAMES,
    H,
    W,
    make_frame,
    test_frame_route,
    test_frame_vs_golden,
    test_frame_vs_jax,
)
from tpu_renderer.golden import cpu_reference as gold
import tpu_renderer_torch as trt
from tpu_renderer_torch.core.types import make_framebuffer
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.textures import checkerboard
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=list(FRAMES)[3:])
def frame(request):
    return make_frame(request.param)


def test_batched_textures_match_per_object():
    """One launch with two textures of different widths and a shared one
    equals drawing the objects one by one, bit for bit; the shared texture
    enters the atlas once."""
    tex_a, tex_b = checkerboard(32, 64, 4), checkerboard(16, 16, 2)
    quad = tp.construct_quad(0.8)
    sg = [(dict(p=(-0.3, -0.2, 0.0), **quad), {"texture": tex_a}),
          (dict(p=(0.3, 0.2, 0.1), **quad),
           {"texture": tex_b, "filter_mode": "bilinear"}),
          (dict(p=(0.0, 0.0, -0.2), **tp.construct_sphere_grid(10, 10)),
           {"phong": True})]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene.append((scene[0][0]._replace(p=scene[0][0].p + 0.45),
                  scene[0][1]))  # shares the first object's texture
    launch = tre.prepare_scene(scene, tr, li, H, W)
    np.testing.assert_array_equal(
        launch.texs.numpy(),
        [[0, 32, 64, 0], [32, 16, 16, 1], [0, 0, 0, 0], [0, 32, 64, 0]])
    assert tuple(launch.operands[-1].shape) == (48, 64)
    fb = trt.render_scene(make_framebuffer(H, W, device="cpu"), scene, tr,
                          li)
    fb_s = make_framebuffer(H, W, device="cpu")
    for obj, cfg in scene:
        fb_s = tre.render_object(fb_s, obj, tr, li, cfg)
    np.testing.assert_array_equal(fb.color.numpy(), fb_s.color.numpy())
    np.testing.assert_array_equal(fb.depth.numpy(), fb_s.depth.numpy())
    assert (fb.color.view(torch.int32).numpy() != 0).sum() > 1000


def test_atlas_over_the_limit_draws_objects_one_by_one():
    """Two 128x128 textures make a 256x128 atlas, over the fused limit:
    the scene draws object by object (each fits alone), as the JAX
    package's render_scene does."""
    tex = [checkerboard(128, 128, 8), checkerboard(128, 128, 16)]
    quad = tp.construct_quad(0.8)
    sg = [(dict(p=(-0.3, 0.0, 0.0), **quad), {"texture": tex[0]}),
          (dict(p=(0.3, 0.0, 0.1), **quad), {"texture": tex[1]})]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    assert not tre._scene_batchable(scene)
    fb = trt.Renderer(H, W, device="cpu").render(scene, tr, li)
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    np.testing.assert_array_equal(fb.color.numpy(), gc)
    np.testing.assert_array_equal(fb.depth.numpy(), gd)
