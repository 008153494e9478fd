"""The slice of tests/test_torch_render.py on its side-list variant (a
1.2-unit quad merged into the sphere grid, two triangles on the side
list), with that file's budgets, and the slice's sub-rects and routes.
(Split from that file so that each file keeps under ten cases; its five
tests of a variant are collected here on the side-list one, so each
variant's JAX reference is made once.)"""

import numpy as np
import pytest

from test_torch_render import (  # noqa: F401 (tests collected here)
    H,
    W,
    golden_scene,
    make_case,
    test_frame_vs_golden,
    test_frame_vs_jax,
    test_raster_on_jax_setup,
    test_route,
    test_stats_vs_jax,
)
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=["sidelist"])
def case(request):
    return make_case(request.param)


def test_subrect_origin_equals_full_frame():
    """A sub-rectangle rasterized at origin (row0, col0) of the frame,
    off the tile grid, holds the full frame's pixels: binning works in
    local tiles, the fragments and the shading in global pixels."""
    sg, tr_d, li_d = golden_scene("sidelist")
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene_t[0]
    pre = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=H,
                               frame_width=W)
    _, z, color, _ = trp.rasterize_shaded(pre, tr, li, True, H, W)
    r0, c0, h, w = 37, 21, 60, 100
    _, zs, cs, _ = trp.rasterize_shaded(pre, tr, li, True, h, w, None, H, W,
                                        r0, c0)
    np.testing.assert_array_equal(zs.numpy(), z[r0:r0 + h, c0:c0 + w].numpy())
    np.testing.assert_array_equal(cs.numpy(),
                                  color[r0:r0 + h, c0:c0 + w].numpy())


def test_routes_outside_the_slice_raise():
    """No route raises now: zcull (K11) renders the frame it renders
    without the flag. Textured objects the fused path cannot take ('avx'
    addressing, a texture over the atlas limits) render through the
    G-buffer path, alone and two at a time (object by object); an unknown
    filter raises ValueError in the deferred shade, as in the JAX package;
    rows 1 (K3), textures (K5) and the mask strategy (K6, T <= 512)
    render."""
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    mesh = tp.construct_sphere_grid(46, 45)
    tex = np.full((8, 8), 0xFF808080, np.uint32)
    for cfg_d in ({"texture": tex, "uv_mode": "avx"},
                  {"texture": np.full((8, 600), 0xFF808080, np.uint32)}):
        sg = [(dict(p=(0.0, 0.0, 0.0), **mesh), cfg_d)]
        scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
        assert not tre._obj_fusable(*scene_t[0])
        fb = trt.Renderer(H, W, device="cpu").render(scene_t, tr, li)
        assert int((fb.depth > -3.0e38).sum()) > 2000
        fb2 = trt.render_scene(None, scene_t * 2, tr, li, frame_height=H,
                               frame_width=W)
        np.testing.assert_array_equal(fb2.color.numpy(), fb.color.numpy())
    sg = [(dict(p=(0.0, 0.0, 0.0), **mesh),
           {"texture": tex, "filter_mode": "trilinear"})]
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    with pytest.raises(ValueError, match="unknown filter_mode"):
        trt.Renderer(H, W, device="cpu").render(scene_t, tr, li)
    sg = [(dict(p=(0.0, 0.0, 0.0), **mesh), {"texture": tex})]
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = trt.Renderer(H, W, device="cpu").render(scene_t, tr, li)
    assert int((fb.depth > -3.0e38).sum()) > 0
    sg = [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": True})]
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    assert trp.raster_route(4140, 512, 512).rows == 1
    fb = trt.Renderer(512, 512, device="cpu").render(scene_t, tr, li)
    assert int((fb.depth > -3.0e38).sum()) > 0
    obj, cfg = scene_t[0]
    pre = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=H,
                               frame_width=W)
    plain = trp.rasterize_shaded(pre, tr, li, True, H, W)
    culled = trp.rasterize_shaded(pre, tr, li, True, H, W, zcull=True)
    for a, b in zip(plain[:3], culled[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert trp.raster_route(trp.AUTO_SORTED_THRESHOLD, H, W).strategy == (
        "mask")
    small = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_cube()), {})]
    scene_t, tr, li = ts.to_torch_scene(small, tr_d, li_d, device="cpu")
    fb = trt.Renderer(H, W, device="cpu").render(scene_t, tr, li)
    assert int((fb.depth > -3.0e38).sum()) > 0
