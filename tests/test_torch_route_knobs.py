"""The entry points' route knobs and origin on the port alone, without a
JAX reference (tests/test_torch_forced_routes.py holds them against the
JAX package): ``raster_route`` with ``strategy`` and ``tile_h`` forced
takes the JAX package's tile height, row packing, expansion and budget
block (raster_pallas.py:2529-2690); an unknown strategy raises; zcull
changes the kernel only on 8-row sorted routes, and every sorted height
above 8 rows takes K4's band form; ``_mask_guard``'s advice
can be followed; and
``render_scene`` into a sub-rect at (row0, col0), called in JAX's order,
holds the whole frame's pixels on every branch (fused, G-buffer,
reference), bit for bit; ``empty_gbuffer`` needs a card unless asked for
the CPU. Scenes come from the suite's generators and the
route scenes (NumPy, deterministic); everything runs the kernels' plain
versions.
"""

import functools

import numpy as np
import pytest
import torch

from tpu_renderer_torch.core.types import DEPTH_CLEAR, make_framebuffer
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import raster_reference as trr
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

SUB = (37, 21, 60, 100)  # row0, col0, height, width of the sub-rects


@functools.lru_cache(maxsize=None)
def subrect_scene(name, variant):
    sg, (h, w) = route_scene(name, variant)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    return sg, (h, w), (tr_d, li_d)


def port_frames(name, variant, backend="kernels"):
    """The port's frame of a route scene on the CPU, whole and into the
    SUB rect by render_scene called by position in JAX's order."""
    sg, (h, w), dicts = subrect_scene(name, variant)
    scene, tr, li = ts.to_torch_scene(sg, *dicts, device="cpu")
    r0, c0, hs, ws = SUB
    full = tre.render_scene(None, scene, tr, li, backend, h, w)
    sub = tre.render_scene(make_framebuffer(hs, ws, device="cpu"), scene,
                           tr, li, backend, h, w, r0, c0)
    return full, sub, (scene, tr, li, h, w)


@pytest.mark.parametrize("name, variant, backend", [
    ("k6multi", "base", "kernels"),    # one fused launch (K6)
    ("mixed", "sidelist", "kernels"),  # one fused launch (K2), side list
    ("k6", "gbuffer", "kernels"),      # the G-buffer path ('avx', K8)
    ("k6", "textured", "reference"),   # the reference backend
])
def test_render_scene_subrect_equals_crop(name, variant, backend):
    """On every branch the sub-rect holds the whole frame's pixels
    (the origin reaches the binning, the raster, the deferred shade and
    the reference rasterizer), bit for bit."""
    full, sub, _ = port_frames(name, variant, backend)
    r0, c0, hs, ws = SUB
    np.testing.assert_array_equal(
        sub.depth.numpy(), full.depth[r0:r0 + hs, c0:c0 + ws].numpy())
    np.testing.assert_array_equal(
        sub.color.numpy(), full.color[r0:r0 + hs, c0:c0 + ws].numpy())
    assert (sub.depth > -3.0e38).sum() > 500



@pytest.mark.parametrize("t, hw, strategy, tile_h, n_obj, want", [
    # (strategy, tile_h, rows, expansion, blk) -- raster_pallas.py:2529-2690
    (360, (64, 64), "sorted", 8, 1, ("sorted", 8, 2, 8, 256)),
    (360, (128, 128), "sorted", 8, 1, ("sorted", 8, 1, 8, 256)),
    (300, (512, 512), "sorted", None, 1, ("sorted", 16, 1, 32, 128)),
    (40040, (1080, 1920), "sorted", 32, 1, ("sorted", 32, 1, 8, 128)),
    (2208, (1080, 1920), "auto", 32, 1, ("sorted", 32, 1, 32, 128)),
    (5000, (128, 128), "mask", None, 2, ("mask", 8, 1, 0, 0)),
    (12, (512, 512), "auto", 32, 1, ("mask", 32, 1, 0, 0)),
])
def test_raster_route_forced(t, hw, strategy, tile_h, n_obj, want):
    """raster_route with the knobs forced: JAX's tile height, row packing
    (8-row tiles only, where T * 12 >= the frame's pixels), expansion
    (_queue_expansion) and budget block for that height."""
    r = trp.raster_route(t, *hw, n_obj, None, strategy, tile_h)
    assert (r.strategy, r.tile_h, r.rows, r.expansion, r.blk) == want


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown strategy"):
        trp.raster_route(600, 64, 64, strategy="wide")
    with pytest.raises(ValueError, match="unknown strategy"):
        tgb.gbuffer_route(600, 64, 64, strategy="wide")


def test_zcull_only_on_wide_routes():
    """zcull launches K11 on forced 8-row sorted routes only (JAX's ``zcull
    and wide``): on the mask and on 16-, 32- and 24-row sorted tiles (K4's
    band form, which carries the height in its options) it changes
    nothing."""
    tr_d, li_d = ts.baseline_camera_lights(64, 256)
    scene, tr, li = ts.to_torch_scene(
        [(dict(p=(0.0, 0.0, 0.0), **construct_sphere(12)), {"phong": True})],
        tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=64,
                                 frame_width=256)
    spec = (trp.ObjSpec(0, obj.num_triangles, True),)
    want = {("sorted", 8): trp.raster_rows1_zcull_kernel,
            ("sorted", 16): trp.raster_narrow_any_kernel,
            ("sorted", 32): trp.raster_narrow_any_kernel,
            ("sorted", 24): trp.raster_narrow_any_kernel,
            ("mask", 32): trp.raster_mask_kernel}
    for (strategy, tile_h), kernel in want.items():
        launch = trp.prepare_raster(table, spec, tr, li, 64, 256, None, 64,
                                    256, 0, 0, strategy, tile_h,
                                    zcull=True)
        assert launch.kernel is kernel
        if kernel is trp.raster_narrow_any_kernel:
            assert launch.options["tile_h"] == launch.route.tile_h == tile_h


def test_mask_guard_advice_can_be_followed():
    """Forcing the mask strategy on config 2's 5,428-triangle teapot at
    1080p is refused with the advice to use strategy='sorted', which the
    entry point takes."""
    sg, tr_d, li_d = ts.baseline_scene(2, 1080, 1920)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=1080,
                                 frame_width=1920)
    spec = (trp.ObjSpec(0, obj.num_triangles, cfg.phong),)
    with pytest.raises(ValueError, match="use strategy='sorted'"):
        trp.prepare_raster(table, spec, tr, li, 1080, 1920, strategy="mask")
    launch = trp.prepare_raster(table, spec, tr, li, 1080, 1920,
                                strategy="sorted")
    assert launch.route.strategy == "sorted"
    assert int(launch.stats()["bins_dropped"]) == 0


def test_empty_gbuffer_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """empty_gbuffer builds its buffers on the card by default and raises
    without one, as JAX's places them on the default device;
    device='cpu' builds them on the CPU: covered all False, DEPTH_CLEAR in
    channel 0, zeros in the 10 attribute channels."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trr.empty_gbuffer(4, 6)
    covered, gbuf = trr.empty_gbuffer(4, 6, device="cpu")
    assert covered.device.type == gbuf.device.type == "cpu"
    assert covered.shape == (4, 6) and not bool(covered.any())
    assert gbuf.shape == (trr.GBUF_CHANNELS, 4, 6)
    assert bool((gbuf[0] == DEPTH_CLEAR).all())
    assert not bool(gbuf[1:].any())
