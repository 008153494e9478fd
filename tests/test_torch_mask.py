"""The port's mask strategy (draws of at most 512 triangles: per-tile
triangle lists and K6) against the JAX package and the NumPy golden, and
the stats of scenes that mix mask and sorted draws.

Inputs come from seeded NumPy generators or the suite's scenes. The JAX
side renders through its jitted Renderer(backend="pallas"), its Pallas
kernels in interpret mode as its own tests run them, each reference once
per module at 128x128; the port runs K6's plain version.

Bars: ``bin_triangles`` (ids, counts, drops), ``_mask_guard`` and the
capacity default exactly as JAX's; frames, route asserted: coverage exact,
colour mismatch <= 0.2%, depth within rtol 1e-6 on >= 99.5% of pixels
against JAX, bit-exact against the golden.

This file holds the frames; the binning and guard tests sit in
test_torch_mask_binning.py and the mixed stats in test_torch_mask_stats.py,
so that each file keeps under ten cases and pytest-xdist's ``--dist
loadfile`` hands them out after tests/test_parallel.py, the suite's
longest file.
"""

import numpy as np
import pytest

from test_torch_render import assert_frame_parity
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
F = np.float32


FRAMES = {  # name -> (scene_golden, tile_h)
    "config1": lambda: (js.baseline_scene(1, H, W)[0], 16),
    "two-objects": lambda: (route_scene("k6multi", "base")[0], 8),
}


@pytest.fixture(scope="module", params=list(FRAMES))
def frame(request):
    """The port's frame of each scene with the golden's and JAX's."""
    sg, tile_h = FRAMES[request.param]()
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(H, W, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb, jstats = JRenderer(H, W, backend="pallas").render(
        scene_j, trj, lij, with_stats=True)
    return dict(name=request.param, tile_h=tile_h, scene=(scene, tr, li),
                stats=stats, jstats=jstats,
                port=(fb.color.numpy(), fb.depth.numpy()),
                jax=(np.asarray(jfb.color), np.asarray(jfb.depth)),
                gold=gold.render(sg, tr_d, li_d, H, W))


def test_frame_route(frame):
    """K6 on the tile height the JAX gates pick, every object's table
    through setup_records and one K7 (padded to 128 rows per object when
    there are several), lists as long as the table; the Renderer's frame
    is that launch's output."""
    scene, tr, li = frame["scene"]
    launch = tre.prepare_scene(scene, tr, li, H, W)
    r = launch.route
    assert (r.strategy, r.tile_h) == ("mask", frame["tile_h"])
    assert launch.kernel is trp.raster_mask_kernel
    T = sum(o.num_triangles + (-o.num_triangles % 128 if len(scene) > 1
                               else 0) for o, _ in scene)
    bins = launch.operands[1]
    assert bins.ids.shape[2] == trp.mask_capacity(T)
    assert launch.objs.shape == (len(scene), 3)
    z, _, color = (a[:H, :W].numpy() for a in launch.run())
    np.testing.assert_array_equal(color, frame["port"][0])
    np.testing.assert_array_equal(z, frame["port"][1])


def test_frame_vs_jax(frame):
    assert_frame_parity(*frame["port"], *frame["jax"])
    assert (frame["port"][1] > -3.0e38).sum() > 1000


def test_frame_vs_golden(frame):
    np.testing.assert_array_equal(frame["port"][0], frame["gold"][0])
    np.testing.assert_array_equal(frame["port"][1], frame["gold"][1])


def test_stats_vs_jax(frame):
    """A mask draw reports its drops only, as JAX's does."""
    assert set(frame["stats"]) == set(frame["jstats"]) == {"bins_dropped"}
    assert int(frame["stats"]["bins_dropped"]) == int(
        frame["jstats"]["bins_dropped"]) == 0


def test_mask_subrect_origin_equals_full_frame():
    """A sub-rectangle off the tile grid through K6's plain version holds
    the full frame's pixels: binning in local tiles, fragments and
    shading (the texture included) in global pixels."""
    sg, (h, w) = route_scene("k6", "textured")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    tex = obj.texture
    _, z, color, _ = trp.rasterize_shaded(table, tr, li, cfg.phong, h, w,
                                          texture=tex,
                                          filter_mode=cfg.filter_mode)
    r0, c0, hs, ws = 37, 21, 60, 100
    _, zs, cs, st = trp.rasterize_shaded(table, tr, li, cfg.phong, hs, ws,
                                         None, h, w, r0, c0, texture=tex,
                                         filter_mode=cfg.filter_mode)
    np.testing.assert_array_equal(zs.numpy(), z[r0:r0 + hs, c0:c0 + ws].numpy())
    np.testing.assert_array_equal(cs.numpy(),
                                  color[r0:r0 + hs, c0:c0 + ws].numpy())
    assert int(st["bins_dropped"]) == 0 and (zs > -3.0e38).sum() > 1000
