"""K11, the occlusion skip (zcull), and its path, the depth-complex stack,
against the JAX package and the NumPy golden.

The skip changes no output, so on the CPU ``zcull=True`` runs the plain
raster (``raster_plain``); what these tests hold is the plumbing: the
route picks K11's wrapper only on 8-row tiles, the frames equal the JAX
package's ZCULL path (``Renderer(backend="pallas", zcull=True)``,
interpret mode) within tests/test_parity_jax.py's budgets and the golden
bit for bit, and every other route renders the same frame with the flag
as without. tests/test_torch_cuda.py holds the kernel itself to its plain
version and to K2 / K3 on the card.

Scene (tests/test_wide_kernel.py:277): config 4's sphere twice, a near
copy (z + 0.6) submitted before a far one (z - 0.9), Phong, 4,416
triangles in one launch: rows 2 (K2's route) at 128x128, rows 1 (K3's)
at 192x320.
"""

import numpy as np
import pytest

from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import primitives as jp
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import (
    ZCULL_STACKS,
    torch_scene,
    zcull_stack,
)
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.ops import raster as trp

from test_torch_render import assert_frame_parity
from torch_threads import one_torch_thread  # noqa: F401

SIZES = {2: (128, 128), 1: (192, 320)}  # rows -> (H, W)


def near_far(h, w):
    _, tr_d, li_d = js.baseline_scene(4, h, w)
    mesh = construct_sphere()
    sg = [(dict(p=(0.0, 0.0, 0.6), **mesh), {"phong": True}),
          (dict(p=(0.0, 0.0, -0.9), **mesh), {"phong": True})]
    return sg, tr_d, li_d


@pytest.mark.parametrize("rows", [2, 1])
def test_zcull_frame_vs_jax_and_golden(rows):
    h, w = SIZES[rows]
    sg, tr_d, li_d = near_far(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    launch = tre.prepare_scene(scene_t, tr, li, h, w, zcull=True)
    assert (launch.route.tile_h, launch.route.rows) == (8, rows)
    assert launch.kernel is trp.ZCULL_KERNELS[(8, rows)]
    fb, stats = trt.Renderer(h, w, device="cpu", zcull=True).render(
        scene_t, tr, li, with_stats=True)
    color, depth = fb.color.numpy(), fb.depth.numpy()

    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb, jstats = JRenderer(h, w, backend="pallas", zcull=True).render(
        scene_j, trj, lij, with_stats=True)
    assert_frame_parity(color, depth, np.asarray(jfb.color),
                        np.asarray(jfb.depth))
    for key in ("bins_dropped", "bins_real_entries"):
        assert int(stats[key]) == int(jstats[key]), key
    assert int(stats["bins_dropped"]) == 0
    assert stats["bins_budget_factor"] == jstats["bins_budget_factor"]

    gc, gd = gold.render(sg, tr_d, li_d, h, w)
    np.testing.assert_array_equal(color, gc)
    np.testing.assert_array_equal(depth, gd)
    # The far sphere hides behind the near one: every covered z > 0.
    assert (depth[depth > -3.0e38] > 0.0).all()


@pytest.mark.parametrize("name, variant, kernel", [
    ("k4", "base", "raster_narrow_any_kernel"),
    ("k6", "base", "raster_mask_kernel"),
    ("k6multi", "base", "raster_mask_kernel"),
])
def test_zcull_does_nothing_off_the_8row_routes(name, variant, kernel):
    """K4 (16-row tiles) and K6 (the mask strategy) ignore the flag, as
    the JAX package does: the same kernel, the same frame."""
    scene, tr, li, (h, w) = torch_scene(name, variant, "cpu")
    launch = tre.prepare_scene(scene, tr, li, h, w, zcull=True)
    assert launch.kernel is getattr(trp, kernel)
    frames = [trt.Renderer(h, w, device="cpu", zcull=z).render(scene, tr, li)
              for z in (False, True)]
    np.testing.assert_array_equal(frames[0].color.numpy(),
                                  frames[1].color.numpy())
    np.testing.assert_array_equal(frames[0].depth.numpy(),
                                  frames[1].depth.numpy())


@pytest.mark.parametrize("name", ["k3", "k6"])
def test_zcull_does_nothing_on_the_gbuffer_path(name):
    """The G-buffer path (K8, K9) never culls (renderer.py:182-185): the
    frame with the flag equals the frame without it."""
    scene, tr, li, (h, w) = torch_scene(name, "gbuffer", "cpu")
    assert not tre._obj_fusable(*scene[0])
    frames = [trt.Renderer(h, w, device="cpu", zcull=z).render(scene, tr, li)
              for z in (False, True)]
    np.testing.assert_array_equal(frames[0].color.numpy(),
                                  frames[1].color.numpy())
    np.testing.assert_array_equal(frames[0].depth.numpy(),
                                  frames[1].depth.numpy())
    assert int((frames[0].depth > -3.0e38).sum()) > 1000


@pytest.mark.parametrize("rows", [1, 2])
def test_zcull_stacks_take_k11_and_cull(rows):
    """The stacks the CUDA tests and chip_smoke cull (route_scenes
    ZCULL_STACKS, innermost layer first): K11 on the route of ``rows``
    streams, no drop, and batches the skip takes (``zcull_skips_plain``,
    which the CUDA tests hold the kernel's count to). In bench.py's order
    (outermost first) every layer is drawn in front of the last and the
    skip takes nothing."""
    scene, tr, li, (h, w) = zcull_stack(rows, "cpu")
    launch = tre.prepare_scene(scene, tr, li, h, w, zcull=True)
    assert launch.kernel is trp.ZCULL_KERNELS[(8, rows)]
    assert int(launch.stats()["bins_dropped"]) == 0
    assert trp.zcull_skips_plain(*launch.operands[:2],
                                 tile_h=launch.route.tile_h,
                                 **launch.options) > 0
    if rows == 1:
        lat, lon, layers, _ = ZCULL_STACKS[rows]
        bench = tre.prepare_scene(
            ts.stack_scene(lat, lon, layers, h, w, device="cpu")[0], tr, li,
            h, w, zcull=True)
        assert trp.zcull_skips_plain(*bench.operands[:2],
                                     tile_h=bench.route.tile_h,
                                     **bench.options) == 0


def test_stack_scene_is_bench_scene():
    """stack_scene's layers are bench.py's: the sphere grid's vertices
    scaled by f32(1 - 0.1 i), outermost first, baseline_scene(4)'s camera
    and lights, Phong."""
    scene, tr, li = ts.stack_scene(12, 10, 4, 64, 96, device="cpu")
    mesh = jp.construct_sphere_grid(12, 10)
    _, tr_d, li_d = js.baseline_scene(4, 64, 96)
    assert float(tr.meters_to_pixels) == np.float32(tr_d["meters_to_pixels"])
    np.testing.assert_array_equal(li.light_p.numpy(), li_d["light_p"])
    for i, (obj, cfg) in enumerate(scene):
        assert cfg.phong and not cfg.textured
        verts = np.asarray(mesh["vertices"]) * np.float32(1.0 - 0.1 * i)
        want = verts.reshape(-1, 3, 3).transpose(2, 1, 0)
        np.testing.assert_array_equal(obj.vertices.numpy(), want)
