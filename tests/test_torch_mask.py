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
"""

import numpy as np
import pytest
import torch

from test_torch_render import assert_frame_parity
from tpu_renderer.engine import renderer as jre
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import binning as jbin
from tpu_renderer.ops import raster_pallas as jrp
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.ops import binning as tbin
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp

H = W = 128
F = np.float32


def seeded_bboxes(T, h, w, seed):
    """Global-frame bboxes of T triangles, as _bbox_core returns them: a
    validity mask, rows in [0, h], columns in [0, w - 1]."""
    rng = np.random.default_rng(seed)
    ylo = rng.uniform(0, h, T).astype(F)
    yhi = np.minimum(ylo + rng.exponential(h / 6, T), h).astype(F)
    xlo = rng.uniform(0, w - 1, T).astype(F)
    xhi = np.minimum(xlo + rng.exponential(w / 6, T), w - 1).astype(F)
    valid = rng.uniform(size=T) < 0.9
    return valid, ylo, yhi, xlo, xhi


@pytest.mark.parametrize("T, tile_h, capacity, origin", [
    (12, 16, 16, (0, 0)),
    (300, 8, 304, (0, 0)),
    (300, 8, 24, (0, 0)),      # capacity below demand: drops counted
    (500, 16, 40, (37, 21)),   # sub-rectangle at an offset, drops
])
def test_bin_triangles_vs_jax(T, tile_h, capacity, origin):
    """Per-tile lists in submission order, counts and n_dropped integer-
    exact against JAX's bin_triangles on seeded bboxes."""
    row0, col0 = origin
    h, w = (H - row0, W - col0) if origin != (0, 0) else (H, W)
    bbox = seeded_bboxes(T, H, W, T + capacity)
    want = jbin.bin_triangles(None, h, w, tile_h, trp.TILE_W, capacity, H,
                              W, row0, col0, bbox=tuple(map(np.asarray,
                                                            bbox)))
    got = tbin.bin_triangles(h, w, tile_h, trp.TILE_W, capacity, row0, col0,
                             tuple(torch.from_numpy(a) for a in bbox))
    for name in ("ids", "counts", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.ids.is_contiguous() and got.ids.dtype == torch.int32
    assert (int(got.n_dropped) > 0) == (capacity < T)


@pytest.mark.parametrize("capacity, tiles", [
    (512, (64, 4)), (512, (135, 15)), (8192, (1, 1)), (4096, (300, 15)),
    (8, (1, 1))])
def test_mask_guard_and_capacity_as_jax(capacity, tiles):
    """_mask_guard raises the same errors for the same inputs, and the
    capacity default follows the table's length."""
    try:
        jrp._mask_guard(capacity, *tiles)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        trp._mask_guard(capacity, *tiles)
    else:
        with pytest.raises(ValueError) as err:
            trp._mask_guard(capacity, *tiles)
        assert str(err.value) == want
    for T in (1, 7, 8, 12, 300, 512, 4095, 10 ** 6):
        assert trp.mask_capacity(T) == min(max(8, -(-T // 8) * 8), 4096)


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


@pytest.mark.parametrize("order", ["mask-first", "sorted-first"])
def test_merge_stats_mixes_mask_and_sorted_draws(order):
    """Fault 1: a per-object scene of a mask draw (config 1's cube) and a
    sorted draw (the 4,140-triangle sphere grid), stats on. The mask draw
    adds only its drops; the sorted draw's entries, utilization and policy
    factor (max and min) carry over: the dict JAX's _merge_stats builds
    from the same draws' stats."""
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    sg = [(dict(p=(0.3, 0.2, 0.2), **tp.construct_cube(0.5)), {}),
          (dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
           {"phong": True})]
    if order == "sorted-first":
        sg = sg[::-1]
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    stats, fb, draws = {}, None, []
    for obj, cfg in scene:
        launch = tre.prepare_scene([(obj, cfg)], tr, li, H, W)
        draws.append(launch.stats())
        fb = tre.render_object(fb, obj, tr, li, cfg, "kernels", H, W,
                               stats=stats)
    assert sorted(d["bins_dropped"].ndim for d in draws) == [0, 0]
    assert ["bins_real_entries" in d for d in draws] == (
        [False, True] if order == "mask-first" else [True, False])
    want = {}
    for d in draws:
        jre._merge_stats(want, {k: np.asarray(v) if torch.is_tensor(v)
                                else v for k, v in d.items()})
    assert set(stats) == set(want) == {
        "bins_dropped", "bins_real_entries", "bins_budget_utilization",
        "bins_budget_factor", "bins_budget_factor_min"}
    for k in want:
        np.testing.assert_array_equal(np.asarray(stats[k]),
                                      np.asarray(want[k]), err_msg=k)
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    np.testing.assert_array_equal(fb.color.numpy(), gc)
    np.testing.assert_array_equal(fb.depth.numpy(), gd)
