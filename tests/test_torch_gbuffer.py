"""The port's G-buffer path (``ops.gbuffer``: K8, K9, K10's plain
versions; ``ops.shading.shade``; the G-buffer branch of ``render_object``)
against the JAX package and the NumPy golden.

Scenes come from the suite's ``baseline_scene`` and the route scenes of
``tpu_renderer_torch/models/route_scenes.py`` (NumPy, deterministic). The
JAX side runs jitted, its Pallas kernels in interpret mode as its own
tests run them: ``rasterize_pallas`` on its own setup's table, ``shade``,
and ``Renderer(backend="pallas")``; the port runs its kernels' plain
versions.

Bars:
- ``rasterize_gbuffer`` against ``rasterize_pallas``, both on JAX's own
  setup table (the raster stage alone; tests/test_pallas.py:67):
  coverage exact, depth equal or within rtol 1e-6 on >= 99.5% of pixels,
  and where z agrees every attribute channel within rtol 1e-6 + atol
  2.4e-7 (XLA's CPU backend contracts al + k * inc into an FMA, golden
  divergence #8: up to 6.5% of a Gouraud colour channel differs by about
  1e-7); binning counts equal, budget utilization within 1 ulp (XLA turns
  the division by the static budget into a product with its reciprocal).
  Against ``gold.rasterize`` per object, on the port's own setup: coverage
  and every channel bit-exact.
- ``shade`` on JAX's own G-buffer: bit-exact against ``gold.shade``;
  against JAX's ``shade`` coverage exact, packed colour mismatch <= 0.2%.
- Frames: against the golden bit-exact; against JAX the budgets of
  tests/test_parity_jax.py (colour mismatch <= 0.2%, depth within rtol
  1e-6 on >= 99.5% of pixels; 'avx' coverage follows u, v at 1 +- 1 ulp).

JAX's interpret-mode compiles set this file's time, so each is made once
and only where it adds a route: the G-buffer cases hold JAX on the mask
strategy at 16 and 8 rows and the sorted one at 8 and 16 rows with the
side list (every case against the golden), the shade cases reuse config
3's G-buffer, and the sphere frame is the mixed frame's G-buffer object.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_render import assert_color_parity, assert_depth_parity
from tpu_renderer.core import math as jm
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import setup_pallas as jsp
from tpu_renderer.ops import shading as jsh
from tpu_renderer.ops.raster_pallas import rasterize_pallas
import tpu_renderer_torch as trt
from tpu_renderer_torch.core.math import pack_argb
from tpu_renderer_torch.core.types import ObjectConfig
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.ops import shading as tsh

H = W = 128
J_SETUP = jax.jit(jsp.setup_for_raster, static_argnums=(3, 4, 5, 6))
J_RASTER = jax.jit(rasterize_pallas, static_argnums=(1, 2, 3, 4, 5, 8))


def scene_of(name):
    """(scene_golden, (h, w)) of a case: 'configN' at 128x128, else a
    route scene 'name' or 'name-variant'."""
    if name.startswith("config"):
        return js.baseline_scene(int(name[-1]), H, W)[0], (H, W)
    return route_scene(*name.split("-"))


def port_table(sg, h, w):
    """The port's setup of the scene's first object on the CPU: (table,
    (obj, cfg), transform, lights)."""
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    return table, scene[0], tr, li


def jax_gbuffer(sg, h, w, strategy="auto"):
    """JAX's setup and rasterize_pallas on the scene's first object ->
    ((covered, gbuf (11, H, W), stats) as NumPy, JAX's setup table as the
    port's: a SetupOut or the channel-major tensor)."""
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    obj, cfg = scene_j[0]
    table = J_SETUP(obj, trj, lij, cfg, 0, h, w)
    cov, gbuf, stats = J_RASTER(table, h, w, None, h, w, 0, 0, strategy)
    if isinstance(table, jsp.SetupOut):
        ttable = tsp.SetupOut(torch.tensor(np.asarray(table.recs)),
                              [torch.tensor(np.asarray(a))
                               for a in table.bbox], table.num_triangles)
    else:
        ttable = torch.tensor(np.asarray(table))
    return (np.asarray(cov), np.asarray(gbuf),
            {k: np.asarray(v) for k, v in stats.items()}), ttable


def golden_gbuffer(sg, h, w):
    """gold.rasterize of the scene's first object -> (covered, gbuf
    (11, H, W))."""
    obj_d, cfg_d = sg[0]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    edges = gold.setup_edges(obj_d, tr_d, li_d,
                             phong=bool(cfg_d.get("phong", False)),
                             textured=cfg_d.get("texture") is not None)
    cov, gbuf = gold.rasterize(edges, h, w)
    return cov, np.ascontiguousarray(gbuf.transpose(2, 0, 1))


# ---------------------------------------------------------------------------
# rasterize_gbuffer
# ---------------------------------------------------------------------------

RASTER_CASES = {  # case -> (scene, strategy, (strategy, tile_h) taken)
    "config3-mask": ("config3", "mask", ("mask", 16)),
    "config3-sorted": ("config3", "sorted", ("sorted", 16)),
    "config4-mask": ("config4", "mask", ("mask", 8)),
    "config4-sorted": ("config4", "sorted", ("sorted", 8)),
    "k3": ("k3", "auto", ("sorted", 8)),
    "k3-sidelist": ("k3-sidelist", "auto", ("sorted", 8)),
    "k4": ("k4", "auto", ("sorted", 16)),
    "k4-sidelist": ("k4-sidelist", "auto", ("sorted", 16)),
}
# Against JAX: each strategy and tile height once, the sorted ones with
# the side list (K10) beside the stream.
JAX_CASES = ["config3-mask", "config4-mask", "k3-sidelist", "k4-sidelist"]


@functools.lru_cache(maxsize=None)
def jax_case(case):
    """JAX's G-buffer of a case, and the port's on JAX's table."""
    name, strategy, _ = RASTER_CASES[case]
    sg, (h, w) = scene_of(name)
    jout, jtable = jax_gbuffer(sg, h, w, strategy)
    cov, gbuf, stats = tgb.rasterize_gbuffer(jtable, h, w, strategy=strategy)
    return jout, (cov.numpy(), gbuf.numpy(), stats)


@pytest.fixture(scope="module", params=list(RASTER_CASES))
def gcase(request):
    name, strategy, route = RASTER_CASES[request.param]
    sg, (h, w) = scene_of(name)
    table, _, _, _ = port_table(sg, h, w)
    launch = tgb.prepare_gbuffer(table, h, w, strategy=strategy)
    cov, gbuf, stats = tgb.rasterize_gbuffer(table, h, w, strategy=strategy)
    return dict(name=request.param, route=route, launch=launch,
                port=(cov.numpy(), gbuf.numpy(), stats),
                gold=golden_gbuffer(sg, h, w))


def test_gbuffer_route(gcase):
    """The route JAX's rasterize_pallas takes: one stream at every tile
    height (no row packing), K9 with the side list on the side-list
    scenes, K8 on the mask strategy."""
    r = gcase["launch"].route
    assert (r.strategy, r.tile_h, r.rows) == gcase["route"] + (1,)
    assert gcase["launch"].kernel is (
        tgb.raster_pass if r.strategy == "mask" else tgb.raster_pass_queue)
    n_large = int(gcase["launch"].qbins.n_large)
    assert (n_large > 0) == gcase["name"].endswith("sidelist")
    assert gcase["port"][0].sum() > 1000


@pytest.mark.parametrize("case", JAX_CASES)
def test_gbuffer_vs_jax(case):
    """The raster stage alone: JAX's own setup table through the port's
    rasterize_gbuffer and through rasterize_pallas."""
    (jcov, jgbuf, _), (cov, gbuf, _) = jax_case(case)
    np.testing.assert_array_equal(cov, jcov)
    assert_depth_parity(gbuf[0], jgbuf[0])
    same_z = cov & (gbuf[0] == jgbuf[0])
    assert same_z.mean() > 0.5 * cov.mean()
    for ch in range(1, tgb.GBUF_CHANNELS):
        np.testing.assert_allclose(gbuf[ch][same_z], jgbuf[ch][same_z],
                                   rtol=1e-6, atol=2.4e-7,
                                   err_msg=f"channel {ch}")


def test_gbuffer_vs_golden(gcase):
    (cov, gbuf, _), (gcov, ggbuf) = gcase["port"], gcase["gold"]
    np.testing.assert_array_equal(cov, gcov)
    np.testing.assert_array_equal(gbuf.view(np.uint32), ggbuf.view(np.uint32))


@pytest.mark.parametrize("case", JAX_CASES)
def test_gbuffer_stats_vs_jax(case):
    """Binning stats of the same table as JAX's: the counts and the policy
    factor equal, the utilization within 1 ulp."""
    (_, _, jstats), (_, _, stats) = jax_case(case)
    assert set(stats) == set(jstats)
    for k, v in jstats.items():
        if k == "bins_budget_utilization":
            np.testing.assert_allclose(np.asarray(stats[k]), v, rtol=2 ** -23)
        else:
            np.testing.assert_array_equal(np.asarray(stats[k]), v, err_msg=k)
    assert int(stats["bins_dropped"]) == 0


@pytest.mark.parametrize("strategy", ["mask", "sorted"])
def test_tile_height_does_not_change_the_gbuffer(strategy):
    """tile_h is a performance knob (tests/test_pallas.py:288): 8-, 16-
    and 32-row tiles give the same G-buffer. (The CUDA kernels take 8, 16
    and 32; the plain version any height.)"""
    sg, (h, w) = scene_of("config1")
    table, _, _, _ = port_table(sg, h, w)
    out = [tgb.rasterize_gbuffer(table, H, W, strategy=strategy, tile_h=th)
           for th in (8, 16, 32)]
    for cov, gbuf, stats in out[1:]:
        np.testing.assert_array_equal(cov.numpy(), out[0][0].numpy())
        np.testing.assert_array_equal(gbuf.numpy().view(np.uint32),
                                      out[0][1].numpy().view(np.uint32))
        assert int(stats["bins_dropped"]) == 0
    assert out[0][0].sum() > 1000


def test_mask_capacity_overflow_is_counted():
    """A list capacity of 8 on config 4's sphere drops triangles, counted
    in the stats, and the earliest ones still render
    (tests/test_pallas.py:105)."""
    sg, (h, w) = scene_of("config4")
    table, _, _, _ = port_table(sg, h, w)
    cov, _, stats = tgb.rasterize_gbuffer(table, H, W, capacity=8,
                                          strategy="mask")
    assert int(stats["bins_dropped"]) > 0
    assert int(cov.sum()) > 0


@pytest.mark.parametrize("name", ["k4-sidelist", "config1"])
def test_subrect_equals_crop_of_full_frame(name):
    """A sub-rectangle at (row0, col0) off the tile grid, as the
    geometry-sharded render calls it, holds the full frame's G-buffer:
    binning in local tiles, fragments in global pixels."""
    sg, (h, w) = scene_of(name)
    table, _, _, _ = port_table(sg, h, w)
    cov, gbuf, _ = tgb.rasterize_gbuffer(table, h, w)
    r0, c0, hs, ws = 37, 21, h - 60, w - 40
    cov_s, gbuf_s, _ = tgb.rasterize_gbuffer(table, hs, ws, None, h, w, r0,
                                             c0)
    np.testing.assert_array_equal(cov_s.numpy(),
                                  cov[r0:r0 + hs, c0:c0 + ws].numpy())
    np.testing.assert_array_equal(
        gbuf_s.numpy().view(np.uint32),
        gbuf[:, r0:r0 + hs, c0:c0 + ws].numpy().view(np.uint32))
    assert int(cov_s.sum()) > 1000


# ---------------------------------------------------------------------------
# shade
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("filter_mode", ["nearest", "bilinear"])
def test_sample_texture_avx_vs_jax_and_golden(filter_mode):
    """'avx' addressing of seeded u, v in and beyond [0, 1], with the six
    conversion edge cases in a row of u and a row of v: the [0, 1] mask
    exact against JAX and the golden; nearest (trunc(u * tw), clipped)
    bit-exact against JAX and, but for u or v = +inf (the golden converts
    through int64, ROADMAP Queue 3), against the golden; bilinear as in
    tests/test_torch_texture.py. Unknown modes raise ValueError."""
    rng = np.random.default_rng(15)
    tex = rng.integers(0, 2 ** 32, (16, 24), dtype=np.uint64).astype(
        np.uint32)
    u = rng.uniform(-0.3, 1.3, (16, 128)).astype(np.float32)
    v = rng.uniform(-0.3, 1.3, (16, 128)).astype(np.float32)
    six = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5], np.float32)
    u[0, :6] = six
    v[1, :6] = six
    ttex = torch.from_numpy(tex.view(np.int32))
    got, mask = tsh.sample_texture(ttex, torch.from_numpy(u),
                                   torch.from_numpy(v), "avx", filter_mode)
    got, mask = got.numpy(), mask.numpy()
    want, jmask = jax.jit(lambda t, a, b: jsh.sample_texture(
        t, a, b, "avx", filter_mode))(tex, u, v)
    want = np.asarray(want)
    gwant, gmask = gold.sample_texture(tex, u, v, "avx", filter_mode)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    np.testing.assert_array_equal(mask, gmask)
    assert 0.3 < mask.mean() < 0.9
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(nan, np.isnan(gwant))
    if filter_mode == "nearest":
        np.testing.assert_array_equal(got, want)
        keep = ~((u == np.inf) | (v == np.inf))[..., None]
        np.testing.assert_array_equal(np.where(keep, got, 0),
                                      np.where(keep, gwant, 0))
    else:
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                                   atol=2.4e-7)
        np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                      gwant.view(np.uint32)[~nan])
    with pytest.raises(ValueError, match="unknown uv_mode"):
        tsh.sample_texture(ttex, torch.from_numpy(u), torch.from_numpy(v),
                           "wrap", "nearest")
    with pytest.raises(ValueError, match="unknown filter_mode"):
        tsh.sample_texture(ttex, torch.from_numpy(u), torch.from_numpy(v),
                           "avx", "trilinear")


@pytest.mark.parametrize("filter_mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("uv_mode", ["scalar", "avx"])
@pytest.mark.parametrize("phong", [True, False], ids=["phong", "gouraud"])
def test_shade_vs_golden_and_jax(phong, uv_mode, filter_mode):
    """The port's shade and JAX's on JAX's own G-buffer of config 3's
    textured cube, both addressings and filters, Phong and Gouraud."""
    jcov, jgbuf, _ = jax_case("config3-mask")[0]  # config 3's own route
    sg, _ = scene_of("config3")
    tex = sg[0][1]["texture"]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    _, tr, li = ts.to_torch_scene([], tr_d, li_d, device="cpu")
    cfg = ObjectConfig(phong=phong, textured=True, uv_mode=uv_mode,
                       filter_mode=filter_mode)
    rgba, cov = tsh.shade(torch.from_numpy(jcov), torch.from_numpy(jgbuf),
                          tr, li, cfg, torch.from_numpy(tex.view(np.int32)))
    rgba, cov = rgba.numpy(), cov.numpy()
    grgba, gcov = gold.shade(jcov, jgbuf.transpose(1, 2, 0), tr_d, li_d,
                             phong, tex, uv_mode, filter_mode)
    np.testing.assert_array_equal(cov, gcov)
    np.testing.assert_array_equal(rgba.view(np.uint32),
                                  grgba.astype(np.float32).view(np.uint32))
    scene_j, trj, lij = js.to_jax_scene(
        [(sg[0][0], dict(sg[0][1], phong=phong, uv_mode=uv_mode,
                         filter_mode=filter_mode))], tr_d, li_d)
    jcfg = scene_j[0][1]
    jrgba, jcov2 = jax.jit(jsh.shade, static_argnums=(4,))(
        jcov, jgbuf, trj, lij, jcfg, scene_j[0][0].texture)
    np.testing.assert_array_equal(cov, np.asarray(jcov2))
    packed = pack_argb(torch.from_numpy(rgba)).numpy()
    jpacked = np.asarray(jm.pack_argb(jrgba))
    assert (packed[cov] != jpacked[cov]).mean() <= 0.002
    if uv_mode == "avx":
        assert cov.sum() < jcov.sum()  # u, v outside [0, 1] dropped


def test_fused_frame_equals_deferred_frame():
    """Config 3 (bilinear, within the fused limits): the fused launch (K6
    with K5's plain version) and rasterize_gbuffer + shade give the same
    coverage, depth and colour (tests/test_pallas.py:220)."""
    sg, (h, w) = scene_of("config3")
    table, (obj, cfg), tr, li = port_table(sg, h, w)
    launch = tre.prepare_scene([(obj, cfg)], tr, li, h, w)
    z_f, gid_f, color_f = (a[:h, :w].numpy() for a in launch.run())
    cov, gbuf, _ = tgb.rasterize_gbuffer(table, h, w)
    rgba, cov = tsh.shade(cov, gbuf, tr, li, cfg, obj.texture)
    color_d = pack_argb(rgba).numpy()
    np.testing.assert_array_equal(gid_f >= 0, cov.numpy())
    np.testing.assert_array_equal(z_f, gbuf[0].numpy())
    np.testing.assert_array_equal(color_f[gid_f >= 0],
                                  color_d[cov.numpy()])
    assert int(cov.sum()) > 1000


# ---------------------------------------------------------------------------
# Frames through Renderer
# ---------------------------------------------------------------------------

FRAMES = {  # name -> scene, the kernel of each object's draw
    "config3-avx": ("k6-gbuffer", ["K8"]),
    "sphere-256": ("mixed-gbuffer", ["K9"]),
    "mixed": ("mixed-gbuffer", ["K9", "K6"]),
    "k4-600": ("k4-gbuffer", ["K9"]),
}
# The sphere alone against the golden only: it is the mixed scene's
# G-buffer object, which the mixed frame holds to JAX.
JAX_FRAMES = ["config3-avx", "mixed", "k4-600"]


def frame_scene(name):
    scene, kernels = FRAMES[name]
    sg, (h, w) = scene_of(scene)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    return sg[:len(kernels)], kernels, tr_d, li_d, (h, w)


@pytest.fixture(scope="module", params=list(FRAMES))
def frame(request):
    """The port's frame with the golden's."""
    sg, kernels, tr_d, li_d, (h, w) = frame_scene(request.param)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(h, w, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    return dict(name=request.param, kernels=kernels, scene=(scene, tr, li),
                hw=(h, w), stats=stats,
                port=(fb.color.numpy(), fb.depth.numpy()),
                gold=gold.render(sg, tr_d, li_d, h, w))


def test_frame_route(frame):
    """Each object's draw: the G-buffer objects on K8 (mask) or K9
    (sorted), the fused one on K6; one drawn after the other."""
    scene, tr, li = frame["scene"]
    h, w = frame["hw"]
    for (obj, cfg), kernel in zip(scene, frame["kernels"]):
        if kernel == "K6":
            assert tre._obj_fusable(obj, cfg)
            launch = tre.prepare_scene([(obj, cfg)], tr, li, h, w)
            assert launch.route.strategy == "mask"
            continue
        assert not tre._obj_fusable(obj, cfg)
        table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                     frame_width=w)
        launch = tgb.prepare_gbuffer(table, h, w)
        assert launch.kernel is (tgb.raster_pass if kernel == "K8"
                                 else tgb.raster_pass_queue)
    assert len(scene) == 1 or not tre._scene_batchable(scene)
    assert int(frame["stats"]["bins_dropped"]) == 0


def test_frame_vs_golden(frame):
    np.testing.assert_array_equal(frame["port"][0], frame["gold"][0])
    np.testing.assert_array_equal(frame["port"][1].view(np.uint32),
                                  frame["gold"][1].view(np.uint32))
    assert (frame["port"][1] > -3.0e38).sum() > 1000


@pytest.mark.parametrize("name", JAX_FRAMES)
def test_frame_vs_jax(name):
    """Against the JAX package's jitted Renderer(backend="pallas"): the
    frame within the budgets, the drops and policy factors its stats."""
    sg, _, tr_d, li_d, (h, w) = frame_scene(name)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(h, w, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb, jstats = JRenderer(h, w, backend="pallas").render(
        scene_j, trj, lij, with_stats=True)
    color, depth = fb.color.numpy(), fb.depth.numpy()
    assert_color_parity(color, np.asarray(jfb.color))
    assert_depth_parity(depth, np.asarray(jfb.depth))
    assert set(stats) == set(jstats)
    for k in ("bins_dropped", "bins_budget_factor", "bins_budget_factor_min"):
        if k in jstats:
            assert np.asarray(stats[k]) == np.asarray(jstats[k]), k
