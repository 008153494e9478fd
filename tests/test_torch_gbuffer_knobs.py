"""The G-buffer path's knobs and pieces (tests/test_torch_gbuffer.py's
module docstring states the bars): tile height, list capacity, sub-rects,
'avx' texture addressing against JAX and the golden, and the fused frame
against the deferred one. (Split from that file, so that each file keeps
under ten cases.)"""

import jax
import numpy as np
import pytest
import torch

from test_torch_gbuffer import H, W, port_table, scene_of
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.ops import shading as jsh
from tpu_renderer_torch.core.math import pack_argb
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import shading as tsh
from torch_threads import one_torch_thread  # noqa: F401


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
