"""The sorted kernels K4 and K9 + K10 at tile heights no route picks
(24, 40, 48, 64 rows): on CUDA tensors the band form
(``ops.raster.raster_narrow_any_kernel``, K9's ``tr_gbuffer_queue``), on
the CPU the plain fold, which takes any height.

Against the JAX package (``rasterize_pallas_shaded`` and
``rasterize_pallas``, jitted, their Pallas kernels in interpret mode): the
528-triangle spheres of tests/test_torch_forced_routes.py at 64 x 256,
Phong and bilinear-textured (K5), on the fused sorted route at 24 and 64
rows, and the side-list scene of that file (a cube and a 16-unit quad,
which takes the side list at these heights) on the sorted G-buffer route
(K9 with K10) at 24 and 64 rows. Without JAX: every frame at 24, 40, 48
and 64 rows bit-equal to the port's own 16-row frame.

The file keeps under ten cases (see tests/test_torch_forced_routes.py).
Bars (tests/test_parity_jax.py; XLA's CPU backend contracts FMAs, golden
divergence #8): coverage exact, colour mismatch <= 0.2%, depth within
rtol 1e-6 on >= 99.5% of covered pixels, G-buffer attributes within rtol
1e-6 + atol 2.4e-7 where z agrees, drops and real entries equal; between
the port's own heights, bit for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_forced_routes import (
    J_GBUFFER,
    J_SHADED,
    inputs,
    sidelist_scene,
)
from test_torch_render import assert_color_parity
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401

HW = (64, 256)  # the 528-triangle spheres' frame


def assert_covered_depth(z, jz, cov):
    """Depth within rtol 1e-6 on >= 99.5% of the covered pixels."""
    ok = (z == jz) | np.isclose(z, jz, rtol=1e-6, atol=0.0)
    assert 1.0 - ok[cov].mean() <= 0.005


def assert_stats_equal(stats, jstats):
    for key in ("bins_dropped", "bins_real_entries"):
        assert int(stats[key]) == int(jstats[key]), key
    assert int(stats["bins_dropped"]) == 0


def fused_launch(name, tile_h):
    """The port's launch, its frame (covered, z, color, stats) and the
    call's arguments for a sphere of test_torch_forced_routes forced to
    the sorted strategy at ``tile_h`` rows."""
    h, w = HW
    ((obj, cfg), tr, li), _, table = inputs(name, h, w)
    spec = trp.ObjSpec(0, obj.num_triangles, cfg.phong,
                       (0, 16, 16, "bilinear") if cfg.textured else None)
    atlas = (trp.pack_texture_atlas([obj.texture])[0] if cfg.textured
             else None)
    launch = trp.prepare_raster(table, (spec,), tr, li, h, w, None, h, w, 0,
                                0, "sorted", tile_h, atlas)
    return launch, trp.run_shaded(launch, h, w)


@functools.lru_cache(maxsize=None)
def jax_shaded(name, tile_h):
    h, w = HW
    _, ((obj_j, cfg_j), trj, lij), table = inputs(name, h, w)
    tex = obj_j.texture if cfg_j.textured else None
    out = J_SHADED(jax.numpy.asarray(table.numpy()), trj, lij, cfg_j.phong,
                   h, w, None, h, w, 0, 0, "sorted", tile_h, tex,
                   cfg_j.filter_mode)
    return tuple(np.asarray(a) for a in out[:3]) + (
        {k: np.asarray(v) for k, v in out[3].items()},)


@pytest.mark.parametrize("name", ["sphere12", "sphere12-tex"])
@pytest.mark.parametrize("tile_h", [24, 64])
def test_fused_sorted_heights_vs_jax(name, tile_h):
    """K4 at 24 and 64 rows (K5 bilinear on the textured sphere): the
    route JAX takes with the requested height, one stream, the band form's
    wrapper, and JAX's frame and stats."""
    launch, (cov, z, color, stats) = fused_launch(name, tile_h)
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == ("sorted", tile_h, 1)
    assert launch.kernel is trp.raster_narrow_any_kernel
    assert launch.options["tile_h"] == tile_h
    jcov, jz, jcolor, jstats = jax_shaded(name, tile_h)
    cov, z, color = cov.numpy(), z.numpy(), color.numpy()
    np.testing.assert_array_equal(cov, jcov)
    assert_color_parity(color, jcolor)
    assert_covered_depth(z, jz, cov)
    assert set(stats) == set(jstats)
    assert_stats_equal(stats, jstats)
    assert cov.sum() == 557


@functools.lru_cache(maxsize=None)
def sidelist_gbuffer(tile_h):
    """The side-list scene's G-buffer launch at ``tile_h`` rows, its
    output, and JAX's rasterize_pallas on the same table."""
    h, w, table, *_ = sidelist_scene()
    launch = tgb.prepare_gbuffer(table, h, w, None, h, w, 0, 0, "sorted",
                                 tile_h)
    port = tgb.rasterize_gbuffer(table, h, w, None, h, w, 0, 0, "sorted",
                                 tile_h)
    jout = J_GBUFFER(jax.numpy.asarray(table.numpy()), h, w, None, h, w, 0,
                     0, "sorted", tile_h)
    return launch, port, jout


@pytest.mark.parametrize("tile_h", [24, 64])
def test_sidelist_gbuffer_heights_vs_jax(tile_h):
    """K9 with K10 at 24 and 64 rows: one stream, the quad on the side
    list (both triangles at 24 rows; at 64 one of them covers at most the
    expansion's 32 tiles and stays in the stream), K9's wrapper; JAX's
    G-buffer and stats."""
    launch, (cov, gbuf, stats), (jcov, jgbuf, jstats) = sidelist_gbuffer(
        tile_h)
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == ("sorted", tile_h, 1)
    assert launch.kernel is tgb.raster_pass_queue
    assert int(launch.qbins.n_large) == {24: 2, 64: 1}[tile_h]
    cov, gbuf, jgbuf = cov.numpy(), gbuf.numpy(), np.asarray(jgbuf)
    np.testing.assert_array_equal(cov, np.asarray(jcov))
    assert_covered_depth(gbuf[0], jgbuf[0], cov)
    same_z = cov & (gbuf[0] == jgbuf[0])
    assert same_z.sum() > 0.5 * cov.sum() > 500
    for ch in range(1, tgb.GBUF_CHANNELS):
        np.testing.assert_allclose(gbuf[ch][same_z], jgbuf[ch][same_z],
                                   rtol=1e-6, atol=2.4e-7,
                                   err_msg=f"channel {ch}")
    assert_stats_equal(stats, jstats)


def test_heights_equal_the_16_row_frame():
    """At 24, 40, 48 and 64 rows every frame equals the 16-row one bit for
    bit, with no drops: the fused spheres (K4, K5 on the textured one),
    the side-list scene's fused frame (K4 with the side list) and its
    G-buffer (K9 with K10)."""
    def frames(tile_h):
        out = [fused_launch(name, tile_h)[1] for name in ("sphere12",
                                                          "sphere12-tex")]
        h, w, table, (obj, tr, li), *_ = sidelist_scene()
        spec = (trp.ObjSpec(0, obj.num_triangles, False),)
        out.append(trp.run_shaded(trp.prepare_raster(
            table, spec, tr, li, h, w, None, h, w, 0, 0, "sorted", tile_h),
            h, w))
        out.append(tgb.rasterize_gbuffer(table, h, w, None, h, w, 0, 0,
                                         "sorted", tile_h))
        for o in out:
            assert int(o[-1]["bins_dropped"]) == 0
        return [o[:-1] for o in out]

    want = frames(16)
    for tile_h in (24, 40, 48, 64):
        for got, ref in zip(frames(tile_h), want):
            for a, b in zip(got, ref):
                assert torch.equal(
                    a.view(torch.int32) if a.dtype == torch.float32 else a,
                    b.view(torch.int32) if b.dtype == torch.float32 else b)
    assert int(want[2][0].sum()) > 1000 and int(want[3][0].sum()) > 1000
