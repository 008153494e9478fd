"""The entry points' route knobs and origin against the JAX package and the
NumPy golden: ``strategy`` and ``tile_h`` forced on the fused and
G-buffer entry points, 32-row tiles on every route that takes them (K4,
K6 with K5, K8, K9 with K10), and ``render_scene`` / ``render_object``
drawing a sub-rect at (row0, col0), called with JAX's parameters in JAX's
order. tests/test_torch_route_knobs.py holds the knobs' cases that need no
JAX reference.

The file keeps under ten cases: pytest-xdist's loadfile scheduler hands
out files in order of their test count, so a file of fewer than ten runs
beside tests/test_parallel.py (ten cases, the suite's longest file)
rather than before it, and its JAX compiles do not delay that file's
start.

Scenes are small (frames of at most 2 x 2 tiles where JAX renders) and
come from the suite's generators (NumPy, deterministic). Both packages
rasterize the port's own setup table (the raster stage alone), except the
sub-rect frames, which run each package's whole engine. The JAX side runs
jitted, its Pallas kernels in interpret mode as its own tests run them,
each reference once per process; the port runs its kernels' plain
versions.

Bars (tests/test_parity_jax.py; XLA's CPU backend contracts FMAs, golden
divergence #8): against JAX coverage exact, colour mismatch <= 0.2%, depth
within rtol 1e-6 on >= 99.5% of covered pixels, G-buffer attributes within
rtol 1e-6 + atol 2.4e-7 where z agrees, drops equal; against the golden
and between the port's own routes, bit-exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_render import assert_depth_parity, assert_frame_parity
from test_torch_route_knobs import SUB, port_frames, subrect_scene
from tpu_renderer.core import types as jtypes
from tpu_renderer.engine import renderer as jre
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer_torch.core.types import make_framebuffer
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

# rasterize_pallas_shaded's static parameters: phong, height, width,
# capacity, frame_height, frame_width, strategy, tile_h, filter_mode.
J_SHADED = jax.jit(jrp.rasterize_pallas_shaded,
                   static_argnums=(3, 4, 5, 6, 7, 8, 11, 12, 14))
# rasterize_pallas's: height, width, capacity, frame dims, strategy, tile_h.
J_GBUFFER = jax.jit(jrp.rasterize_pallas,
                    static_argnums=(1, 2, 3, 4, 5, 8, 9))

# case -> (scene, (h, w), strategy, tile_h, (strategy, tile_h, rows) taken)
SHADED = {
    # (a) 360 triangles, sorted forced on 8-row tiles: 360 * 12 >= 64 * 64
    # packs two row streams (K2's route), where 'auto' would take the mask.
    "sorted8": ("sphere10", (64, 64), "sorted", 8, ("sorted", 8, 2)),
    # (b), (c) 528 triangles, the mask forced on 32-row tiles, bilinear
    # texture (K6 with K5), where 'auto' would take the sorted strategy.
    "mask32": ("sphere12-tex", (64, 256), "mask", 32, ("mask", 32, 1)),
    # (c) K4 on 32-row tiles, the strategy left to 'auto'.
    "sorted32": ("sphere12", (64, 256), "auto", 32, ("sorted", 32, 1)),
}


def golden_scene(name):
    """A scene in the golden's form: a Phong sphere of construct_sphere(n)
    at the origin, optionally textured (16 x 16 checkerboard, bilinear)."""
    base, _, tex = name.partition("-")
    cfg = {"phong": True}
    if tex:
        cfg.update(texture=checkerboard(16, 16, 2), filter_mode="bilinear")
    return [(dict(p=(0.0, 0.0, 0.0), **construct_sphere(int(base[6:]))),
             cfg)]


@functools.lru_cache(maxsize=None)
def inputs(name, h, w):
    """((obj, cfg), transform, lights) in the port's form and the JAX
    package's, and the port's setup table of the object (channel-major;
    every scene here is below K1's threshold) on the CPU."""
    sg = golden_scene(name)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    assert not isinstance(table, tsp.SetupOut)
    return (scene[0], tr, li), (scene_j[0], trj, lij), table


def shaded_args(case):
    """The positional arguments of rasterize_pallas_shaded for a case, in
    JAX's order, after (table, transform, lights)."""
    name, (h, w), strategy, tile_h, _ = SHADED[case]
    (_, cfg), _, _ = inputs(name, h, w)[0]
    return (cfg.phong, h, w, None, h, w, 0, 0, strategy, tile_h)


@functools.lru_cache(maxsize=None)
def jax_shaded(case):
    """JAX's rasterize_pallas_shaded on the port's table, called by
    position: (covered, z, color, stats) as NumPy."""
    name, (h, w), *_ = SHADED[case]
    _, ((obj_j, cfg_j), trj, lij), table = inputs(name, h, w)
    tex = obj_j.texture if cfg_j.textured else None
    out = J_SHADED(jax.numpy.asarray(table.numpy()), trj, lij,
                   *shaded_args(case), tex, cfg_j.filter_mode)
    return tuple(np.asarray(a) for a in out[:3]) + (
        {k: np.asarray(v) for k, v in out[3].items()},)


@pytest.mark.parametrize("case", list(SHADED))
def test_forced_shaded_route_vs_jax(case):
    """(a)-(c): the fused entry point, called by position in JAX's order
    with the strategy and tile height forced, takes the route JAX takes
    and gives JAX's frame; the keyword call gives the same frame."""
    name, (h, w), strategy, tile_h, route = SHADED[case]
    ((obj, cfg), tr, li), _, table = inputs(name, h, w)
    tex = (obj.texture, cfg.filter_mode) if cfg.textured else (None,)
    spec = trp.ObjSpec(0, obj.num_triangles, cfg.phong,
                       (0, 16, 16, "bilinear") if cfg.textured else None)
    atlas = (trp.pack_texture_atlas([obj.texture])[0] if cfg.textured
             else None)
    launch = trp.prepare_raster(table, (spec,), tr, li, h, w, None, h, w, 0,
                                0, strategy, tile_h, atlas)
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == route
    assert launch.kernel is (
        trp.raster_mask_kernel if r.strategy == "mask"
        else trp.RASTER_KERNELS.get((r.tile_h, r.rows),
                                    trp.raster_narrow_any_kernel))
    cov, z, color, stats = trp.rasterize_shaded(table, tr, li,
                                                *shaded_args(case), *tex)
    jcov, jz, jcolor, jstats = jax_shaded(case)
    np.testing.assert_array_equal(cov.numpy(), jcov)
    assert_frame_parity(color.numpy(), z.numpy(), jcolor, jz)
    assert set(stats) == set(jstats)
    assert int(stats["bins_dropped"]) == int(jstats["bins_dropped"]) == 0
    if "bins_real_entries" in stats:
        assert int(stats["bins_real_entries"]) == int(
            jstats["bins_real_entries"])
        assert stats["bins_budget_factor"] == float(
            jstats["bins_budget_factor"])
    kw = trp.rasterize_shaded(
        table, tr, li, cfg.phong, h, w, frame_height=h, frame_width=w,
        strategy=strategy, tile_h=tile_h,
        texture=tex[0], filter_mode=cfg.filter_mode)
    for a, b in zip(kw[:3], (cov, z, color)):
        assert torch.equal(a, b)
    assert cov.sum() > 500


@functools.lru_cache(maxsize=None)
def gbuffer_case(strategy):
    """(c): the 528-triangle textured sphere's G-buffer on 32-row tiles
    from the port and from JAX's rasterize_pallas, on the port's table."""
    (h, w) = (64, 256)
    _, _, table = inputs("sphere12-tex", h, w)
    launch = tgb.prepare_gbuffer(table, h, w, None, h, w, 0, 0, strategy,
                                 32)
    port = tgb.rasterize_gbuffer(table, h, w, None, h, w, 0, 0, strategy, 32)
    jout = J_GBUFFER(jax.numpy.asarray(table.numpy()), h, w, None, h, w, 0,
                     0, strategy, 32)
    return launch, port, jout


@pytest.mark.parametrize("strategy", ["mask", "sorted"])
def test_gbuffer_32_rows_vs_jax(strategy):
    """K8 and K9 on 32-row tiles: the G-buffer route JAX's
    rasterize_pallas takes at tile_h 32 (one stream), and its G-buffer."""
    launch, (cov, gbuf, stats), (jcov, jgbuf, jstats) = gbuffer_case(
        strategy)
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == (strategy, 32, 1)
    assert launch.kernel is (tgb.raster_pass if strategy == "mask"
                             else tgb.raster_pass_queue)
    cov, gbuf, jgbuf = cov.numpy(), gbuf.numpy(), np.asarray(jgbuf)
    np.testing.assert_array_equal(cov, np.asarray(jcov))
    assert_depth_parity(gbuf[0], jgbuf[0])
    same_z = cov & (gbuf[0] == jgbuf[0])
    assert same_z.mean() > 0.5 * cov.mean() and cov.sum() > 500
    for ch in range(1, tgb.GBUF_CHANNELS):
        np.testing.assert_allclose(gbuf[ch][same_z], jgbuf[ch][same_z],
                                   rtol=1e-6, atol=2.4e-7,
                                   err_msg=f"channel {ch}")
    assert int(stats["bins_dropped"]) == int(jstats["bins_dropped"]) == 0


@functools.lru_cache(maxsize=None)
def sidelist_scene():
    """(d): the scene of tests/test_pallas.py:459 in the port's form -- a
    cube and a 16-unit quad 0.5 behind it in one flat object -- at 256 x
    1408, where the quad covers all 88 tiles of 32 rows and takes the side
    list; its golden frame and per-object G-buffer."""
    h, w = 256, 1408
    quad = tp.construct_quad(16.0, color=(0.3, 0.9, 0.4, 1.0))
    quad["vertices"] = quad["vertices"] + np.float32([0.0, 0.0, -0.5])
    sg = [(dict(p=(0.0, 0.0, 0.0),
                **tp.merge_meshes(tp.construct_cube(), quad)), {})]
    _, tr_d, li_d = ts.baseline_scene(1, h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    edges = gold.setup_edges(sg[0][0], tr_d, li_d)
    gcov, ggbuf = gold.rasterize(edges, h, w)
    return (h, w, table, (obj, tr, li), gold.render(sg, tr_d, li_d, h, w),
            (gcov, np.ascontiguousarray(ggbuf.transpose(2, 0, 1))))


@pytest.mark.parametrize("kind", ["shaded", "gbuffer"])
def test_sidelist_32_rows_sorted_equals_mask_and_golden(kind):
    """(d): on 32-row tiles the sorted strategy with the quad's two
    triangles on the side list (K4 or K9 with K10) equals the mask
    strategy (K6, K8), which has no side list, and the golden, bit for
    bit; no drops."""
    h, w, table, (obj, tr, li), (gc, gd), (gcov, ggbuf) = sidelist_scene()
    outs = {}
    for strategy in ("mask", "sorted"):
        if kind == "shaded":
            spec = (trp.ObjSpec(0, obj.num_triangles, False),)
            launch = trp.prepare_raster(table, spec, tr, li, h, w, None, h,
                                        w, 0, 0, strategy, 32)
            cov, z, color, stats = trp.run_shaded(launch, h, w)
            outs[strategy] = (cov.numpy(), z.numpy(), color.numpy())
        else:
            launch = tgb.prepare_gbuffer(table, h, w, None, h, w, 0, 0,
                                         strategy, 32)
            gid, gbuf = launch.run()
            stats = launch.stats()
            outs[strategy] = ((gid[:h, :w] >= 0).numpy(),
                              gbuf[:, :h, :w].numpy())
        assert (launch.route.strategy, launch.route.tile_h) == (strategy,
                                                                 32)
        assert int(stats["bins_dropped"]) == 0
        if strategy == "sorted":
            assert launch.kernel in (trp.raster_narrow_any_kernel,
                                     tgb.raster_pass_queue)
            assert int(launch.qbins.n_large) == 2
    want = (gd > -3.0e38, gd, gc) if kind == "shaded" else (gcov, ggbuf)
    for strategy in ("mask", "sorted"):
        for a, b in zip(outs[strategy], want):
            np.testing.assert_array_equal(
                a.view(np.uint32) if a.dtype == np.float32 else a,
                b.view(np.uint32) if b.dtype == np.float32 else b)
    assert outs["sorted"][0].sum() > 0


@functools.lru_cache(maxsize=None)
def jax_subrect():
    """(e): JAX's render_scene of the two-object mask scene (k6multi, one
    fused launch) into the SUB rect of its 128 x 128 frame, called by
    position."""
    sg, (h, w), dicts = subrect_scene("k6multi", "base")
    scene_j, trj, lij = js.to_jax_scene(sg, *dicts)
    cfgs = tuple(c for _, c in scene_j)
    r0, c0, hs, ws = SUB

    @jax.jit
    def frame(objs, trj, lij):
        return jre.render_scene(jtypes.make_framebuffer(hs, ws),
                                list(zip(objs, cfgs)), trj, lij, "pallas",
                                h, w, r0, c0)

    fb = frame(tuple(o for o, _ in scene_j), trj, lij)
    return np.asarray(fb.color), np.asarray(fb.depth)


def test_render_scene_subrect_vs_jax():
    """(e): the sub-rect frame of the one-launch scene against JAX's
    render_scene with the same origin."""
    _, sub, _ = port_frames("k6multi", "base")
    jc, jd = jax_subrect()
    assert_frame_parity(sub.color.numpy(), sub.depth.numpy(), jc, jd)
    assert (jd > -3.0e38).sum() > 500


def test_render_object_positional_vs_jax():
    """(f): render_object called by position in JAX's order (framebuffer,
    obj, transform, lights, cfg, backend, frame_height, frame_width, row0,
    col0, capacity, stats), object by object into the sub-rect, gives
    JAX's frame; the stats dict at its place collects the drops."""
    _, _, (scene, tr, li, h, w) = port_frames("k6multi", "base")
    r0, c0, hs, ws = SUB
    fb, stats = make_framebuffer(hs, ws, device="cpu"), {}
    for obj, cfg in scene:
        fb = tre.render_object(fb, obj, tr, li, cfg, "kernels", h, w, r0, c0,
                               None, stats)
    jc, jd = jax_subrect()
    assert_frame_parity(fb.color.numpy(), fb.depth.numpy(), jc, jd)
    assert int(stats["bins_dropped"]) == 0
