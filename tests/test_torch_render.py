"""The port's whole slice (setup -> binning -> raster + shade) vs the JAX
package and the NumPy golden.

Scene: construct_sphere_grid(46, 45), 4,140 triangles of dense Phong at
128x128 with the baseline_scene(4) camera and its 2 lights, which routes
K1 -> sorted -> 8-row tiles -> row packing 2 (asserted below). Its
side-list variant merges a 1.2-unit quad into the object, so two large
triangles take the side list. The JAX side renders through its jitted
Renderer(backend="pallas"), its Pallas kernels in interpret mode as its
own tests run them; the port runs its kernels' plain
versions.

Budgets (tests/test_parity_jax.py; XLA's CPU backend contracts FMAs,
golden divergence #8): coverage exact, color mismatch <= 0.2%, depth
within rtol 1e-6 on >= 99.5% of pixels; equal bins_dropped.

This file holds the shared helpers and the sphere's tests; the side-list
variant, sub-rects and routes sit in test_torch_render_sidelist.py, the
device defaults in test_torch_render_device.py, so that each file keeps
under ten cases and pytest-xdist's ``--dist loadfile`` hands them out
after tests/test_parallel.py, the suite's longest file.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import shading as jsh
from tpu_renderer.ops import setup_pallas as jsp
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.ops import shading as tsh
from tpu_renderer_torch.ops.setup import SetupOut
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
F = np.float32


def assert_depth_parity(jd, gd, flip_budget=0.005):
    """Depth must be bit-exact or within ~1 ulp everywhere except a tiny
    budget of structural flips (a razor-edge boundary pixel covered by one
    path only, or a depth tie resolved to a different fragment) caused by
    XLA CPU's FMA contraction of interpolation math."""
    ok = (jd == gd) | np.isclose(jd, gd, rtol=1e-6, atol=0.0)
    frac = 1.0 - ok.mean()
    assert frac <= flip_budget, f"depth structural-flip fraction {frac:.4%}"


def assert_color_parity(jc, gc, budget=0.002):
    frac = 1.0 - (jc == gc).mean()
    assert frac <= budget, f"color mismatch fraction {frac:.4%}"


def assert_frame_parity(color, depth, ref_color, ref_depth):
    np.testing.assert_array_equal(depth > -3.0e38, ref_depth > -3.0e38)
    assert_color_parity(color, ref_color)
    assert_depth_parity(depth, ref_depth)


def mesh_for(variant):
    sphere = tp.construct_sphere_grid(46, 45)
    if variant == "sidelist":
        return tp.merge_meshes(sphere, tp.construct_quad(1.2))
    return sphere


def golden_scene(variant, phong=True):
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    return [(dict(p=(0.0, 0.0, 0.0), **mesh_for(variant)),
             {"phong": phong})], tr_d, li_d


@functools.lru_cache(maxsize=None)
def jax_setup(variant):
    """JAX's fused setup kernel (jitted, interpret mode) on the scene of
    ``variant``: (recs, bbox 5-tuple) as NumPy arrays. Computed once per
    process and shared with tests/test_torch_binning.py."""
    sg, tr_d, li_d = golden_scene(variant)
    (oj, cj), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    recs, bbox = jax.jit(jsp.setup_records_fused,
                         static_argnums=(3, 4, 5, 6, 7))(
        oj, trj, lij, cj, 0, H, W, jsp._setup_blk(oj.num_triangles))
    return np.asarray(recs), tuple(np.asarray(a) for a in bbox)


def make_case(variant):
    """The port's frame of a variant with the golden's and JAX's, JAX's
    stats and setup table."""
    sg, tr_d, li_d = golden_scene(variant)
    gc, gd = gold.render(sg, tr_d, li_d, H, W)

    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb, jstats = JRenderer(H, W, backend="pallas").render(
        scene_j, trj, lij, with_stats=True)
    jrecs, jbbox = jax_setup(variant)

    scene_t, trt_, lit = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(H, W, device="cpu").render(
        scene_t, trt_, lit, with_stats=True)
    return dict(
        variant=variant, gold=(gc, gd),
        jax=(np.asarray(jfb.color), np.asarray(jfb.depth)),
        jstats={k: np.asarray(v) for k, v in jstats.items()},
        jsetup=(jrecs, list(jbbox)),
        port=(fb.color.numpy(), fb.depth.numpy()), stats=stats,
        scene=(scene_t, trt_, lit),
    )


@pytest.fixture(scope="module", params=["sphere"])
def case(request):
    """The sphere (its side-list variant: test_torch_render_sidelist.py)."""
    return make_case(request.param)


def test_route(case):
    scene_t, tr, li = case["scene"]
    obj, cfg = scene_t[0]
    T = obj.num_triangles
    assert T >= tsp.FUSED_SETUP_MIN  # K1, not the small-T setup chain
    r = trp.raster_route(T, H, W)
    assert (r.strategy, r.tile_h, r.rows) == ("sorted", 8, 2)
    pre = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=H,
                               frame_width=W)
    qbins, lcounts = trp.bin_for_raster(pre.bbox, r, H, W)
    n_large = int(qbins.n_large)
    if case["variant"] == "sidelist":
        assert n_large == 2 and int(lcounts.sum()) > 0
    else:
        assert n_large == 0 and int(lcounts.sum()) == 0


def test_frame_vs_jax(case):
    assert_frame_parity(*case["port"], *case["jax"])
    cov = (case["port"][1] > -3.0e38).sum()
    assert cov >= 2174  # the sphere alone covers 2,174 px


def test_frame_vs_golden(case):
    assert_frame_parity(*case["port"], *case["gold"])


def test_stats_vs_jax(case):
    assert int(case["stats"]["bins_dropped"]) == 0
    assert int(case["stats"]["bins_dropped"]) == int(
        case["jstats"]["bins_dropped"])
    assert case["stats"]["bins_budget_factor"] == case["jstats"][
        "bins_budget_factor"]


def test_raster_on_jax_setup(case):
    """K2's module in isolation: the JAX package's own record table and
    bboxes go through the port's binning + raster; the frame must match
    JAX's within the budgets and the binning stats exactly."""
    _, tr, li = case["scene"]
    recs, bbox = case["jsetup"]
    T = case["scene"][0][0][0].num_triangles
    pre = SetupOut(torch.tensor(recs),
                   (torch.tensor(bbox[0]),) + tuple(
                       torch.tensor(a) for a in bbox[1:]), T)
    cov, z, color, stats = trp.rasterize_shaded(pre, tr, li, True, H, W)
    assert_frame_parity(color.numpy(), z.numpy(), *case["jax"])
    for key in ("bins_dropped", "bins_real_entries"):
        assert int(stats[key]) == int(case["jstats"][key]), key
    np.testing.assert_array_equal(
        stats["bins_budget_utilization"].numpy(),
        case["jstats"]["bins_budget_utilization"])


@pytest.mark.parametrize("phong", [True, False])
def test_shade_and_pack_planes_vs_jax(phong):
    """shade_planes on seeded planes: to rtol 1e-5 against JAX (XLA
    contracts the unrolled dots), packed colors equal on >= 99.8%."""
    rng = np.random.default_rng(5)
    shape = (8, 128)
    z = rng.uniform(2.6, 3.4, shape).astype(F) - F(3)
    col = [rng.uniform(0, 1, shape).astype(F) for _ in range(4)]
    nrm = [rng.normal(size=shape).astype(F) for _ in range(3)]
    px = np.broadcast_to(np.arange(128, dtype=F), shape)
    py = np.broadcast_to(np.arange(8, dtype=F)[:, None], shape)
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    cam = [tr_d["distance_above_target"], tr_d["focal_length"],
           tr_d["meters_to_pixels"], *tr_d["screen_center"]]
    lp, lint = li_d["light_p"], li_d["light_intensity"]

    def run(mod, conv, scal):
        out = mod.shade_planes(
            conv(z), [conv(c) for c in col], [conv(n) for n in nrm],
            conv(px), conv(py), tuple(scal(c) for c in cam),
            tuple(scal(a) for a in li_d["ambient"]),
            [tuple(scal(v) for v in p) for p in lp],
            [tuple(scal(v) for v in i) for i in lint], phong, 2)
        return out, mod.pack_argb_planes(*out)

    j_rgba, j_pack = run(jsh, jax.numpy.asarray, F)
    t_rgba, t_pack = run(tsh, lambda a: torch.tensor(np.array(a)),
                         lambda v: torch.tensor(F(v)))
    for a, b in zip(t_rgba, j_rgba):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert (t_pack.numpy() == np.asarray(j_pack)).mean() >= 0.998


def test_gouraud_frame_vs_golden():
    sg, tr_d, li_d = golden_scene("sphere", phong=False)
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = trt.Renderer(H, W, device="cpu").render(scene_t, tr, li)
    assert_frame_parity(fb.color.numpy(), fb.depth.numpy(), gc, gd)


def test_objects_drawn_in_order_vs_golden():
    """Two objects over one z-buffer (one batched launch): the second
    loses depth ties to the first, as the golden's strict '>' test has
    it."""
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    mesh = tp.construct_sphere_grid(46, 45)
    sg = [(dict(p=(-0.25, 0.0, 0.0), **mesh), {"phong": True}),
          (dict(p=(0.25, 0.1, -0.1), **mesh), {"phong": False})]
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    stats = {}
    fb = trt.render_scene(None, scene_t, tr, li, frame_height=H,
                          frame_width=W, stats=stats)
    assert_frame_parity(fb.color.numpy(), fb.depth.numpy(), gc, gd)
    assert int(stats["bins_dropped"]) == 0
    assert int(stats["bins_real_entries"]) > 0
