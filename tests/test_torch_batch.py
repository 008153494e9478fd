"""The port's one-launch multi-object scenes (engine.renderer.
prepare_scene): frames against the JAX package and the NumPy
golden, batched against per-object rendering on the port itself, and the
cross-object depth tie (the analogs of tests/test_batch.py). Scenes in
tpu_renderer_torch/models/route_scenes.py:

| Name | Route | Why it routes there |
| --- | --- | --- |
| k4multi | K4, 3 objects | padded T (1,024) * 256 <= H * W: 16-row tiles |
| k2multi | K2, 3 objects | rows 2 with the flat multi-object budget |

The XLA-chain scenes are below 4096 triangles: each object takes
setup_records, padded to 128 rows, and the concatenated table goes
through one K7. The JAX package decides the route on the PADDED total,
and so does the port. Side-list variants: a quad merged into the K4
scene's sphere, and config 5's quad, untextured, as a fourth object; every
scene is held to the golden, the base scenes also to JAX. The JAX side
renders through its jitted Renderer(backend="pallas"), its Pallas
kernels in interpret mode as its own tests run them.

This file holds the scenes' fixtures, the tests against JAX and the
batched ones; each scene's launch and its frame against the golden sit in
test_torch_batch_golden.py, so that each file keeps under ten cases and
pytest-xdist's ``--dist loadfile`` hands both out after
tests/test_parallel.py, the suite's longest file.
"""

import functools

import numpy as np
import pytest

from test_torch_render import assert_frame_parity
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.core.types import make_framebuffer
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.models.route_scenes import route_scene
from torch_threads import one_torch_thread  # noqa: F401


def port_case(route, variant):
    """The port's frame of a scene; each rendered once per process (the
    golden and JAX fixtures share it)."""
    return dict(_port_case(route, variant))


@functools.lru_cache(maxsize=None)
def _port_case(route, variant):
    sg, (h, w) = route_scene(route + "multi", variant)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(h, w, device="cpu").render(
        scene_t, tr, li, with_stats=True)
    return dict(route=route, variant=variant, hw=(h, w), sg=sg,
                dicts=(tr_d, li_d), port=(fb.color.numpy(), fb.depth.numpy()),
                stats=stats, scene=(scene_t, tr, li))


@pytest.fixture(scope="module", params=[
    (r, v) for r in ("k4", "k2") for v in ("base", "sidelist")],
    ids=lambda p: "-".join(p))
def case(request):
    """The port's frame of each scene and its side-list variant, with the
    golden's."""
    out = port_case(*request.param)
    h, w = out["hw"]
    out["gold"] = gold.render(out["sg"], *out["dicts"], h, w)
    return out


@pytest.fixture(scope="module", params=("k4", "k2"))
def jax_case(request):
    """The port's frame of each base scene with the JAX package's, and the
    stats of both."""
    out = port_case(request.param, "base")
    h, w = out["hw"]
    scene_j, trj, lij = js.to_jax_scene(out["sg"], *out["dicts"])
    jfb, jstats = JRenderer(h, w, backend="pallas").render(
        scene_j, trj, lij, with_stats=True)
    out["jax"] = (np.asarray(jfb.color), np.asarray(jfb.depth))
    out["jstats"] = {k: np.asarray(v) for k, v in jstats.items()}
    return out


def test_frame_vs_jax(jax_case):
    assert_frame_parity(*jax_case["port"], *jax_case["jax"])
    assert (jax_case["port"][1] > -3.0e38).sum() > 1000


def test_stats_vs_jax(jax_case):
    stats, jstats = jax_case["stats"], jax_case["jstats"]
    assert int(stats["bins_dropped"]) == int(jstats["bins_dropped"]) == 0
    for key in ("bins_real_entries", "bins_budget_utilization"):
        np.testing.assert_array_equal(np.asarray(stats[key]), jstats[key])
    assert stats["bins_budget_factor"] == jstats["bins_budget_factor"]


def per_object(scene_t, tr, li, h, w):
    fb = make_framebuffer(h, w, device="cpu")
    for obj, cfg in scene_t:
        fb = tre.render_object(fb, obj, tr, li, cfg)
    return fb


@pytest.mark.parametrize("name", ["chain", "fused"])
def test_batched_matches_per_object(name):
    """One launch for the scene equals drawing its objects one by one with
    the strict '>' merge, bit for bit, though the routes differ: the
    setup_records chain (sphere(12) Phong + torus, 512x512: batched K3,
    each object alone K4) and the fused form (sphere grid Phong + sphere(12)
    Gouraud, 128x128: batched K2 with the small object through K7, alone
    K2 and K3)."""
    if name == "chain":
        h = w = 512
        sg = [(dict(p=(-0.2, 0.1, 0.2), **construct_sphere(12)),
               {"phong": True}),
              (dict(p=(0.2, -0.1, 0.0), **tp.construct_torus()), {})]
    else:
        h = w = 128
        sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
               {"phong": True}),
              (dict(p=(0.25, 0.1, 0.1), **construct_sphere(12)), {})]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb_b = trt.render_scene(make_framebuffer(h, w, device="cpu"), scene_t,
                            tr, li)
    fb_s = per_object(scene_t, tr, li, h, w)
    np.testing.assert_array_equal(fb_b.color.numpy(), fb_s.color.numpy())
    np.testing.assert_array_equal(fb_b.depth.numpy(), fb_s.depth.numpy())
    fresh = trt.render_scene(None, scene_t, tr, li, frame_height=h,
                             frame_width=w)
    np.testing.assert_array_equal(fresh.color.numpy(), fb_b.color.numpy())
    assert (fb_b.depth.numpy() > -3.0e38).sum() > 1000


def plane_grid(n: int, size: float, rgba):
    """A flat n x n grid of quads in the xy plane facing +z (2 n^2
    triangles) in one colour."""
    mesh = tp.construct_quad(size / n)
    tiles = []
    for i in range(n):
        for j in range(n):
            m = dict(mesh)
            off = np.float32([(i - (n - 1) / 2) * size / n,
                              (j - (n - 1) / 2) * size / n, 0.0])
            m["vertices"] = (mesh["vertices"] + off).astype(np.float32)
            tiles.append(m)
    out = tp.merge_meshes(*tiles)
    out["colors"] = np.tile(np.float32(rgba), (len(out["vertices"]), 1))
    return out


def test_cross_object_depth_tie_first_object_wins():
    """Two coplanar 578-triangle plane grids at the same depth in one
    launch (K3 at 128x128): the first-submitted object owns every tied
    pixel (global gids follow submission order), as in the golden and
    per-object drawing."""
    h, w = 128, 128
    red = dict(p=(0.0, 0.0, 0.0), **plane_grid(17, 1.5, [1, 0, 0, 1]))
    blue = dict(p=(0.0, 0.0, 0.0), **plane_grid(17, 1.5, [0, 0, 1, 1]))
    sg = [(red, {}), (blue, {})]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    stats = {}
    fb = trt.render_scene(None, scene_t, tr, li, frame_height=h,
                          frame_width=w, stats=stats)
    assert int(stats["bins_dropped"]) == 0
    col, depth = fb.color.numpy(), fb.depth.numpy()
    fb_s = per_object(scene_t, tr, li, h, w)
    np.testing.assert_array_equal(col, fb_s.color.numpy())
    gc, gd = gold.render(sg, tr_d, li_d, h, w)
    assert_frame_parity(col, depth, gc, gd)
    covered = depth > -3.0e38
    r, b = (col[covered] >> 16) & 0xFF, col[covered] & 0xFF
    assert covered.sum() > 1000 and (r >= b).all() and (b == 0).all()
