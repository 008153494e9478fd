"""The port's routes off the headline frame with one object, or with K1
and a small object in one launch: whole frames against the JAX package and
the NumPy golden (scenes in models/route_scenes.py).

| Name | Route | Why it routes there |
| --- | --- | --- |
| k3 | K1 -> K3 | T * 12 < H * W: rows 1; T >= 4096: K1 |
| k4 | setup_records -> K7 -> K4 | T * 256 <= H * W: 16-row tiles; T > 512: sorted |
| mixed | K1 + small object via K7 -> K2 | total T >= 4096: K1 for the sphere grid, the cube through setup_records, K7 and triangle_bbox_rows |

Each has a side-list variant with a large quad merged into one object's
mesh, so that n_large > 0 under the route's expansion; every scene is held
to the golden, the base scenes also to JAX. The JAX side renders
through its jitted Renderer(backend="pallas"), its Pallas kernels in
interpret mode as its own tests run them; the port runs
its kernels' plain versions. Budgets (tests/test_parity_jax.py): coverage
exact, colour mismatch <= 0.2%, depth within rtol 1e-6 on >= 99.5% of
pixels; bins_dropped equal.

This file holds the scenes' fixtures and the tests against JAX; the others
sit in files of at most nine cases, which pytest-xdist's ``--dist
loadfile`` hands out after tests/test_parallel.py, the suite's longest
file: test_torch_routes_launch.py (each scene's launch),
test_torch_routes_golden.py (the frames against the golden) and
test_torch_routes_plain.py (no launch counted on the CPU).
"""

import functools

import numpy as np
import pytest

from test_torch_render import assert_frame_parity
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.models.route_scenes import route_scene
from torch_threads import one_torch_thread  # noqa: F401


def port_case(route, variant):
    """The port's frame of a scene; each rendered once per process (the
    golden and JAX fixtures share it)."""
    return dict(_port_case(route, variant))


@functools.lru_cache(maxsize=None)
def _port_case(route, variant):
    sg, (h, w) = route_scene(route, variant)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(h, w, device="cpu").render(
        scene_t, tr, li, with_stats=True)
    return dict(route=route, variant=variant, hw=(h, w), sg=sg,
                dicts=(tr_d, li_d), port=(fb.color.numpy(), fb.depth.numpy()),
                stats=stats, scene=(scene_t, tr, li))


@pytest.fixture(scope="module", params=[
    (r, v) for r in ("k3", "k4", "mixed") for v in ("base", "sidelist")],
    ids=lambda p: "-".join(p))
def case(request):
    """The port's frame of each scene and its side-list variant, with the
    golden's."""
    out = port_case(*request.param)
    h, w = out["hw"]
    out["gold"] = gold.render(out["sg"], *out["dicts"], h, w)
    return out


@pytest.fixture(scope="module", params=("k3", "k4", "mixed"))
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
    """Equal drops (none); the K3 and K4 scenes also bin exactly as many
    real entries as JAX. The sphere grid of the mixed scene does not: JAX's
    K1 bboxes call 11 degenerate pole triangles valid (ROADMAP Queue 3)."""
    stats, jstats = jax_case["stats"], jax_case["jstats"]
    assert int(stats["bins_dropped"]) == int(jstats["bins_dropped"]) == 0
    assert stats["bins_budget_factor"] == jstats["bins_budget_factor"]
    if jax_case["route"] != "mixed":
        assert int(stats["bins_real_entries"]) == int(
            jstats["bins_real_entries"])


def test_setup_forms_give_one_frame():
    """Config 2's teapot through K1 (a SetupOut padded to 5,632 rows) and
    through setup_records + K7 (5,428 rows, so another entry budget): the
    same K3 frame, bit for bit."""
    from tpu_renderer_torch.geometry.vertex import setup_records

    sg, (h, w) = route_scene("k3", "base")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene_t[0]
    outs = []
    for table in (tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                       frame_width=w),
                  setup_records(obj, tr, li, cfg)):
        _, z, color, stats = trp.rasterize_shaded(table, tr, li, cfg.phong,
                                                  h, w)
        assert int(stats["bins_dropped"]) == 0
        outs.append((z.numpy(), color.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert (outs[0][0] > -3.0e38).sum() > 1000


SUBRECT = {"k3": (150, 200), "k4": (300, 300)}  # wide enough for side lists


@pytest.mark.parametrize("route", ["k3", "k4"])
def test_subrect_origin_equals_full_frame_on_route(route):
    """A sub-rectangle off the tile grid, rasterized at its origin (row0,
    col0) of the frame through the route's single stream, holds the full
    frame's pixels (side-list triangles included)."""
    sg, (h, w) = route_scene(route, "sidelist")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene_t[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    _, z, color, _ = trp.rasterize_shaded(table, tr, li, cfg.phong, h, w)
    r0, c0 = 37, 21
    hs, ws = SUBRECT[route]
    launch = trp.prepare_raster(
        table, (trp.ObjSpec(0, obj.num_triangles, cfg.phong),), tr, li, hs,
        ws, None, h, w, r0, c0)
    assert launch.route.rows == 1 and int(launch.qbins.n_large) > 0
    _, zs, cs, _ = trp.rasterize_shaded(table, tr, li, cfg.phong, hs, ws,
                                        None, h, w, r0, c0)
    np.testing.assert_array_equal(zs.numpy(), z[r0:r0 + hs, c0:c0 + ws].numpy())
    np.testing.assert_array_equal(cs.numpy(),
                                  color[r0:r0 + hs, c0:c0 + ws].numpy())
