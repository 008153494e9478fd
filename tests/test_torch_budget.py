"""The sorted strategy's entry budget as a knob: ``budget_factor`` (the
JAX package's ``budget_override``), ``Renderer.calibrate`` and
``calibrate_budget_factor``, against the JAX package.

Scenes, each binning exactly as many real entries as JAX's (the
4,140-triangle sphere of tests/test_torch_render.py does not: ROADMAP
Queue 3): the near/far pair of config 4's sphere (tests/test_torch_zcull.py)
at 128x128, K2's route, two objects under row packing, where the
override is scaled by PACK_ROWS_STREAM_FRAC; config 2's teapot at
256x256, K3's route, one stream. The JAX side renders through its jitted
``Renderer(backend="pallas", budget_factor=...)``. The G-buffer path's
budget is in tests/test_torch_knobs.py.

Bars: the stats equal JAX's (bins_budget_utilization within 1 ulp: XLA
turns the division by the static budget into a product, ROADMAP Queue 3);
fused frames within tests/test_parity_jax.py's budgets, also where entries
drop (the same entries drop in both packages).
"""

import numpy as np
import pytest

from tpu_renderer.engine import renderer as jre
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene

from test_torch_render import assert_frame_parity
from test_torch_zcull import near_far
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32


def both(sg, tr_d, li_d, h, w, **knobs):
    """((port frame, stats), (JAX frame, stats)) as NumPy, ``knobs``
    named as the port's Renderer takes them."""
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, st = trt.Renderer(h, w, device="cpu", **knobs).render(
        scene_t, tr, li, with_stats=True)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb, jst = jre.Renderer(h, w, backend="pallas", **knobs).render(
        scene_j, trj, lij, with_stats=True)
    return ((fb.color.numpy(), fb.depth.numpy(), st),
            (np.asarray(jfb.color), np.asarray(jfb.depth), jst))


def assert_stats_equal(st, jst):
    assert sorted(st) == sorted(jst)
    for key in ("bins_dropped", "bins_real_entries"):
        assert int(st[key]) == int(jst[key]), key
    for key in ("bins_budget_factor", "bins_budget_factor_min"):
        assert st[key] == jst[key], key
    np.testing.assert_array_max_ulp(
        F(st["bins_budget_utilization"]),
        np.asarray(jst["bins_budget_utilization"], F), maxulp=1)


@pytest.mark.parametrize("factor, drops", [(0.1, True), (1.0, False)])
def test_budget_factor_on_k2_route_vs_jax(factor, drops):
    sg, tr_d, li_d = near_far(128, 128)
    (c, d, st), (jc, jd, jst) = both(sg, tr_d, li_d, 128, 128,
                                     budget_factor=factor)
    assert_stats_equal(st, jst)
    assert st["bins_budget_factor"] == factor
    assert (int(st["bins_dropped"]) > 0) == drops
    assert_frame_parity(c, d, jc, jd)


def test_calibrate_vs_jax():
    """Renderer.calibrate on K3's route: margin 0.5 suggests half the
    realized demand, the re-render drops and both packages revert (None,
    budget unchanged); margin 1.25 applies the same factor in both (to
    1 ulp of the utilization). calibrate_budget_factor is
    _suggest_budget_factor of one policy frame's stats in both packages:
    the port's against JAX's on JAX's jitted stats."""
    sg, (h, w) = route_scene("k3")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    r = trt.Renderer(h, w, device="cpu")
    jr = jre.Renderer(h, w, backend="pallas")
    _, jst = jr.render(scene_j, trj, lij, with_stats=True)
    for margin in (0.5, 1.25):
        got = r.calibrate(scene_t, tr, li, margin=margin)
        want = jr.calibrate(scene_j, trj, lij, margin=margin)
        if margin == 0.5:
            assert got is None and want is None
            assert r.budget_factor is None and jr.budget_factor is None
        else:
            assert got == pytest.approx(want, rel=2.4e-7)
            assert r.budget_factor == got and jr.budget_factor == want
            assert got < 2.0  # tighter than the policy factor
    suggestion = tre.calibrate_budget_factor(scene_t, tr, li, h, w)
    assert suggestion == pytest.approx(
        jre._suggest_budget_factor(jst, 1.25), rel=2.4e-7)
    assert suggestion == r.budget_factor


def test_suggest_budget_factor_refusals():
    """The refusals of _suggest_budget_factor, as JAX's: no stream,
    nothing used, or a suggestion at or above the smallest policy
    factor."""
    cases = [
        {"bins_dropped": 0},
        {"bins_budget_utilization": 0.0, "bins_budget_factor": 2,
         "bins_budget_factor_min": 2},
        {"bins_budget_utilization": 0.5, "bins_budget_factor": 4,
         "bins_budget_factor_min": 2},
        {"bins_budget_utilization": 0.5, "bins_budget_factor": 2,
         "bins_budget_factor_min": 2},
    ]
    for stats in cases:
        for margin in (1.0, 1.25):
            assert tre._suggest_budget_factor(stats, margin) == (
                jre._suggest_budget_factor(stats, margin))
