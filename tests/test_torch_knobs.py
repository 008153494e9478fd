"""The Renderer's knobs besides the budget (tests/test_torch_budget.py):
``clear_color`` and ``capacity``, on the fused, batched and G-buffer
paths, against the JAX package and the NumPy golden; and the G-buffer
path's ``budget_factor``.

The JAX side renders through its jitted ``Renderer(backend="pallas",
...)``. Bars: frames bit-equal to the golden's (``gold.render(...,
clear_color=)``) and within tests/test_parity_jax.py's budgets of JAX's;
stats equal JAX's (bins_budget_utilization within 1 ulp). Coverage
against JAX is held by the depth budget, not exactly: 'avx' coverage
follows u, v to 1 ulp (tests/test_torch_gbuffer.py).
"""

import numpy as np
import pytest

from tpu_renderer.engine import renderer as jre
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene, textured
from tpu_renderer_torch.models.textures import checkerboard

from test_torch_budget import assert_stats_equal, both
from test_torch_render import assert_color_parity, assert_depth_parity
from torch_threads import one_torch_thread  # noqa: F401

CLEAR = 0xFF203040


@pytest.mark.parametrize("name, variant, path", [
    ("k3", "base", "fused, K3"),
    ("k2multi", "textured", "batched, config 5"),
    ("k6", "gbuffer", "G-buffer, config 3 avx"),
])
def test_clear_color_vs_jax_and_golden(name, variant, path):
    """A non-zero clear colour takes the merge path: uncovered pixels keep
    it, covered ones take the draw's colour."""
    sg, (h, w) = route_scene(name, variant)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    (c, d, st), (jc, jd, jst) = both(sg, tr_d, li_d, h, w,
                                     clear_color=CLEAR)
    gc, gd = gold.render(sg, tr_d, li_d, h, w, clear_color=CLEAR)
    np.testing.assert_array_equal(c, gc)
    np.testing.assert_array_equal(d, gd)
    assert_color_parity(c, jc)
    assert_depth_parity(d, jd)
    uncovered = d <= -3.0e38
    assert uncovered.any() and (c[uncovered] == CLEAR).all()
    assert int(st["bins_dropped"]) == int(jst["bins_dropped"]) == 0


@pytest.mark.parametrize("uv_mode", ["none", "avx"])
def test_capacity_below_the_need_vs_jax(uv_mode):
    """A mask-strategy list capacity below the busiest tile's need drops
    the same entries as the JAX package: k6multi's torus and cube (108
    triangles, 8-row tiles) on the fused path (K6, one launch), and with
    an 'avx' texture on the G-buffer path (K8, object by object)."""
    sg, (h, w) = route_scene("k6multi")
    if uv_mode == "avx":
        sg = [textured(e, checkerboard(8, 8, 2), uv_mode="avx") for e in sg]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    (c, d, st), (jc, jd, jst) = both(sg, tr_d, li_d, h, w, capacity=8)
    assert sorted(st) == sorted(jst) == ["bins_dropped"]
    assert int(st["bins_dropped"]) == int(jst["bins_dropped"]) > 0


def test_budget_factor_on_gbuffer_route_vs_jax():
    """The G-buffer path's single stream: the override is the budget. The
    frames are not compared: 'avx' coverage follows u, v to 1 ulp
    (tests/test_torch_gbuffer.py holds it to its own budget)."""
    sg, (h, w) = route_scene("k3", "gbuffer")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    (_, _, st), (_, _, jst) = both(sg, tr_d, li_d, h, w, budget_factor=0.5)
    assert_stats_equal(st, jst)
    assert st["bins_budget_factor"] == 0.5
    assert int(st["bins_dropped"]) > 0
