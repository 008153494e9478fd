"""The stats of scenes that mix mask and sorted draws, against the JAX
package's merge. (Split from tests/test_torch_mask.py so that each file
keeps under ten cases.)"""

import numpy as np
import pytest
import torch

from test_torch_mask import H, W
from tpu_renderer.engine import renderer as jre
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from torch_threads import one_torch_thread  # noqa: F401


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
