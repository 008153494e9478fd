"""Frames through Renderer that take the G-buffer path against the JAX
package's jitted Renderer(backend="pallas") (interpret mode), within the
budgets of tests/test_parity_jax.py, on tests/test_torch_gbuffer_frames.py's
JAX_FRAMES. (Split from tests/test_torch_gbuffer.py, so that each file
keeps under ten cases.)"""

import numpy as np
import pytest

from test_torch_gbuffer_frames import JAX_FRAMES, frame_scene
from test_torch_render import assert_color_parity, assert_depth_parity
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import scenes as ts
from torch_threads import one_torch_thread  # noqa: F401


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
