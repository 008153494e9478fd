"""Every route's textured scene (models/route_scenes.py) through Renderer
against the NumPy golden, bit for bit. (Split from tests/
test_torch_texture.py so that each file keeps under ten cases.)"""

import numpy as np
import pytest

from tpu_renderer.golden import cpu_reference as gold
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import TEXTURED_NAMES, route_scene
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", TEXTURED_NAMES)
def test_textured_route_scene_vs_golden(name):
    """Every route's textured scene (models/route_scenes.py): K3, K4, K2
    with two texture widths in one atlas, config 5 in full on K2, K6 with
    one or two filters; bit-exact against the golden."""
    sg, (h, w) = route_scene(name, "textured")
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = trt.Renderer(h, w, device="cpu").render(scene, tr, li)
    gc, gd = gold.render(sg, tr_d, li_d, h, w)
    np.testing.assert_array_equal(fb.color.numpy(), gc)
    np.testing.assert_array_equal(fb.depth.numpy(), gd)
    assert (gd > -3.0e38).sum() > 1000
