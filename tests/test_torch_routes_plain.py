"""The plain versions the route scenes run on CPU tensors (tests/
test_torch_routes.py's scenes and fixtures) count no kernel launch. (Split
from that file so that each file keeps under ten cases.)"""

import tpu_renderer_torch as trt
from test_torch_routes import case  # noqa: F401 (the scenes' fixture)
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401


def test_plain_versions_touch_no_launch_counter(case):
    """CPU tensors run the plain versions, which count no launch."""
    scene_t, tr, li = case["scene"]
    h, w = case["hw"]
    wrappers = list(trp.RASTER_KERNELS.values()) + [
        trp.raster_narrow_any_kernel, trp.finish_records]
    before = [k.launches for k in wrappers]
    trt.render_scene(None, scene_t, tr, li, frame_height=h, frame_width=w)
    assert [k.launches for k in wrappers] == before
