"""Frames through Renderer that take the G-buffer path (K8, K9 with K10,
the deferred shade; one scene also a fused object on K6) against the
NumPy golden, bit for bit. (Split from tests/test_torch_gbuffer.py, so
that each file keeps under ten cases.)"""

import numpy as np
import pytest

from test_torch_gbuffer import scene_of
from tpu_renderer.golden import cpu_reference as gold
import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401


FRAMES = {  # name -> scene, the kernel of each object's draw
    "config3-avx": ("k6-gbuffer", ["K8"]),
    "sphere-256": ("mixed-gbuffer", ["K9"]),
    "mixed": ("mixed-gbuffer", ["K9", "K6"]),
    "k4-600": ("k4-gbuffer", ["K9"]),
}
# The sphere alone against the golden only: it is the mixed scene's
# G-buffer object, which the mixed frame holds to JAX.
JAX_FRAMES = ["config3-avx", "mixed", "k4-600"]


def frame_scene(name):
    scene, kernels = FRAMES[name]
    sg, (h, w) = scene_of(scene)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    return sg[:len(kernels)], kernels, tr_d, li_d, (h, w)


@pytest.fixture(scope="module", params=list(FRAMES))
def frame(request):
    """The port's frame with the golden's."""
    sg, kernels, tr_d, li_d, (h, w) = frame_scene(request.param)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(h, w, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    return dict(name=request.param, kernels=kernels, scene=(scene, tr, li),
                hw=(h, w), stats=stats,
                port=(fb.color.numpy(), fb.depth.numpy()),
                gold=gold.render(sg, tr_d, li_d, h, w))


def test_frame_route(frame):
    """Each object's draw: the G-buffer objects on K8 (mask) or K9
    (sorted), the fused one on K6; one drawn after the other."""
    scene, tr, li = frame["scene"]
    h, w = frame["hw"]
    for (obj, cfg), kernel in zip(scene, frame["kernels"]):
        if kernel == "K6":
            assert tre._obj_fusable(obj, cfg)
            launch = tre.prepare_scene([(obj, cfg)], tr, li, h, w)
            assert launch.route.strategy == "mask"
            continue
        assert not tre._obj_fusable(obj, cfg)
        table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                     frame_width=w)
        launch = tgb.prepare_gbuffer(table, h, w)
        assert launch.kernel is (tgb.raster_pass if kernel == "K8"
                                 else tgb.raster_pass_queue)
    assert len(scene) == 1 or not tre._scene_batchable(scene)
    assert int(frame["stats"]["bins_dropped"]) == 0


def test_frame_vs_golden(frame):
    np.testing.assert_array_equal(frame["port"][0], frame["gold"][0])
    np.testing.assert_array_equal(frame["port"][1].view(np.uint32),
                                  frame["gold"][1].view(np.uint32))
    assert (frame["port"][1] > -3.0e38).sum() > 1000
