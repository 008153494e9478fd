"""The port's entry points and public constructors default to the card and
raise without one unless the caller asks for the CPU. (Split from tests/
test_torch_render.py so that each file keeps under ten cases.)"""

import pytest
import torch

from test_torch_render import golden_scene
import tpu_renderer_torch as trt
from tpu_renderer_torch.core import types as tt
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from torch_threads import one_torch_thread  # noqa: F401


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    """Renderer and to_torch_scene default to the card and raise without
    one; device='cpu' runs the plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trt.Renderer(8, 8)
    sg, tr_d, li_d = golden_scene("sphere")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.to_torch_scene(sg, tr_d, li_d)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = trt.Renderer(8, 8, device="cpu").render(scene_t, tr, li)
    assert fb.color.shape == (8, 8) and fb.color.device.type == "cpu"


@pytest.mark.parametrize("make", [
    lambda **kw: tt.make_transform(3.0, 1.0, 300.0, (4.0, 4.0), **kw),
    lambda **kw: tt.make_lights((0.3,) * 4, [(2.0, 2.0, 1.0)],
                                [(0.8,) * 4], **kw),
    lambda **kw: tt.make_object((0.0, 0.0, 0.0),
                                **tp.construct_quad(1.0), **kw),
    lambda **kw: tt.make_framebuffer(8, 8, **kw),
], ids=["make_transform", "make_lights", "make_object", "make_framebuffer"])
def test_constructors_need_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                           make):
    """The public constructors default to the card as the entry points
    do: without one they raise unless given device='cpu', and a scene
    built from their defaults never renders on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    leaves = [t for t in torch.utils._pytree.tree_leaves(make(device="cpu"))
              if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
