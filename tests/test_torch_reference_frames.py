"""The 'reference' backend (``Renderer(backend="reference")``: setup_triangles
-> rasterize_reference -> shade -> pack -> merge, object by object) on the
suite's configs 1-5 and config 3 with 'avx' addressing, against the JAX
package's default backend (its jitted ``Renderer(backend="reference")``)
and the NumPy golden.

Bars: bit-exact against the golden; against JAX the budgets of
tests/test_parity_jax.py (coverage exact, colour mismatch <= 0.2%, depth
within rtol 1e-6 on >= 99.5% of pixels), except 'avx' coverage, which
follows u, v to 1 ulp and is held by the depth budget alone.
"""

import numpy as np
import pytest

from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import scenes as ts

from test_torch_render import (
    assert_color_parity,
    assert_depth_parity,
    assert_frame_parity,
)
from torch_threads import one_torch_thread  # noqa: F401

H, W = 96, 128


def config_scene(name):
    config = int(name[-1]) if name[-1].isdigit() else 3
    sg, tr_d, li_d = js.baseline_scene(config, H, W)
    if name == "config3-avx":
        sg = [(sg[0][0], dict(sg[0][1], uv_mode="avx"))]
    return sg, tr_d, li_d


@pytest.mark.parametrize("name", ["config1", "config2", "config3",
                                  "config4", "config5", "config3-avx"])
def test_reference_backend_vs_jax_and_golden(name):
    sg, tr_d, li_d = config_scene(name)
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(H, W, device="cpu", backend="reference").render(
        scene_t, tr, li, with_stats=True)
    assert stats == {}  # the reference rasterizer bins nothing
    color, depth = fb.color.numpy(), fb.depth.numpy()
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    np.testing.assert_array_equal(color, gc)
    np.testing.assert_array_equal(depth.view(np.uint32), gd.view(np.uint32))
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb = JRenderer(H, W).render(scene_j, trj, lij)
    jc, jd = np.asarray(jfb.color), np.asarray(jfb.depth)
    if name.endswith("avx"):
        assert_color_parity(color, jc)
        assert_depth_parity(depth, jd)
    else:
        assert_frame_parity(color, depth, jc, jd)
    assert (depth > -3.0e38).sum() > 300


def test_reference_backend_equals_kernels_backend():
    """Both backends draw the same frame (config 3: the bilinear-textured
    cube, K6 with K5 on the kernels backend)."""
    sg, tr_d, li_d = config_scene("config3")
    scene_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    frames = [trt.Renderer(H, W, device="cpu", backend=b).render(
        scene_t, tr, li) for b in ("kernels", "reference")]
    np.testing.assert_array_equal(frames[0].color.numpy(),
                                  frames[1].color.numpy())
    np.testing.assert_array_equal(frames[0].depth.numpy(),
                                  frames[1].depth.numpy())
    with pytest.raises(ValueError, match="unknown backend"):
        trt.Renderer(H, W, device="cpu", backend="pallas")
