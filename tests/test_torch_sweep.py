"""One small scene of each family of the boundary sweep
(tpu_renderer_torch/models/sweep_scenes.py ``cpu_scenes``, fixed seed)
through the JAX package and the port on the CPU.

Each scene is drawn by ``render_scene`` into its rect at its origin of
its frame (the whole frame but for the ragged family), with its mask
capacity, budget factor and zcull: the JAX package's jitted, on its
'pallas' backend (interpret mode, as its own tests run it), the port's
on CPU tensors (the kernels' plain versions). Budgets
(tests/test_parity_jax.py; XLA's CPU backend contracts FMAs, golden
divergence #8): coverage exact, colour mismatch <= 0.2%, depth within
rtol 1e-6 on >= 99.5% of pixels; ``bins_dropped`` and
``bins_real_entries`` equal. A scene that drops nothing is also
bit-equal to the port's NumPy spec. T of 4096 and more and the
2048-slot side list are held on the card only (chip_smoke.py's sweep
phase), against the plain versions.
"""

import jax
import numpy as np
import pytest

from test_torch_render import assert_frame_parity
from tpu_renderer.core.types import make_framebuffer as jmake_framebuffer
from tpu_renderer.engine.renderer import render_scene as jrender_scene
from tpu_renderer.models import scenes as js
from tpu_renderer_torch.core.types import make_framebuffer
from tpu_renderer_torch.engine.renderer import render_scene
from tpu_renderer_torch.golden import cpu_reference as gold
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import sweep_scenes as ss
from torch_threads import one_torch_thread  # noqa: F401


def jax_frame(sc):
    """(color, depth, stats) of the JAX package's jitted render_scene."""
    scene_j, trj, lij = js.to_jax_scene(sc.sg, *sc.camera())
    cfgs = tuple(cfg for _, cfg in scene_j)
    (h, w), (fh, fw), (row0, col0) = sc.hw, sc.frame, sc.origin

    @jax.jit
    def fn(objs, transform, lights):
        stats = {}
        fb = jrender_scene(jmake_framebuffer(h, w), list(zip(objs, cfgs)),
                           transform, lights, "pallas", fh, fw, row0, col0,
                           capacity=sc.capacity, stats=stats,
                           budget_override=sc.budget_override,
                           zcull=sc.zcull)
        return fb, stats

    fb, stats = fn(tuple(o for o, _ in scene_j), trj, lij)
    return (np.asarray(fb.color), np.asarray(fb.depth),
            {k: np.asarray(v) for k, v in stats.items()})


def port_frame(sc):
    """(color, depth, stats) of the port's render_scene on CPU tensors."""
    scene, tr, li = ts.to_torch_scene(sc.sg, *sc.camera(), device="cpu")
    stats = {}
    fb = render_scene(make_framebuffer(*sc.hw, device="cpu"), scene, tr, li,
                      "kernels", sc.frame[0], sc.frame[1], sc.origin[0],
                      sc.origin[1], capacity=sc.capacity, stats=stats,
                      budget_override=sc.budget_override, zcull=sc.zcull)
    return fb.color.numpy(), fb.depth.numpy(), stats


@pytest.mark.parametrize("family", ss.FAMILIES)
def test_family_scene_against_jax(family):
    for sc in ss.cpu_scenes(family):
        assert sc.triangles < ss.FUSED_SETUP_MIN
        color, depth, stats = port_frame(sc)
        jcolor, jdepth, jstats = jax_frame(sc)
        covered = depth > gold.DEPTH_CLEAR
        assert covered.sum() > 300, (sc.name, int(covered.sum()))
        assert_frame_parity(color, depth, jcolor, jdepth)
        for key in ("bins_dropped", "bins_real_entries"):
            if key in jstats or key in stats:
                assert int(stats[key]) == int(jstats[key]), (sc.name, key)
        if sc.exact:
            assert int(stats["bins_dropped"]) == 0
            want = gold.render(sc.sg, *sc.camera(), *sc.frame)
            (h, w), (r0, c0) = sc.hw, sc.origin
            np.testing.assert_array_equal(color, want[0][r0:r0 + h,
                                                         c0:c0 + w])
            np.testing.assert_array_equal(
                depth.view(np.int32),
                want[1][r0:r0 + h, c0:c0 + w].view(np.int32))
        else:
            assert int(stats["bins_dropped"]) > 0
