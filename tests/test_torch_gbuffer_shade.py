"""The port's deferred shade (``ops.shading.shade``) on JAX's own G-buffer
of config 3's textured cube, against the golden's shade bit for bit and
JAX's jitted shade within the packed-colour budget (tests/
test_torch_gbuffer.py's module docstring). (Split from that file, whose
cached JAX G-buffer it reads, so that each file keeps under ten cases.)"""

import jax
import numpy as np
import pytest
import torch

from test_torch_gbuffer import H, W, jax_case, scene_of
from tpu_renderer.core import math as jm
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import shading as jsh
from tpu_renderer_torch.core.math import pack_argb
from tpu_renderer_torch.core.types import ObjectConfig
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import shading as tsh
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("filter_mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("uv_mode", ["scalar", "avx"])
@pytest.mark.parametrize("phong", [True, False], ids=["phong", "gouraud"])
def test_shade_vs_golden_and_jax(phong, uv_mode, filter_mode):
    """The port's shade and JAX's on JAX's own G-buffer of config 3's
    textured cube, both addressings and filters, Phong and Gouraud."""
    jcov, jgbuf, _ = jax_case("config3-mask")[0]  # config 3's own route
    sg, _ = scene_of("config3")
    tex = sg[0][1]["texture"]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    _, tr, li = ts.to_torch_scene([], tr_d, li_d, device="cpu")
    cfg = ObjectConfig(phong=phong, textured=True, uv_mode=uv_mode,
                       filter_mode=filter_mode)
    rgba, cov = tsh.shade(torch.from_numpy(jcov), torch.from_numpy(jgbuf),
                          tr, li, cfg, torch.from_numpy(tex.view(np.int32)))
    rgba, cov = rgba.numpy(), cov.numpy()
    grgba, gcov = gold.shade(jcov, jgbuf.transpose(1, 2, 0), tr_d, li_d,
                             phong, tex, uv_mode, filter_mode)
    np.testing.assert_array_equal(cov, gcov)
    np.testing.assert_array_equal(rgba.view(np.uint32),
                                  grgba.astype(np.float32).view(np.uint32))
    scene_j, trj, lij = js.to_jax_scene(
        [(sg[0][0], dict(sg[0][1], phong=phong, uv_mode=uv_mode,
                         filter_mode=filter_mode))], tr_d, li_d)
    jcfg = scene_j[0][1]
    jrgba, jcov2 = jax.jit(jsh.shade, static_argnums=(4,))(
        jcov, jgbuf, trj, lij, jcfg, scene_j[0][0].texture)
    np.testing.assert_array_equal(cov, np.asarray(jcov2))
    packed = pack_argb(torch.from_numpy(rgba)).numpy()
    jpacked = np.asarray(jm.pack_argb(jrgba))
    assert (packed[cov] != jpacked[cov]).mean() <= 0.002
    if uv_mode == "avx":
        assert cov.sum() < jcov.sum()  # u, v outside [0, 1] dropped
