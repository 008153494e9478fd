"""Texture sampling (K5's plain version) and the textured setup (K1's uv
fields, the small-object chain) against the JAX package and the golden;
tests/test_torch_texture.py's module docstring states the bars. (Split
from that file so that each file keeps under ten cases.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_texture import (
    F,
    H,
    SIX,
    UV_LANES,
    W,
    assert_setup_vs_golden,
    assert_setup_vs_jax,
    textured_sphere_scene,
)
from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import setup_pallas as jsp
from tpu_renderer.ops import shading as jsh
from tpu_renderer_torch.geometry import vertex as tvx
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.ops import shading as tsh
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[True, False], ids=["phong", "gouraud"])
def k1_case(request):
    """K1's plain version on the textured 4,140-triangle sphere grid, and
    JAX's fused setup kernel (jitted, interpret mode) on the same scene."""
    phong = request.param
    sg, tr_d, li_d = textured_sphere_scene(phong)
    (oj, cj), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    jrecs, _ = jax.jit(jsp.setup_records_fused,
                       static_argnums=(3, 4, 5, 6, 7))(
        oj, trj, lij, cj, 0, H, W, jsp._setup_blk(oj.num_triangles))
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    pre = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=H,
                               frame_width=W)
    return dict(phong=phong, sg=sg, dicts=(tr_d, li_d), T=obj.num_triangles,
                recs=pre.recs.numpy(), jrecs=np.asarray(jrecs))


def test_textured_k1_plain_vs_golden(k1_case):
    T = k1_case["T"]
    assert T == 4140 >= tsp.FUSED_SETUP_MIN
    rows = k1_case["recs"][:T]
    assert_setup_vs_golden(rows, k1_case["sg"][0][0], *k1_case["dicts"],
                           k1_case["phong"])
    assert (rows[:, list(UV_LANES)] != 0).any()


def test_textured_k1_plain_vs_jax(k1_case):
    assert k1_case["recs"].shape == k1_case["jrecs"].shape == (4608, 128)
    assert_setup_vs_jax(k1_case["recs"], k1_case["jrecs"], k1_case["phong"])
    np.testing.assert_array_equal(k1_case["recs"][:, 85:], 0)


@pytest.mark.parametrize("config", [3, 5])
def test_textured_setup_records_vs_jax_and_golden(config):
    """The small-object chain on config 3's bilinear cube and config 5's
    textured quad (with its Gouraud white base): bit-exact against the
    golden, within the lane budgets against JAX's setup_records."""
    sg, tr_d, li_d = js.baseline_scene(config, H, W)
    sg = [e for e in sg if "texture" in e[1]]
    (oj, cj), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    jrec = np.asarray(jax.jit(jvx.setup_records, static_argnums=(3, 4))(
        oj, trj, lij, cj, 0))
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    rec = tvx.setup_records(obj, tr, li, cfg).numpy()
    assert_setup_vs_golden(rec[:84].T.copy(), sg[0][0], tr_d, li_d,
                           cfg.phong)
    assert_setup_vs_jax(rec.T.copy(), jrec.T.copy(), cfg.phong)
    # The white base: the cube's Gouraud colour lanes no longer carry its
    # face colours (config 5's quad is white either way).
    plain = tvx.setup_records(obj, tr, li,
                              dataclasses.replace(cfg, textured=False))
    assert np.array_equal(rec[14:22], plain[14:22].numpy()) == (config == 5)


@pytest.mark.parametrize("filter_mode", ["nearest", "bilinear"])
def test_sample_texture_vs_jax_and_golden(filter_mode):
    """'scalar' sampling of seeded u, v in and beyond [0, 1], with the six
    conversion edge cases in a row of u and a row of v: nearest bit-exact
    against JAX, bilinear against the golden (see the module docstring).
    The golden converts indices through int64, so its nearest index of
    u = +inf is 0 where XLA's (and the port's) is tw - 1: those pixels are
    left out of the golden comparison (ROADMAP Queue 3)."""
    rng = np.random.default_rng(14)
    tex = rng.integers(0, 2 ** 32, (16, 24), dtype=np.uint64).astype(np.uint32)
    u = rng.uniform(-0.3, 1.3, (16, 128)).astype(F)
    v = rng.uniform(-0.3, 1.3, (16, 128)).astype(F)
    u[0, :6] = SIX
    v[1, :6] = SIX
    got, mask = tsh.sample_texture(torch.from_numpy(tex.view(np.int32)),
                                   torch.from_numpy(u), torch.from_numpy(v),
                                   "scalar", filter_mode)
    assert bool(mask.all())
    got = got.numpy()
    jfn = jax.jit(lambda t, a, b: jsh.sample_texture(t, a, b, "scalar",
                                                     filter_mode)[0])
    want = np.asarray(jfn(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
    gwant, _ = gold.sample_texture(tex, u, v, "scalar", filter_mode)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    if filter_mode == "nearest":
        np.testing.assert_array_equal(got, want)
        keep = ~((u == np.inf) | (v == np.inf))[..., None]
        np.testing.assert_array_equal(np.where(keep, got, 0),
                                      np.where(keep, gwant, 0))
    else:
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=0,
                                   atol=2.4e-7)
        np.testing.assert_array_equal(got.view(np.uint32)[~nan],
                                      gwant.view(np.uint32)[~nan])
        np.testing.assert_array_equal(nan, np.isnan(gwant))
