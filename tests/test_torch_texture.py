"""The port's fused texturing (K1's textured fields, K5 in the raster
kernels' finalize) against the JAX package and the NumPy golden.

Inputs come from seeded NumPy generators or the suite's scenes. The JAX
side renders through its jitted Renderer(backend="pallas"), its Pallas
kernels in interpret mode as its own tests run them, each reference once
per module at 128x128; the port runs its kernels' plain versions.

Bars:
- bit-exact against JAX: the saturating ``to_i32`` (XLA's convert),
  ``unpack_argb``, ``pack_texture_atlas``'s offsets, dimensions and
  texels, nearest ``sample_texture``. Bilinear ``sample_texture`` is
  bit-exact against the golden; against JAX it holds to an absolute
  2.4e-7, because XLA's CPU backend contracts the lerp's c0 + f * (c1 -
  c0) into an FMA (golden divergence #8);
- textured setup (``setup_records`` and K1's plain version): every lane
  bit-exact against the golden; against JAX the lane budgets of
  tests/test_torch_setup.py, and the u/z and v/z gradients ug, vg to rtol
  1e-3: XLA contracts u1 - u0 = u_max * (1/z_max) - u0 into an FMA, and
  the difference amplifies the product's rounding; u0, v0, 1/z and its
  gradient exact;
- frames, route asserted: coverage exact, colour mismatch <= 0.2%, depth
  within rtol 1e-6 on >= 99.5% of pixels against JAX; bit-exact against
  the golden.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import assert_frame_parity
from tpu_renderer.core import math as jm
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer.ops import setup_pallas as jsp
from tpu_renderer.ops import shading as jsh
import tpu_renderer_torch as trt
from tpu_renderer_torch.core import math as tm
from tpu_renderer_torch.core.types import make_framebuffer
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.geometry import vertex as tvx
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import TEXTURED_NAMES, route_scene
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.ops import shading as tsh

H = W = 128
F = np.float32
SIX = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2.5], F)


def test_to_i32_saturates_like_xla():
    """Fault 2: f32 -> int32 saturates at the limits (infinities too) and
    maps NaN to 0, as XLA's convert; torch's own cast gives INT_MIN."""
    want = np.asarray(jnp.asarray(SIX).astype(jnp.int32))
    np.testing.assert_array_equal(want, [2 ** 31 - 1, -2 ** 31, 0,
                                         2 ** 31 - 1, -2 ** 31, 2])
    np.testing.assert_array_equal(tm.to_i32(torch.from_numpy(SIX)).numpy(),
                                  want)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(0, 12, 4096)
         ).astype(F)
    np.testing.assert_array_equal(
        tm.to_i32(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_unpack_argb_vs_jax():
    rng = np.random.default_rng(12)
    px = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    px[:4] = [0, 0xFFFFFFFF, 0xFF000000, 0x00FFFFFF]
    want = np.asarray(jm.unpack_argb(jnp.asarray(px)))
    got = tm.unpack_argb(torch.from_numpy(px.view(np.int32)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got], -1),
                                  want)


def test_pack_texture_atlas_vs_jax():
    """Two textures of different widths (tests/test_batch.py:82): the same
    row offsets and atlas dimensions, and texels that decode to JAX's
    channel-blocked atlas entries (zero padding included)."""
    texs = [checkerboard(32, 64, 4), checkerboard(16, 16, 2)]
    rng = np.random.default_rng(13)
    texs.append(rng.integers(0, 2 ** 32, (8, 40), dtype=np.uint64)
                .astype(np.uint32))
    jatlas, joffs = jrp.pack_texture_atlas([jnp.asarray(t) for t in texs])
    atlas, offs = trp.pack_texture_atlas(
        [torch.from_numpy(t.view(np.int32)) for t in texs])
    assert offs == joffs == [0, 32, 48]
    jatlas = np.asarray(jatlas.astype(jnp.float32))
    ah, aw = atlas.shape
    assert (ah, 4 * aw) == jatlas.shape == (56, 4 * 64)
    specs = [trp.ObjSpec(0, 1, False, (o, t.shape[0], t.shape[1]))
             for o, t in zip(offs, texs)]
    assert trp._atlas_dims(specs) == jrp._atlas_dims(specs) == (56, 64)
    p = atlas.to(torch.int64) & 0xFFFFFFFF
    for c, shift in enumerate((16, 8, 0, 24)):  # r, g, b, a blocks
        np.testing.assert_array_equal(
            ((p >> shift) & 0xFF).numpy().astype(F),
            jatlas[:, c * aw:(c + 1) * aw])


@pytest.mark.parametrize("specs", [
    ((0, 10, False, None),),
    ((0, 10, True, None),),
    ((0, 10, False, (0, 16, 16)),),
    ((0, 10, True, (0, 16, 16, "bilinear")),),
    ((0, 10, True, None), (10, 20, False, (0, 16, 16)),
     (20, 30, False, None)),
    ((0, 2, False, (0, 32, 32)), (128, 130, False, (32, 32, 32,
                                                     "bilinear"))),
])
def test_scene_fields_vs_jax(specs):
    """The planes a scene's finalize reads, and their offsets, as JAX's
    _scene_fields; the same from a launch's tables (launch_fields)."""
    want = jrp._scene_fields(tuple(jrp.ObjSpec(*o) for o in specs))
    ours = tuple(trp.ObjSpec(*o) for o in specs)
    assert trp._scene_fields(ours) == want
    objs = trp.obj_table(ours, torch.device("cpu"))
    assert trp.launch_fields(objs, trp.tex_table(ours, objs.device)) == want
    assert [o.bilinear for o in ours] == [
        jrp.ObjSpec(*o).bilinear for o in specs]


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


# ---------------------------------------------------------------------------
# Textured setup: K1's plain version and the small-object chain
# ---------------------------------------------------------------------------

UV_LANES = range(7, 13)  # oz0, ozg, u0, ug, v0, vg


def assert_setup_vs_golden(rows, obj_d, tr_d, li_d, phong):
    """rows: (T, 85) record rows; every lane bit-exact against the golden's
    textured edge setup."""
    ge = gold.setup_edges(obj_d, tr_d, li_d, phong=phong, textured=True)
    names = ["valid", "ymin", "ymax", "x0", "xg", "z0", "zg", "oz0", "ozg",
             "u0", "ug", "v0", "vg", "left"]
    vec = (("col0", 14, 4), ("colg", 18, 4), ("n0", 22, 3), ("ng", 25, 3))
    for e in range(3):
        v = ge["valid"][:, e]
        for f, name in enumerate(names):
            want = np.where(v, ge[name][:, e], 0).astype(F)
            np.testing.assert_array_equal(rows[:, e * 28 + f].view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"edge {e} {name}")
        for name, off, c in vec:
            want = np.where(v[:, None], ge[name][:, e], 0).astype(F)
            np.testing.assert_array_equal(
                rows[:, e * 28 + off:e * 28 + off + c].view(np.uint32),
                want.view(np.uint32), err_msg=f"edge {e} {name}")


def assert_setup_vs_jax(rows, jrows, phong):
    """The lane budgets of tests/test_torch_setup.py (x0 rtol 1e-6, xg rtol
    2e-2, Gouraud colour lanes rtol 1e-6 / colg atol 2.4e-7) and ug, vg
    rtol 1e-3, all from XLA's FMA contraction; every other lane exact."""
    for lane in range(85):
        a, b = rows[:, lane], jrows[:, lane]
        e, f = divmod(lane, 28)
        rtol = {3: 1e-6, 4: 2e-2, 10: 1e-3, 12: 1e-3}.get(f) if (
            lane < 84) else None
        if not phong and lane < 84 and 14 <= f < 22:
            rtol = 1e-6
        if rtol is None:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32),
                                          err_msg=f"lane {lane}")
        else:
            atol = 2.4e-7 if 18 <= f < 22 else 0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"lane {lane}")


def textured_sphere_scene(phong, filter_mode="bilinear"):
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    cfg = {"phong": phong, "texture": checkerboard(16, 16, 2),
           "filter_mode": filter_mode}
    return [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
             cfg)], tr_d, li_d


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


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

FRAMES = {  # name -> (scene_golden, (strategy, tile_h, rows), K1 or chain)
    "config3": lambda: (js.baseline_scene(3, H, W)[0], ("mask", 16, 1)),
    "config5": lambda: (js.baseline_scene(5, H, W)[0], ("sorted", 8, 2)),
    "sphere-gouraud": lambda: (textured_sphere_scene(False)[0],
                               ("sorted", 8, 2)),
    "sphere-phong": lambda: (textured_sphere_scene(True)[0],
                             ("sorted", 8, 2)),
    "mixed-filters": lambda: (route_scene("k6multi", "textured")[0],
                              ("mask", 8, 1)),
}


@pytest.fixture(scope="module", params=list(FRAMES))
def frame(request):
    """The port's frame of each scene with the golden's and JAX's."""
    sg, route = FRAMES[request.param]()
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb, stats = trt.Renderer(H, W, device="cpu").render(scene, tr, li,
                                                        with_stats=True)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb = JRenderer(H, W, backend="pallas").render(scene_j, trj, lij)
    return dict(name=request.param, route=route, stats=stats,
                launch=tre.prepare_scene(scene, tr, li, H, W),
                port=(fb.color.numpy(), fb.depth.numpy()),
                jax=(np.asarray(jfb.color), np.asarray(jfb.depth)),
                gold=gold.render(sg, tr_d, li_d, H, W))


def test_frame_route(frame):
    """The fused route the JAX gates pick, with the textures in the atlas
    and the Renderer's frame that launch's output."""
    launch = frame["launch"]
    r = launch.route
    assert (r.strategy, r.tile_h, r.rows) == frame["route"]
    texs = launch.texs.numpy()
    assert (texs[:, 1] > 0).any()
    z, _, color = (a[:H, :W].numpy() for a in launch.run())
    np.testing.assert_array_equal(color, frame["port"][0])
    np.testing.assert_array_equal(z, frame["port"][1])
    assert int(frame["stats"]["bins_dropped"]) == 0


def test_frame_vs_jax(frame):
    assert_frame_parity(*frame["port"], *frame["jax"])
    assert (frame["port"][1] > -3.0e38).sum() > 1000


def test_frame_vs_golden(frame):
    np.testing.assert_array_equal(frame["port"][0], frame["gold"][0])
    np.testing.assert_array_equal(frame["port"][1], frame["gold"][1])


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


def test_batched_textures_match_per_object():
    """One launch with two textures of different widths and a shared one
    equals drawing the objects one by one, bit for bit; the shared texture
    enters the atlas once."""
    tex_a, tex_b = checkerboard(32, 64, 4), checkerboard(16, 16, 2)
    quad = tp.construct_quad(0.8)
    sg = [(dict(p=(-0.3, -0.2, 0.0), **quad), {"texture": tex_a}),
          (dict(p=(0.3, 0.2, 0.1), **quad),
           {"texture": tex_b, "filter_mode": "bilinear"}),
          (dict(p=(0.0, 0.0, -0.2), **tp.construct_sphere_grid(10, 10)),
           {"phong": True})]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    scene.append((scene[0][0]._replace(p=scene[0][0].p + 0.45),
                  scene[0][1]))  # shares the first object's texture
    launch = tre.prepare_scene(scene, tr, li, H, W)
    np.testing.assert_array_equal(
        launch.texs.numpy(),
        [[0, 32, 64, 0], [32, 16, 16, 1], [0, 0, 0, 0], [0, 32, 64, 0]])
    assert tuple(launch.operands[-1].shape) == (48, 64)
    fb = trt.render_scene(make_framebuffer(H, W, device="cpu"), scene, tr,
                          li)
    fb_s = make_framebuffer(H, W, device="cpu")
    for obj, cfg in scene:
        fb_s = tre.render_object(fb_s, obj, tr, li, cfg)
    np.testing.assert_array_equal(fb.color.numpy(), fb_s.color.numpy())
    np.testing.assert_array_equal(fb.depth.numpy(), fb_s.depth.numpy())
    assert (fb.color.view(torch.int32).numpy() != 0).sum() > 1000


def test_atlas_over_the_limit_draws_objects_one_by_one():
    """Two 128x128 textures make a 256x128 atlas, over the fused limit:
    the scene draws object by object (each fits alone), as the JAX
    package's render_scene does."""
    tex = [checkerboard(128, 128, 8), checkerboard(128, 128, 16)]
    quad = tp.construct_quad(0.8)
    sg = [(dict(p=(-0.3, 0.0, 0.0), **quad), {"texture": tex[0]}),
          (dict(p=(0.3, 0.0, 0.1), **quad), {"texture": tex[1]})]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    assert not tre._scene_batchable(scene)
    fb = trt.Renderer(H, W, device="cpu").render(scene, tr, li)
    gc, gd = gold.render(sg, tr_d, li_d, H, W)
    np.testing.assert_array_equal(fb.color.numpy(), gc)
    np.testing.assert_array_equal(fb.depth.numpy(), gd)
