"""The port's CUDA kernels against their plain-PyTorch versions on the card:
K1 (setup, untextured and textured), K2 / K3 / K4 (raster + shade of the
sorted strategy, single and multi-object; K4 also on 32-row tiles), K6
(the mask strategy, 8- to 64-row tiles folded strip by strip, at every
strip height), K5
(texture sampling, inside each route's finalize), K7 (record
transpose), K8 / K9 / K10 (raster into a G-buffer: mask, sorted, side
list; 8-, 16- and 32-row tiles, K8 also 64), K4 and K9 + K10 in the band
form (24 to 64 rows), K11 (the occlusion skip on K2's and
K3's routes), K2 / K3 / K4 and K9 split into parts of 1, 16 and the
default number of entries merged by the (z, gid) key, and whole frames
on the card against the CPU run, with the
Renderer's knobs (clear_color, capacity, budget_factor, calibrate,
zcull), the 'reference' backend and sub-rects at an origin; with two
cards or more, frames rendered on cuda:1 while cuda:0 is current (the
K1 + K2, K7 + K4, K8 and K9 + K10 routes) against cuda:0's, and
``dryrun_multichip`` over NCCL, one rank a card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX, so it also runs on a machine that has only torch; there,
run it without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Bar: bit equality. The kernels are built without FMA contraction and with
IEEE division and square root, in the plain versions' f32 op order.
"""

import numpy as np
import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from tpu_renderer_torch.models.route_scenes import (
    GBUFFER_NAMES,
    MASK_NAMES,
    ROUTE_NAMES,
    TEXTURED_NAMES,
    route_scene,
    torch_scene,
    zcull_stack,
)
from tpu_renderer_torch.models.textures import checkerboard

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(variant, h, w, device, lat=46, lon=45, phong=True):
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    mesh = tp.construct_sphere_grid(lat, lon)
    if variant == "sidelist":
        mesh = tp.merge_meshes(mesh, tp.construct_quad(1.2))
    sg = [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": phong})]
    return ts.to_torch_scene(sg, tr_d, li_d, device=device)


def bits(t):
    return t.view(torch.int32) if t.dtype in (torch.float32, torch.uint32) else t


@pytest.mark.parametrize("phong", [True, False])
@pytest.mark.parametrize("variant", ["sphere", "sidelist"])
def test_kernels_equal_plain(cuda, variant, phong):
    h = w = 128
    sc, tr, li = scene(variant, h, w, cuda, phong=phong)
    obj, cfg = sc[0]
    params = tsp.setup_params(obj.p, tr, li)
    tp_ = 4608
    kw = dict(n_lights=li.count, phong=phong, gid0=0, frame_height=h,
              frame_width=w, tp=tp_)
    args = (params, obj.vertices, obj.colors, obj.normals)
    n0 = tsp.setup_kernel.launches
    recs_k, bbox_k = tsp.setup_kernel(*args, **kw)
    assert tsp.setup_kernel.launches == n0 + 1
    recs_p, bbox_p = tsp.setup_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(bits(recs_k), bits(recs_p))
    assert torch.equal(bits(bbox_k), bits(bbox_p))

    T = obj.num_triangles
    pre = tsp.SetupOut(recs_k, (bbox_k[0] > 0.5,) + tuple(bbox_k[1:5]), T)
    launch = trp.prepare_raster(pre, (trp.ObjSpec(0, T, phong),), tr, li,
                                h, w)
    assert launch.kernel is trp.raster_kernel
    if variant == "sidelist":
        assert int(launch.qbins.n_large) == 2
    n0 = trp.raster_kernel.launches
    out_k = launch.run()
    assert trp.raster_kernel.launches == n0 + 1
    out_p = launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert int((out_k[1] >= 0).sum()) >= 2174


@pytest.mark.parametrize("variant", ["sphere", "sidelist"])
def test_slice_on_card_equals_cpu(cuda, variant):
    """The whole slice on the card (kernels) equals the CPU run (plain
    versions), which the CPU tests hold to the JAX package and the golden."""
    h = w = 128
    fbs = []
    for dev in ("cpu", cuda):
        sc, tr, li = scene(variant, h, w, dev)
        fbs.append(trt.Renderer(h, w, device=dev).render(sc, tr, li))
    torch.cuda.synchronize()
    cpu, gpu = fbs
    np.testing.assert_array_equal(gpu.depth.cpu().numpy(), cpu.depth.numpy())
    np.testing.assert_array_equal(gpu.color.view(torch.int32).cpu().numpy(),
                                  cpu.color.view(torch.int32).numpy())


def test_subrect_origin_on_card(cuda):
    """The kernel's row0 / col0 offsets: a sub-rectangle off the tile grid
    holds the full frame's pixels, and equals the plain version."""
    sc, tr, li = scene("sidelist", 128, 128, cuda)
    obj, cfg = sc[0]
    pre = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=128,
                               frame_width=128)
    _, z, color, _ = trp.rasterize_shaded(pre, tr, li, True, 128, 128)
    r0, c0, h, w = 37, 21, 60, 100
    _, zs, cs, _ = trp.rasterize_shaded(pre, tr, li, True, h, w, None, 128,
                                        128, r0, c0)
    torch.cuda.synchronize()
    assert torch.equal(bits(zs), bits(z[r0:r0 + h, c0:c0 + w]))
    assert torch.equal(bits(cs), bits(color[r0:r0 + h, c0:c0 + w]))
    launch = trp.prepare_raster(
        pre, (trp.ObjSpec(0, obj.num_triangles, True),), tr, li, h, w, None,
        128, 128, r0, c0)
    for a, b in zip(launch.run(), launch.run_plain()):
        assert torch.equal(bits(a), bits(b))


def test_wrappers_check_their_inputs(cuda):
    sc, tr, li = scene("sphere", 128, 128, cuda)
    obj, cfg = sc[0]
    params = tsp.setup_params(obj.p, tr, li)
    kw = dict(n_lights=li.count, phong=True, gid0=0, frame_height=128,
              frame_width=128, tp=4608)
    with pytest.raises(TypeError):
        tsp.setup_kernel(params.double(), obj.vertices, obj.colors,
                         obj.normals, **kw)
    with pytest.raises(ValueError):
        tsp.setup_kernel(params, obj.vertices.transpose(1, 2).contiguous()
                         .transpose(1, 2), obj.colors, obj.normals, **kw)
    with pytest.raises(ValueError):
        tsp.setup_kernel(params.cpu(), obj.vertices, obj.colors,
                         obj.normals, **kw)


def route_launch(name, variant, device):
    """The raster launch of a route's scene (models/route_scenes.py), as the
    engine prepares it, with K1 / K7 run on ``device``."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = torch_scene(name, variant, device)
    return prepare_scene(scene, tr, li, h, w)


ROUTE_KERNEL = {"k3": "raster_rows1_kernel", "k4": "raster_narrow_kernel",
                "mixed": "raster_kernel", "k4multi": "raster_narrow_kernel",
                "k2multi": "raster_kernel", "k6": "raster_mask_kernel",
                "k6multi": "raster_mask_kernel"}


@pytest.mark.parametrize("name, variant", [
    (n, v) for n in ROUTE_NAMES for v in ("base", "sidelist")]
    + [(n, "base") for n in MASK_NAMES]
    + [(n, "textured") for n in TEXTURED_NAMES])
def test_route_kernel_equals_plain(cuda, name, variant):
    """K2 / K3 / K4 / K6 on each route's launch, single and multi-object,
    with and without side-list triangles, and with K5 sampling textures
    (nearest, bilinear, both in one atlas): bit-equal to the plain version
    on the same card tensors, one launch counted on the route's own
    wrapper."""
    launch = route_launch(name, variant, cuda)
    wrapper = getattr(trp, ROUTE_KERNEL[name])
    assert launch.kernel is wrapper
    n0 = wrapper.launches
    out_k = launch.run()
    assert wrapper.launches == n0 + 1
    out_p = launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert int((out_k[1] >= 0).sum()) > 1000
    if variant == "sidelist":
        assert int(launch.qbins.n_large) > 0
    if variant == "textured":
        assert int((launch.texs[:, 1] > 0).sum()) > 0


@pytest.mark.parametrize("phong", [True, False])
def test_textured_k1_equals_plain(cuda, phong):
    """K1 with the textured fields (u/z, v/z, 1/z, the white Gouraud
    base): bit-equal to setup_plain, one launch counted."""
    h = w = 128
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
           {"phong": phong, "texture": checkerboard(16, 16, 2)})]
    sc, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=cuda)
    obj, cfg = sc[0]
    kw = dict(n_lights=li.count, phong=phong, gid0=0, frame_height=h,
              frame_width=w, tp=4608, uvs=obj.uvs)
    args = (tsp.setup_params(obj.p, tr, li), obj.vertices, obj.colors,
            obj.normals)
    n0 = tsp.setup_kernel.launches
    got = tsp.setup_kernel(*args, **kw)
    assert tsp.setup_kernel.launches == n0 + 1
    want = tsp.setup_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(bits(a), bits(b))
    assert bool((got[0][:, 7] != 0).any())  # the 1/z lane is written


@pytest.mark.parametrize("textured", [False, True])
@pytest.mark.parametrize("phong", [True, False])
def test_k1_staged_rows_equal_plain(cuda, phong, textured):
    """K1 writes its record rows through each warp's stage in shared
    memory, whole rows a store. Each of its four forms on the 4,140-triangle
    sphere, at tp = T (a ragged last warp and block) and tp = T + 1,000
    (padding rows over whole warps), gid0 = 7: recs and bbox bit-equal to
    setup_plain, one launch counted a call."""
    h = w = 128
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    cfg_d = {"phong": phong}
    if textured:
        cfg_d["texture"] = checkerboard(16, 16, 2)
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
           cfg_d)]
    sc, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=cuda)
    obj, _ = sc[0]
    T = obj.num_triangles
    assert T == 4140 and T % 32
    args = (tsp.setup_params(obj.p, tr, li), obj.vertices, obj.colors,
            obj.normals)
    for tp_ in (T, T + 1000):
        kw = dict(n_lights=li.count, phong=phong, gid0=7, frame_height=h,
                  frame_width=w, tp=tp_, uvs=obj.uvs if textured else None)
        n0 = tsp.setup_kernel.launches
        got = tsp.setup_kernel(*args, **kw)
        assert tsp.setup_kernel.launches == n0 + 1
        want = tsp.setup_plain(*args, **kw)
        torch.cuda.synchronize()
        assert got[0].shape == (tp_, 128) and got[1].shape == (8, tp_)
        for a, b in zip(got, want):
            assert torch.equal(bits(a), bits(b))
        gids = torch.arange(tp_, device=cuda, dtype=torch.int32) + 7
        assert torch.equal(got[0][:, 84], gids.float())
        assert int((got[1][0] > 0.5).sum()) > 1000
        assert not bool((got[1][0, T:] > 0.5).any())


@pytest.mark.parametrize("name", TEXTURED_NAMES)
def test_textured_route_frame_on_card_equals_cpu(cuda, name):
    """Each route's textured frame through Renderer on the card equals the
    CPU run."""
    fbs = []
    for dev in ("cpu", cuda):
        scene, tr, li, (h, w) = torch_scene(name, "textured", dev)
        fbs.append(trt.Renderer(h, w, device=dev).render(scene, tr, li))
    torch.cuda.synchronize()
    cpu, gpu = fbs
    np.testing.assert_array_equal(gpu.depth.cpu().numpy(), cpu.depth.numpy())
    np.testing.assert_array_equal(gpu.color.view(torch.int32).cpu().numpy(),
                                  cpu.color.view(torch.int32).numpy())


def test_mask_subrect_origin_on_card(cuda):
    """K6's row0 / col0 offsets: a sub-rectangle off the tile grid equals
    the plain version on the same card tensors and the full frame."""
    scene, tr, li, (h, w) = torch_scene("k6", "textured", cuda)
    from tpu_renderer_torch.engine.renderer import prepare_scene

    full = prepare_scene(scene, tr, li, h, w)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    spec = trp.ObjSpec(0, obj.num_triangles, cfg.phong,
                       (0, 64, 64, "bilinear"))
    launch = trp.prepare_raster(table, (spec,), tr, li, 60, 100, None, h, w,
                                37, 21, atlas=full.operands[-1])
    assert launch.kernel is trp.raster_mask_kernel
    out_k, out_p = launch.run(), launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    z, _, color = full.run()
    assert torch.equal(bits(out_k[0][:60, :100]), bits(z[37:97, 21:121]))
    assert torch.equal(bits(out_k[2][:60, :100]), bits(color[37:97, 21:121]))


@pytest.mark.parametrize("shape", [(85, 1), (85, 528), (85, 3456),
                                   (128, 700), (3, 2000), (85, 2208), (1, 1),
                                   (128, 513), (85, 31)])
def test_finish_records_kernel_equals_plain(cuda, shape):
    """K7: bit-equal to pad + t().contiguous(), NaN and -0 included."""
    rng = np.random.default_rng(shape[1])
    rec = rng.normal(size=shape).astype(np.float32)
    rec[rng.integers(0, shape[0], 9), rng.integers(0, shape[1], 9)] = np.nan
    rec[0, 0] = -0.0
    rec = torch.from_numpy(rec).to(cuda)
    n0 = trp.finish_records.launches
    got = trp.finish_records(rec)
    assert trp.finish_records.launches == n0 + 1
    want = trp.finish_records_plain(rec)
    torch.cuda.synchronize()
    assert got.shape == (shape[1] + (-shape[1] % 512), 128)
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("name", ROUTE_NAMES)
def test_route_frame_on_card_equals_cpu(cuda, name):
    """Each route's whole frame through Renderer on the card (kernels)
    equals the CPU run (plain versions), which the CPU tests hold to the
    JAX package and the golden."""
    fbs = []
    for dev in ("cpu", cuda):
        scene, tr, li, (h, w) = torch_scene(name, "sidelist", dev)
        fbs.append(trt.Renderer(h, w, device=dev).render(scene, tr, li))
    torch.cuda.synchronize()
    cpu, gpu = fbs
    np.testing.assert_array_equal(gpu.depth.cpu().numpy(), cpu.depth.numpy())
    np.testing.assert_array_equal(gpu.color.view(torch.int32).cpu().numpy(),
                                  cpu.color.view(torch.int32).numpy())


@pytest.mark.parametrize("name", ["k3", "k4"])
def test_route_subrect_origin_on_card(cuda, name):
    """K3's and K4's row0 / col0 offsets: a sub-rectangle off the tile grid
    equals the plain version on the same card tensors."""
    scene, tr, li, (h, w) = torch_scene(name, "sidelist", cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    launch = trp.prepare_raster(
        table, (trp.ObjSpec(0, obj.num_triangles, cfg.phong),), tr, li,
        *{"k3": (150, 200), "k4": (300, 300)}[name], None, h, w, 37, 21)
    assert launch.kernel is getattr(trp, ROUTE_KERNEL[name])
    assert int(launch.qbins.n_large) > 0
    out_k, out_p = launch.run(), launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))


SPLIT_ROUTES = {  # kernel -> (route scene, wrapper, prepare_scene knobs)
    "K2": ("mixed", "raster_kernel", {}),
    "K3": ("k3", "raster_rows1_kernel", {}),
    "K4": ("k4", "raster_narrow_kernel", {}),
    "K4@32": ("k4", "raster_narrow32_kernel",
              dict(strategy="sorted", tile_h=32)),
}


def split_parts(launch, part_entries):
    """(tiles + 1,) offsets of a sorted launch's parts (K2, K3, K4, K11 or
    K9), from its bins: per tile the parts of at most ``part_entries``
    entries of each stream, and one more where the side-list gate is
    open."""
    nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
    counts = launch.qbins.counts.long().reshape(nfb + 1, -1)[:nfb]
    parts = ((counts + part_entries - 1) // part_entries).sum(dim=1) + (
        launch.operands[2] > 0).long()
    return torch.cat([parts.new_zeros(1), parts.cumsum(0)])


@pytest.mark.parametrize("part_entries", [1, 16, trp.RASTER_PART_ENTRIES])
@pytest.mark.parametrize("kernel", sorted(SPLIT_ROUTES))
def test_split_raster_equals_plain(cuda, monkeypatch, kernel, part_entries):
    """K2, K3, K4 and K4 on 32-row tiles with each tile's streams split
    into parts of 1, 16 and the default RASTER_PART_ENTRIES entries, merged
    by the (z desc, gid asc) key and shaded by the finalize: z, gid and
    colour bit-equal to raster_plain without and with the side list,
    textured (K5), and in a sub-rect at (37, 21); one launch counted each,
    its part offsets as the bins give them."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    monkeypatch.setattr(trp, "RASTER_PART_ENTRIES", part_entries)
    name, wrapper_name, knobs = SPLIT_ROUTES[kernel]
    wrapper = getattr(trp, wrapper_name)
    for variant in ("base", "sidelist", "textured", "sub-rect"):
        sc, tr, li, (h, w) = torch_scene(
            name, "sidelist" if variant == "sub-rect" else variant, cuda)
        rect = (h, w) if variant != "sub-rect" else (h - 60, w - 40, h, w,
                                                     37, 21)
        launch = prepare_scene(sc, tr, li, *rect, **knobs)
        assert launch.kernel is wrapper, variant
        if variant == "sidelist":
            assert int(launch.qbins.n_large) > 0
        if variant == "textured":
            assert int((launch.texs[:, 1] > 0).sum()) > 0
        n0 = wrapper.launches
        out_k = launch.run()
        assert wrapper.launches == n0 + 1
        assert torch.equal(wrapper.part_offsets.long(),
                           split_parts(launch, part_entries)), variant
        out_p = launch.run_plain()
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(bits(a), bits(b)), variant
        assert int((out_k[1] >= 0).sum()) > (
            100 if variant == "sub-rect" else 1000), variant


def gbuffer_launch(name, variant, device, **kw):
    """The G-buffer launch of the first object of a route's scene, its
    setup (K1 or setup_records) run on ``device``."""
    scene, tr, li, (h, w) = torch_scene(name, variant, device)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    return tgb.prepare_gbuffer(table, h, w, **kw)


@pytest.mark.parametrize("name, variant, route", [
    ("k3", "base", ("sorted", 8)), ("k3", "sidelist", ("sorted", 8)),
    ("k4", "base", ("sorted", 16)), ("k4", "sidelist", ("sorted", 16)),
    ("k6", "base", ("mask", 16)), ("k6", "gbuffer", ("mask", 16)),
    ("k6multi", "base", ("mask", 8))])
def test_gbuffer_kernel_equals_plain(cuda, name, variant, route):
    """K8 (mask) and K9 with the side-list fold K10 (sorted): gid and the
    11 planes bit-equal to the plain version on the same card tensors, one
    launch counted on the route's own wrapper."""
    launch = gbuffer_launch(name, variant, cuda)
    assert (launch.route.strategy, launch.route.tile_h) == route
    wrapper = tgb.raster_pass if route[0] == "mask" else tgb.raster_pass_queue
    assert launch.kernel is wrapper
    n0 = wrapper.launches
    out_k = launch.run()
    assert wrapper.launches == n0 + 1
    out_p = launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert int((out_k[0] >= 0).sum()) > 1000
    assert (int(launch.qbins.n_large) > 0) == (variant == "sidelist")


def test_gbuffer_subrect_and_tile_height_on_card(cuda):
    """K9's row0 / col0 offsets: a sub-rectangle off the tile grid equals
    the plain version and the full frame's crop; tile_h 12, not a multiple
    of 8, raises on CUDA tensors, naming the rule, and launches nothing."""
    scene, tr, li, (h, w) = torch_scene("k4", "sidelist", cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    _, full, _ = tgb.rasterize_gbuffer(table, h, w)
    launch = tgb.prepare_gbuffer(table, 300, 300, None, h, w, 37, 21)
    out_k, out_p = launch.run(), launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert torch.equal(bits(out_k[1][:, :300, :300]),
                       bits(full[:, 37:337, 21:321]))
    n0 = tgb.raster_pass_queue.launches
    with pytest.raises(ValueError, match="multiple of 8 rows on CUDA, not 12"):
        tgb.rasterize_gbuffer(table, h, w, tile_h=12)
    assert tgb.raster_pass_queue.launches == n0


@pytest.mark.parametrize("part_entries", [1, 16, trp.RASTER_PART_ENTRIES])
@pytest.mark.parametrize("tile_h", [8, 16, 32])
def test_split_k9_equals_plain(cuda, monkeypatch, tile_h, part_entries):
    """K9 with each tile's entries split into parts of 1, 16 and the
    default RASTER_PART_ENTRIES entries, merged by the (z desc, gid asc) key:
    gid and the 11 planes bit-equal to gbuffer_plain at 8, 16 and 32 rows,
    without and with the side list (K10, a part of its own), in a sub-rect
    at (37, 21), and on the k4 scene with every triangle drawn twice (equal
    z across parts, the smaller gid wins); one launch counted each, its
    part offsets as the bins give them."""
    monkeypatch.setattr(trp, "RASTER_PART_ENTRIES", part_entries)
    scene, tr, li, (h, w) = torch_scene("k4", "sidelist", cuda)
    obj, cfg = scene[0]
    sg, _ = route_scene("k4", "sidelist")
    doubled, _, _ = ts.to_torch_scene(
        [(dict(p=o["p"], **tp.merge_meshes(o, o)), c) for o, c in sg],
        *ts.baseline_camera_lights(h, w), device=cuda)
    cases = []
    for variant in ("base", "sidelist"):
        sc, _, _, _ = torch_scene("k4", variant, cuda)
        cases.append((variant, sc[0], (h, w, None, h, w, 0, 0)))
    cases.append(("sub-rect", scene[0], (300, 300, None, h, w, 37, 21)))
    cases.append(("doubled", doubled[0], (h, w, None, h, w, 0, 0)))
    for label, (o, c), args in cases:
        table = tsp.setup_for_raster(o, tr, li, c, frame_height=h,
                                     frame_width=w)
        launch = tgb.prepare_gbuffer(table, *args, strategy="sorted",
                                     tile_h=tile_h)
        assert launch.kernel is tgb.raster_pass_queue
        if label != "sub-rect":  # at 32 rows its quad spans few tiles
            assert (int(launch.qbins.n_large) > 0) == (label != "base")
        n0 = tgb.raster_pass_queue.launches
        out_k = launch.run()
        assert tgb.raster_pass_queue.launches == n0 + 1
        assert torch.equal(tgb.raster_pass_queue.part_offsets.long(),
                           split_parts(launch, part_entries))
        out_p = launch.run_plain()
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(bits(a), bits(b)), label
        assert int((out_k[0] >= 0).sum()) > 1000, label
        if label == "doubled":
            assert int(out_k[0].max()) < obj.num_triangles


BAND_HEIGHTS = (24, 40, 48, 56, 64)  # heights without a form of their own


def band_cases(device):
    """(label, scene, transform, lights, (h, w)) of the band form's
    scenes: the k4 route scenes (528 triangles; the 2.2-unit quad on the
    side list at 24 rows) and a cube with a 16-unit quad behind it at 256
    x 1408, whose quad takes the side list at every band height."""
    cases = [(f"k4 {v}",) + torch_scene("k4", v, device)
             for v in ("base", "sidelist", "textured")]
    quad = tp.construct_quad(16.0, color=(0.3, 0.9, 0.4, 1.0))
    quad["vertices"] = quad["vertices"] + np.float32([0.0, 0.0, -0.5])
    sg = [(dict(p=(0.0, 0.0, 0.0),
                **tp.merge_meshes(tp.construct_cube(), quad)), {})]
    _, tr_d, li_d = ts.baseline_scene(1, 256, 1408)
    cases.append(("cube + 16-unit quad",)
                 + ts.to_torch_scene(sg, tr_d, li_d, device=device)
                 + ((256, 1408),))
    return cases


@pytest.mark.parametrize("part_entries", [16, trp.RASTER_PART_ENTRIES])
@pytest.mark.parametrize("tile_h", BAND_HEIGHTS)
def test_band_form_equals_plain(cuda, monkeypatch, tile_h, part_entries):
    """K4 (``raster_narrow_any_kernel``) and K9 + K10 in the band form at
    24 to 64 rows, parts of 16 and the default entries: z, gid and colour
    (K5 on the textured sphere), and gid and the 11 planes, bit-equal to
    the plain version and to the 16-row form's frame; one launch counted,
    the part offsets as the bins give them, the side list reached."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    monkeypatch.setattr(trp, "RASTER_PART_ENTRIES", part_entries)
    side = False
    for label, scene, tr, li, (h, w) in band_cases(cuda):
        fused = prepare_scene(scene, tr, li, h, w, strategy="sorted",
                              tile_h=tile_h)
        obj, cfg = scene[0]
        table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                     frame_width=w)
        gbuf = tgb.prepare_gbuffer(table, h, w, strategy="sorted",
                                   tile_h=tile_h)
        assert fused.kernel is trp.raster_narrow_any_kernel
        assert gbuf.kernel is tgb.raster_pass_queue
        for launch, wrapper, form16 in (
                (fused, trp.raster_narrow_any_kernel, prepare_scene(
                    scene, tr, li, h, w, strategy="sorted", tile_h=16)),
                (gbuf, tgb.raster_pass_queue, tgb.prepare_gbuffer(
                    table, h, w, strategy="sorted", tile_h=16))):
            assert (launch.route.tile_h, launch.route.rows) == (tile_h, 1)
            n0 = wrapper.launches
            out_k = launch.run()
            assert wrapper.launches == n0 + 1
            assert torch.equal(wrapper.part_offsets.long(),
                               split_parts(launch, part_entries))
            out_p = launch.run_plain()
            out_16 = form16.run()
            torch.cuda.synchronize()
            for a, b, c in zip(out_k, out_p, out_16):
                assert torch.equal(bits(a), bits(b)), label
                assert torch.equal(bits(a[..., :h, :w]),
                                   bits(c[..., :h, :w])), label
            assert int(launch.stats()["bins_dropped"]) == 0
            side |= int(launch.qbins.n_large) > 0
    assert side


@pytest.mark.parametrize("part_entries",
                         [16, trp.RASTER_PART_ENTRIES, 2 ** 31 - 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_band_walk_on_the_bands_family(cuda, monkeypatch, seed,
                                       part_entries):
    """The band walk on the boundary sweep's ``bands`` scenes (rows
    ending and starting on band boundaries, parts reaching only a tile's
    first and last band, entries reaching in from above and below, zero
    heights, spans of one and of 128 columns, exact ties across parts, the
    side list), every form at every height, parts of 16, the default and
    one a stream (several staged batches a part): bit-equal to the plain
    version, one launch counted, the parts as the bins give them."""
    from tpu_renderer_torch.engine.renderer import prepare_scene
    from tpu_renderer_torch.models import sweep_scenes as ss

    monkeypatch.setattr(trp, "RASTER_PART_ENTRIES", part_entries)
    for sc in ss.bands(seed):
        scene_, tr, li = ts.to_torch_scene(sc.sg, *sc.camera(), device=cuda)
        (h, w) = sc.frame
        obj, cfg = scene_[0]
        table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                     frame_width=w)
        for form in sc.forms:
            if form.path == "fused":
                launch = prepare_scene(scene_, tr, li, h, w,
                                       strategy="sorted", tile_h=form.tile_h)
                wrapper = trp.raster_narrow_any_kernel
            else:
                launch = tgb.prepare_gbuffer(table, h, w, strategy="sorted",
                                             tile_h=form.tile_h)
                wrapper = tgb.raster_pass_queue
            assert launch.kernel is wrapper
            n0 = wrapper.launches
            out_k = launch.run()
            assert wrapper.launches == n0 + 1
            assert torch.equal(wrapper.part_offsets.long(),
                               split_parts(launch, part_entries))
            out_p = launch.run_plain()
            torch.cuda.synchronize()
            for a, b in zip(out_k, out_p):
                assert torch.equal(bits(a), bits(b)), (form, sc.name)
            assert int(launch.stats()["bins_dropped"]) == 0


def test_binning_on_card_equals_cpu_at_every_height(cuda):
    """The sorted binning on the card lists exactly the CPU's entries at
    heights whose reciprocal is not exact (24, 40, 48, 56): the bbox rows
    divide by a tile height held as a device tensor, where a host float
    made torch multiply by its rounded reciprocal and list a triangle
    whose bbox ends on a tile boundary in one tile more."""
    from tpu_renderer_torch.engine.renderer import prepare_scene
    from tpu_renderer_torch.models import sweep_scenes as ss

    sc, = ss.bands(0)
    h, w = sc.frame
    on = {d: ts.to_torch_scene(sc.sg, *sc.camera(), device=d)
          for d in (cuda, "cpu")}
    for tile_h in ss.BAND_HEIGHTS:
        got = {d: prepare_scene(*on[d], h, w, strategy="sorted",
                                tile_h=tile_h) for d in on}
        for a, b in zip(got[cuda].qbins, got["cpu"].qbins):
            assert torch.equal(a.cpu(), b), tile_h
        assert torch.equal(got[cuda].operands[2].cpu(),
                           got["cpu"].operands[2]), tile_h


@pytest.mark.parametrize("tile_h", [16, 32])
def test_band_form_at_16_and_32_rows(cuda, tile_h):
    """The band form asked for at the heights of forms of their own (K4's
    band wrapper, K9's ``band=True``): bit-equal to the plain version and
    to ``<16>`` / ``<32>`` on the same operands, one launch counted."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    for label, scene, tr, li, (h, w) in band_cases(cuda):
        fused = prepare_scene(scene, tr, li, h, w, strategy="sorted",
                              tile_h=tile_h)
        obj, cfg = scene[0]
        table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                     frame_width=w)
        gbuf = tgb.prepare_gbuffer(table, h, w, strategy="sorted",
                                   tile_h=tile_h)
        for launch, band, wrapper in (
                (fused, lambda: trp.raster_narrow_any_kernel(
                    *fused.operands, tile_h=tile_h, **fused.options),
                 trp.raster_narrow_any_kernel),
                (gbuf, lambda: tgb.raster_pass_queue(
                    *gbuf.operands, band=True, **gbuf.options),
                 tgb.raster_pass_queue)):
            n0 = wrapper.launches
            out_b = band()
            assert wrapper.launches == n0 + 1
            out_f, out_p = launch.run(), launch.run_plain()
            torch.cuda.synchronize()
            for a, b, c in zip(out_b, out_f, out_p):
                assert torch.equal(bits(a), bits(b)), label
                assert torch.equal(bits(a), bits(c)), label


def test_band_form_refuses_other_heights(cuda):
    """On CUDA tensors the sorted kernels refuse a height that is not a
    multiple of 8, naming the rule, and launch nothing: no other height
    and no plain fold renders in their place."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = torch_scene("k4", "base", cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    n0 = (trp.raster_narrow_any_kernel.launches,
          tgb.raster_pass_queue.launches)
    for tile_h in (12, 20, 4):
        launch = prepare_scene(scene, tr, li, h, w, strategy="sorted",
                               tile_h=tile_h)
        assert launch.kernel is trp.raster_narrow_any_kernel
        with pytest.raises(ValueError, match="multiple of 8 rows on CUDA"):
            launch.run()
        with pytest.raises(ValueError, match="multiple of 8 rows on CUDA"):
            tgb.rasterize_gbuffer(table, h, w, strategy="sorted",
                                  tile_h=tile_h)
    assert (trp.raster_narrow_any_kernel.launches,
            tgb.raster_pass_queue.launches) == n0


@pytest.mark.parametrize("name, variant, strategy", [
    ("k4", "base", "sorted"), ("k4", "sidelist", "sorted"),
    ("k6", "base", "mask"), ("k6", "gbuffer", "mask")])
def test_gbuffer_32_rows_equals_plain(cuda, name, variant, strategy):
    """K8 and K9 on 32-row tiles (256-thread blocks), K9 with the side
    list (K10; the 2.2-unit quad covers the 36 tiles of the 384 x 384
    frame, more than the expansion of 32): gid and the 11 planes
    bit-equal to the plain version, one launch counted."""
    launch = gbuffer_launch(name, variant, cuda, strategy=strategy,
                            tile_h=32)
    assert (launch.route.strategy, launch.route.tile_h) == (strategy, 32)
    wrapper = launch.kernel
    n0 = wrapper.launches
    out_k = launch.run()
    assert wrapper.launches == n0 + 1
    out_p = launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert int((out_k[0] >= 0).sum()) > 1000
    assert (int(launch.qbins.n_large) > 0) == (variant == "sidelist")


@pytest.mark.parametrize("name, variant", [
    ("k4", "base"), ("k4", "sidelist"), ("k4", "textured"),
    ("k4multi", "sidelist"), ("k2multi", "textured"), ("k6", "textured"),
    ("k6multi", "base"), ("k6multi", "textured")])
def test_32_row_kernel_equals_plain(cuda, name, variant):
    """K4 (sorted, ``raster_narrow32_kernel``) and K6 (mask) on 32-row
    tiles, with and without the side list, textured (K5) and not, one and
    several objects: z, gid and colour bit-equal to the plain version,
    one launch counted on the route's wrapper."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = torch_scene(name, variant, cuda)
    strategy = "mask" if name in MASK_NAMES else "sorted"
    launch = prepare_scene(scene, tr, li, h, w, strategy=strategy,
                           tile_h=32)
    wrapper = (trp.raster_mask_kernel if strategy == "mask"
               else trp.raster_narrow32_kernel)
    assert launch.kernel is wrapper and launch.route.tile_h == 32
    n0 = wrapper.launches
    out_k = launch.run()
    assert wrapper.launches == n0 + 1
    out_p = launch.run_plain()
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_p):
        assert torch.equal(bits(a), bits(b))
    assert int((out_k[1] >= 0).sum()) > 1000
    if variant == "sidelist":
        assert int(launch.qbins.n_large) > 0


def k4_mask_scene(filter_mode, device):
    """(scene, transform, lights, (h, w)) of route k4's 528-triangle sphere
    at 384 x 384 with its 16 x 16 checkerboard sampled ``filter_mode``."""
    sg, (h, w) = route_scene("k4", "textured")
    sg = [(sg[0][0], dict(sg[0][1], filter_mode=filter_mode))]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    return ts.to_torch_scene(sg, tr_d, li_d, device=device) + ((h, w),)


def assert_mask_lists(bins, longest):
    """Some tile's list is longer than ``longest`` entries (more than one
    batch of a strip) and some tile has none."""
    assert int(bins.counts.max()) > longest
    assert int((bins.counts == 0).sum()) > 0


def assert_strips_equal_plain(launch, wrapper, monkeypatch):
    """At every strip height (``MASK_STRIP_ROWS`` 1, 2, 4, 8) one launch
    counted on ``wrapper``, every output bit-equal to the plain version on
    the same card tensors; returns the kernel's outputs at the default
    height."""
    assert launch.kernel is wrapper
    out_p = launch.run_plain()
    for rows in (1, 2, 4, 8, trp.MASK_STRIP_ROWS):
        with monkeypatch.context() as m:
            m.setattr(trp, "MASK_STRIP_ROWS", rows)
            n0 = wrapper.launches
            out_k = launch.run()
            assert wrapper.launches == n0 + 1
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            assert torch.equal(bits(a), bits(b)), rows
    return out_k


MASK_TILE_HEIGHTS = [8, 16, 32, 64]
SUBRECT = (300, 300, 37, 21)  # rows, cols, row0, col0: off the strip grid


@pytest.mark.parametrize("tile_h", MASK_TILE_HEIGHTS)
@pytest.mark.parametrize("case", ["nearest", "bilinear", "sub-rect"])
def test_mask_strips_k6_equals_plain(cuda, monkeypatch, tile_h, case):
    """K6, each tile folded strip by strip at every strip height, on route
    k4's 528-triangle sphere forced to the mask strategy (lists longer than
    the 32-entry batches of 4-row strips, the 64 of 1-row ones at 64 rows;
    empty tiles) with K5 nearest and bilinear, and (bilinear) into a 300 x
    300 sub-rect at (37, 21), off the strip grid, also equal to the whole
    frame's crop: z, gid and colour bit-equal to the plain version, one
    launch counted a call; 64-row tiles too, which only the mask kernels
    run."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = k4_mask_scene(
        "nearest" if case == "nearest" else "bilinear", cuda)
    hs, ws, r0, c0 = SUBRECT if case == "sub-rect" else (h, w, 0, 0)
    launch = prepare_scene(scene, tr, li, hs, ws, h, w, r0, c0,
                           strategy="mask", tile_h=tile_h)
    assert launch.route.tile_h == tile_h
    assert_mask_lists(launch.operands[1], 32)
    out_k = assert_strips_equal_plain(launch, trp.raster_mask_kernel,
                                      monkeypatch)
    assert int((out_k[1] >= 0).sum()) > 1000
    if case == "sub-rect":
        full = prepare_scene(scene, tr, li, h, w, strategy="mask",
                             tile_h=tile_h).run()
        for a, b in zip(out_k, full):
            assert torch.equal(bits(a[:hs, :ws]),
                               bits(b[r0:r0 + hs, c0:c0 + ws]))


@pytest.mark.parametrize("tile_h", MASK_TILE_HEIGHTS)
@pytest.mark.parametrize("case", ["frame", "sub-rect"])
def test_mask_strips_k8_equals_plain(cuda, monkeypatch, tile_h, case):
    """K8, each tile folded strip by strip at every strip height, on the
    same forced-mask sphere (its uv fields set), the whole frame and the
    sub-rect at (37, 21): gid and the 11 planes bit-equal to the plain
    version, one launch counted a call."""
    scene, tr, li, (h, w) = k4_mask_scene("nearest", cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    hs, ws, r0, c0 = SUBRECT if case == "sub-rect" else (h, w, 0, 0)
    launch = tgb.prepare_gbuffer(table, hs, ws, None, h, w, r0, c0, "mask",
                                 tile_h)
    assert (launch.route.strategy, launch.route.tile_h) == ("mask", tile_h)
    assert_mask_lists(launch.operands[1], 32)
    out_k = assert_strips_equal_plain(launch, tgb.raster_pass, monkeypatch)
    assert int((out_k[0] >= 0).sum()) > 1000


def test_mask_kernels_refuse_bad_heights(cuda, monkeypatch):
    """K6 and K8 raise on a tile height that is not a multiple of 8, naming
    the rule, and on a strip height that does not divide 8."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = k4_mask_scene("nearest", cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    for tile_h in (12, 4):
        with pytest.raises(ValueError, match="multiple of 8 rows on CUDA"):
            prepare_scene(scene, tr, li, h, w, strategy="mask",
                          tile_h=tile_h).run()
        with pytest.raises(ValueError, match="multiple of 8 rows on CUDA"):
            tgb.rasterize_gbuffer(table, h, w, strategy="mask",
                                  tile_h=tile_h)
    monkeypatch.setattr(trp, "MASK_STRIP_ROWS", 3)
    with pytest.raises(RuntimeError, match="tr_raster_mask launch failed"):
        prepare_scene(scene, tr, li, h, w, strategy="mask", tile_h=16).run()
    with pytest.raises(RuntimeError, match="tr_gbuffer_mask launch failed"):
        tgb.rasterize_gbuffer(table, h, w, strategy="mask", tile_h=16)


@pytest.mark.parametrize("name, variant, backend", [
    ("k4multi", "sidelist", "kernels"), ("k6", "gbuffer", "kernels"),
    ("k6", "textured", "reference")])
def test_subrect_render_scene_on_card_equals_cpu(cuda, name, variant,
                                                 backend):
    """render_scene into a sub-rect off the tile grid, called in JAX's
    order (framebuffer, scene, transform, lights, backend, frame_height,
    frame_width, row0, col0), on the fused, G-buffer and reference
    branches: the card's frame equals the CPU run's and the crop of the
    card's whole frame."""
    r0, c0, hs, ws = 37, 21, 60, 100
    frames = []
    for dev in ("cpu", cuda):
        scene, tr, li, (h, w) = torch_scene(name, variant, dev)
        frames.append(trt.render_scene(
            trt.make_framebuffer(hs, ws, device=dev), scene, tr, li,
            backend, h, w, r0, c0))
    full = trt.render_scene(None, scene, tr, li, backend, h, w)
    torch.cuda.synchronize()
    cpu, gpu = frames
    np.testing.assert_array_equal(gpu.depth.cpu().numpy(), cpu.depth.numpy())
    np.testing.assert_array_equal(gpu.color.view(torch.int32).cpu().numpy(),
                                  cpu.color.view(torch.int32).numpy())
    assert torch.equal(bits(gpu.depth), bits(full.depth[r0:r0 + hs,
                                                        c0:c0 + ws]))
    assert torch.equal(bits(gpu.color), bits(full.color[r0:r0 + hs,
                                                        c0:c0 + ws]))
    assert int((cpu.depth > -3.0e38).sum()) > 500


@pytest.mark.parametrize("name", GBUFFER_NAMES)
def test_gbuffer_frame_on_card_equals_cpu(cuda, name):
    """Each G-buffer route scene's frame through Renderer on the card
    (K8 / K9 / K10 and the deferred shade on the card) equals the CPU
    run."""
    fbs = []
    for dev in ("cpu", cuda):
        scene, tr, li, (h, w) = torch_scene(name, "gbuffer", dev)
        fbs.append(trt.Renderer(h, w, device=dev).render(scene, tr, li))
    torch.cuda.synchronize()
    cpu, gpu = fbs
    np.testing.assert_array_equal(gpu.depth.cpu().numpy(), cpu.depth.numpy())
    np.testing.assert_array_equal(gpu.color.view(torch.int32).cpu().numpy(),
                                  cpu.color.view(torch.int32).numpy())
    assert int((cpu.depth > -3.0e38).sum()) > 1000


def stream_batches(qbins, nfb, part_entries, batch):
    """Stream batches of a split launch: each stream of each tile cut into
    parts of at most ``part_entries`` entries, each part into batches of
    ``batch``."""
    rs = qbins.counts.shape[0] // (nfb + 1)
    total = 0
    for n in qbins.counts[:rs * nfb].tolist():
        full, rest = divmod(n, part_entries)
        total += full * -(-part_entries // batch) + -(-rest // batch)
    return total


@pytest.mark.parametrize("rows", [1, 2])
def test_zcull_kernel_equals_plain_and_unculled(cuda, monkeypatch, rows):
    """K11 on K3's (rows 1) and K2's (rows 2) route, at the default
    RASTER_PART_ENTRIES, at 256 entries a part and at one part a stream: z,
    gid and colour bit-equal to the plain version and to the non-culling
    kernel (K3 or K2, split alike) on the same operands; the launch counts
    on K11's wrapper only. Its skipped batches depend on the
    order the parts run in, so they are held to bounds: at least the
    per-part replay (``zcull_skips_plain(..., part_entries=P)``, each part
    culling against its own winners alone) and at most the stream batches;
    at 256 entries a part that replay skips batches, so the kernel does.
    At one part a stream with every side-list gate closed (the rows-1 stack
    has no side list; the rows-2 one runs with its lcounts zeroed too)
    exactly the serial replay: each strip's keys are then written only by
    its own part, after it has folded. The default part size's launch fits
    in about one wave of blocks here, so few keys are set when its parts
    test them; test_zcull_kernel_skips_on_the_2m_stack holds its skips > 0
    on a stack that takes many waves."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    scene, tr, li, (h, w) = zcull_stack(rows, cuda)
    launch = prepare_scene(scene, tr, li, h, w, zcull=True)
    wrapper, unculled = (trp.ZCULL_KERNELS[(8, rows)],
                         trp.RASTER_KERNELS[(8, rows)])
    assert launch.kernel is wrapper
    gates = launch.operands[2]
    assert bool((gates > 0).any()) == (rows == 2)
    closed = launch.operands[:2] + (torch.zeros_like(gates),) + (
        launch.operands[3:])
    nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
    one = 2 ** 31 - 1
    replay = {p: trp.zcull_skips_plain(
        *launch.operands[:2], tile_h=8,
        part_entries=None if p == one else p, **launch.options)
        for p in (trp.RASTER_PART_ENTRIES, 256, one)}
    assert replay[256] > 0
    cases = [(launch.operands, p) for p in replay] + [(closed, one)]
    for operands, part_entries in cases:
        monkeypatch.setattr(trp, "RASTER_PART_ENTRIES", part_entries)
        skipped = torch.zeros(1, dtype=torch.int32, device=cuda)
        n0, m0 = wrapper.launches, unculled.launches
        out_k = wrapper(*operands, skipped=skipped, **launch.options)
        assert (wrapper.launches, unculled.launches) == (n0 + 1, m0)
        out_u = unculled(*operands, **launch.options)
        out_p = trp.raster_plain(*operands, tile_h=8, **launch.options)
        torch.cuda.synchronize()
        for a, b, c in zip(out_k, out_u, out_p):
            assert torch.equal(bits(a), bits(b))
            assert torch.equal(bits(a), bits(c))
        batches = stream_batches(launch.qbins, nfb, part_entries,
                                 128 // (8 // rows))
        floor = replay[part_entries]
        assert floor <= int(skipped) <= batches, part_entries
        if part_entries == one and not bool((operands[2] > 0).any()):
            assert int(skipped) == floor
    assert int(launch.stats()["bins_dropped"]) == 0
    assert int((out_p[1] >= 0).sum()) > 20000


def test_zcull_kernel_skips_on_the_2m_stack(cuda):
    """K11 at the default RASTER_PART_ENTRIES on bench.py's
    2,007,372-triangle stack (stack_scene(409, 409, 6) at 1920x1080,
    innermost layer first), whose parts take many waves of blocks: bit-equal
    to K2 on the same operands, and more than none of its stream batches
    skipped (at most all of them)."""
    from tpu_renderer_torch.engine.renderer import prepare_scene

    h, w = 1080, 1920
    scene, tr, li = ts.stack_scene(409, 409, 6, h, w, device=cuda,
                                   inner_first=True)
    launch = prepare_scene(scene, tr, li, h, w, zcull=True)
    assert launch.kernel is trp.raster_zcull_kernel
    assert int(launch.stats()["bins_dropped"]) == 0
    skipped = torch.zeros(1, dtype=torch.int32, device=cuda)
    out_k = launch.kernel(*launch.operands, skipped=skipped,
                          **launch.options)
    out_u = trp.raster_kernel(*launch.operands, **launch.options)
    torch.cuda.synchronize()
    for a, b in zip(out_k, out_u):
        assert torch.equal(bits(a), bits(b))
    nfb = launch.options["tiles_y"] * launch.options["tiles_x"]
    batches = stream_batches(launch.qbins, nfb, trp.RASTER_PART_ENTRIES, 32)
    assert 0 < int(skipped) <= batches


def test_zcull_renderer_launches(cuda):
    """Renderer(zcull=False) launches K2 and not K11; zcull=True launches
    K11 and not K2; the two frames are bit-equal."""
    scene, tr, li, (h, w) = zcull_stack(2, cuda)
    fbs = []
    for zcull in (False, True):
        n2, n11 = trp.raster_kernel.launches, trp.raster_zcull_kernel.launches
        fbs.append(trt.Renderer(h, w, device=cuda, zcull=zcull).render(
            scene, tr, li))
        torch.cuda.synchronize()
        assert (trp.raster_kernel.launches - n2,
                trp.raster_zcull_kernel.launches - n11) == (
                    (0, 1) if zcull else (1, 0))
    assert torch.equal(bits(fbs[0].depth), bits(fbs[1].depth))
    assert torch.equal(bits(fbs[0].color), bits(fbs[1].color))


def frames_card_and_cpu(make_scene, **knobs):
    """(CPU frame and stats, card frame and stats) of Renderer(**knobs)."""
    out = []
    for dev in ("cpu", torch.device("cuda")):
        scene, tr, li, (h, w) = make_scene(dev)
        out.append(trt.Renderer(h, w, device=dev, **knobs).render(
            scene, tr, li, with_stats=True))
    torch.cuda.synchronize()
    return out


def assert_same_frames(cpu, gpu):
    (cfb, cst), (gfb, gst) = cpu, gpu
    np.testing.assert_array_equal(gfb.depth.cpu().numpy(), cfb.depth.numpy())
    np.testing.assert_array_equal(gfb.color.view(torch.int32).cpu().numpy(),
                                  cfb.color.view(torch.int32).numpy())
    assert sorted(gst) == sorted(cst)
    for key in cst:
        assert float(gst[key]) == float(cst[key]), key


@pytest.mark.parametrize("name, variant, knobs", [
    ("k2multi", "textured", dict(clear_color=0xFF203040)),
    ("k3", "gbuffer", dict(clear_color=0xFF203040)),
    ("k3", "base", dict(clear_color=0xFF203040, zcull=True)),
    ("k3", "base", dict(budget_factor=0.25)),
    ("k3", "gbuffer", dict(budget_factor=0.5)),
    ("k6", "base", dict(capacity=8)),
    ("k4", "base", dict(zcull=True)),
    ("k6", "gbuffer", dict(zcull=True)),
    ("k6", "textured", dict(backend="reference")),
    ("k4multi", "base", dict(backend="reference")),
])
def test_knobs_on_card_equal_cpu(cuda, name, variant, knobs):
    """The Renderer's knobs and the 'reference' backend on the card give
    the CPU run's frame and stats bit for bit."""
    cpu, gpu = frames_card_and_cpu(
        lambda dev: torch_scene(name, variant, dev), **knobs)
    assert_same_frames(cpu, gpu)
    assert int((cpu[0].depth > -3.0e38).sum()) > 1000


def test_calibrate_on_card_equals_cpu(cuda):
    """Renderer.calibrate on the card applies the CPU run's factor."""
    got = []
    for dev in ("cpu", cuda):
        sc, tr, li = scene("sphere", 128, 128, dev)
        r = trt.Renderer(128, 128, device=dev)
        got.append((r.calibrate(sc, tr, li), r.budget_factor))
    assert got[0] == got[1]
    assert got[0][0] is not None


# ---------------------------------------------------------------------------
# Several cards: every launch on its tensors' own card; NCCL ranks
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    yield
    torch.cuda.set_device(0)


def deferred40k_scene(h, w, device):
    """Chip_smoke's deferred 40k: the 40,040-triangle sphere with a
    2.2-unit quad 0.6 behind it, one mesh, Phong, a 1024x1024 checkerboard
    sampled bilinearly (over the fused atlas limit): the G-buffer path."""
    quad = tp.construct_quad(2.2)
    quad["vertices"][:, 2] -= 0.6
    mesh = tp.merge_meshes(tp.construct_sphere_grid(140, 143), quad)
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    sg = [(dict(p=(0.0, 0.0, 0.0), **mesh),
           {"phong": True, "texture": checkerboard(1024, 1024, 64),
            "filter_mode": "bilinear"})]
    return ts.to_torch_scene(sg, tr_d, li_d, device=device)


def config3_avx_scene(h, w, device):
    sg, tr_d, li_d = ts.baseline_scene(3, h, w)
    sg = [(sg[0][0], dict(sg[0][1], uv_mode="avx"))]
    return ts.to_torch_scene(sg, tr_d, li_d, device=device)


def baseline_torch_scene(n, h, w, device):
    sg, tr_d, li_d = ts.baseline_scene(n, h, w)
    return ts.to_torch_scene(sg, tr_d, li_d, device=device)


# name: (scene function, (h, w), the kernels one frame launches; K14,
# raster.bin_for_raster, bins each sorted draw)
CROSS_CARD = {
    "headline (K1 + K2)": (
        lambda h, w, dev: ts.stack_scene(708, 707, 1, h, w, device=dev),
        (1080, 1920), {"setup.setup_kernel": 1, "raster.bin_for_raster": 1,
                       "raster.raster_kernel": 1}),
    "config 5 (K7 + K4)": (
        lambda h, w, dev: baseline_torch_scene(5, h, w, dev), (1080, 1920),
        {"raster.finish_records": 1, "raster.bin_for_raster": 1,
         "raster.raster_narrow_kernel": 1}),
    "config 3 avx (K8)": (
        config3_avx_scene, (512, 512),
        {"raster.finish_records": 1, "gbuffer.raster_pass": 1}),
    "deferred 40k (K9 + K10)": (
        deferred40k_scene, (1080, 1920),
        {"setup.setup_kernel": 1, "raster.bin_for_raster": 1,
         "gbuffer.raster_pass_queue": 1}),
}


@pytest.mark.parametrize("name", list(CROSS_CARD))
def test_frame_on_another_card_equals_cuda0(two_cards, name):
    """Renderer(device="cuda:1") with its scene on cuda:1, while cuda:0
    stays the current device, launches the route's kernels on cuda:1 and
    renders cuda:0's frame bit for bit. Every C entry launches on the
    current device, so each wrapper has to make its tensors' card current
    for the call (``_cuda.launch``)."""
    from tpu_renderer_torch import entry

    build, (h, w), want = CROSS_CARD[name]
    counters = entry.launch_counters()
    frames = []
    for dev in (torch.device("cuda", 0), torch.device("cuda", 1)):
        scene, tr, li = build(h, w, dev)
        before = {n: f.launches for n, f in counters.items()}
        fb = trt.Renderer(h, w, device=dev).render(scene, tr, li)
        torch.cuda.synchronize(dev)
        launched = {n: f.launches - before[n] for n, f in counters.items()
                    if f.launches != before[n]}
        assert launched == want, (dev, launched)
        assert torch.cuda.current_device() == 0
        assert fb.color.device == fb.depth.device == dev
        frames.append((fb.color.cpu(), fb.depth.cpu()))
    (c0, d0), (c1, d1) = frames
    assert torch.equal(bits(c1), bits(c0))
    assert torch.equal(bits(d1), bits(d0))
    assert int((d0 > -3.0e38).sum()) > 1000


def test_dryrun_multichip_on_nccl_one_rank_a_card(two_cards):
    """dryrun_multichip over NCCL, rank r on cuda:r: every mesh shape held
    bit-equal to the unsharded frame inside the ranks."""
    from tpu_renderer_torch import entry

    n = min(4, torch.cuda.device_count())
    per_rank = entry.dryrun_multichip(n, backend="nccl")
    assert len(per_rank) == n
    shapes = {"tiled"} | ({"geometry", "object", "2level"} if n % 2 == 0
                          else set())
    for ms in per_rank:
        assert set(ms) == shapes
