"""Scene-wide setup (``ops.setup.setup_scene``): a fused scene of several
objects of 4096 triangles or more in all is set up in one table, every
object at its gid offset and padding, K1's grouped form on the card and
``setup_scene_plain`` here. Held to the per-object path it replaced
(``per_object_table``: K1 per object of 4096 triangles or more, the
small-object chain and K7 below, the tables concatenated):

- the table bit for bit on every triangle's row and its bbox column, pad
  rows invalid records that bin nowhere;
- the launch's raster outputs and stats equal on both tables;
- ``Renderer`` frames equal to the 'reference' backend's and to the NumPy
  golden's.

Seeded scenes mix a K1-sized Phong sphere grid, chain-sized reference
spheres (pole fans included), a Phong twin of one of them (a depth tie
on every pixel it covers, which the first submitted must win), a
textured Phong sphere and a bilinear textured backdrop quad, so every
<PHONG, TEXTURED> kind of the grouped launch is present. The ``cuda``
test does the same on the card at the benchmark's ``sphere_cluster``
size, a 1920x1080 frame of 137 objects and 1,018,370 triangles.
"""

import numpy as np
import pytest
import torch

import tpu_renderer_torch as trt
from tpu_renderer_torch.engine import renderer as tre
from tpu_renderer_torch.golden import cpu_reference as gold
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import binning as tbin
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

H, W = 96, 128
SEEDS = (0, 1, 2)


def mixed_scene(seed):
    """(scene_golden, transform dict, lights dict): six objects, 5,334
    triangles, at positions jittered by the seed."""
    rng = np.random.default_rng(seed)

    def at(x, y, z):
        return tuple(float(v) for v in np.asarray((x, y, z)) + rng.uniform(
            -0.05, 0.05, 3))

    grid = tp.construct_sphere_grid(46, 45, radius=0.45)  # 4,140: K1-sized
    ref = construct_sphere(12)  # 528, pole fans included: chain-sized
    small = construct_sphere(8)  # 240
    twin = at(0.35, 0.2, 0.3)
    sg = [
        (dict(p=(0.0, 0.0, -0.6), **tp.construct_quad(2.4)),
         {"texture": checkerboard(32, 32, 4), "filter_mode": "bilinear"}),
        (dict(p=at(-0.3, 0.0, 0.0), **grid), {"phong": True}),
        (dict(p=twin, **ref), {}),
        (dict(p=twin, **ref), {"phong": True}),
        (dict(p=at(0.3, -0.35, 0.2), **ref), {}),
        (dict(p=at(-0.4, -0.3, 0.35), **small),
         {"phong": True, "texture": checkerboard(16, 16, 2)}),
    ]
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    return sg, tr_d, li_d


def per_object_table(scene, tr, li, fh, fw):
    """The per-object path: each object set up alone at its gid offset
    (K1 from 4096 triangles, else setup_records padded to 128 -> K7 and
    the bbox from its channel-major rows), the tables concatenated."""
    tables, bboxes, gid = [], [], 0
    for obj, cfg in scene:
        T = obj.num_triangles
        out = tsp.setup_for_raster(obj, tr, li, cfg, gid0=gid,
                                   frame_height=fh, frame_width=fw)
        if isinstance(out, tsp.SetupOut):
            rt, pad = out.recs, out.recs.shape[0] - T
            bboxes.append(out.bbox)
        else:
            pad = -T % 128
            rt_cm = torch.nn.functional.pad(out, (0, pad))
            rt = trp.finish_records(rt_cm)[:T + pad]
            bboxes.append(tbin.triangle_bbox_rows(rt_cm, fh, fw))
        tables.append(rt)
        gid += T + pad
    return tsp.SetupOut(torch.cat(tables),
                        [torch.cat(p) for p in zip(*bboxes)],
                        sum(o.num_triangles for o, _ in scene))


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_tables_equal(new, old, scene):
    """Every triangle's row and bbox column bit-equal; every pad row an
    invalid record (zero edge lanes) with an invalid bbox, on both."""
    assert new.recs.shape == old.recs.shape
    assert new.num_triangles == old.num_triangles
    real = torch.zeros(new.recs.shape[0], dtype=torch.bool,
                       device=new.recs.device)
    at = 0
    for obj, _ in scene:
        real[at:at + obj.num_triangles] = True
        at += tsp.object_rows(obj.num_triangles)
    assert at == new.recs.shape[0]
    assert torch.equal(bits(new.recs[real]), bits(old.recs[real]))
    for a, b in zip(new.bbox, old.bbox):
        assert torch.equal(bits(a[real]), bits(b[real]))
    for t in (new, old):
        assert not t.recs[~real][:, :tsp.GID_LANE].any()
        assert not t.bbox[0][~real].any()


def launches(scene, tr, li, h, w):
    """The scene's launch on the scene-wide table and on the per-object
    one (the same objspecs and atlas)."""
    table, objspecs, atlas = tre._scene_table(scene, tr, li, h, w)
    old = per_object_table(scene, tr, li, h, w)

    def prep(t):
        return trp.prepare_raster(t, objspecs, tr, li, h, w, atlas=atlas)
    return table, old, prep(table), prep(old)


def assert_runs_equal(a, b):
    for x, y in zip(a.run(), b.run()):
        assert torch.equal(bits(x), bits(y))
    sa, sb = a.stats(), b.stats()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(torch.as_tensor(sa[k]).cpu(),
                           torch.as_tensor(sb[k]).cpu()), k


def assert_frame_equal(fb, color, depth):
    got_c = fb.color.contiguous().view(torch.int32).cpu().numpy().view(
        np.uint32)
    np.testing.assert_array_equal(got_c, color)
    np.testing.assert_array_equal(
        fb.depth.cpu().numpy().view(np.uint32), depth.view(np.uint32))


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def case(request):
    sg, tr_d, li_d = mixed_scene(request.param)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    return sg, tr_d, li_d, scene, tr, li


def test_table_equals_the_per_object_tables(case):
    _, _, _, scene, tr, li = case
    assert sum(o.num_triangles for o, _ in scene) >= tsp.FUSED_SETUP_MIN
    table, old, _, _ = launches(scene, tr, li, H, W)
    plan = tsp.plan_scene_setup(scene, li.count)
    assert [k[:2] for k in plan.kinds] == list(tsp.KINDS)
    assert plan.table is None  # the plain version needs none
    assert_tables_equal(table, old, scene)


def test_raster_outputs_and_stats_equal(case):
    _, _, _, scene, tr, li = case
    _, _, new, old = launches(scene, tr, li, H, W)
    assert new.route == old.route and new.route.strategy == "sorted"
    assert_runs_equal(new, old)


def test_frames_equal_the_reference_backend_and_the_golden(case):
    sg, tr_d, li_d, scene, tr, li = case
    fb = trt.Renderer(H, W, device="cpu").render(scene, tr, li)
    ref = trt.Renderer(H, W, backend="reference", device="cpu").render(
        scene, tr, li)
    color, depth = gold.render(sg, tr_d, li_d, H, W)
    assert (depth > gold.DEPTH_CLEAR).sum() > 0.3 * H * W
    assert_frame_equal(fb, color, depth)
    assert_frame_equal(ref, color, depth)


def cluster(device):
    """The benchmark's sphere_cluster scene at 1920x1080, seed 1, on
    ``device``, at step 30 of the orbit's 240 (an eighth of a turn)."""
    from portbench import catalog, harness, scene as scenes
    from portbench import traffic as traffics
    from tpu_renderer_torch.geometry.transform import rotate_object

    cfg = catalog.config("sphere_cluster")
    mix = catalog.traffic("orbit_1080p")
    sg, tr_d, li_d = scenes.build(cfg, mix["height"], mix["width"],
                                  harness.rng(1, "scene"))
    rot = torch.as_tensor(traffics.rotation("y", 2 * np.pi * 30 / 240),
                          device=device)
    prog, tr, li = harness.device_scene(sg, tr_d, li_d, device)
    return [(rotate_object(o, rot), c) for o, c in prog], tr, li, mix


@pytest.mark.cuda
def test_cluster_on_the_card_equals_the_per_object_path():
    """At full size on the card: the grouped K1 table against K1 per
    object and the chain + K7, the raster outputs and stats of both,
    three launches of the grouped kernel and none of the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene, tr, li, mix = cluster(dev)
    h, w = mix["height"], mix["width"]
    assert len(scene) == 137
    assert sum(o.num_triangles for o, _ in scene) == 1_018_370
    counters = (tsp.setup_scene_kernel, tsp.setup_kernel,
                trp.finish_records)
    before = [c.launches for c in counters]
    tre._scene_table(scene, tr, li, h, w)
    assert [c.launches - b for c, b in zip(counters, before)] == [3, 0, 0]
    table, old, new_l, old_l = launches(scene, tr, li, h, w)
    assert_tables_equal(table, old, scene)
    assert_runs_equal(new_l, old_l)
    fb, stats = trt.Renderer(h, w, device=dev).render(scene, tr, li,
                                                      with_stats=True)
    z, _, color = (a[:h, :w] for a in new_l.run())
    assert torch.equal(bits(fb.depth), bits(z))
    assert torch.equal(fb.color.view(torch.int32), color.view(torch.int32))
    assert int(stats["bins_dropped"]) == 0
    assert int((fb.depth > gold.DEPTH_CLEAR).sum()) > 500_000
    torch.cuda.synchronize()
