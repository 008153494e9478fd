"""K14, the sorted strategy's binning as CUDA kernels around one sort
(``ops.binning.bin_queue_kernel``, csrc/binning.cu), against its plain
version on the card: every output of ``ops.raster.bin_for_raster`` (the
eight QueueBins fields and the side-list gate ``lcounts``) integer-exact
against ``bin_for_raster_plain`` on host copies of the same bbox planes
and on the card, over ``binning_cases``' grid: every tile height the sweep
covers, one and two streams, expansion 4, 8 and 32, sub-rects off the
frame's origin, drops past the budget, more than 2048 large triangles,
NaN, infinities and degenerate bboxes, sort keys of 16 and 32 bits. Also
K1's bboxes of the benchmark's 1M-triangle sphere at its frame sizes, on
the fused and G-buffer routes, one launch counted a draw, and the checks
that refuse bad planes.

Every test here needs an NVIDIA GPU (marked ``cuda``) and skips without
one. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_binning_kernels.py
"""

import pytest
import torch

import binning_cases as bc
import tpu_renderer_torch as trt
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import binning as tb
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import setup as tsp

pytestmark = pytest.mark.cuda
FIELDS = ("sorted_tri", "starts", "counts", "large_ids", "n_large",
          "n_dropped", "n_real", "budget_util")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def as_bits(t):
    t = t.detach().cpu().contiguous()
    return t.view(torch.int32) if t.dtype is torch.float32 else t


def assert_bins_equal(got, want, what):
    (qk, lk), (qp, lp) = got, want
    for name in FIELDS:
        a, b = getattr(qk, name), getattr(qp, name)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name)
        assert a.is_contiguous(), (what, name)
        assert torch.equal(as_bits(a), as_bits(b)), (what, name)
    assert lk.dtype == lp.dtype and lk.shape == lp.shape, what
    assert torch.equal(lk.cpu(), lp.cpu()), (what, "lcounts")


def kernel_bins(bbox, route, h, w, row0, col0):
    before = trp.bin_for_raster.launches
    out = trp.bin_for_raster(bbox, route, h, w, row0, col0)
    torch.cuda.synchronize()
    assert trp.bin_for_raster.launches == before + 1
    return out


@pytest.mark.parametrize("case", bc.CASES, ids=lambda c: c.name)
def test_kernel_equals_plain_on_the_grid(cuda, case):
    h, w, row0, col0 = case.rect
    host = bc.bbox_planes(case)
    card = tuple(t.to(cuda) for t in host)
    got = kernel_bins(card, case.route, h, w, row0, col0)
    assert got[0].sorted_tri.is_cuda and got[1].is_cuda
    assert_bins_equal(got, trp.bin_for_raster_plain(host, case.route, h, w,
                                                    row0, col0), case.name)
    assert_bins_equal(got, trp.bin_for_raster_plain(card, case.route, h, w,
                                                    row0, col0),
                      case.name + " (plain on the card)")


def test_the_grid_reaches_both_key_widths_drops_and_the_side_list(cuda):
    """The grid's named edges, read from the kernel's own outputs."""
    seen = {}
    for case in bc.CASES:
        h, w, row0, col0 = case.rect
        r = case.route
        lay = tb.queue_layout(case.T, h, w, r.tile_h, trp.TILE_W, r.blk,
                              r.expansion, r.budget_factor, r.rows)
        q, lc = kernel_bins(tuple(t.to(cuda) for t in bc.bbox_planes(case)),
                            r, h, w, row0, col0)
        seen[case.name] = (lay.key_dtype, int(q.n_dropped), int(q.n_large),
                           int((lc > 0).sum()))
    assert {v[0] for v in seen.values()} == {torch.int16, torch.int32}
    assert seen["key32-rows2"][0] is seen["key32-single"][0] is torch.int32
    assert seen["over-budget-rows2"][1] > 0 and seen["over-budget-single"][1]
    assert seen["side-list-2400"][2] == trp.LARGE_CAPACITY
    assert seen["side-list-2400"][1] > 0 and seen["side-list-2400"][3] > 0


@pytest.mark.parametrize("shape", [(1080, 1920), (2160, 3840)])
def test_benchmark_sphere_on_both_routes(cuda, shape):
    """K1's bboxes of the 1M-triangle sphere at the benchmark's frame sizes
    (and its backdrop quad merged in, as the deferred cells draw it): the
    fused route (two strip streams) and the G-buffer route (one stream,
    expansion 4), integer-exact against the plain version on the card."""
    h, w = shape
    mesh = tp.merge_meshes(tp.construct_sphere_grid(708, 707),
                           tp.construct_quad(2.2))
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(
        [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": True})], tr_d, li_d,
        device=cuda)
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    T = table.num_triangles
    for route in (trp.raster_route(T, h, w), tgb.gbuffer_route(T, h, w)):
        got = kernel_bins(table.bbox, route, h, w, 0, 0)
        want = trp.bin_for_raster_plain(table.bbox, route, h, w, 0, 0)
        assert_bins_equal(got, want, f"{shape} {route}")
        assert int(got[0].n_dropped) == 0 and int(got[0].n_real) > 0
    assert trp.raster_route(T, h, w).rows == 2
    assert tgb.gbuffer_route(T, h, w).expansion == 4


def test_one_launch_counted_a_draw(cuda):
    """A sorted frame through Renderer bins once a draw, on the kernels;
    the mask route never calls them."""
    scene, tr, li = bc_scene(cuda, 46, 45)
    r = trt.Renderer(128, 128, device=cuda)
    before = trp.bin_for_raster.launches
    for _ in range(3):
        r.render(scene, tr, li)
    torch.cuda.synchronize()
    assert trp.bin_for_raster.launches == before + 3
    small, tr_s, li_s = bc_scene(cuda, 8, 8)
    before = trp.bin_for_raster.launches
    trt.Renderer(128, 128, device=cuda).render(small, tr_s, li_s)
    assert trp.bin_for_raster.launches == before


def bc_scene(device, lat, lon):
    tr_d, li_d = ts.baseline_camera_lights(128, 128)
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(lat, lon)),
           {"phong": True})]
    return ts.to_torch_scene(sg, tr_d, li_d, device=device)


def test_kernel_refuses_bad_planes(cuda):
    """Planes of the wrong type, length or layout, or on another device,
    raise before anything launches."""
    case = bc.EDGE_CASES[0]
    h, w, row0, col0 = case.rect
    bbox = tuple(t.to(cuda) for t in bc.bbox_planes(case))
    route = case.route
    bad = {
        "valid as f32": (bbox[0].float(),) + bbox[1:],
        "ylo as f64": (bbox[0], bbox[1].double()) + bbox[2:],
        "xhi short": bbox[:4] + (bbox[4][1:],),
        "xlo strided": bbox[:3] + (torch.stack([bbox[3], bbox[3]], 1)[:, 0],
                                  bbox[4]),
        "yhi on the host": bbox[:2] + (bbox[2].cpu(),) + bbox[3:],
    }
    for what, planes in bad.items():
        before = trp.bin_for_raster.launches
        with pytest.raises((TypeError, ValueError)):
            trp.bin_for_raster(planes, route, h, w, row0, col0)
        assert trp.bin_for_raster.launches == before, what
