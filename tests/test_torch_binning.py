"""Port binning (tpu_renderer_torch.ops.binning) vs the JAX package's.

Both packages get the SAME bbox rows (from the JAX package's setup) so
binning is compared on its own; every output must be integer-exact:
sorted_tri (dead tail included), starts, counts, large_ids, n_large,
n_dropped and n_real. Both the row-packed strip streams (8-row tiles,
WIDE_BLK) and the single stream (8-row tiles at WIDE_BLK with expansion 8,
16-row tiles at QUEUE_BLK with expansion 32) are held to it. The policy
helpers that pick the route and the budget must agree as well, and so must
the K7 record transpose's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_render import jax_setup, mesh_for
from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import binning as jb
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.sphere import construct_sphere
from tpu_renderer_torch.ops import binning as tb
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
F = np.float32


@pytest.fixture(scope="module")
def bboxes():
    """JAX's fused-setup bboxes of the sphere grid and its side-list
    variant (test_torch_render.jax_setup, computed once per process)."""
    return {v: (len(mesh_for(v)["vertices"]) // 3, list(jax_setup(v)[1]))
            for v in ("sphere", "sidelist")}


def both_bins(bbox, budget_factor, large_capacity=2048):
    args = (H, W, 8, 128, 256, budget_factor, large_capacity, 0, 0, 2)
    jq = jax.jit(lambda b: jb._bin_queue_rows(b, *args, False))(
        tuple(jnp.asarray(a) for a in bbox))
    tq = tb._bin_queue_rows(tuple(torch.tensor(a) for a in bbox), *args)
    return jq, tq


def assert_bins_equal(jq, tq):
    for name in ("sorted_tri", "starts", "counts", "large_ids", "n_large",
                 "n_dropped", "n_real"):
        got = getattr(tq, name).numpy()
        want = np.asarray(getattr(jq, name))
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(tq.budget_util.numpy(),
                                  np.asarray(jq.budget_util))


@pytest.mark.parametrize("scene", ["sphere", "sidelist"])
def test_bin_queue_rows_integer_exact(bboxes, scene):
    T, bbox = bboxes[scene]
    route = trp.raster_route(T, H, W)
    jq, tq = both_bins(bbox, route.budget_factor)
    assert_bins_equal(jq, tq)
    assert int(tq.n_dropped) == 0
    if scene == "sidelist":
        assert int(tq.n_large) > 0


@pytest.mark.parametrize("bf,cap", [(0.05, 2048), (0.5, 1)])
def test_drops_counted_identically(bboxes, bf, cap):
    """A budget far below demand, or a side list of one slot: entries drop,
    and both packages count the same drops and keep the same prefix."""
    _, bbox = bboxes["sidelist"]
    jq, tq = both_bins(bbox, bf, cap)
    assert_bins_equal(jq, tq)
    assert int(tq.n_dropped) > 0


@pytest.mark.parametrize("T", [4140, 4608, 51200, 10 ** 6])
@pytest.mark.parametrize("bf", [0.19, 0.49, 1.2])
def test_entry_budget_policy(T, bf):
    want = int(-(-(bf * max(T, 256)) // 256)) * 256
    want = min(want, -(-(T * 2) // 256) * 256)
    assert tb.entry_budget(T, 256, bf) == want


@pytest.mark.parametrize("seed,p,cap", [(0, 0.001, 64), (1, 0.05, 64),
                                        (2, 0.5, 2048), (3, 0.0, 16)])
def test_large_side_list(seed, p, cap):
    rng = np.random.default_rng(seed)
    large = rng.uniform(size=5000) < p
    jids, jn = jb._large_side_list(jnp.asarray(large), cap)
    tids, tn = tb._large_side_list(torch.from_numpy(large), cap)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tn) == int(jn) == int(large.sum())


def test_count_subset_per_tile(bboxes):
    _, bbox = bboxes["sidelist"]
    jq, tq = both_bins(bbox, 0.5)
    ids = tq.large_ids
    want = jb.count_subset_per_tile(
        jnp.asarray(ids.numpy()), None, H, W, 8, 128,
        bbox=tuple(jnp.asarray(a) for a in bbox))
    got = tb.count_subset_per_tile(
        ids, H, W, 8, 128, bbox=tuple(torch.tensor(a) for a in bbox))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and int(got.sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbox_core_special_values(seed):
    """Seeded edge rows with NaN / Inf / out-of-frame values: tri_valid,
    ylo, yhi exact; xlo / xhi to rtol 1e-6 (XLA contracts the
    x0 + (ymax - 1 - ymin) * xg term into an FMA)."""
    rng = np.random.default_rng(seed)
    n = 3000
    ymin = np.floor(rng.uniform(-20, 150, (3, n))).astype(F)
    ymax = (ymin + np.floor(rng.uniform(-2, 30, (3, n)))).astype(F)
    x0 = rng.uniform(-50, 180, (3, n)).astype(F)
    xg = rng.normal(0, 3, (3, n)).astype(F)
    valid = rng.uniform(size=(3, n)) < 0.8
    for arr, val in ((x0, np.nan), (xg, np.inf), (xg, -np.inf),
                     (x0, np.inf), (ymin, np.nan)):
        arr[rng.integers(0, 3, 40), rng.integers(0, n, 40)] = val
    want = jb._bbox_core([jnp.asarray(v) for v in valid],
                         *[[jnp.asarray(a[e]) for e in range(3)]
                           for a in (ymin, ymax, x0, xg)], H, W)
    got = tb._bbox_core([torch.from_numpy(v) for v in valid],
                        *[[torch.from_numpy(a[e]) for e in range(3)]
                          for a in (ymin, ymax, x0, xg)], H, W)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6)


@pytest.mark.parametrize("T", [300, 600, 4140, 51200, 200000, 1001112])
@pytest.mark.parametrize("hw", [(128, 128), (512, 512), (1080, 1920)])
def test_route_policy_helpers(T, hw):
    """The route follows the JAX package's gates (raster_pallas.py:2529-
    2690): sorted above 512 triangles, 8- or 16-row tiles, row packing 2
    on 8-row tiles at or below 12 px/triangle, the expansion and budget
    block of the route, and the flat per-stream budget for several
    objects under row packing; the mask strategy at or below 512, with the
    same tile height."""
    h, w = hw
    assert trp._pick_tile_h(T, h, w) == jrp._pick_tile_h(T, h, w)
    for th in (8, 16):
        assert trp._queue_expansion(th, T) == jrp._queue_expansion(th, T)
    assert (trp._rows_stream_budget_factor(T, h, w)
            == jrp._rows_stream_budget_factor(T, h, w))
    if T <= jrp.AUTO_SORTED_THRESHOLD:
        r = trp.raster_route(T, h, w)
        assert (r.strategy, r.tile_h) == ("mask", jrp._pick_tile_h(T, h, w))
        return
    tile_h = jrp._pick_tile_h(T, h, w)
    exp, bf = jrp._queue_expansion(tile_h, T)
    rows2 = tile_h == 8 and T * jrp.PACK_ROWS_MAX_PX_PER_TRI >= h * w
    for n_obj in (1, 3):
        r = trp.raster_route(T, h, w, n_obj)
        assert (r.strategy, r.tile_h, r.rows) == (
            "sorted", tile_h, 2 if rows2 else 1)
        assert (r.expansion, r.policy_factor) == (exp, bf)
        assert r.blk == (jrp.WIDE_BLK if tile_h == 8 else jrp.QUEUE_BLK)
        if not rows2:
            want = bf
        elif n_obj > 1:
            want = (1.2 * jrp.PACK_ROWS_STREAM_FRAC) * (2.0 / 2)
        else:
            want = jrp._rows_stream_budget_factor(T, h, w) * (2.0 / 2)
        assert r.budget_factor == want


def test_test_scene_takes_the_main_route():
    """4,140 triangles at 128x128: sorted (T > 512), 8-row tiles
    (T * 256 > H * W), row packing 2 (T * 12 >= H * W)."""
    r = trp.raster_route(4140, H, W)
    assert (r.strategy, r.tile_h, r.rows) == ("sorted", 8, 2)
    assert r.policy_factor == 2
    assert r.budget_factor == jrp._rows_stream_budget_factor(4140, H, W)


# ---------------------------------------------------------------------------
# The single stream (K3: 8-row tiles; K4: 16-row tiles) and its inputs
# ---------------------------------------------------------------------------


def jax_table(mesh, h, w, phong=True, p=(0.0, 0.0, 0.0)):
    """The JAX package's channel-major setup_records table (85, T)."""
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    sg = [(dict(p=p, **mesh), {"phong": phong})]
    (o, c), tr, li = (lambda s_: (s_[0][0], s_[1], s_[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    return np.array(jax.jit(jvx.setup_records, static_argnums=3)(
        o, tr, li, c))


def test_triangle_bbox_rows_vs_jax():
    """From the same channel-major table: tri_valid / ylo / yhi exact,
    xlo / xhi to rtol 1e-6 (XLA contracts x0 + (ymax - 1 - ymin) * xg)."""
    rec = jax_table(tp.merge_meshes(construct_sphere(12),
                                    tp.construct_quad(2.2)), 384, 384)
    want = jb.triangle_bbox_rows(jnp.asarray(rec), 384, 384)
    got = tb.triangle_bbox_rows(torch.from_numpy(rec), 384, 384)
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    for i in (3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=1e-6)
    assert got[0].dtype == torch.bool and int(got[0].sum()) > 0


SINGLE_ROUTES = {  # route -> (mesh, frame, tile_h)
    "k3": (lambda: js.baseline_scene(2, 256, 256)[0][0][0], 256, 8),
    "k4": (lambda: construct_sphere(12), 384, 16),
}


@pytest.fixture(scope="module")
def single_bboxes():
    """The JAX package's bbox rows of each route's scene and of its
    side-list variant (a 2.2-unit quad merged in)."""
    out = {}
    for name, (mesh_fn, hw, tile_h) in SINGLE_ROUTES.items():
        mesh = {k: v for k, v in mesh_fn().items()
                if k in ("vertices", "colors", "normals", "uvs")}
        for variant, m in (("base", mesh), ("sidelist", tp.merge_meshes(
                mesh, tp.construct_quad(2.2)))):
            bbox = jb.triangle_bbox_rows(jnp.asarray(jax_table(m, hw, hw)),
                                         hw, hw)
            out[name, variant] = (hw, tile_h, [np.asarray(a) for a in bbox])
    return out


def single_bins(hw, tile_h, bbox, budget_factor=None, large_capacity=2048):
    T = bbox[0].shape[0]
    route = trp.raster_route(T, hw, hw)
    assert (route.tile_h, route.rows) == (tile_h, 1)
    args = (hw, hw, tile_h, 128, route.blk)
    kw = dict(expansion=route.expansion,
              budget_factor=(route.budget_factor if budget_factor is None
                             else budget_factor),
              large_capacity=large_capacity)
    jq = jax.jit(lambda b: jb.bin_triangles_queue(None, *args, bbox=b,
                                                  **kw))(
        tuple(jnp.asarray(a) for a in bbox))
    tq = tb.bin_triangles_queue(*args, bbox=tuple(
        torch.tensor(a) for a in bbox), **kw)
    return jq, tq


@pytest.mark.parametrize("variant", ["base", "sidelist"])
@pytest.mark.parametrize("route", ["k3", "k4"])
def test_bin_queue_single_integer_exact(single_bboxes, route, variant):
    hw, tile_h, bbox = single_bboxes[route, variant]
    jq, tq = single_bins(hw, tile_h, bbox)
    assert_bins_equal(jq, tq)
    assert tq.starts.shape[0] == (-(-hw // tile_h)) * (-(-hw // 128)) + 1
    assert int(tq.n_dropped) == 0
    assert (int(tq.n_large) > 0) == (variant == "sidelist")
    lc_j = jb.count_subset_per_tile(
        jq.large_ids, None, hw, hw, tile_h, 128,
        bbox=tuple(jnp.asarray(a) for a in bbox))
    lc_t = tb.count_subset_per_tile(
        tq.large_ids, hw, hw, tile_h, 128,
        bbox=tuple(torch.tensor(a) for a in bbox))
    np.testing.assert_array_equal(lc_t.numpy(), np.asarray(lc_j))


@pytest.mark.parametrize("route", ["k3", "k4"])
@pytest.mark.parametrize("bf,cap", [(0.05, 2048), (2, 1)])
def test_single_stream_drops_counted_identically(single_bboxes, route, bf,
                                                 cap):
    """A budget far below demand, or a one-slot side list: both packages
    drop and count the same entries and keep the same prefix."""
    hw, tile_h, bbox = single_bboxes[route, "sidelist"]
    jq, tq = single_bins(hw, tile_h, bbox, bf, cap)
    assert_bins_equal(jq, tq)
    assert int(tq.n_dropped) > 0


@pytest.mark.parametrize("T", [1, 300, 511, 512, 700])
def test_finish_records_plain_vs_jax(T):
    """K7's plain version (pad + t().contiguous()) against the JAX
    package's Pallas transpose in interpret mode: bit-exact, NaN and -0
    lanes included."""
    rng = np.random.default_rng(T)
    rec = rng.normal(size=(85, T)).astype(F)
    rec[rng.integers(0, 85, 20), rng.integers(0, T, 20)] = np.nan
    rec[0, 0] = -0.0
    want = np.asarray(jrp.finish_records(jnp.asarray(rec)))
    got = trp.finish_records(torch.from_numpy(rec)).numpy()
    assert got.shape == want.shape == (T + (-T % 512), 128)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
