"""The host side of K14, the sorted binning's CUDA kernels (csrc/binning.cu),
on the CPU: the sort key's width, the entry layout, the budget, and a NumPy
model of the kernels' algorithm held integer-exact to the plain version
(``ops.raster.bin_for_raster_plain``) over the grid of ``binning_cases``.

The model follows the kernels step by step: every slot's key s * (ntiles +
1) + tile from the bbox planes (triangle-major), one stable sort of the keys
alone (the triangle of an entry is its source index over streams * slots),
each stream's first entry of every tile where its key first reaches the
tile, the budget clamp, the dead tails, the side list in submission order
and its per-tile gate. On CPU tensors ``bin_for_raster`` runs the plain
version and launches nothing. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_binning_layout.py
"""

import numpy as np
import pytest
import torch

import binning_cases as bc
from tpu_renderer_torch.ops import binning as tb
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32
MODEL_CASES = bc.HEIGHT_CASES + bc.ROWS_CASES + bc.EDGE_CASES


def to_i32(x):
    """f32 -> int32 as XLA's convert (and __float2int_rz): truncate,
    saturate, NaN -> 0; as int64."""
    x = np.asarray(x, F)
    with np.errstate(invalid="ignore"):
        out = np.trunc(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0))
        out = np.clip(out, -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)
    out[x >= F(2.0 ** 31)] = 2 ** 31 - 1
    out[x < F(-2.0 ** 31)] = -2 ** 31
    return out


def inc_wrap(v):
    """v + 1 in int32, INT_MAX wrapping to INT_MIN."""
    return ((v + 1 + 2 ** 31) % 2 ** 32) - 2 ** 31


def div_floor(a, b, r):
    with np.errstate(invalid="ignore", over="ignore"):
        return to_i32(np.floor((a - F(r)) / F(b)))


def div_ceil(a, b, r):
    with np.errstate(invalid="ignore", over="ignore"):
        return to_i32(np.ceil((a - F(r)) / F(b)))


def kernel_model(bbox, route, height, width, row0, col0, lcap):
    """The QueueBins fields and the gate as K14 computes them, in NumPy."""
    valid, ylo, yhi, xlo, xhi = (t.numpy() for t in bbox)
    T = len(valid)
    lay = tb.queue_layout(T, height, width, route.tile_h, trp.TILE_W,
                          route.blk, route.expansion, route.budget_factor,
                          route.rows)
    rs, E, nfb, eb = lay.streams, lay.slots, lay.ntiles, lay.eb
    unit_h, n_units = route.tile_h // rs, lay.tiles_y * rs
    # bin_entries_kernel
    u_lo = np.clip(div_floor(ylo, unit_h, row0), 0, n_units)
    u_hi = np.clip(div_ceil(yhi, unit_h, row0), 0, n_units)
    tx_lo = np.clip(div_floor(xlo, trp.TILE_W, col0), 0, lay.tiles_x)
    tx_hi = np.clip(inc_wrap(div_floor(xhi, trp.TILE_W, col0)), 0,
                    lay.tiles_x)
    wx = np.maximum(tx_hi - tx_lo, 0)
    covers = valid & (u_hi > u_lo) & (wx > 0)
    bases = [u_lo + np.mod(s - u_lo, rs) for s in range(rs)]
    ns = [np.where(u_hi > b, (u_hi - b + rs - 1) // rs, 0) * wx
          for b in bases]
    small = covers & np.all([n <= E for n in ns], axis=0)
    large = covers & ~small
    wxs = np.maximum(wx, 1)
    keys = np.empty((T, rs, E), np.int64)
    for s in range(rs):
        for j in range(E):
            tile = ((bases[s] + rs * (j // wxs)) // rs) * lay.tiles_x + (
                tx_lo + j % wxs)
            keys[:, s, j] = s * (nfb + 1) + np.where(small & (j < ns[s]),
                                                     tile, nfb)
    keys = keys.reshape(-1)
    assert keys.max() <= torch.iinfo(lay.key_dtype).max
    # the sort: stable, keys alone
    perm = np.argsort(keys, kind="stable")
    skeys = keys[perm]
    # bin_bounds_kernel: first[s, t], the position where stream s's key
    # first reaches tile t (the entry count past its last key)
    m = T * E
    first = np.empty((rs, nfb + 1), np.int64)
    for p in range(rs * m):
        s, q = divmod(p, m)
        k = skeys[p] - s * (nfb + 1)
        prev = -1 if q == 0 else skeys[p - 1] - s * (nfb + 1)
        if k != prev:
            first[s, prev + 1:k + 1] = q
        if q == m - 1:
            first[s, k + 1:] = m
    ids = np.flatnonzero(large)
    large_ids = np.full(lcap, -1, np.int64)
    large_ids[:min(len(ids), lcap)] = ids[:lcap]
    # bin_finish_kernel
    tri = np.empty(rs * eb, np.int64)
    for s in range(rs):
        li = np.arange(eb)
        if rs > 1:
            kept = min(first[s, nfb], eb)
            src = perm[s * m + np.minimum(li, m - 1)] // (rs * E)
            tri[s * eb:(s + 1) * eb] = np.where(li < kept, src, li % T)
        else:
            src = perm[np.minimum(li, m - 1)] // E
            tri[:eb] = np.where(li < m, src, 0)
    clamped = np.minimum(first, eb)
    starts = (clamped + np.arange(rs)[:, None] * eb).T.reshape(-1)
    cnt = np.concatenate([clamped[:, 1:] - clamped[:, :-1],
                          np.zeros((rs, 1), np.int64)], axis=1)
    counts = cnt.T.reshape(-1)
    n = min(len(ids), lcap)
    lid = large_ids[:n]
    ty_lo = np.where(valid[lid], div_floor(ylo[lid], route.tile_h, row0), 0)
    ty_hi = np.where(valid[lid], div_ceil(yhi[lid], route.tile_h, row0), 0)
    gx_lo = np.where(valid[lid], div_floor(xlo[lid], trp.TILE_W, col0), 0)
    gx_hi = np.where(valid[lid], inc_wrap(div_floor(xhi[lid], trp.TILE_W,
                                                    col0)), 0)
    ty = np.arange(nfb) // lay.tiles_x
    tx = np.arange(nfb) % lay.tiles_x
    lcounts = ((ty[:, None] >= ty_lo) & (ty[:, None] < ty_hi)
               & (tx[:, None] >= gx_lo) & (tx[:, None] < gx_hi)).sum(axis=1)
    real = first[:, nfb]
    stats = dict(
        n_large=min(len(ids), lcap),
        n_dropped=int(np.maximum(real - eb, 0).sum()) + max(len(ids) - lcap,
                                                            0),
        n_real=int(real.sum()),
        budget_util=F(real.max()) / F(eb))
    return dict(sorted_tri=tri, starts=starts, counts=counts,
                large_ids=large_ids, lcounts=lcounts, **stats)


def plain(case):
    h, w, row0, col0 = case.rect
    bbox = bc.bbox_planes(case)
    before = trp.bin_for_raster.launches
    qbins, lcounts = trp.bin_for_raster(bbox, case.route, h, w, row0, col0)
    assert trp.bin_for_raster.launches == before  # CPU: nothing launched
    return bbox, qbins, lcounts


@pytest.mark.parametrize("case", MODEL_CASES, ids=lambda c: c.name)
def test_kernel_model_equals_plain(case):
    h, w, row0, col0 = case.rect
    bbox, qbins, lcounts = plain(case)
    got = kernel_model(bbox, case.route, h, w, row0, col0, trp.LARGE_CAPACITY)
    for name in ("sorted_tri", "starts", "counts", "large_ids"):
        want = getattr(qbins, name)
        assert want.dtype == torch.int32
        np.testing.assert_array_equal(got[name], want.numpy(), err_msg=name)
    np.testing.assert_array_equal(got["lcounts"], lcounts.numpy())
    for name in ("n_large", "n_dropped", "n_real"):
        assert got[name] == int(getattr(qbins, name)), name
    assert got["budget_util"].tobytes() == qbins.budget_util.numpy().tobytes()


def test_cases_reach_what_they_are_named_for():
    """The grid holds drops, a side list past its 2048 slots, bboxes ending
    on tile boundaries that a reciprocal would misplace, and open gates."""
    seen = {}
    for case in MODEL_CASES:
        _, qbins, lcounts = plain(case)
        seen[case.name] = (int(qbins.n_dropped), int(qbins.n_large),
                           int((lcounts > 0).sum()))
    assert seen["over-budget-rows2"][0] > 0
    assert seen["over-budget-single"][0] > 0
    for name in ("side-list-2400", "side-list-2400-rows2"):
        assert seen[name][1] == trp.LARGE_CAPACITY and seen[name][0] > 0
    # every listed triangle opens the gate of a tile of the rect
    assert all(v[2] > 0 for v in seen.values() if v[1] > 0)
    assert sum(v[1] > 0 for v in seen.values()) >= 20
    assert sum(v[0] for k, v in seen.items()
               if not k.startswith("over-budget") and
               not k.startswith("side-list")) == 0


@pytest.mark.parametrize("n_values, dtype", [
    (1, torch.int16), (32767, torch.int16), (32768, torch.int16),
    (32769, torch.int32), (2 ** 31 - 1, torch.int32)])
def test_sort_key_width(n_values, dtype):
    """Keys 0..n - 1 take int16 while they fit in 15 bits, else int32."""
    assert tb.sort_key_dtype(n_values) is dtype
    assert torch.iinfo(dtype).max >= n_values - 1


@pytest.mark.parametrize("case", bc.CASES, ids=lambda c: c.name)
def test_layout_matches_the_plain_shapes(case):
    """queue_layout's tiles, budget and key width are the plain version's:
    eb entries a stream, rows * (tiles + 1) starts, and keys that hold
    every (stream, tile) value; two slots a strip stream, else the
    expansion."""
    h, w, _, _ = case.rect
    r = case.route
    lay = tb.queue_layout(case.T, h, w, r.tile_h, trp.TILE_W, r.blk,
                          r.expansion, r.budget_factor, r.rows)
    slots = 2 if r.rows > 1 else r.expansion
    assert lay.streams == r.rows and lay.slots == slots
    assert lay.ntiles == lay.tiles_y * lay.tiles_x == (-(-h // r.tile_h)) * (
        -(-w // trp.TILE_W))
    assert lay.eb == tb.entry_budget(case.T, r.blk, r.budget_factor, slots)
    assert lay.n_keys == case.T * r.rows * slots
    assert torch.iinfo(lay.key_dtype).max >= r.rows * (lay.ntiles + 1) - 1
    assert (lay.key_dtype is torch.int32) == case.name.startswith("key32")
    if case in MODEL_CASES:
        _, qbins, lcounts = plain(case)
        assert qbins.sorted_tri.numel() == r.rows * lay.eb
        assert qbins.starts.numel() == r.rows * (lay.ntiles + 1)
        assert lcounts.numel() == lay.ntiles


@pytest.mark.parametrize("T, blk, bf, slots, want", [
    (1_001_472, 256, 0.27, 2, 270_592),  # headline-like strip stream
    (1_001_472, 128, 1.2, 4, 1_201_792),  # deferred-like, one stream
    (100, 256, 2.0, 2, 256),  # floored at one block
    (1000, 128, 4.0, 32, 4096),
    (1000, 128, 64.0, 2, 2048),  # capped at the slots' maximum
])
def test_entry_budget(T, blk, bf, slots, want):
    """budget_factor * max(T, blk) rounded up to blk, at most every slot."""
    eb = tb.entry_budget(T, blk, bf, slots)
    assert eb == want and eb % blk == 0
    assert eb <= -(-(T * slots) // blk) * blk


@pytest.mark.parametrize("rows, expansion, ok", [
    (1, 4, True), (1, 8, True), (1, 32, True), (2, 8, True),
    (1, 2, False), (1, 6, False), (3, 8, False), (4, 8, False)])
def test_kernel_layouts(rows, expansion, ok):
    """K14 takes every route's layout (one stream of 4, 8 or 32 slots, two
    strip streams of 2) and refuses the others before looking at the
    planes' device; the plain version takes them all."""
    lay = tb.queue_layout(3000, 200, 600, 8 * rows, trp.TILE_W, 256, expansion,
                          2.0, rows)
    if ok:
        tb.check_kernel_layout(lay)
    else:
        with pytest.raises(ValueError, match="one or two streams"):
            tb.check_kernel_layout(lay)


def test_kernel_wrapper_refuses_other_devices():
    """bin_queue_kernel takes CUDA planes only: CPU planes are refused
    before anything launches (bin_for_raster sends them to the plain
    version), and bin_for_raster refuses a device that is neither."""
    case = bc.EDGE_CASES[-1]
    h, w, row0, col0 = case.rect
    bbox = bc.bbox_planes(case)
    r = case.route
    with pytest.raises(ValueError, match="CUDA tensors, not cpu"):
        tb.bin_queue_kernel(bbox, h, w, r.tile_h, trp.TILE_W, r.blk,
                            r.expansion, r.budget_factor, trp.LARGE_CAPACITY,
                            row0, col0, r.rows)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        trp.bin_for_raster(tuple(t.to("meta") for t in bbox), r, h, w)
