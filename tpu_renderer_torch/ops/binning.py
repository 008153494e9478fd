"""Tile binning: triangle bboxes -> per-tile triangle lists (the mask
strategy) or per-tile entry streams (the sorted strategy), as torch ops.

PyTorch counterpart of ``tpu_renderer.ops.binning``: ``_bbox_core``,
``triangle_bbox_rows``, ``_bin_from_bbox`` / ``bin_triangles`` (the mask
strategy's fixed-capacity lists, submission order kept, overflow counted
in ``n_dropped``), ``count_subset_per_tile``,
``_large_side_list`` (the searchsorted form), ``_bin_queue_rows`` (row
packing, two strip streams) and the single-stream branch of
``bin_triangles_queue``. Every array compares integer-exact with the JAX
package's (these torch ops are the plain version; on CUDA tensors the
sorted strategy runs K14, ``bin_queue_kernel``, below):

- sort keys are int64 ``(tile << 32) | tri``, one sort per stream, which
  orders entries exactly like the JAX package's packed u32 keys (and its
  pair-sort fallback, which is not ported);
- the static entry budget, the drop counts and the dead tails (the
  strip streams' ``idx % T`` rewrite; the single stream's sentinel-key
  triangle ids, zero past the sort) are kept as they are;
- the work-item tables (``item_start`` / ``wi_tile``) are not built: they
  only drive the TPU's sequential grid, and the CUDA raster kernel walks
  each tile's ``starts`` / ``counts`` directly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..core.math import clip, maximum, minimum, scalar, to_i32
from ..geometry.vertex import EDGE_STRIDE

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64
_BIG = float(np.float32(3.4028235e38))  # FLT_MAX


def _nan_to_num(x, nan, posinf, neginf):
    x = torch.where(torch.isnan(x), nan, x)
    x = torch.where(x == float("inf"), posinf, x)
    return torch.where(x == float("-inf"), neginf, x)


def _bbox_core(valids, ymins, ymaxs, x0s, xgs, height: int, width: int):
    """Conservative per-triangle screen bbox from per-edge rows (length-3
    lists of (T,) tensors): (tri_valid, ylo, yhi, xlo, xhi)."""
    valid = [v & (ymaxs[e] > ymins[e]) for e, v in enumerate(valids)]

    def mn3(vals, fill):
        a = [torch.where(valid[e], vals[e], fill) for e in range(3)]
        return minimum(minimum(a[0], a[1]), a[2])

    def mx3(vals, fill):
        a = [torch.where(valid[e], vals[e], fill) for e in range(3)]
        return maximum(maximum(a[0], a[1]), a[2])

    ylo = mn3(ymins, _BIG)
    yhi = mx3(ymaxs, -_BIG)
    yhi = minimum(yhi, float(height))

    xa = x0s
    xb = [x0s[e] + (ymaxs[e] - 1.0 - ymins[e]) * xgs[e] for e in range(3)]
    xlo = mn3([minimum(xa[e], xb[e]) for e in range(3)], _BIG)
    xhi = mx3([maximum(xa[e], xb[e]) for e in range(3)], -_BIG)
    # NaN-proof: degenerate values force the triangle invalid below.
    nvalid = (valid[0].to(I32) + valid[1].to(I32) + valid[2].to(I32))
    tri_valid = (
        (nvalid >= 2) & (yhi > ylo)
        & torch.isfinite(ylo) & torch.isfinite(yhi)
    )
    w1 = float(width - 1)
    xlo = clip(_nan_to_num(xlo, 0.0, w1, 0.0) - 1.0, 0.0, w1)
    xhi = clip(_nan_to_num(xhi, w1, w1, 0.0) + 1.0, 0.0, w1)
    ylo = clip(ylo, 0.0, float(height))
    yhi = clip(yhi, 0.0, float(height))
    return tri_valid, ylo, yhi, xlo, xhi


def triangle_bbox_rows(rec_t, height: int, width: int):
    """The bbox straight from the channel-major record table (85+, T)
    (binning.py:100): lanes valid 0, ymin 1, ymax 2, x0 3, xg 4 of each
    edge."""

    def rows(j):
        return [rec_t[e * EDGE_STRIDE + j] for e in range(3)]

    return _bbox_core([r > 0.5 for r in rows(0)], rows(1), rows(2), rows(3),
                      rows(4), height, width)


def count_subset_per_tile(subset_ids, height: int, width: int, tile_h: int,
                          tile_w: int, row0=0, col0=0, bbox=None):
    """Per-tile overlap counts of a compacted triangle subset (-1 = empty
    slot): the (tiles_y * tiles_x,) i32 gate the raster kernel uses to
    skip the side-list fold on tiles no large triangle touches."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    tri_valid, ylo, yhi, xlo, xhi = bbox
    dev = subset_ids.device
    ok = subset_ids >= 0
    safe = torch.clamp(subset_ids, min=0).to(I64)
    valid = ok & tri_valid[safe]
    ylo = ylo[safe] - float(row0)
    yhi = yhi[safe] - float(row0)
    xlo = xlo[safe] - float(col0)
    xhi = xhi[safe] - float(col0)

    th_f, tw_f = scalar(tile_h, dev), scalar(tile_w, dev)
    ty_lo = to_i32(torch.floor(ylo / th_f))
    ty_hi = to_i32(torch.ceil(yhi / th_f))
    tx_lo = to_i32(torch.floor(xlo / tw_f))
    tx_hi = to_i32(torch.floor(xhi / tw_f)) + 1

    ty_ids = torch.arange(tiles_y, dtype=I32, device=dev)
    tx_ids = torch.arange(tiles_x, dtype=I32, device=dev)
    in_y = (ty_ids[None, :] >= ty_lo[:, None]) & (ty_ids[None, :] < ty_hi[:, None])
    in_x = (tx_ids[None, :] >= tx_lo[:, None]) & (tx_ids[None, :] < tx_hi[:, None])
    mask = valid[:, None, None] & in_y[:, :, None] & in_x[:, None, :]
    return mask.to(I32).sum(dim=0, dtype=I32).reshape(-1)


class TileBins(NamedTuple):
    """Per-tile triangle lists of the mask strategy."""

    ids: torch.Tensor  # (tiles_y, tiles_x, K) i32 triangle ids, -1 = empty
    counts: torch.Tensor  # (tiles_y, tiles_x) i32 kept triangles per tile
    n_dropped: torch.Tensor  # () i32 triangles past the capacity, all tiles


def _bin_from_bbox(tri_valid, ylo, yhi, xlo, xhi, tri_ids, tiles_y: int,
                   tiles_x: int, tile_h: int, tile_w: int, capacity: int,
                   row0=0, col0=0) -> TileBins:
    """Dense-mask binning over global-frame bboxes (binning.py:120): each
    tile lists the ``tri_ids`` of the triangles whose bbox overlaps it, in
    submission order (an exclusive cumsum gives each its slot), the first
    ``capacity`` kept and the rest counted in n_dropped."""
    T = tri_valid.shape[0]
    dev = tri_valid.device
    ntiles = tiles_y * tiles_x
    th_f, tw_f = scalar(tile_h, dev), scalar(tile_w, dev)
    ylo = ylo - float(row0)
    yhi = yhi - float(row0)
    xlo = xlo - float(col0)
    xhi = xhi - float(col0)
    ty_lo = to_i32(torch.floor(ylo / th_f))
    ty_hi = to_i32(torch.ceil(yhi / th_f))  # exclusive
    tx_lo = to_i32(torch.floor(xlo / tw_f))
    tx_hi = to_i32(torch.floor(xhi / tw_f)) + 1  # exclusive

    ty_ids = torch.arange(tiles_y, dtype=I32, device=dev)
    tx_ids = torch.arange(tiles_x, dtype=I32, device=dev)
    in_y = (ty_ids[None, :] >= ty_lo[:, None]) & (ty_ids[None, :] < ty_hi[:, None])
    in_x = (tx_ids[None, :] >= tx_lo[:, None]) & (tx_ids[None, :] < tx_hi[:, None])
    mask = (tri_valid[:, None, None] & in_y[:, :, None]
            & in_x[:, None, :]).reshape(T, ntiles)

    pos = torch.cumsum(mask.to(I32), dim=0, dtype=I32) - 1  # (T, tiles)
    total = torch.where(mask.any(dim=0), pos[-1] + 1, 0)
    n_dropped = torch.clamp(total - capacity, min=0).sum(dtype=I32)
    # Slot `capacity` of each tile's row is the discard slot.
    slot = torch.where(mask & (pos < capacity), pos, capacity).to(I64)
    flat = torch.arange(ntiles, dtype=I64, device=dev)[None, :] * (
        capacity + 1) + slot
    ids = torch.full((ntiles * (capacity + 1),), -1, dtype=I32, device=dev)
    ids.scatter_(0, flat.reshape(-1),
                 tri_ids.to(I32)[:, None].expand(T, ntiles).reshape(-1))
    ids = ids.reshape(ntiles, capacity + 1)[:, :capacity]
    return TileBins(
        ids=ids.reshape(tiles_y, tiles_x, capacity).contiguous(),
        counts=torch.clamp(total, max=capacity).to(I32).reshape(tiles_y,
                                                                tiles_x),
        n_dropped=n_dropped,
    )


def bin_triangles(height: int, width: int, tile_h: int, tile_w: int,
                  capacity: int, row0=0, col0=0, bbox=None) -> TileBins:
    """The mask strategy's per-tile triangle lists (binning.py:173) over
    the local (height, width) rect at origin (row0, col0), from the
    global-frame bboxes (``triangle_bbox_rows`` or K1's)."""
    if bbox is None:
        raise ValueError("bin_triangles needs the setup bboxes")
    tri_valid = bbox[0]
    T = tri_valid.shape[0]
    return _bin_from_bbox(
        *bbox, torch.arange(T, dtype=I32, device=tri_valid.device),
        -(-height // tile_h), -(-width // tile_w), tile_h, tile_w, capacity,
        row0, col0)


def _large_side_list(large, large_capacity: int):
    """Compact the large-triangle mask into a fixed-capacity id list in
    submission order: slot i holds the first t whose inclusive cumsum of
    ``large`` reaches i + 1 (a searchsorted, no scatter).

    Returns (large_ids (large_capacity,) i32, -1 padded; n_large () i64,
    the UNCLAMPED total)."""
    pos_incl = torch.cumsum(large.to(I64), dim=0)
    n_large = pos_incl[-1]
    targets = torch.arange(1, large_capacity + 1, dtype=I64,
                           device=large.device)
    idx = torch.searchsorted(pos_incl, targets, side="left")
    large_ids = torch.where(targets <= n_large, idx, -1).to(I32)
    return large_ids, n_large


class QueueBins(NamedTuple):
    """Entry streams of the sorted strategy, ``rs`` streams of one budget
    each (rs = 1, or the row packing's 2).

    Stream s holds the entries binned to strip s of each framebuffer tile
    (the whole tile when rs = 1), sorted by (tile, triangle id); the
    streams are concatenated (stream s offset by s budgets) and
    ``starts`` / ``counts`` are interleaved at index ``rs * tile + s`` (the
    last tile index is the empty sentinel). Triangles spanning more strips
    or tiles than the expansion go to the ``large_ids`` side list."""

    sorted_tri: torch.Tensor  # (rs * EB,) i32 triangle id per entry
    starts: torch.Tensor  # (rs * (ntiles + 1),) i32 first entry per strip
    counts: torch.Tensor  # (rs * (ntiles + 1),) i32 kept entries per strip
    large_ids: torch.Tensor  # (Lcap,) i32, -1 padded
    n_large: torch.Tensor  # () i32, clamped to Lcap
    n_dropped: torch.Tensor  # () i32 entry-budget + side-list drops
    n_real: torch.Tensor  # () i32 real entries before the budget
    budget_util: torch.Tensor  # () f32 max-stream real / stream budget


def entry_budget(T: int, blk: int, budget_factor: float, exp_h: int = 2):
    """Static per-stream entry budget: budget_factor * max(T, blk), rounded
    up to ``blk``, capped at the expansion's maximum (binning.py:486-487)."""
    eb = int(-(-(budget_factor * max(T, blk)) // blk)) * blk
    return min(eb, -(-(T * exp_h) // blk) * blk)


def _bin_queue_rows(bbox, height, width, tile_h, tile_w, blk, budget_factor,
                    large_capacity, row0, col0, row_split) -> QueueBins:
    """Per-parity strip binning (binning.py:403): entries are binned to
    (tile_h / row_split)-row strips, one stream per strip parity, each
    expanded to <= 2 slots per triangle, sorted by (tile, tri) and
    budgeted on its own."""
    rs = row_split
    exp_h = 2
    strip_h = tile_h // rs
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    nfb = tiles_y * tiles_x
    n_strips = tiles_y * rs

    tri_valid, ylo, yhi, xlo, xhi = bbox
    T = tri_valid.shape[0]
    dev = tri_valid.device
    ylo = ylo - float(row0)
    yhi = yhi - float(row0)
    xlo = xlo - float(col0)
    xhi = xhi - float(col0)

    sh_f, tw_f = scalar(strip_h, dev), scalar(tile_w, dev)
    sy_lo = torch.clamp(to_i32(torch.floor(ylo / sh_f)), 0, n_strips)
    sy_hi = torch.clamp(to_i32(torch.ceil(yhi / sh_f)), 0, n_strips)
    tx_lo = torch.clamp(to_i32(torch.floor(xlo / tw_f)), 0, tiles_x)
    tx_hi = torch.clamp(to_i32(torch.floor(xhi / tw_f)) + 1, 0, tiles_x)
    sy_lo, sy_hi, tx_lo, tx_hi = (a.to(I64) for a in (sy_lo, sy_hi, tx_lo,
                                                      tx_hi))
    wx = torch.clamp(tx_hi - tx_lo, min=0)
    covers = tri_valid & (sy_hi > sy_lo) & (wx > 0)

    # Parity h's strips within [sy_lo, sy_hi) start at base_h, step rs.
    bases, nslots = [], []
    for h in range(rs):
        base = sy_lo + ((h - sy_lo) % rs)
        ns = torch.where(sy_hi > base, (sy_hi - base + (rs - 1)) // rs, 0) * wx
        bases.append(base)
        nslots.append(ns)

    small = covers
    for ns in nslots:
        small = small & (ns <= exp_h)
    large = covers & ~small

    eb = entry_budget(T, blk, budget_factor, exp_h)

    j = torch.arange(exp_h, dtype=I64, device=dev)[:, None]
    wx_safe = torch.clamp(wx, min=1)[None, :]
    entry_tri = torch.arange(T, dtype=I64, device=dev)[None, :].expand(
        exp_h, T).reshape(-1)
    bounds = torch.arange(nfb + 1, dtype=I64, device=dev) << 32
    idx = torch.arange(eb, dtype=I64, device=dev)

    starts_sides, counts_sides, tris_sides = [], [], []
    drops = torch.zeros((), dtype=I64, device=dev)
    n_real = torch.zeros((), dtype=I64, device=dev)
    max_stream_real = torch.zeros((), dtype=I64, device=dev)
    for h in range(rs):
        strip = bases[h][None, :] + rs * (j // wx_safe)
        tile = (strip // rs) * tiles_x + (tx_lo[None, :] + j % wx_safe)
        slot_ok = small[None, :] & (j < nslots[h][None, :])
        entry_tile = torch.where(slot_ok, tile, nfb).reshape(-1)
        skey, _ = torch.sort((entry_tile << 32) | entry_tri)
        starts_full = torch.searchsorted(skey, bounds, side="left")
        sorted_tri = skey & 0xFFFFFFFF
        real = starts_full[nfb]
        drops = drops + torch.clamp(real - eb, min=0)
        n_real = n_real + real
        max_stream_real = torch.maximum(max_stream_real, real)
        starts_h = torch.clamp(starts_full, max=eb)
        keep_h = starts_h[1:] - starts_h[:-1]
        if sorted_tri.shape[0] < eb:
            sorted_tri = torch.nn.functional.pad(
                sorted_tri, (0, eb - sorted_tri.shape[0]))
        sorted_tri = sorted_tri[:eb]
        # Dead tail: positions past the kept prefix point at distinct
        # sequential rows (never read; kept for integer-exact tables).
        sorted_tri = torch.where(idx < starts_h[nfb], sorted_tri, idx % T)
        starts_sides.append(starts_h + h * eb)
        counts_sides.append(torch.cat([keep_h, keep_h.new_zeros(1)]))
        tris_sides.append(sorted_tri)

    large_ids, n_large = _large_side_list(large, large_capacity)
    eb_f = scalar(eb, dev)
    return QueueBins(
        sorted_tri=torch.cat(tris_sides).to(I32),
        starts=torch.stack(starts_sides, dim=1).reshape(-1).to(I32),
        counts=torch.stack(counts_sides, dim=1).reshape(-1).to(I32),
        large_ids=large_ids,
        n_large=torch.clamp(n_large, max=large_capacity).to(I32),
        n_dropped=(drops + torch.clamp(n_large - large_capacity, min=0)
                   ).to(I32),
        n_real=n_real.to(I32),
        budget_util=max_stream_real.to(F32) / eb_f,
    )


def _bin_queue_single(bbox, height, width, tile_h, tile_w, blk, expansion,
                      budget_factor, large_capacity, row0, col0) -> QueueBins:
    """One stream (binning.py:664-867): each triangle expands to the <=
    ``expansion`` tiles its bbox covers (slot j -> tile (ty_lo + j // wx,
    tx_lo + j % wx)), the slots sort by (tile, tri) and the first
    ``entry_budget`` entries are kept; triangles covering more tiles go to
    the side list."""
    tiles_y = -(-height // tile_h)
    tiles_x = -(-width // tile_w)
    ntiles = tiles_y * tiles_x

    tri_valid, ylo, yhi, xlo, xhi = bbox
    T = tri_valid.shape[0]
    dev = tri_valid.device
    ylo = ylo - float(row0)
    yhi = yhi - float(row0)
    xlo = xlo - float(col0)
    xhi = xhi - float(col0)

    th_f, tw_f = scalar(tile_h, dev), scalar(tile_w, dev)
    ty_lo = torch.clamp(to_i32(torch.floor(ylo / th_f)), 0, tiles_y)
    ty_hi = torch.clamp(to_i32(torch.ceil(yhi / th_f)), 0, tiles_y)
    tx_lo = torch.clamp(to_i32(torch.floor(xlo / tw_f)), 0, tiles_x)
    tx_hi = torch.clamp(to_i32(torch.floor(xhi / tw_f)) + 1, 0, tiles_x)
    ty_lo, ty_hi, tx_lo, tx_hi = (a.to(I64) for a in (ty_lo, ty_hi, tx_lo,
                                                      tx_hi))
    wy = torch.clamp(ty_hi - ty_lo, min=0)
    wx = torch.clamp(tx_hi - tx_lo, min=0)
    n_tiles = torch.where(tri_valid, wy * wx, 0)

    small = (n_tiles > 0) & (n_tiles <= expansion)
    large = n_tiles > expansion

    j = torch.arange(expansion, dtype=I64, device=dev)[:, None]
    wx_safe = torch.clamp(wx, min=1)[None, :]
    tile = (ty_lo[None, :] + j // wx_safe) * tiles_x + (
        tx_lo[None, :] + j % wx_safe)
    slot_ok = small[None, :] & (j < n_tiles[None, :])
    entry_tile = torch.where(slot_ok, tile, ntiles).reshape(-1)
    entry_tri = torch.arange(T, dtype=I64, device=dev)[None, :].expand(
        expansion, T).reshape(-1)
    eb = entry_budget(T, blk, budget_factor, expansion)

    skey, _ = torch.sort((entry_tile << 32) | entry_tri)
    bounds = torch.arange(ntiles + 1, dtype=I64, device=dev) << 32
    starts_full = torch.searchsorted(skey, bounds, side="left")
    sorted_tri = skey & 0xFFFFFFFF
    total_real = starts_full[ntiles]
    starts = torch.clamp(starts_full, max=eb)
    keep_t = starts[1:] - starts[:-1]
    if sorted_tri.shape[0] < eb:
        sorted_tri = torch.nn.functional.pad(
            sorted_tri, (0, eb - sorted_tri.shape[0]))
    large_ids, n_large = _large_side_list(large, large_capacity)
    eb_f = scalar(eb, dev)
    return QueueBins(
        sorted_tri=sorted_tri[:eb].to(I32),
        starts=starts.to(I32),
        counts=torch.cat([keep_t, keep_t.new_zeros(1)]).to(I32),
        large_ids=large_ids,
        n_large=torch.clamp(n_large, max=large_capacity).to(I32),
        n_dropped=(torch.clamp(total_real - eb, min=0)
                   + torch.clamp(n_large - large_capacity, min=0)).to(I32),
        n_real=total_real.to(I32),
        budget_util=total_real.to(F32) / eb_f,
    )


def bin_triangles_queue(height: int, width: int, tile_h: int, tile_w: int,
                        blk: int, expansion: int = 8, budget_factor: float = 2,
                        large_capacity: int = 2048, row0=0, col0=0,
                        bbox=None, row_split: int = 1) -> QueueBins:
    """Sorted-strategy binning of the local (height, width) rect at origin
    (row0, col0) from precomputed global-frame bboxes: one stream with
    ``expansion`` slots per triangle, or (``row_split`` > 1) the
    per-parity strip streams, where ``budget_factor`` is per stream and
    each stream expands to 2 slots per triangle (``expansion`` unused)."""
    if bbox is None:
        raise ValueError("bin_triangles_queue needs the setup bboxes")
    if row_split > 1:
        return _bin_queue_rows(
            bbox, height, width, tile_h, tile_w, blk, budget_factor,
            large_capacity, row0, col0, row_split,
        )
    return _bin_queue_single(
        bbox, height, width, tile_h, tile_w, blk, expansion, budget_factor,
        large_capacity, row0, col0,
    )


# ---------------------------------------------------------------------------
# K14: the sorted strategy's binning as CUDA kernels around one sort
# ---------------------------------------------------------------------------

KEY16_VALUES = 2 ** 15  # distinct sort keys an int16 key holds (0..32767)


def sort_key_dtype(n_values: int) -> torch.dtype:
    """The narrowest sort key for keys 0..n_values - 1: int16 up to
    KEY16_VALUES values (the sort then makes two radix passes), else
    int32."""
    return torch.int16 if n_values <= KEY16_VALUES else torch.int32


class QueueLayout(NamedTuple):
    """A sorted draw's shapes as K14 lays them out: ``streams`` streams of
    ``slots`` slots a triangle (2 per strip stream under row packing, else
    the expansion), entries triangle-major (triangle t's slot j of stream s
    at t * streams * slots + s * slots + j), each keyed s * (ntiles + 1) +
    tile (tile ntiles for a dead slot) in ``key_dtype``; ``eb`` entries a
    stream kept."""

    streams: int
    slots: int
    tiles_y: int
    tiles_x: int
    ntiles: int
    eb: int
    n_keys: int
    key_dtype: torch.dtype


def queue_layout(T: int, height: int, width: int, tile_h: int, tile_w: int,
                 blk: int, expansion: int, budget_factor: float,
                 row_split: int = 1) -> QueueLayout:
    """The layout of ``bin_triangles_queue``'s streams over T triangles
    (the bbox planes' length) on the local (height, width) rect."""
    slots = 2 if row_split > 1 else expansion
    tiles_y, tiles_x = -(-height // tile_h), -(-width // tile_w)
    ntiles = tiles_y * tiles_x
    return QueueLayout(row_split, slots, tiles_y, tiles_x, ntiles,
                       entry_budget(T, blk, budget_factor, slots),
                       T * row_split * slots,
                       sort_key_dtype(row_split * (ntiles + 1)))


def check_kernel_layout(lay: QueueLayout) -> None:
    """Raise unless K14 takes the layout: one or two streams (every route's),
    streams * slots a power of two of at least 4 (whole 8-byte words of keys,
    and a shift from an entry to its triangle), fewer than 2^31 keys."""
    per = lay.streams * lay.slots
    if lay.streams not in (1, 2) or per < 4 or per & (per - 1) or (
            lay.n_keys >= 2 ** 31):
        raise ValueError(
            f"K14 takes one or two streams of a power-of-two number (>= 4 in "
            f"all) of slots and < 2^31 keys, not {lay.streams} x "
            f"{lay.slots} slots, {lay.n_keys} keys")


def bin_queue_kernel(bbox, height: int, width: int, tile_h: int, tile_w: int,
                     blk: int, expansion: int, budget_factor: float,
                     large_capacity: int, row0: int = 0, col0: int = 0,
                     row_split: int = 1):
    """K14 (csrc/binning.cu): ``bin_triangles_queue`` and the side-list
    gate (``count_subset_per_tile`` over its ``large_ids``) of CUDA bbox
    planes -> (QueueBins, lcounts (ntiles,) i32), integer-exact against
    them. Two C entries around one stable ``torch.sort`` of the
    ``queue_layout`` keys: the entries (keys and the large mask), then the
    tile bounds and side list, and the outputs. No host sync: every shape
    is known from T and the grid."""
    valid = bbox[0]
    dev = valid.device
    T = int(valid.shape[0])
    lay = queue_layout(T, height, width, tile_h, tile_w, blk, expansion,
                       budget_factor, row_split)
    check_kernel_layout(lay)
    if dev.type != "cuda":
        raise ValueError(f"K14 runs on CUDA tensors, not {dev}")
    _cuda.check_tensor("tri_valid", valid, dev, torch.bool, (T,))
    for name, t in zip(("ylo", "yhi", "xlo", "xhi"), bbox[1:]):
        _cuda.check_tensor(name, t, dev, F32, (T,))
    rs, nst = lay.streams, lay.streams * (lay.ntiles + 1)
    key_bytes = 2 if lay.key_dtype is torch.int16 else 4
    grid = (T, rs, lay.slots, lay.tiles_y, lay.tiles_x, tile_h, tile_w,
            row0, col0)
    planes = tuple(t.data_ptr() for t in bbox)
    keys = torch.empty((lay.n_keys,), dtype=lay.key_dtype, device=dev)
    nwords, nblocks = -(-T // 32), -(-T // 256)
    sizes = (nwords, nblocks, nst, 1, rs * lay.eb, nst, nst, large_capacity,
             lay.ntiles, 4)
    (words, block_large, first, n_all, sorted_tri, starts, counts, large_ids,
     lcounts, stats) = torch.empty((sum(sizes),), dtype=I32,
                                   device=dev).split(sizes)
    _cuda.launch("tr_bin_entries", dev, *planes, *grid, key_bytes,
                 keys.data_ptr(), words.data_ptr(), block_large.data_ptr())
    skeys, perm = torch.sort(keys, stable=True)
    _cuda.launch("tr_bin_finish", dev, skeys.data_ptr(), key_bytes,
                 perm.data_ptr(), words.data_ptr(), block_large.data_ptr(),
                 *planes, *grid, lay.eb, large_capacity, first.data_ptr(),
                 n_all.data_ptr(), sorted_tri.data_ptr(), starts.data_ptr(),
                 counts.data_ptr(), large_ids.data_ptr(), lcounts.data_ptr(),
                 stats.data_ptr())
    n_large, n_dropped, n_real, util = stats.unbind()
    return QueueBins(sorted_tri=sorted_tri, starts=starts, counts=counts,
                     large_ids=large_ids, n_large=n_large,
                     n_dropped=n_dropped, n_real=n_real,
                     budget_util=util.view(F32)), lcounts


_P, _I = ctypes.c_void_p, ctypes.c_int
_GRID = [_I] * 9  # T, rs, slots, tiles_y, tiles_x, tile_h, tile_w, row0, col0
_cuda.declare("tr_bin_entries", [_P] * 5 + _GRID + [_I] + [_P] * 4)
_cuda.declare("tr_bin_finish", [_P, _I, _P, _P, _P] + [_P] * 5 + _GRID
              + [_I, _I] + [_P] * 8 + [_P])
