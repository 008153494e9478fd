"""Rasterization into a G-buffer: the path of textured objects the fused
kernels cannot take, and the raw G-buffer API.

PyTorch counterpart of ``tpu_renderer.ops.raster_pallas``'s G-buffer
family (raster_pallas.py:1723-2092) and its entry point
``rasterize_pallas`` (:2822). The G-buffer is channel-first (11, H, W) f32:
z, rgba, normal xyz, u/z, v/z, 1/z (``GBUF_CHANNELS``,
golden/cpu_reference.py:302); uncovered pixels hold DEPTH_CLEAR and zeros,
and gid -1. It holds three kernels, in ``csrc/raster.cu``:

- K8, ``raster_pass``: the mask strategy (``_raster_kernel_tilelist``
  :1756), each tile folding its ``bin_triangles`` list in place, a frame
  row a block;
- K9, ``raster_pass_queue``: the sorted strategy's single stream
  (``_raster_kernel_queue`` :1853), each tile's entries split into parts
  of at most ``ops.raster.RASTER_PART_ENTRIES`` that many blocks fold in
  parallel, merged by a 64-bit (z desc, gid asc) key per pixel;
- K10: the large-triangle side list (``_raster_kernel_bcast`` :2018, merged
  by ``_merge_gbuf_by_gid`` :2954), one more part of each tile it reaches,
  inside K9's call, merged by the same key, and counted with K9.

Each wrapper launches its kernel on CUDA tensors and runs its plain
version on CPU tensors: ``gbuffer_plain``, the plain raster's fragments and
winners (``ops.raster.raster_fragments``, ``resolve_winners``) over all 10
attribute planes. Both CUDA entries take any multiple of 8 rows, as the
Pallas kernels. K9 has one form a height: 8-row tiles the split form
(K2's, whose blocks fold a part into winners in registers), every other
multiple of 8 the band form (K4's: each part folded over only the rows
its entries reach, fragment by fragment, csrc/raster.cu). Other heights
raise on CUDA tensors; the plain version takes any tile height.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _cuda
from ..geometry.vertex import REC_LANES
from ..utils.profiling import annotate
from . import raster as _raster
from .binning import QueueBins, TileBins, bin_triangles
from .raster import (
    COL_FIELDS,
    F32,
    I32,
    NRM_FIELDS,
    QUEUE_BLK,
    TILE_W,
    UV_FIELDS,
    RasterRoute,
    _mask_guard,
    _queue_expansion,
    bin_for_raster,
    bin_stats,
    check_cuda_tile_h,
    pick_strategy,
    mask_capacity,
    mask_stream,
    raster_fragments,
    resolve_winners,
    setup_out,
)

GBUF_CHANNELS = 11  # z, rgba, normal xyz, u/z, v/z, 1/z
ATTR_FIELDS = COL_FIELDS + NRM_FIELDS + UV_FIELDS  # channels 1..10


def gbuffer_route(t_policy: int, frame_height: int, frame_width: int,
                  strategy: str = "auto", tile_h: int | None = None,
                  budget_override: float | None = None) -> RasterRoute:
    """rasterize_pallas's route (raster_pallas.py:2864-2907): the mask
    strategy up to AUTO_SORTED_THRESHOLD triangles under 'auto', else the
    sorted one with ONE stream at every tile height, budget block
    QUEUE_BLK and _queue_expansion's policy factor as the budget (no row
    packing, no rows-scaled budget, unlike the fused ``raster_route``);
    ``budget_override`` replaces that factor."""
    strategy, tile_h = pick_strategy(t_policy, frame_height, frame_width,
                                     strategy, tile_h)
    if strategy == "mask":
        return RasterRoute("mask", tile_h, 1, 0, 0, 0.0, 0.0)
    expansion, policy = _queue_expansion(tile_h, t_policy, budget_override)
    return RasterRoute("sorted", tile_h, 1, expansion, QUEUE_BLK, policy,
                       policy)


def _outputs(tiles_y: int, tile_h: int, tiles_x: int, dev):
    hp, wp = tiles_y * tile_h, tiles_x * TILE_W
    return (torch.empty((hp, wp), dtype=I32, device=dev),
            torch.empty((GBUF_CHANNELS, hp, wp), dtype=F32, device=dev))


def _check_cuda(kernel: str, dev, recs, tile_h: int) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, not {dev}")
    check_cuda_tile_h(kernel, tile_h)
    _cuda.check_tensor("recs", recs, dev, F32, (recs.shape[0], REC_LANES))


def raster_pass(recs, bins: TileBins, *, tile_h: int, tiles_y: int,
                tiles_x: int, row0: int, col0: int, frame_width: int):
    """K8, the mask strategy into a G-buffer (tiles of any multiple of 8
    rows): each tile folds its list ``bins.ids`` (submission order,
    ``bins.counts`` entries) over all of its rows, reading the records in
    place, one block a frame row.
    Returns (gid (hp, wp) i32, gbuf (11, hp, wp) f32) for every tile, hp =
    tiles_y * tile_h, wp = tiles_x * 128. CUDA tensors launch
    ``tr_gbuffer_mask`` and count ``raster_pass.launches``; CPU tensors
    run ``raster_pass_plain``."""
    dev = recs.device
    kw = dict(tile_h=tile_h, tiles_y=tiles_y, tiles_x=tiles_x, row0=row0,
              col0=col0, frame_width=frame_width)
    if tuple(bins.counts.shape) != (tiles_y, tiles_x):
        raise ValueError(f"bins for {tuple(bins.counts.shape)} tiles, "
                         f"launch of {(tiles_y, tiles_x)}")
    if dev.type == "cpu":
        return raster_pass_plain(recs, bins, **kw)
    _check_cuda("K8", dev, recs, tile_h)
    capacity = bins.ids.shape[2]
    _cuda.check_tensor("ids", bins.ids, dev, I32,
                       (tiles_y, tiles_x, capacity))
    _cuda.check_tensor("counts", bins.counts, dev, I32, (tiles_y, tiles_x))
    gid, gbuf = _outputs(tiles_y, tile_h, tiles_x, dev)
    _cuda.launch(
        "tr_gbuffer_mask", dev,
        recs.data_ptr(), bins.ids.data_ptr(), bins.counts.data_ptr(),
        capacity, tile_h, tiles_y, tiles_x, row0, col0, frame_width,
        gid.data_ptr(), gbuf.data_ptr())
    raster_pass.launches += 1
    return gid, gbuf


def raster_pass_queue(recs, qbins: QueueBins, lcounts, *, tile_h: int,
                      tiles_y: int, tiles_x: int, row0: int, col0: int,
                      frame_width: int):
    """K9 + K10, the sorted strategy into a G-buffer: each tile's stream
    entries, and where ``lcounts`` is open the side list
    ``qbins.large_ids``, folded in parts of at most
    ``ops.raster.RASTER_PART_ENTRIES`` entries (the side list one part)
    and merged by the (z desc, gid asc) key; tiles of any multiple of 8
    rows on CUDA tensors (8 rows in the split form, every other height in
    the band form). Outputs as ``raster_pass``'s.
    CUDA tensors launch ``tr_gbuffer_queue`` (the key fill, the part count, the
    walk and the finalize are its device ops), count
    ``raster_pass_queue.launches`` once (K10 runs inside that call) and leave
    the parts' offsets on the device in ``raster_pass_queue.part_offsets``
    ((tiles + 1,) i32, tile t's parts from [t] to [t + 1], the last the total);
    CPU tensors run ``gbuffer_plain``."""
    dev = recs.device
    nfb = tiles_y * tiles_x
    if qbins.starts.shape[0] != nfb + 1:
        raise ValueError(f"starts has {qbins.starts.shape[0]} entries for "
                         f"{nfb} tiles and one stream")
    if dev.type == "cpu":
        return gbuffer_plain(recs, qbins, lcounts, tile_h=tile_h,
                             tiles_y=tiles_y, tiles_x=tiles_x, row0=row0,
                             col0=col0, frame_width=frame_width)
    _check_cuda("K9", dev, recs, tile_h)
    for name, t, shape in (
        ("sorted_tri", qbins.sorted_tri, qbins.sorted_tri.shape),
        ("starts", qbins.starts, (nfb + 1,)),
        ("counts", qbins.counts, (nfb + 1,)),
        ("large_ids", qbins.large_ids, qbins.large_ids.shape),
        ("n_large", qbins.n_large, ()),
        ("lcounts", lcounts, (nfb,)),
    ):
        _cuda.check_tensor(name, t, dev, I32, shape)
    gid, gbuf = _outputs(tiles_y, tile_h, tiles_x, dev)
    keys = torch.empty(gid.shape, dtype=torch.int64, device=dev)
    part_off = torch.empty((nfb + 1,), dtype=I32, device=dev)
    _cuda.launch(
        "tr_gbuffer_queue", dev,
        recs.data_ptr(), qbins.sorted_tri.data_ptr(), qbins.starts.data_ptr(),
        qbins.counts.data_ptr(), qbins.large_ids.data_ptr(),
        qbins.n_large.data_ptr(), lcounts.data_ptr(), tile_h, tiles_y,
        tiles_x, row0, col0, frame_width, qbins.sorted_tri.shape[0],
        _raster.RASTER_PART_ENTRIES, keys.data_ptr(), part_off.data_ptr(),
        gid.data_ptr(), gbuf.data_ptr())
    raster_pass_queue.launches += 1
    raster_pass_queue.part_offsets = part_off
    return gid, gbuf


raster_pass.launches = 0
raster_pass_queue.launches = 0
raster_pass_queue.part_offsets = None
_cuda.declare("tr_gbuffer_mask", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
              + [ctypes.c_void_p] * 3)
_cuda.declare("tr_gbuffer_queue", [ctypes.c_void_p] * 7
              + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 5)


def gbuffer_plain(recs, qbins: QueueBins, lcounts, *, tile_h: int,
                  tiles_y: int, tiles_x: int, row0: int, col0: int,
                  frame_width: int):
    """Plain-PyTorch K9 + K10: ``raster_fragments`` of the stream and the
    side list with the 10 attribute planes, each pixel's winner
    (``resolve_winners``), stacked as (gid (hp, wp), gbuf (11, hp, wp))."""
    hp, wp = tiles_y * tile_h, tiles_x * TILE_W
    frags = raster_fragments(
        recs, qbins, lcounts, tile_h=tile_h, tiles_y=tiles_y,
        tiles_x=tiles_x, row0=row0, col0=col0, frame_width=frame_width,
        fields=ATTR_FIELDS)
    z, gid, planes = resolve_winners(frags, hp, wp)
    return gid, torch.stack([z] + planes)


def raster_pass_plain(recs, bins: TileBins, *, tiles_y: int, tiles_x: int,
                      **kw):
    """Plain-PyTorch K8: ``gbuffer_plain`` over ``mask_stream`` (each
    listed triangle on all of its tile's rows, no side list)."""
    lcounts = torch.zeros((tiles_y * tiles_x,), dtype=I32,
                          device=recs.device)
    return gbuffer_plain(recs, mask_stream(bins), lcounts, tiles_y=tiles_y,
                         tiles_x=tiles_x, **kw)


class GBufferLaunch(NamedTuple):
    """One G-buffer raster launch, ready to run: its route, its wrapper
    (``raster_pass``, K8, or ``raster_pass_queue``, K9 + K10) and the
    wrapper's operands ((recs, bins) or (recs, qbins, lcounts)) and
    options."""

    route: RasterRoute
    kernel: object
    operands: tuple
    options: dict  # tile_h, tiles_y, tiles_x, row0, col0, frame_width

    @property
    def qbins(self) -> QueueBins:
        """The sorted route's stream (``mask_stream`` on the mask route)."""
        if self.route.strategy == "mask":
            return mask_stream(self.operands[1])
        return self.operands[1]

    def run(self):
        """(gid, gbuf) of every tile from the route's kernel (its plain
        version on CPU tensors)."""
        return self.kernel(*self.operands, **self.options)

    def run_plain(self):
        """The same outputs from the plain version, on any device."""
        if self.route.strategy == "mask":
            return raster_pass_plain(*self.operands, **self.options)
        return gbuffer_plain(*self.operands, **self.options)

    def stats(self) -> dict:
        """rasterize_pallas's stats (``ops.raster.bin_stats``)."""
        return bin_stats(self.route, self.operands[1])


def prepare_gbuffer(table, height: int, width: int,
                    capacity: int | None = None,
                    frame_height: int | None = None,
                    frame_width: int | None = None, row0: int = 0,
                    col0: int = 0, strategy: str = "auto",
                    tile_h: int | None = None,
                    budget_override: float | None = None) -> GBufferLaunch:
    """Everything before the G-buffer kernel (raster_pallas.py:2846-2911)
    for the local (height, width) rect at origin (row0, col0): the
    row-major table and bboxes, the route, the binning.

    ``table`` is a SetupOut (K1's table and bboxes), the channel-major
    (85, T) table of ``setup_records`` (bboxes from ``triangle_bbox_rows``,
    the row-major form from ``finish_records``, K7) or an EdgeTable
    (``ops.raster.record_table``), each made a SetupOut by
    ``ops.raster.setup_out``. The strategy and tile height follow the
    true triangle count; the mask capacity (default ``mask_capacity``) the
    table's rows, padding included; ``budget_override`` the sorted
    budget (``gbuffer_route``). There is no zcull here: the JAX package
    never culls the G-buffer kernels."""
    if frame_height is None:
        frame_height = height
    if frame_width is None:
        frame_width = width
    table, T = setup_out(table, frame_height, frame_width)
    with annotate("tr.binning"):
        recs, bbox, t_policy = table.recs, table.bbox, table.num_triangles
        route = gbuffer_route(t_policy, frame_height, frame_width, strategy,
                              tile_h, budget_override)
        tiles_y = -(-height // route.tile_h)
        tiles_x = -(-width // TILE_W)
        options = dict(tile_h=route.tile_h, tiles_y=tiles_y, tiles_x=tiles_x,
                       row0=row0, col0=col0, frame_width=frame_width)
        if route.strategy == "mask":
            capacity = mask_capacity(T) if capacity is None else capacity
            _mask_guard(capacity, tiles_y, tiles_x)
            bins = bin_triangles(height, width, route.tile_h, TILE_W, capacity,
                                 row0, col0, bbox)
            return GBufferLaunch(route, raster_pass, (recs, bins), options)
        qbins, lcounts = bin_for_raster(bbox, route, height, width, row0, col0)
        return GBufferLaunch(route, raster_pass_queue, (recs, qbins, lcounts),
                             options)


def rasterize_gbuffer(table, height: int, width: int,
                      capacity: int | None = None,
                      frame_height: int | None = None,
                      frame_width: int | None = None, row0: int = 0,
                      col0: int = 0, strategy: str = "auto",
                      tile_h: int | None = None,
                      budget_override: float | None = None):
    """rasterize_pallas (raster_pallas.py:2822): ``table`` (see
    ``prepare_gbuffer``) rasterized into the local (height, width) rect ->
    (covered (H, W) bool, gbuf (11, H, W) f32, stats), ``strategy`` 'mask',
    'sorted' or 'auto', ``capacity`` the mask strategy's list length,
    ``budget_override`` the sorted strategy's budget factor; stats as
    ``GBufferLaunch.stats``."""
    launch = prepare_gbuffer(table, height, width, capacity, frame_height,
                             frame_width, row0, col0, strategy, tile_h,
                             budget_override)
    with annotate("tr.raster"):
        gid, gbuf = launch.run()
        return (gid[:height, :width] >= 0, gbuf[:, :height, :width],
                launch.stats())
