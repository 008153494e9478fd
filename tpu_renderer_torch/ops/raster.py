"""Fused raster + shade, the texture atlas, and the record transpose.

PyTorch counterpart of ``tpu_renderer.ops.raster_pallas``'s fused path,
one or several objects per launch, textured ('scalar' addressing, nearest
or bilinear, within the fused atlas limits) or not. It holds five kernels:

- K2, K3 and K4: the Pallas ``_raster_kernel_queue_shaded``
  (raster_pallas.py:2192) on the sorted strategy's routes -- 8-row tiles
  with row packing 2 (K2, ``raster_kernel``), 8-row tiles with one stream
  (K3, ``raster_rows1_kernel``), and taller tiles with one stream (K4,
  ``raster_narrow_any_kernel``: on CUDA any multiple of 8 rows);
- K6: the Pallas ``_raster_kernel_tilelist_shaded`` (raster_pallas.py:2121),
  the mask strategy (``raster_mask_kernel``), tiles of any multiple of 8
  rows, each folded a row a block;
- K5: the texture fetch of their finalize (``_sample_texture_atlas`` :755,
  ``_sample_texture_atlas_bilinear`` :863), a device function of
  ``csrc/shade.cuh`` with no launch of its own; its plain version is
  ``ops.shading.sample_atlas``;
- K7: ``finish_records`` (raster_pallas.py:449), the transpose of a
  channel-major record table to the row-major one (``csrc/records.cu``).

Each wrapper launches its CUDA kernel on CUDA tensors and runs its plain
version on CPU tensors. Every CUDA raster kernel takes any multiple of 8
rows, as the Pallas kernels; other heights raise on CUDA tensors
(``check_cuda_tile_h``), and the plain versions take any height. The
sorted kernels have one form a height: 8-row tiles (K2, K3, K11, and K9 in
``ops.gbuffer``) the split form, whose blocks fold a part of a tile's
entries into winners in registers; every other multiple of 8 (K4, and K9
+ K10) the band form (``tr_raster_narrow_any``, ``tr_gbuffer_queue``),
whose blocks fold a part over only the rows its entries reach, fragment by
fragment. Either way one wrapper call is four device ops: the CUDA code
cuts each tile's streams into parts of at most ``RASTER_PART_ENTRIES``
entries (the side list one more part), many blocks fold the parts, a
64-bit (z desc, gid asc) key per pixel merges them, and a finalize block
per tile (per 8-row band in the band form) shades the winners. The mask
kernels (K6, K8) fold each tile's list a frame row a block. The raster
kernels' plain version, ``raster_plain``, is vectorised over the binned
entries (the mask strategy's lists go in as one stream, ``mask_plain``);
each pixel's winner is the lexicographic best (z descending, gid
ascending) over fragments with z > DEPTH_CLEAR, which is what the TPU
kernels' strict '>' first-writer folds over gid-ordered lists plus the
sorted strategy's gid-aware side-list merge compute. Multi-object launches
pick each pixel's object from the winner's gid (``_finalize_shade``,
raster_pallas.py:1600).

K11, the occlusion skip (``zcull``), is K2 and K3 with a per-batch cull
(``raster_zcull_kernel``, ``raster_rows1_zcull_kernel``) against the
part's own winners and the merge keys as they stand; the cull changes
no output, so its plain version
is ``raster_plain``, and ``zcull_skips_plain`` replays the skips a part
takes against its own winners alone, a floor under the kernel's count. As
in the JAX package it applies on 8-row tiles only: K4, K6 and the G-buffer
kernels ignore the flag.

The G-buffer kernels K8, K9 and K10 (``ops.gbuffer``) share these
kernels' fold, binning and plain fragments.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _cuda
from ..core.math import maximum, minimum, round_half_away, scalar, to_i32
from ..core.types import DEPTH_CLEAR, LightData, ProjectiveTransform
from ..geometry.vertex import (
    EDGE_STRIDE,
    REC_ROWS,
    EdgeTable,
    F_COL0,
    F_COLG,
    F_LEFT,
    F_N0,
    F_NG,
    F_OZ0,
    F_OZG,
    F_U0,
    F_UG,
    F_V0,
    F_VALID,
    F_VG,
    F_X0,
    F_XG,
    F_YMAX,
    F_YMIN,
    F_Z0,
    F_ZG,
    GID_LANE,
    REC_LANES,
)
from ..utils.profiling import annotate
from .binning import (
    QueueBins,
    TileBins,
    bin_queue_kernel,
    bin_triangles,
    bin_triangles_queue,
    count_subset_per_tile,
    triangle_bbox_rows,
)
from .setup import SetupOut
from .shading import (
    pack_argb_planes,
    sample_atlas,
    shade_params,
    shade_planes,
)

F32 = torch.float32
I32 = torch.int32
I64 = torch.int64

TILE_W = 128
WIDE_BLK = 256  # entry-budget rounding block of 8-row tiles
QUEUE_BLK = 128  # entry-budget rounding block of 16-row tiles
REC_T_BLK = 512  # finish_records pads the triangle axis to this (_PACK_T_BLK)
_BIG = float(np.float32(3.4028235e38))  # FLT_MAX
AUTO_SORTED_THRESHOLD = 512  # 'auto' picks the sorted strategy above this
TILE8_PX_PER_TRI = 256  # 8-row tiles below this many frame px / triangle
PACK_ROWS = 2
PACK_ROWS_MAX_PX_PER_TRI = 12  # row packing at or below this px / triangle
PACK_ROWS_STREAM_FRAC = 0.45  # multi-object per-stream budget, x 1.2
LARGE_CAPACITY = 2048  # side-list slots (bin_triangles_queue default)
CHUNK_T = 8  # the mask strategy's list capacity rounds up to this
MASK_MAX_CAPACITY = 4096
STRATEGIES = ("auto", "mask", "sorted")
# K2, K3, K4, K9, K11: stream entries per part (csrc/raster.cu, "The
# sorted strategy, each tile's entries split"), chosen on an H100 by
# chip_smoke.py's sweeps (PERF.md). It spreads the work and changes no
# output: any int in [1, 2^31) gives the same frame, bit for bit; 2^31 - 1
# gives one part a stream of a tile.
RASTER_PART_ENTRIES = 32
_MASK_BLOCK_BYTES_CAP = 4 * 1024 * 1024  # one tile's list of records
_MASK_TOTAL_BYTES_CAP = 512 * 1024 * 1024  # all tiles' lists of records
# The f32 gid lane is exact only up to 2**24 triangles per scene.
MAX_SCENE_TRIANGLES = 2 ** 24
# Fused texturing limits of the whole scene atlas (raster_pallas.py:535).
MAX_FUSED_TEX_DIM = 512
MAX_FUSED_TEX_PIXELS = 128 * 128

COL_FIELDS = tuple((F_COL0 + c, F_COLG + c) for c in range(4))
NRM_FIELDS = tuple((F_N0 + c, F_NG + c) for c in range(3))
UV_FIELDS = ((F_U0, F_UG), (F_V0, F_VG), (F_OZ0, F_OZG))  # u/z, v/z, 1/z


def _queue_expansion(tile_h: int, num_triangles: int, override=None):
    """(expansion, budget_factor) policy of the sorted strategy's stream
    (raster_pallas.py:160): the tiles a triangle may cover before it goes
    to the side list, and the entry budget per triangle; the factor is
    reported as stats['bins_budget_factor']. ``override`` (a renderer's
    budget_factor) replaces the policy's factor."""
    if tile_h >= 16 and num_triangles <= 16384:
        exp, bf = 32, 4
    elif tile_h <= 8 and num_triangles > 65536:
        exp, bf = 4, 1.2
    else:
        exp, bf = 8, 2
    return exp, (bf if override is None else override)


def _rows_stream_budget_factor(t_policy, frame_height, frame_width):
    """Per-stream budget factor of the row-packed streams, scaled to the
    scene's density (raster_pallas.py:270): a piecewise-linear fit of 2x
    the measured per-stream demand, never above the flat 0.54."""
    ppt = (frame_height * frame_width) / max(t_policy, 1)
    pts = (  # (px/tri, per-stream budget = 2x measured demand)
        (0.52, 0.19), (1.04, 0.268), (2.07, 0.382),
        (2.93, 0.444), (4.15, 0.496), (5.88, 0.544),
    )
    flat = 0.54
    if ppt <= pts[0][0]:
        return pts[0][1]
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if ppt <= x1:
            return min(flat, y0 + (y1 - y0) * (ppt - x0) / (x1 - x0))
    return flat


def _pick_tile_h(num_triangles: int, height: int = 1080,
                 width: int = 1920) -> int:
    """8-row tiles for dense scenes, 16-row for sparse ones."""
    return 8 if num_triangles * TILE8_PX_PER_TRI > height * width else 16


class ObjSpec(NamedTuple):
    """Per-object spec of a launch: the object's global-triangle-id range
    [gid_lo, gid_hi) in the scene's record table (gid_hi = gid_lo + T, not
    the padded end), Phong or Gouraud, and ``tex``: None, or the object's
    texture in the scene atlas as (v_off, th, tw) (nearest) or (v_off, th,
    tw, 'bilinear')."""

    gid_lo: int
    gid_hi: int
    phong: bool
    tex: tuple | None = None

    @property
    def bilinear(self) -> bool:
        return self.tex is not None and len(self.tex) > 3 and (
            self.tex[3] == "bilinear")


def _scene_fields(objspecs):
    """The planes the scene's finalize reads (raster_pallas.py:561):
    (fields, col_off, nrm_off, uv_off), the (j0, jg) lane pairs of the
    planes and each group's first plane (None when absent). The colour
    unless EVERY object is textured (texture replaces the base colour),
    the normal iff any object is Phong, u/z v/z 1/z iff any is
    textured."""
    fields: tuple = ()
    col_off = nrm_off = uv_off = None
    if any(o.tex is None for o in objspecs):
        col_off = 0
        fields += COL_FIELDS
    if any(o.phong for o in objspecs):
        nrm_off = len(fields)
        fields += NRM_FIELDS
    if any(o.tex is not None for o in objspecs):
        uv_off = len(fields)
        fields += UV_FIELDS
    return fields, col_off, nrm_off, uv_off


def _atlas_dims(objspecs):
    """(rows, max width) of the scene texture atlas."""
    ah = max(o.tex[0] + o.tex[1] for o in objspecs if o.tex is not None)
    aw = max(o.tex[2] for o in objspecs if o.tex is not None)
    return ah, aw


def texture_fits_fused(th: int, tw: int) -> bool:
    """Within the fused path's atlas limits (renderer.py:77)."""
    return max(th, tw) <= MAX_FUSED_TEX_DIM and th * tw <= MAX_FUSED_TEX_PIXELS


def pack_texture_atlas(textures):
    """Stack (th, tw) u32 ARGB textures row-wise into one scene atlas
    (raster_pallas.py:605): (atlas (AH, AW) int32 holding the u32 texels,
    each texture zero padded to the widest; row offset per texture). The
    offsets and dimensions are the JAX package's; its atlas holds the same
    texels as bf16 channel blocks [r|g|b|a] for the TPU's one-hot matrix
    product, which the H100 does not need."""
    aw = max(int(t.shape[1]) for t in textures)
    rows, offs, off = [], [], 0
    for t in textures:
        t = t.view(I32)
        if t.shape[1] < aw:
            t = torch.nn.functional.pad(t, (0, aw - t.shape[1]))
        rows.append(t)
        offs.append(off)
        off += int(t.shape[0])
    atlas = rows[0] if len(rows) == 1 else torch.cat(rows)
    return atlas.contiguous(), offs


@functools.lru_cache(maxsize=64)
def obj_table(objspecs: tuple, device) -> torch.Tensor:
    """The (n_obj, 3) i32 [gid_lo, gid_hi, phong] table the raster kernels
    read in their finalize. Cached per scene layout, so every caller shares
    one read-only tensor: copying it to the card every frame would make the
    host wait for the device."""
    return torch.tensor([[o.gid_lo, o.gid_hi, int(o.phong)]
                         for o in objspecs], dtype=I32, device=device)


@functools.lru_cache(maxsize=64)
def tex_table(objspecs: tuple, device) -> torch.Tensor:
    """The (n_obj, 4) i32 [v_off, th, tw, bilinear] table of the objects'
    textures in the scene atlas (th = 0: untextured), cached like
    ``obj_table``."""
    return torch.tensor([list(o.tex[:3]) + [int(o.bilinear)]
                         if o.tex is not None else [0, 0, 0, 0]
                         for o in objspecs], dtype=I32, device=device)


class RasterRoute(NamedTuple):
    """How a draw is binned and rasterized (raster_pallas.py:2529-2700)."""

    strategy: str  # 'mask' or 'sorted'
    tile_h: int
    rows: int  # streams per tile: 2 under row packing, else 1
    expansion: int  # tiles a triangle may cover off the side list
    blk: int  # entry-budget rounding block
    budget_factor: float  # per stream, as binning uses it
    policy_factor: float  # _queue_expansion's, reported in the stats


def pick_strategy(t_policy: int, frame_height: int, frame_width: int,
                  strategy: str, tile_h: int | None) -> tuple[str, int]:
    """(strategy, tile_h) of a T-triangle draw (raster_pallas.py:2529-2532):
    'auto' takes the mask strategy up to AUTO_SORTED_THRESHOLD triangles
    and the sorted one above it, 'mask' or 'sorted' forces one; ``tile_h``
    None takes ``_pick_tile_h``'s height."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy: {strategy}")
    if strategy == "auto":
        strategy = ("sorted" if t_policy > AUTO_SORTED_THRESHOLD
                    else "mask")
    if tile_h is None:
        tile_h = _pick_tile_h(t_policy, frame_height, frame_width)
    return strategy, tile_h


def raster_route(t_policy: int, frame_height: int, frame_width: int,
                 n_objects: int = 1, budget_override: float | None = None,
                 strategy: str = "auto",
                 tile_h: int | None = None) -> RasterRoute:
    """The fused route of a T-triangle draw of ``n_objects`` objects on
    this frame (raster_pallas.py:2529-2532, 2640-2690): the strategy and
    tile height of ``pick_strategy`` (the mask strategy has no stream:
    expansion, blk and the budget factors are 0); on the sorted strategy,
    8-row tiles (wide) pack two row streams when the scene is dense
    enough, taller ones run one stream. ``budget_override`` replaces the
    policy factor (and is what the stats report); under row packing it is
    scaled by PACK_ROWS_STREAM_FRAC * 2 / rows
    (raster_pallas.py:2654-2666)."""
    strategy, tile_h = pick_strategy(t_policy, frame_height, frame_width,
                                     strategy, tile_h)
    if strategy == "mask":
        return RasterRoute("mask", tile_h, 1, 0, 0, 0.0, 0.0)
    expansion, policy = _queue_expansion(tile_h, t_policy, budget_override)
    wide = tile_h <= 8
    rows = 1
    if wide and (t_policy * PACK_ROWS_MAX_PX_PER_TRI
                 >= frame_height * frame_width):
        rows = PACK_ROWS
    bf = policy
    if rows > 1 and budget_override is not None:
        bf = policy * PACK_ROWS_STREAM_FRAC * (2.0 / rows)
    elif rows > 1 and n_objects > 1:
        # Stacked objects defeat the density key; flat per-stream budget.
        bf = (1.2 * PACK_ROWS_STREAM_FRAC) * (2.0 / rows)
    elif rows > 1:
        bf = _rows_stream_budget_factor(
            t_policy, frame_height, frame_width) * (2.0 / rows)
    return RasterRoute("sorted", tile_h, rows, expansion,
                       WIDE_BLK if wide else QUEUE_BLK, bf, policy)


def mask_capacity(T: int) -> int:
    """The mask strategy's default list capacity for a T-row table
    (raster_pallas.py:2564)."""
    return min(max(CHUNK_T, -(-T // CHUNK_T) * CHUNK_T), MASK_MAX_CAPACITY)


def _mask_guard(capacity: int, tiles_y: int, tiles_x: int,
                lanes: int = REC_LANES) -> None:
    """Refuse a mask launch whose per-tile record lists would be too large
    (raster_pallas.py:1779): the same limits and message as the JAX
    package, though K6 reads the records in place."""
    block_bytes = capacity * lanes * 4
    total_bytes = tiles_y * tiles_x * block_bytes
    if block_bytes > _MASK_BLOCK_BYTES_CAP or (
            total_bytes > _MASK_TOTAL_BYTES_CAP):
        raise ValueError(
            f"mask strategy would materialize {total_bytes / 2**20:.0f} MB "
            f"of per-tile records ({block_bytes / 2**20:.1f} MB per tile "
            "block); use strategy='sorted' for this triangle count"
        )


def bin_for_raster(bbox, route: RasterRoute, height: int, width: int,
                   row0: int = 0, col0: int = 0):
    """Binning stage of a sorted draw over the local (height, width) rect
    at origin (row0, col0) from the global-frame ``bbox``: (QueueBins,
    lcounts (ntiles,) i32, the side-list gate per tile).

    CUDA tensors launch K14 (``binning.bin_queue_kernel``, csrc/binning.cu:
    two C entries around one sort) and count the draw in
    ``bin_for_raster.launches``; CPU tensors run ``bin_for_raster_plain``."""
    dev = bbox[0].device
    if dev.type == "cuda":
        out = bin_queue_kernel(
            bbox, height, width, route.tile_h, TILE_W, route.blk,
            route.expansion, route.budget_factor, LARGE_CAPACITY, row0, col0,
            route.rows)
        bin_for_raster.launches += 1
        return out
    if dev.type != "cpu":
        raise ValueError(f"binning runs on CUDA or CPU tensors, not {dev}")
    return bin_for_raster_plain(bbox, route, height, width, row0, col0)


bin_for_raster.launches = 0


def bin_for_raster_plain(bbox, route: RasterRoute, height: int, width: int,
                         row0: int = 0, col0: int = 0):
    """Plain ``bin_for_raster``, torch ops on any device:
    ``bin_triangles_queue``, then ``count_subset_per_tile`` over its side
    list."""
    qbins = bin_triangles_queue(
        height, width, route.tile_h, TILE_W, route.blk,
        expansion=route.expansion, budget_factor=route.budget_factor,
        large_capacity=LARGE_CAPACITY, row0=row0, col0=col0, bbox=bbox,
        row_split=route.rows,
    )
    lcounts = count_subset_per_tile(
        qbins.large_ids, height, width, route.tile_h, TILE_W, row0, col0,
        bbox=bbox,
    )
    return qbins, lcounts


# ---------------------------------------------------------------------------
# K7: record transpose
# ---------------------------------------------------------------------------


def finish_records(rec_t: torch.Tensor) -> torch.Tensor:
    """K7: channel-major (R <= 128, T) f32 record table -> row-major (Tp,
    128), zero padded to 128 lanes and to Tp = T rounded up to REC_T_BLK
    (raster_pallas.py:449).

    CUDA tensors launch ``tr_records`` (csrc/records.cu; the table's own
    device and shape need no check, the C entry rejects bad sizes) and
    count the launch in ``finish_records.launches``; CPU tensors run
    ``finish_records_plain``."""
    if not rec_t.is_cuda:
        if rec_t.device.type == "cpu":
            return finish_records_plain(rec_t)
        raise ValueError(f"K7 runs on CUDA or CPU tensors, not "
                         f"{rec_t.device}")
    R, T = rec_t.shape
    tp = T + (-T % REC_T_BLK)
    dev = rec_t.device
    if rec_t.dtype is not F32 or not rec_t.is_contiguous():
        _cuda.check_tensor("rec_t", rec_t, dev, F32, (R, T))
    out = rec_t.new_empty((tp, REC_LANES))
    _cuda.launch("tr_records", dev, rec_t.data_ptr(), R, T, tp,
                 out.data_ptr())
    finish_records.launches += 1
    return out


finish_records.launches = 0
_cuda.declare("tr_records", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def finish_records_plain(rec_t: torch.Tensor) -> torch.Tensor:
    """Plain K7: pad, then ``t().contiguous()``."""
    R, T = rec_t.shape
    padded = torch.nn.functional.pad(
        rec_t, (0, -T % REC_T_BLK, 0, REC_LANES - R))
    return padded.t().contiguous()


# ---------------------------------------------------------------------------
# K2 / K3 / K4 / K6: raster + shade (with K5 in the finalize)
# ---------------------------------------------------------------------------


def _check_finalize(dev, recs, params, objs, texs, atlas, n_lights):
    """Check the operands every raster kernel's finalize reads; returns
    (n_obj, atlas pointer or None, atlas width)."""
    n_obj = objs.shape[0]
    checks = [("recs", recs, F32, (recs.shape[0], REC_LANES)),
              ("params", params, F32, (9 + 7 * n_lights,)),
              ("objs", objs, I32, (max(n_obj, 1), 3)),
              ("texs", texs, I32, (max(n_obj, 1), 4))]
    if atlas is not None:
        checks.append(("atlas", atlas, I32, atlas.shape))
    for name, t, dtype, shape in checks:
        _cuda.check_tensor(name, t, dev, dtype, shape)
    if atlas is None:
        return n_obj, None, 0
    return n_obj, atlas.data_ptr(), int(atlas.shape[1])


def _outputs(tiles_y: int, tile_h: int, tiles_x: int, dev):
    hp, wp = tiles_y * tile_h, tiles_x * TILE_W
    return (torch.empty((hp, wp), dtype=F32, device=dev),
            torch.empty((hp, wp), dtype=I32, device=dev),
            torch.empty((hp, wp), dtype=I32, device=dev))


def _raster(wrapper, entry: str, tile_h: int, streams: int, recs,
            qbins: QueueBins, lcounts, params, objs, texs, atlas, *,
            tiles_y: int, tiles_x: int, row0: int, col0: int,
            frame_width: int, n_lights: int, zcull: bool = False,
            skipped=None, band: bool = False):
    """Check the operands, launch ``entry`` and count it on ``wrapper``;
    CPU tensors run ``raster_plain``. The entry's device ops are the key
    fill, the part count, the walk over parts of at most
    RASTER_PART_ENTRIES stream entries and the finalize (csrc/raster.cu,
    "The sorted strategy, each tile's entries split"); its keys and part
    offsets are one scratch tensor, and the offsets ((tiles + 1,) i32, the
    last the total) stay in ``wrapper.part_offsets``. ``zcull`` entries
    (K11) take one more operand, ``skipped``: None, or a (1,) i32 CUDA
    tensor the kernel adds the number of batches it skipped to. ``band``
    entries (the band form) take ``tile_h`` as an operand, any multiple of
    8 on CUDA tensors."""
    dev = recs.device
    if band and dev.type == "cuda":
        check_cuda_tile_h(entry, tile_h)
    kw = dict(tile_h=tile_h, tiles_y=tiles_y, tiles_x=tiles_x, row0=row0,
              col0=col0, frame_width=frame_width, n_lights=n_lights)
    nfb = tiles_y * tiles_x
    nst = qbins.starts.shape[0]
    if nst != streams * (nfb + 1):
        raise ValueError(f"starts has {nst} entries for {nfb} tiles and "
                         f"{streams} streams")
    if dev.type == "cpu":
        return raster_plain(recs, qbins, lcounts, params, objs, texs, atlas,
                            **kw)
    if dev.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA or CPU tensors, not {dev}")
    for name, t, shape in (
        ("sorted_tri", qbins.sorted_tri, qbins.sorted_tri.shape),
        ("starts", qbins.starts, (nst,)),
        ("counts", qbins.counts, (nst,)),
        ("large_ids", qbins.large_ids, (LARGE_CAPACITY,)),
        ("n_large", qbins.n_large, ()),
        ("lcounts", lcounts, (nfb,)),
    ):
        _cuda.check_tensor(name, t, dev, I32, shape)
    n_obj, atlas_ptr, aw = _check_finalize(dev, recs, params, objs, texs,
                                           atlas, n_lights)
    probe = ()
    if zcull:
        if skipped is not None:
            _cuda.check_tensor("skipped", skipped, dev, I32, (1,))
        probe = (None if skipped is None else skipped.data_ptr(),)
    z, gid, color = _outputs(tiles_y, tile_h, tiles_x, dev)
    n_keys = z.numel()
    # u64 keys, then the part offsets.
    scratch = torch.empty((2 * n_keys + nfb + 1,), dtype=I32, device=dev)
    part_off = scratch[2 * n_keys:2 * n_keys + nfb + 1]
    _cuda.launch(
        entry, dev,
        recs.data_ptr(), qbins.sorted_tri.data_ptr(), qbins.starts.data_ptr(),
        qbins.counts.data_ptr(), qbins.large_ids.data_ptr(),
        qbins.n_large.data_ptr(), lcounts.data_ptr(), params.data_ptr(),
        objs.data_ptr(), texs.data_ptr(), atlas_ptr, n_obj, n_lights, aw,
        *((tile_h,) if band else ()), tiles_y, tiles_x, row0, col0,
        frame_width,
        qbins.sorted_tri.shape[0], RASTER_PART_ENTRIES,
        scratch.data_ptr(), part_off.data_ptr(), z.data_ptr(),
        gid.data_ptr(), color.data_ptr(), *probe,
    )
    wrapper.launches += 1
    wrapper.part_offsets = part_off
    return z, gid, color.view(torch.uint32)


def raster_kernel(recs, qbins, lcounts, params, objs, texs, atlas, **kw):
    """K2 (8-row tiles, two strip streams): (z f32, gid i32, color u32),
    each (tiles_y * 8, tiles_x * 128), written for every tile. CUDA tensors
    launch ``tr_raster``, count ``raster_kernel.launches`` once and leave
    the parts' offsets in ``raster_kernel.part_offsets`` (``_raster``)."""
    return _raster(raster_kernel, "tr_raster", 8, PACK_ROWS, recs, qbins,
                   lcounts, params, objs, texs, atlas, **kw)


def raster_rows1_kernel(recs, qbins, lcounts, params, objs, texs, atlas,
                        **kw):
    """K3 (8-row tiles, one stream): as K2; ``tr_raster_rows1``, counted
    in ``raster_rows1_kernel.launches``."""
    return _raster(raster_rows1_kernel, "tr_raster_rows1", 8, 1, recs,
                   qbins, lcounts, params, objs, texs, atlas, **kw)


def raster_narrow_any_kernel(recs, qbins, lcounts, params, objs, texs,
                             atlas, *, tile_h: int, **kw):
    """K4, the sorted strategy on tiles taller than 8 rows (16, 24, 32,
    ...; one stream): outputs (tiles_y * tile_h, tiles_x * 128). CUDA
    tensors take a multiple of 8 (``check_cuda_tile_h``), launch
    ``tr_raster_narrow_any`` (the band form: each part folded over only the
    rows its entries reach, fragment by fragment, csrc/raster.cu), count
    ``raster_narrow_any_kernel.launches`` once and leave the parts' offsets
    in ``raster_narrow_any_kernel.part_offsets``; CPU tensors run
    ``raster_plain`` at any height, with the bins' own streams."""
    nfb = kw["tiles_y"] * kw["tiles_x"]
    streams = 1 if recs.is_cuda else qbins.starts.shape[0] // (nfb + 1)
    return _raster(raster_narrow_any_kernel, "tr_raster_narrow_any", tile_h,
                   streams, recs, qbins, lcounts, params, objs, texs, atlas,
                   band=True, **kw)


def check_cuda_tile_h(kernel: str, tile_h: int) -> None:
    """Raise unless ``tile_h`` is a multiple of 8, the heights every CUDA
    raster kernel runs, as the Pallas kernels."""
    if tile_h < 8 or tile_h % 8:
        raise ValueError(f"{kernel} runs tiles of a multiple of 8 rows on "
                         f"CUDA, not {tile_h}")


def raster_mask_kernel(recs, bins: TileBins, params, objs, texs, atlas, *,
                       tile_h: int, tiles_y: int, tiles_x: int, row0: int,
                       col0: int, frame_width: int, n_lights: int):
    """K6, the mask strategy (tiles of any multiple of 8 rows): each tile
    folds its list ``bins.ids`` (submission order, ``bins.counts`` entries)
    over all of its rows, reading the records in place, one block a frame
    row; outputs as K2's. CUDA tensors launch ``tr_raster_mask`` and count
    ``raster_mask_kernel.launches``; CPU tensors run ``mask_plain``."""
    dev = recs.device
    kw = dict(tile_h=tile_h, tiles_y=tiles_y, tiles_x=tiles_x, row0=row0,
              col0=col0, frame_width=frame_width, n_lights=n_lights)
    if tuple(bins.counts.shape) != (tiles_y, tiles_x):
        raise ValueError(f"bins for {tuple(bins.counts.shape)} tiles, "
                         f"launch of {(tiles_y, tiles_x)}")
    if dev.type == "cpu":
        return mask_plain(recs, bins, params, objs, texs, atlas, **kw)
    if dev.type != "cuda":
        raise ValueError(f"K6 runs on CUDA or CPU tensors, not {dev}")
    check_cuda_tile_h("K6", tile_h)
    capacity = bins.ids.shape[2]
    _cuda.check_tensor("ids", bins.ids, dev, I32,
                       (tiles_y, tiles_x, capacity))
    _cuda.check_tensor("counts", bins.counts, dev, I32, (tiles_y, tiles_x))
    n_obj, atlas_ptr, aw = _check_finalize(dev, recs, params, objs, texs,
                                           atlas, n_lights)
    z, gid, color = _outputs(tiles_y, tile_h, tiles_x, dev)
    _cuda.launch(
        "tr_raster_mask", dev,
        recs.data_ptr(), bins.ids.data_ptr(), bins.counts.data_ptr(),
        params.data_ptr(), objs.data_ptr(), texs.data_ptr(), atlas_ptr,
        capacity, tile_h, n_obj, n_lights, aw, tiles_y, tiles_x, row0, col0,
        frame_width, z.data_ptr(), gid.data_ptr(), color.data_ptr(),
    )
    raster_mask_kernel.launches += 1
    return z, gid, color.view(torch.uint32)


def raster_zcull_kernel(recs, qbins, lcounts, params, objs, texs, atlas,
                        *, skipped=None, **kw):
    """K11 on K2's route: K2 with the occlusion skip, a batch of stream
    entries that cannot win a pixel skipping its fold (the zcull branch of
    raster_pallas.py:2384-2394), tested against the part's own winners and
    the merge keys as they stand. Outputs equal K2's. CUDA tensors launch
    ``tr_raster_zcull`` and count ``raster_zcull_kernel.launches``;
    ``skipped`` is None or a (1,) i32 CUDA tensor that the kernel adds its
    skipped batches to (a probe: the renderer passes None; the count
    depends on the order the parts run in, ``zcull_skips_plain`` bounds it
    from below). CPU tensors run ``raster_plain``."""
    return _raster(raster_zcull_kernel, "tr_raster_zcull", 8, PACK_ROWS,
                   recs, qbins, lcounts, params, objs, texs, atlas,
                   zcull=True, skipped=skipped, **kw)


def raster_rows1_zcull_kernel(recs, qbins, lcounts, params, objs, texs,
                              atlas, *, skipped=None, **kw):
    """K11 on K3's route (8-row tiles, one stream): as
    ``raster_zcull_kernel``; ``tr_raster_rows1_zcull``, counted in
    ``raster_rows1_zcull_kernel.launches``."""
    return _raster(raster_rows1_zcull_kernel, "tr_raster_rows1_zcull", 8, 1,
                   recs, qbins, lcounts, params, objs, texs, atlas,
                   zcull=True, skipped=skipped, **kw)


for _fn in (raster_kernel, raster_rows1_kernel, raster_narrow_any_kernel,
            raster_mask_kernel, raster_zcull_kernel,
            raster_rows1_zcull_kernel):
    _fn.launches = 0
for _fn in (raster_kernel, raster_rows1_kernel, raster_narrow_any_kernel,
            raster_zcull_kernel, raster_rows1_zcull_kernel):
    _fn.part_offsets = None
for _entry in ("tr_raster", "tr_raster_rows1"):
    _cuda.declare(_entry, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                  + [ctypes.c_void_p] * 6)
_cuda.declare("tr_raster_narrow_any", [ctypes.c_void_p] * 11
              + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 6)
for _entry in ("tr_raster_zcull", "tr_raster_rows1_zcull"):
    _cuda.declare(_entry, [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10
                  + [ctypes.c_void_p] * 7)
_cuda.declare("tr_raster_mask", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
              + [ctypes.c_void_p] * 4)

# (tile_h, rows) -> wrapper of the sorted strategy on 8-row tiles; every
# other height takes raster_narrow_any_kernel.
RASTER_KERNELS = {
    (8, 2): raster_kernel,
    (8, 1): raster_rows1_kernel,
}
ZCULL_KERNELS = {  # (tile_h, rows) -> K11's wrapper on that route
    (8, 2): raster_zcull_kernel,
    (8, 1): raster_rows1_zcull_kernel,
}


def _span_setup(rec, yf, w_f, fields):
    """Stage A (_stage_a_fill, raster_pallas.py:1179-1271) for a batch of
    (entry, row) pairs: rec (P, 128) records, yf (P,) global rows, fields
    the (j0, jg) lane pairs of the attribute planes.

    Returns (minx, maxx, xoff, zl, zinc, [(al, inc)] per field, gid);
    maxx is -BIG where the row has no span."""

    def field(e, j):
        return rec[:, e * EDGE_STRIDE + j]

    act, xs, dys, xgs, lefts = [], [], [], [], []
    for e in range(3):
        valid_e = field(e, F_VALID) > 0.5
        ymin_e, ymax_e = field(e, F_YMIN), field(e, F_YMAX)
        dy = yf - ymin_e
        act.append(valid_e & (ymin_e <= yf) & (yf < ymax_e))
        xs.append(field(e, F_X0) + dy * field(e, F_XG))
        dys.append(dy)
        xgs.append(field(e, F_XG))
        lefts.append(field(e, F_LEFT))

    # AET ordering (projekt.cpp:212-216): lexicographic (x, xg, left, e).
    kx = [torch.where(act[e], xs[e], _BIG) for e in range(3)]
    kg = [torch.where(act[e], xgs[e], _BIG) for e in range(3)]
    kl = [torch.where(act[e], lefts[e], _BIG) for e in range(3)]

    def less(i, j):
        return (kx[i] < kx[j]) | (
            (kx[i] == kx[j]) & (
                (kg[i] < kg[j]) | (
                    (kg[i] == kg[j])
                    & ((kl[i] < kl[j]) | ((kl[i] == kl[j]) & (i < j)))
                )
            )
        )

    rank = [sum(less(j, i).to(I32) for j in range(3) if j != i)
            for i in range(3)]

    def pick(vals, r):
        return torch.where(rank[0] == r, vals[0],
                           torch.where(rank[1] == r, vals[1], vals[2]))

    def attr_lr(j0, jg):
        vals = [field(e, j0) + dys[e] * field(e, jg) for e in range(3)]
        return pick(vals, 0), pick(vals, 1)

    xl, xr = pick(xs, 0), pick(xs, 1)
    nact = act[0].to(I32) + act[1].to(I32) + act[2].to(I32)

    xd = round_half_away(xr - xl)
    nz = xd != 0.0
    xoff = torch.where(xl < 0.0, -xl, 0.0)
    w1 = w_f - 1.0
    lx = torch.where(xl < 0.0, 0.0, torch.where(xl >= w_f, w1, xl))
    rx = torch.where(xr < 0.0, 0.0, torch.where(xr >= w_f, w1, xr))
    minx = minimum(round_half_away(lx), w1)
    maxx = minimum(round_half_away(rx), w1)
    maxx = torch.where(nact >= 2, maxx, -_BIG)

    zl, zr = attr_lr(F_Z0, F_ZG)
    zinc = torch.where(nz, (zr - zl) / xd, 0.0)
    attrs = []
    for j0, jg in fields:
        al, ar = attr_lr(j0, jg)
        attrs.append((al, torch.where(nz, (ar - al) / xd, 0.0)))
    gid = to_i32(rec[:, GID_LANE])
    return minx, maxx, xoff, zl, zinc, attrs, gid


def _stream_pairs(qbins: QueueBins, nfb: int, tile_h: int, dev):
    """(tile, triangle, tile row) of every (entry, row) pair of the
    streams: with rs streams, stream h's entries cover tile rows
    [h * strip_h, (h + 1) * strip_h), strip_h = tile_h / rs."""
    rs = qbins.starts.shape[0] // (nfb + 1)
    strip_h = tile_h // rs
    tiles, tris, rows = [], [], []
    for h in range(rs):
        st = qbins.starts[h:rs * nfb:rs].to(I64)
        cn = qbins.counts[h:rs * nfb:rs].to(I64)
        tile = torch.repeat_interleave(torch.arange(nfb, device=dev), cn)
        first = torch.cumsum(cn, 0) - cn
        pos = st[tile] + torch.arange(tile.shape[0], device=dev) - first[tile]
        tri = qbins.sorted_tri.to(I64)[pos]
        r = torch.arange(strip_h, device=dev) + h * strip_h
        tiles.append(tile.repeat_interleave(strip_h))
        tris.append(tri.repeat_interleave(strip_h))
        rows.append(r.repeat(tile.shape[0]))
    return torch.cat(tiles), torch.cat(tris), torch.cat(rows)


def _side_pairs(qbins: QueueBins, lcounts, tile_h: int, dev):
    """(tile, triangle, tile row) of the side list: every listed triangle
    on every row of every tile whose lcounts gate is open."""
    nl = int(qbins.n_large)
    ltiles = torch.nonzero(lcounts > 0).reshape(-1)
    ids = qbins.large_ids[:nl].to(I64)
    tile = ltiles.repeat_interleave(nl * tile_h)
    tri = ids.repeat_interleave(tile_h).repeat(ltiles.shape[0])
    rows = torch.arange(tile_h, device=dev).repeat(nl * ltiles.shape[0])
    return tile, tri, rows


def _object_masks(gid, specs):
    """_finalize_shade's per-object pixel masks (raster_pallas.py:1630-1639)
    for the [gid_lo, gid_hi, ...] rows of ``specs``: covered pixels whose
    winner lies in the object's range, a range end compared only where a
    neighbour, or the scene's end, lies beyond it."""
    multi = len(specs) > 1
    last_hi = specs[-1][1]
    covered = gid >= 0
    masks = []
    for lo, hi, *_ in specs:
        m = covered
        if multi and lo > 0:
            m = m & (gid >= lo)
        if multi and hi < last_hi:
            m = m & (gid < hi)
        masks.append(m)
    return masks


def _phong_mask(gid, objs):
    """Pixels whose winner belongs to a Phong object: the object masks
    OR-ed over the Phong objects (raster_pallas.py:1714-1719)."""
    specs = objs.tolist()
    pm = torch.zeros_like(gid >= 0)
    for m, (_, _, phong) in zip(_object_masks(gid, specs), specs):
        if phong:
            pm = pm | m
    return pm


def launch_fields(objs, texs):
    """``_scene_fields`` of a launch, from its object and texture
    tables."""
    return _scene_fields([
        ObjSpec(lo, hi, bool(phong), tuple(t[:3]) if t[1] > 0 else None)
        for (lo, hi, phong), t in zip(objs.tolist(), texs.tolist())])


class Fragments(NamedTuple):
    """The fragments of one raster launch (``raster_fragments``)."""

    pair_tri: torch.Tensor  # (P,) triangle of each (entry, row) pair
    pair_in_span: torch.Tensor  # (P,) bool: the row lies in the triangle
    pix: torch.Tensor  # (F,) i64 pixel of each fragment with z > clear
    z: torch.Tensor  # (F,) f32
    gid: torch.Tensor  # (F,) i64 triangle id
    k: torch.Tensor  # (F,) f32 interpolation step from the span's left end
    pair: torch.Tensor  # (F,) i64 index of the fragment's pair
    attrs: list  # [(al, inc) (P,) f32] per attribute plane


def raster_fragments(recs, qbins: QueueBins, lcounts, *, tile_h: int,
                     tiles_y: int, tiles_x: int, row0: int, col0: int,
                     frame_width: int, fields) -> Fragments:
    """Steps 1-2 of ``raster_plain``: each stream entry -> its strip's
    rows (all tile_h rows with one stream), each side-list triangle ->
    every row of every tile with lcounts > 0; stage A per (entry, row)
    with the ``fields`` planes; then the in-span fragments (the span
    clipped to the tile's 128 columns) with z > DEPTH_CLEAR, at pixels of
    the padded local frame."""
    dev = recs.device
    nfb = tiles_y * tiles_x
    wp = tiles_x * TILE_W
    pairs = [_stream_pairs(qbins, nfb, tile_h, dev),
             _side_pairs(qbins, lcounts, tile_h, dev)]
    tile, tri, row = (torch.cat(parts) for parts in zip(*pairs))
    ty, tx = tile // tiles_x, tile % tiles_x
    prow = ty * tile_h + row  # row in the padded local frame
    yf = (prow + row0).to(F32)
    w_f = scalar(frame_width, dev)
    minx, maxx, xoff, zl, zinc, attrs, gid = _span_setup(
        recs[tri], yf, w_f, fields)

    # In-span fragments: columns [max(minx, x0), min(maxx, x0 + 127)] of
    # the pair's tile (minx/maxx are whole numbers, NaN or -BIG).
    x0 = (tx * TILE_W + col0).to(F32)
    c_lo = torch.maximum(minx, x0)
    c_hi = torch.minimum(maxx, x0 + (TILE_W - 1))
    ok = ~(torch.isnan(minx) | torch.isnan(maxx)) & (c_hi >= c_lo)
    length = torch.where(ok, c_hi - c_lo + 1, 0.0).to(I64)
    fp = torch.repeat_interleave(torch.arange(length.shape[0], device=dev),
                                 length)
    first = torch.cumsum(length, 0) - length
    xc = c_lo[fp] + (torch.arange(fp.shape[0], device=dev) - first[fp]).to(F32)
    k = xoff[fp] + (xc - minx[fp])
    z = zl[fp] + k * zinc[fp]
    pix = prow[fp] * wp + (xc.to(I64) - col0)
    live = z > DEPTH_CLEAR
    fp = fp[live]
    return Fragments(tri, maxx != -_BIG, pix[live], z[live],
                     gid[fp].to(I64), k[live], fp, attrs)


def resolve_winners(frags: Fragments, hp: int, wp: int):
    """Each pixel's winner among a launch's fragments over the padded
    (hp, wp) frame, by (z descending, gid ascending): amax of z, then amin
    of gid among the fragments at that z. Returns (z (hp, wp), DEPTH_CLEAR
    where uncovered; gid (hp, wp) i32, -1 where uncovered; the winner's
    al + k * inc of each of ``frags.attrs`` as (hp, wp) planes, 0 where
    uncovered). The one copy of the tie rule of every plain raster
    version, shaded (``raster_plain``) or G-buffer (``gbuffer_plain``)."""
    pix, z, g, k, fp = frags.pix, frags.z, frags.gid, frags.k, frags.pair
    dev = z.device
    bz = torch.full((hp * wp,), DEPTH_CLEAR, dtype=F32, device=dev)
    bz = bz.scatter_reduce(0, pix, z, "amax", include_self=True)
    at_max = z == bz[pix]
    none = torch.iinfo(I64).max
    bg = torch.full((hp * wp,), none, dtype=I64, device=dev)
    bg = bg.scatter_reduce(0, pix[at_max], g[at_max], "amin",
                           include_self=True)
    win = at_max & (g == bg[pix])
    wpix, wfp, wk = pix[win], fp[win], k[win]
    planes = []
    for al, inc in frags.attrs:
        plane = torch.zeros((hp * wp,), dtype=F32, device=dev)
        plane[wpix] = al[wfp] + wk * inc[wfp]
        planes.append(plane.reshape(hp, wp))
    gid = torch.where(bg != none, bg, -1).to(I32).reshape(hp, wp)
    return bz.reshape(hp, wp), gid, planes


def _finalize_plain(z, gid, planes, params, objs, texs, atlas, px, py,
                    n_lights: int, offs):
    """_finalize_shade (raster_pallas.py:1600) on whole planes: per-object
    masks, the textured objects' perspective u, v and texel fetch
    (``sample_atlas``, plain K5) as their base colour, Blinn-Phong where
    the object is Phong, ARGB pack."""
    _, col_off, nrm_off, uv_off = offs
    masks = _object_masks(gid, objs.tolist())
    if col_off is not None:
        col = list(planes[col_off:col_off + 4])
    else:
        col = [torch.zeros_like(z) for _ in range(4)]
    if uv_off is not None:
        tex_objs = [(t, m) for t, m in zip(texs.tolist(), masks) if t[1] > 0]
        tex_mask = tex_objs[0][1]
        for _, m in tex_objs[1:]:
            tex_mask = tex_mask | m
        inv_oz = 1.0 / planes[uv_off + 2]
        u = torch.where(tex_mask, inv_oz * planes[uv_off], 0.0)
        v = torch.where(tex_mask, inv_oz * planes[uv_off + 1], 0.0)
        for (v_off, th, tw, bil), m in tex_objs:
            rgba = sample_atlas(atlas, u, v, v_off, th, tw, bool(bil))
            col = [torch.where(m, rgba[c], col[c]) for c in range(4)]
    any_phong = nrm_off is not None
    nrm = planes[nrm_off:nrm_off + 3] if any_phong else None
    cam = tuple(params[i] for i in range(5))
    ambient = tuple(params[5 + c] for c in range(4))
    light_p = [tuple(params[9 + 7 * k + i] for i in range(3))
               for k in range(n_lights)]
    light_i = [tuple(params[9 + 7 * k + 3 + c] for c in range(4))
               for k in range(n_lights)]
    rgba = shade_planes(z, col, nrm, px, py, cam, ambient, light_p, light_i,
                        any_phong, n_lights)
    if any_phong:
        pm = _phong_mask(gid, objs)
        rgba = [torch.where(pm, rgba[c], col[c]) for c in range(4)]
    return pack_argb_planes(*rgba)


def raster_plain(recs, qbins: QueueBins, lcounts, params, objs, texs, atlas,
                 *, tile_h: int, tiles_y: int, tiles_x: int, row0: int,
                 col0: int, frame_width: int, n_lights: int):
    """Plain-PyTorch K2 / K3 / K4, vectorised over the binned streams:

    1. ``raster_fragments``: stage A per (entry, row) of the streams and
       the side list, and the in-span fragments with z > DEPTH_CLEAR;
    2. ``resolve_winners``: per pixel, the (z, gid) winner and its
       attribute planes (al + k * inc) that the scene's objects read;
    3. ``_finalize_plain``."""
    dev = recs.device
    hp, wp = tiles_y * tile_h, tiles_x * TILE_W
    offs = launch_fields(objs, texs)
    frags = raster_fragments(
        recs, qbins, lcounts, tile_h=tile_h, tiles_y=tiles_y,
        tiles_x=tiles_x, row0=row0, col0=col0, frame_width=frame_width,
        fields=offs[0])
    zimg, gid_img, planes = resolve_winners(frags, hp, wp)
    px = (torch.arange(wp, device=dev) + col0).to(F32)[None, :].expand(hp, wp)
    py = (torch.arange(hp, device=dev) + row0).to(F32)[:, None].expand(hp, wp)
    color = _finalize_plain(zimg, gid_img, planes, params, objs, texs, atlas,
                            px, py, n_lights, offs)
    return zimg, gid_img, color


def zcull_skips_plain(recs, qbins: QueueBins, *, tile_h: int, tiles_y: int,
                      tiles_x: int, row0: int, col0: int, frame_width: int,
                      part_entries: int | None = None, **_) -> int:
    """The number of batches K11 skips on these operands when each part
    culls against its own partial winners only, replayed on the plain path
    (``batch_occluded`` in csrc/raster.cu without the keys): per tile and
    stream, the stream cut into parts of at most ``part_entries`` entries
    (None: the whole stream one part), each part's batches of 128 / strip
    entries in order, its winners starting at DEPTH_CLEAR; a batch is
    skipped when the max of its (entry, row) pairs' z at the span ends,
    plus 1e-6 of its magnitude, lies below the min of the strip rows'
    winners. The side list is never culled, so it is left out.

    What the kernel's count is held to:
    - at least this count, at any part size and in any order of the parts.
      By induction over a part's batches, the kernel's max(own winner, key)
      at each pixel of the strip stays at or above this replay's own
      winner: a batch both fold raises both alike; a batch the kernel skips
      lies below max(own, key) at every pixel of its rows, so the replay's
      fold of it leaves its winner at or below that max. So the kernel's
      min over the strip is at or above the replay's, and every batch the
      replay skips, the kernel skips;
    - at most the stream batches;
    - equal to it with one part a stream (``part_entries`` at or above
      every stream's count) where no tile's side-list gate is open: each
      strip's keys are then written only by its own part, after that part
      has folded, so the kernel reads 0 and culls against its own winners
      alone, as the serial walk of one block a tile did.
    A probe for the tests and chip_smoke; it loops over tiles and batches
    in Python, so keep it to small frames."""
    dev = recs.device
    rs = qbins.starts.shape[0] // (tiles_y * tiles_x + 1)
    strip = tile_h // rs
    batch = 128 // strip
    starts, counts = qbins.starts.tolist(), qbins.counts.tolist()
    w_f = scalar(frame_width, dev)
    inf = float("inf")
    skipped = 0
    for tile in range(tiles_y * tiles_x):
        ty, tx = divmod(tile, tiles_x)
        xc = (torch.arange(TILE_W, device=dev) + col0 + tx * TILE_W).to(F32)
        for h in range(rs):
            s, n = starts[rs * tile + h], counts[rs * tile + h]
            yf = (torch.arange(strip, device=dev) + row0 + ty * tile_h
                  + h * strip).to(F32)
            part = max(n, 1) if part_entries is None else part_entries
            for p0 in range(0, n, part):
                zwin = torch.full((strip, TILE_W), DEPTH_CLEAR, dtype=F32,
                                  device=dev)
                p1 = min(n, p0 + part)
                for b0 in range(p0, p1, batch):
                    ids = qbins.sorted_tri[s + b0:s + min(p1, b0 + batch)]
                    minx, maxx, xoff, zl, zinc, _, _ = _span_setup(
                        recs[ids.long()].repeat_interleave(strip, 0),
                        yf.repeat(ids.shape[0]), w_f, ())
                    z_lo = zl + (xoff + (minx - minx)) * zinc
                    z_hi = zl + (xoff + (maxx - minx)) * zinc
                    zp = maximum(z_lo, z_hi)
                    zp = torch.where(torch.isnan(zp), inf, zp)
                    zmax = torch.where(maxx != -_BIG, zp, -_BIG).max()
                    if bool(zmax + torch.abs(zmax) * 1e-6 < zwin.min()):
                        skipped += 1
                        continue
                    k = xoff[:, None] + (xc[None, :] - minx[:, None])
                    z = zl[:, None] + k * zinc[:, None]
                    keep = ((xc[None, :] >= minx[:, None])
                            & (xc[None, :] <= maxx[:, None])
                            & ~torch.isnan(z))
                    z = torch.where(keep, z, -inf).reshape(-1, strip, TILE_W)
                    zwin = torch.maximum(zwin, z.amax(dim=0))
    return skipped


def mask_stream(bins: TileBins) -> QueueBins:
    """The mask strategy's per-tile lists as one sorted-strategy stream
    (tile t's entries at t * capacity, counts[t] of them) with an empty
    side list, for ``raster_plain``."""
    tiles_y, tiles_x, cap = bins.ids.shape
    nfb = tiles_y * tiles_x
    dev = bins.ids.device
    zero = torch.zeros((), dtype=I32, device=dev)
    counts = bins.counts.reshape(-1)
    return QueueBins(
        sorted_tri=torch.clamp(bins.ids.reshape(-1), min=0),
        starts=torch.arange(nfb + 1, dtype=I32, device=dev) * cap,
        counts=torch.cat([counts, zero[None]]),
        large_ids=torch.full((LARGE_CAPACITY,), -1, dtype=I32, device=dev),
        n_large=zero, n_dropped=bins.n_dropped,
        n_real=counts.sum(dtype=I32), budget_util=zero.to(F32))


def mask_plain(recs, bins: TileBins, params, objs, texs, atlas, *,
               tile_h: int, tiles_y: int, tiles_x: int, **kw):
    """Plain-PyTorch K6: ``raster_plain`` over ``mask_stream`` (each listed
    triangle on all of its tile's rows, no side list)."""
    lcounts = torch.zeros((tiles_y * tiles_x,), dtype=I32,
                          device=recs.device)
    return raster_plain(recs, mask_stream(bins), lcounts, params, objs,
                        texs, atlas, tile_h=tile_h, tiles_y=tiles_y,
                        tiles_x=tiles_x, **kw)


class RasterLaunch(NamedTuple):
    """One raster launch, ready to run: its route, the wrapper of the
    route's kernel (K2, K3, K4, K6, or K11 on K2's or K3's route) and the
    wrapper's operands and options. Operands: (recs, qbins, lcounts,
    params, objs, texs, atlas) on the sorted routes, (recs, bins, params,
    objs, texs, atlas) on the mask route."""

    route: RasterRoute
    kernel: object
    operands: tuple
    options: dict  # tiles_y, tiles_x, row0, col0, frame_width, ...

    @property
    def qbins(self) -> QueueBins:
        """The sorted route's streams (``mask_stream`` on the mask
        route)."""
        if self.route.strategy == "mask":
            return mask_stream(self.operands[1])
        return self.operands[1]

    @property
    def objs(self) -> torch.Tensor:
        return self.operands[-3]

    @property
    def texs(self) -> torch.Tensor:
        return self.operands[-2]

    def run(self):
        """(z, gid, color) of every tile from the route's kernel (its plain
        version on CPU tensors)."""
        return self.kernel(*self.operands, **self.options)

    def run_plain(self):
        """The same outputs from the plain version, on any device."""
        if self.route.strategy == "mask":
            return mask_plain(*self.operands, **self.options)
        return raster_plain(*self.operands,
                            **{"tile_h": self.route.tile_h, **self.options})

    def stats(self) -> dict:
        return bin_stats(self.route, self.operands[1])


def bin_stats(route: RasterRoute, bins) -> dict:
    """A draw's binning stats: bins_dropped on the mask route (``bins`` a
    TileBins); bins_dropped, bins_real_entries, bins_budget_utilization
    (0-d tensors) and bins_budget_factor (the policy factor) on the
    sorted routes (``bins`` a QueueBins)."""
    if route.strategy == "mask":
        return {"bins_dropped": bins.n_dropped}
    return {
        "bins_dropped": bins.n_dropped,
        "bins_real_entries": bins.n_real,
        "bins_budget_utilization": bins.budget_util,
        "bins_budget_factor": route.policy_factor,
    }


def pack_records(edges: EdgeTable) -> torch.Tensor:
    """(T, 128) f32 row-major records of an EdgeTable (raster_pallas.py:412):
    3 edges x 28 fields, the triangle id at lane 84, zeros after."""
    T = edges.num_triangles
    cols = []
    for e in range(3):
        cols += [edges.valid[:, e].to(F32)] + [
            getattr(edges, f)[:, e] for f in (
                "ymin", "ymax", "x0", "xg", "z0", "zg", "oz0", "ozg", "u0",
                "ug", "v0", "vg", "left")]
        cols += [edges.col0[:, e, c] for c in range(4)]
        cols += [edges.colg[:, e, c] for c in range(4)]
        cols += [edges.n0[:, e, c] for c in range(3)]
        cols += [edges.ng[:, e, c] for c in range(3)]
    cols.append(torch.arange(T, dtype=I32, device=edges.valid.device).to(F32))
    rec = torch.stack(cols, dim=1)
    return torch.nn.functional.pad(rec, (0, REC_LANES - rec.shape[1]))


def record_table(table):
    """``table`` as the raster entry points take it: an EdgeTable becomes
    the channel-major (85, T) record table (``pack_records`` transposed),
    which bins and rasterizes as ``setup_records``'s does; a SetupOut or a
    channel-major table passes through."""
    if isinstance(table, EdgeTable):
        return pack_records(table)[:, :REC_ROWS].t().contiguous()
    return table


def setup_out(table, frame_height: int, frame_width: int):
    """Any table the raster entry points take -> (SetupOut, T), T the
    table's rows, which size the mask lists (``mask_capacity``). A
    SetupOut passes through, T its records' rows; the channel-major
    (85, T) table of ``setup_records`` (or an EdgeTable, ``record_table``)
    gets its row-major form from ``finish_records`` (K7, which may pad
    it) and its bboxes over the (frame_height, frame_width) frame from
    ``triangle_bbox_rows``, T its columns, the true count."""
    if isinstance(table, SetupOut):
        return table, int(table.recs.shape[0])
    with annotate("tr.setup"):
        table = record_table(table)
        T = int(table.shape[1])
        return SetupOut(finish_records(table),
                        triangle_bbox_rows(table, frame_height, frame_width),
                        T), T


def prepare_raster(table, objspecs: tuple, transform: ProjectiveTransform,
                   lights: LightData, height: int, width: int,
                   capacity: int | None = None,
                   frame_height: int | None = None,
                   frame_width: int | None = None, row0: int = 0,
                   col0: int = 0, strategy: str = "auto",
                   tile_h: int | None = None, atlas=None,
                   budget_override: float | None = None,
                   zcull: bool = False) -> RasterLaunch:
    """Everything before the raster kernel (raster_pallas.py:2501-2723):
    the row-major table and bboxes, the route, the binning (and on the
    sorted routes the side-list gate), for the local (height, width) rect
    at origin (row0, col0) of a (frame_height, frame_width) frame. The
    parameters are ``rasterize_scene_shaded``'s, in its order.

    ``table`` is a SetupOut (the K1 kernel's row-major table and bboxes),
    the channel-major (85, T) table of ``setup_records``, whose bboxes
    come from ``triangle_bbox_rows`` and whose row-major form from
    ``finish_records`` (K7), or an EdgeTable (``record_table``); either
    way the record of gid g is row g. ``objspecs`` holds one ObjSpec per
    object; ``atlas`` is the scene's ``pack_texture_atlas`` when any object
    is textured. ``capacity`` is the mask strategy's list length (default
    ``mask_capacity``); ``strategy`` and ``tile_h`` force the route
    (``raster_route``; on the sorted strategy the 8-row routes of
    ``RASTER_KERNELS`` take K2 or K3 and every other height K4's
    ``raster_narrow_any_kernel``, whose options carry ``tile_h``);
    ``budget_override`` is the sorted strategy's budget factor. ``zcull``
    launches K11 in place of K2 or K3 on 8-row tiles; on taller tiles (K4)
    and the mask strategy (K6) it does nothing, as in the JAX package."""
    if frame_height is None:
        frame_height = height
    if frame_width is None:
        frame_width = width
    table, T = setup_out(table, frame_height, frame_width)
    with annotate("tr.binning"):
        recs, bbox, t_policy = table.recs, table.bbox, table.num_triangles
        assert objspecs[-1].gid_hi <= T, "objspecs beyond the record table"
        assert T <= MAX_SCENE_TRIANGLES, (
            f"scene has {T} triangles; the f32 gid lane is exact only to "
            f"{MAX_SCENE_TRIANGLES}"
        )
        if any(o.tex is not None for o in objspecs):
            assert atlas is not None, "textured objects need the scene atlas"
            assert texture_fits_fused(*_atlas_dims(objspecs)), (
                "texture atlas too large for the fused path")
        else:
            atlas = None
        route = raster_route(t_policy, frame_height, frame_width,
                             len(objspecs), budget_override, strategy,
                             tile_h)
        tiles_y = -(-height // route.tile_h)
        tiles_x = -(-width // TILE_W)
        finalize = (shade_params(transform, lights),
                    obj_table(objspecs, recs.device),
                    tex_table(objspecs, recs.device), atlas)
        options = dict(tiles_y=tiles_y, tiles_x=tiles_x, row0=row0, col0=col0,
                       frame_width=frame_width, n_lights=lights.count)
        if route.strategy == "mask":
            capacity = mask_capacity(T) if capacity is None else capacity
            _mask_guard(capacity, tiles_y, tiles_x)
            bins = bin_triangles(height, width, route.tile_h, TILE_W, capacity,
                                 row0, col0, bbox)
            return RasterLaunch(route, raster_mask_kernel,
                                (recs, bins) + finalize,
                                dict(tile_h=route.tile_h, **options))
        key = (route.tile_h, route.rows)
        qbins, lcounts = bin_for_raster(bbox, route, height, width, row0, col0)
        if key not in RASTER_KERNELS:
            return RasterLaunch(route, raster_narrow_any_kernel,
                                (recs, qbins, lcounts) + finalize,
                                dict(tile_h=route.tile_h, **options))
        kernel = (ZCULL_KERNELS[key] if zcull and key in ZCULL_KERNELS
                  else RASTER_KERNELS[key])
        return RasterLaunch(route, kernel, (recs, qbins, lcounts) + finalize,
                            options)


def rasterize_scene_shaded(table, objspecs: tuple,
                           transform: ProjectiveTransform, lights: LightData,
                           height: int, width: int,
                           capacity: int | None = None,
                           frame_height: int | None = None,
                           frame_width: int | None = None, row0: int = 0,
                           col0: int = 0, strategy: str = "auto",
                           tile_h: int | None = None, atlas=None,
                           budget_override: float | None = None,
                           zcull: bool = False):
    """Fused raster + interpolate + texture + shade + ARGB pack of a
    scene's record table -> (covered, z (H, W), color u32 (H, W), stats)
    (raster_pallas.py:2467, same parameters in the same order; see
    ``prepare_raster``); stats as ``RasterLaunch.stats``."""
    return run_shaded(prepare_raster(table, objspecs, transform, lights,
                                     height, width, capacity, frame_height,
                                     frame_width, row0, col0, strategy,
                                     tile_h, atlas, budget_override, zcull),
                      height, width)


def run_shaded(launch: RasterLaunch, height: int, width: int):
    """Run a prepared launch and crop its tiles to (height, width) ->
    (covered, z, color u32, stats), as ``rasterize_scene_shaded``."""
    with annotate("tr.raster"):
        z, gid, color = (a[:height, :width] for a in launch.run())
        return gid >= 0, z, color, launch.stats()


def rasterize_shaded(table, transform: ProjectiveTransform,
                     lights: LightData, phong: bool, height: int,
                     width: int, capacity: int | None = None,
                     frame_height: int | None = None,
                     frame_width: int | None = None, row0: int = 0,
                     col0: int = 0, strategy: str = "auto",
                     tile_h: int | None = None, texture=None,
                     filter_mode: str = "nearest",
                     budget_override: float | None = None,
                     zcull: bool = False):
    """Single-object entry point (raster_pallas.rasterize_pallas_shaded,
    same parameters in the same order); ``texture`` (th, tw) u32 ARGB
    samples in the finalize, nearest or bilinear per ``filter_mode``."""
    table = record_table(table)
    T = (table.num_triangles if isinstance(table, SetupOut)
         else int(table.shape[1]))
    atlas, tex = None, None
    if texture is not None:
        atlas, _ = pack_texture_atlas([texture])
        tex = (0, int(texture.shape[0]), int(texture.shape[1])) + (
            ("bilinear",) if filter_mode == "bilinear" else ())
    return rasterize_scene_shaded(
        table, (ObjSpec(0, T, bool(phong), tex),), transform, lights,
        height, width, capacity, frame_height, frame_width, row0, col0,
        strategy, tile_h, atlas, budget_override, zcull,
    )
