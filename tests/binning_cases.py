"""Inputs of the sorted binning's tests (``ops.raster.bin_for_raster``, K14
on the card): seeded bbox planes as K1 writes them (valid, ylo, yhi, xlo,
xhi over the global frame), with bboxes that end exactly on tile and strip
boundaries, triangles large enough for the side list, invalid and
degenerate rows, NaN and infinities, and the grid of routes the sorted
strategy takes (every tile height the sweep covers, one and two streams,
expansion 4, 8 and 32, sub-rects off the frame's origin, budgets that
drop, more than 2048 large triangles, both sort key widths). Imports no
JAX: the card's tests use it too."""

from typing import NamedTuple

import numpy as np
import torch

from tpu_renderer_torch.ops.raster import QUEUE_BLK, WIDE_BLK, RasterRoute

F = np.float32


class Case(NamedTuple):
    name: str
    T: int
    frame: tuple  # (frame_height, frame_width)
    rect: tuple  # (height, width, row0, col0) of the local rect
    tile_h: int
    rows: int
    expansion: int
    budget_factor: float
    large_share: float  # share of triangles sized for the side list
    seed: int
    special: bool = False  # NaN, infinities and degenerate rows planted

    @property
    def route(self) -> RasterRoute:
        blk = WIDE_BLK if self.tile_h <= 8 else QUEUE_BLK
        return RasterRoute("sorted", self.tile_h, self.rows, self.expansion,
                           blk, self.budget_factor, self.budget_factor)


def bbox_planes(case: Case, device="cpu"):
    """The case's five bbox planes, (T,) each: bool, then f32."""
    rng = np.random.default_rng(case.seed)
    T, (fh, fw) = case.T, case.frame
    th, tw = case.tile_h, 128
    large = rng.random(T) < case.large_share
    cy = rng.uniform(-6.0, fh + 6.0, T)
    cx = rng.uniform(-20.0, fw + 20.0, T)
    unit = th // case.rows
    hh = np.where(large, rng.uniform(2.0, 3.5, T) * th,
                  rng.exponential(0.3 * unit, T))
    hw = np.where(large, rng.uniform(1.2, 3.0, T) * tw,
                  rng.exponential(10.0, T))
    ylo, yhi = cy - hh, cy + hh
    xlo, xhi = cx - hw, cx + hw
    # Ends on tile and strip boundaries: where a divisor's rounding shows.
    snap = rng.random(T) < 0.15
    ylo = np.where(snap, np.floor(ylo / unit) * unit, ylo)
    yhi = np.where(snap, np.ceil(yhi / unit) * unit, yhi)
    xsnap = rng.random(T) < 0.1
    xlo = np.where(xsnap, np.floor(xlo / tw) * tw, xlo)
    xhi = np.where(xsnap, np.floor(xhi / tw) * tw - rng.integers(0, 2, T),
                   xhi)
    ylo, yhi = np.clip(ylo, 0, fh), np.clip(yhi, 0, fh)
    xlo, xhi = np.clip(xlo, 0, fw - 1), np.clip(xhi, 0, fw - 1)
    valid = rng.random(T) < 0.9
    valid[-min(T, 37):] = False  # K1's padded rows
    planes = [ylo.astype(F), yhi.astype(F), xlo.astype(F), xhi.astype(F)]
    if case.special:
        n = min(T // 8, 64)
        picks = rng.choice(T, size=(4, n), replace=False)
        for k, vals in enumerate(([np.nan] * 2, [np.inf, -np.inf],
                                  [np.nan, np.inf], [-np.inf, np.nan])):
            planes[k][picks[k]] = rng.choice(np.array(vals, F), n)
            valid[picks[k]] = True
        flat = picks[0][: n // 2]
        planes[1][flat] = planes[0][flat]  # zero height
        back = picks[2][: n // 2]
        planes[2][back], planes[3][back] = planes[3][back], planes[2][back]
        huge = picks[3][: n // 4]
        planes[0][huge], planes[1][huge] = F(-3e38), F(3e38)
    return (torch.from_numpy(valid).to(device),) + tuple(
        torch.from_numpy(p).to(device) for p in planes)


def _case(name, T, frame, rect, tile_h, rows, expansion, bf, large, seed,
          special=False):
    return Case(name, T, frame, rect, tile_h, rows, expansion, bf, large,
                seed, special)


# The sweep's tile heights, one stream, its expansion and budget from the
# route policy at each size (expansion 32 under 16,384 triangles on tiles
# of 16 rows or more), on a sub-rect off the origin of a ragged frame.
HEIGHT_CASES = tuple(
    _case(f"h{th}-e{exp}", T, (232, 700), (200, 620, 19, 37), th, 1, exp, bf,
          60 / T, 100 + th)
    for th in (8, 16, 24, 32, 40, 48, 56, 64)
    for T, exp, bf in ((3000, 8, 2.0), (9000, 32, 4.0) if th >= 16 else
                       (70000, 4, 1.2)))
# Two strip streams (row packing) at the heights it divides.
ROWS_CASES = tuple(
    _case(f"rows2-h{th}", T, (240, 900), (240, 900, 0, 0), th, 2, 2, bf,
          0.01, 200 + th)
    for th, T, bf in ((8, 40000, 1.0), (16, 6000, 1.0), (24, 5000, 1.0)))
EDGE_CASES = (
    _case("rows2-origin", 20000, (300, 1000), (150, 500, 150, 500), 8, 2, 2,
          0.4, 0.03, 7),
    _case("rows2-special", 8000, (200, 640), (200, 640, 0, 0), 8, 2, 2, 1.0,
          0.05, 8, True),
    _case("single-special", 8000, (200, 640), (176, 600, 11, 29), 16, 1, 8,
          2.0, 0.05, 9, True),
    _case("over-budget-rows2", 20000, (256, 1024), (256, 1024, 0, 0), 8, 2,
          2, 0.06, 0.01, 10),
    _case("over-budget-single", 20000, (256, 1024), (256, 1024, 0, 0), 8, 1,
          4, 0.1, 0.01, 11),
    _case("side-list-2400", 6000, (256, 1024), (256, 1024, 0, 0), 8, 1, 4,
          1.2, 0.45, 12),
    _case("side-list-2400-rows2", 6000, (256, 1024), (240, 1000, 16, 24), 8,
          2, 2, 0.5, 0.45, 13),
    _case("one-tile", 300, (8, 100), (8, 100, 0, 0), 8, 1, 4, 1.2, 0.0, 14),
)
# The sort key past 16 bits: rows * (tiles + 1) > 32,768.
WIDE_KEY_CASES = (
    _case("key32-rows2", 30000, (1600, 12800), (1600, 12800, 0, 0), 8, 2, 2,
          0.5, 0.01, 15),
    _case("key32-single", 30000, (2100, 16500), (2048, 16384, 20, 60), 8, 1,
          4, 1.2, 0.01, 16),
)
CASES = HEIGHT_CASES + ROWS_CASES + EDGE_CASES + WIDE_KEY_CASES
