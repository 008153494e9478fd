"""Closed-form span evaluation of one or many triangles over a block of
rows and columns: what the reference's active-edge-table walk computes
sequentially (DrawModel span setup + pixel loop, projekt.cpp:303-539).

PyTorch counterpart of ``tpu_renderer.ops.spans``, in its f32 op order:

  per row y:   which 2 of the 3 edges are active, ordered by the AET rules
               (x, then dx/dy, then the Left flag, projekt.cpp:212-216);
  per span:    increments = (right - left) / roundf(xr - xl), the XOffset
               left-clip advance, the [round(lx), round(rx)] inclusive
               pixel range (projekt.cpp:306-421);
  per pixel:   attr = left_attr + (XOffset + (x - minx)) * increment.

A ``TriangleSlice`` may carry leading batch axes (fields (..., 3)); every
result then carries them too. ``span_rows`` stops at the per-row span
setup, so ``ops.raster_reference`` can evaluate a chunk of triangles'
depth first and the winners' attributes after, with the same per-pixel
operation as ``span_block``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.math import minimum, round_half_away

F32 = torch.float32
_BIG = float(np.float32(3.4028235e38))  # inactive-edge sort key: FLT_MAX


class TriangleSlice(NamedTuple):
    """A triangle's 3 candidate edges (fields (..., 3), (..., 3, 4),
    (..., 3, 3)): one row of an EdgeTable, or a chunk of rows."""

    valid: torch.Tensor
    ymin: torch.Tensor
    ymax: torch.Tensor
    x0: torch.Tensor
    xg: torch.Tensor
    z0: torch.Tensor
    zg: torch.Tensor
    oz0: torch.Tensor
    ozg: torch.Tensor
    u0: torch.Tensor
    ug: torch.Tensor
    v0: torch.Tensor
    vg: torch.Tensor
    left: torch.Tensor
    col0: torch.Tensor
    colg: torch.Tensor
    n0: torch.Tensor
    ng: torch.Tensor


class SpanBlock(NamedTuple):
    """Per-pixel fragment data for an (R, W) block: coverage + interpolants."""

    mask: torch.Tensor  # (R, W) bool
    z: torch.Tensor  # (R, W)
    col: torch.Tensor  # (R, W, 4)
    n: torch.Tensor  # (R, W, 3)
    u: torch.Tensor  # (R, W) u/viewz
    v: torch.Tensor  # (R, W) v/viewz
    oz: torch.Tensor  # (R, W) 1/viewz


class SpanRows(NamedTuple):
    """Per-row span setup of triangles over R rows (leading axes ...):
    ``ok`` (..., R) at least two active edges; ``minx``, ``maxx``,
    ``xoff`` (..., R); ``left`` and ``inc`` (..., R, 11), the left value
    and per-pixel increment of the G-buffer channels z, rgba, normal xyz,
    u/z, v/z, 1/z."""

    ok: torch.Tensor
    minx: torch.Tensor
    maxx: torch.Tensor
    xoff: torch.Tensor
    left: torch.Tensor
    inc: torch.Tensor


def _edge_order(xs, xg, left, act):
    """Rank the 3 candidate edges per row by the AET insertion key (x,
    gradient, left; index as the final tie-break), inactive edges last.
    Returns (rank0_is, rank1_is): two (..., 3) boolean selectors."""
    kx = torch.where(act, xs, _BIG)
    kg = torch.where(act, xg, _BIG)
    kl = torch.where(act, left, _BIG)

    def less(i, j):
        lt = kx[..., i] < kx[..., j]
        eq = kx[..., i] == kx[..., j]
        lt2 = kg[..., i] < kg[..., j]
        eq2 = kg[..., i] == kg[..., j]
        lt3 = kl[..., i] < kl[..., j]
        eq3 = kl[..., i] == kl[..., j]
        return lt | (eq & (lt2 | (eq2 & (lt3 | (eq3 & (i < j))))))

    before = torch.stack([
        sum(less(j, i).to(torch.int32) for j in range(3) if j != i)
        for i in range(3)], dim=-1)
    return before == 0, before == 1


def _sel(isL, isR, vals):
    """The rank-0 and rank-1 edge's value. vals: (..., 3) or (..., 3, C);
    the selectors (..., 3), exactly one true entry each."""

    def pick(sel):
        if vals.dim() > sel.dim():
            sel = sel[..., None]
            s = [sel[..., e, :] for e in range(3)]
            v = [vals[..., e, :] for e in range(3)]
        else:
            s = [sel[..., e] for e in range(3)]
            v = [vals[..., e] for e in range(3)]
        return torch.where(s[0], v[0], torch.where(s[1], v[1], v[2]))

    return pick(isL), pick(isR)


def span_rows(tri: TriangleSlice, rows: torch.Tensor,
              width: int) -> SpanRows:
    """The per-row half of ``span_block``: rows (R,) f32 integer-valued
    frame rows; width the full framebuffer width (the reference clamps
    spans against the frame, projekt.cpp:381-400)."""
    yf = rows[:, None]  # (R, 1)

    def per_row(a):  # (..., 3) -> (..., 1, 3)
        return a[..., None, :]

    def per_row_c(a):  # (..., 3, C) -> (..., 1, 3, C)
        return a[..., None, :, :]

    act = (per_row(tri.valid) & (per_row(tri.ymin) <= yf)
           & (yf < per_row(tri.ymax)))
    dy = yf - per_row(tri.ymin)  # (..., R, 3)

    def at(f0, fg):
        return per_row(f0) + dy * per_row(fg)

    def at_c(f0, fg):
        return per_row_c(f0) + dy[..., None] * per_row_c(fg)

    xs = at(tri.x0, tri.xg)
    isL, isR = _edge_order(xs, per_row(tri.xg).expand(xs.shape),
                           per_row(tri.left).expand(xs.shape), act)
    ok = act.to(torch.int32).sum(dim=-1) >= 2
    xl, xr = _sel(isL, isR, xs)
    # Channel order of the G-buffer: z, rgba, normal xyz, u/z, v/z, 1/z.
    chans = torch.cat([at(tri.z0, tri.zg)[..., None],
                       at_c(tri.col0, tri.colg), at_c(tri.n0, tri.ng),
                       at(tri.u0, tri.ug)[..., None],
                       at(tri.v0, tri.vg)[..., None],
                       at(tri.oz0, tri.ozg)[..., None]], dim=-1)
    cl, cr = _sel(isL, isR, chans)

    # Span setup (projekt.cpp:306-421).
    xd = round_half_away(xr - xl)
    nz = xd != 0.0
    inc = torch.where(nz[..., None], (cr - cl) / xd[..., None], 0.0)
    w_f = float(width)
    xoff = torch.where(xl < 0.0, -xl, 0.0)
    lx = torch.where(xl < 0.0, 0.0, torch.where(xl >= w_f, w_f - 1.0, xl))
    rx = torch.where(xr < 0.0, 0.0, torch.where(xr >= w_f, w_f - 1.0, xr))
    # divergence #7: clamp the rounded index back into the row.
    minx = minimum(round_half_away(lx), w_f - 1.0)
    maxx = minimum(round_half_away(rx), w_f - 1.0)
    return SpanRows(ok, minx, maxx, xoff, cl, inc)


def span_k(sr: SpanRows, cols: torch.Tensor):
    """(in-span mask, k) per pixel, (..., R, W): cols (W,) f32 frame
    columns; k = XOffset + (x - minx), the step from the span's left
    end."""
    xc = cols
    minx = sr.minx[..., None]
    inspan = sr.ok[..., None] & (xc >= minx) & (xc <= sr.maxx[..., None])
    return inspan, sr.xoff[..., None] + (xc - minx)


def span_block(tri: TriangleSlice, rows: torch.Tensor, cols: torch.Tensor,
               width: int) -> SpanBlock:
    """Rasterize one triangle over a row/column block (spans.py:122):
    rows (R,) and cols (W,) f32 integer-valued frame rows and columns;
    width the full framebuffer width."""
    sr = span_rows(tri, rows, width)
    mask, k = span_k(sr, cols)
    vals = sr.left[..., None, :] + k[..., None] * sr.inc[..., None, :]
    return SpanBlock(mask=mask, z=vals[..., 0], col=vals[..., 1:5],
                     n=vals[..., 5:8], u=vals[..., 8], v=vals[..., 9],
                     oz=vals[..., 10])
