"""Procedural ARGB32 textures, copied from ``tpu_renderer.models.textures``
(a test holds the copy equal to it). Texture memory layout is u32 ARGB:
bits[31:24]=A, [23:16]=R, [15:8]=G, [7:0]=B (projekt.cpp:440-443).
"""

from __future__ import annotations

import numpy as np


def pack_argb_u8(r, g, b, a=255):
    return (
        (np.uint32(a) << 24)
        | (np.uint32(r) << 16)
        | (np.uint32(g) << 8)
        | np.uint32(b)
    )


def checkerboard(height: int = 64, width: int = 64, cell: int = 8,
                 color_a=(255, 255, 255), color_b=(40, 40, 160)):
    """Classic checker texture as (H, W) u32 ARGB."""
    ys = np.arange(height)[:, None] // cell
    xs = np.arange(width)[None, :] // cell
    sel = ((ys + xs) % 2).astype(bool)
    a = pack_argb_u8(*color_a)
    b = pack_argb_u8(*color_b)
    return np.where(sel, np.uint32(a), np.uint32(b)).astype(np.uint32)
