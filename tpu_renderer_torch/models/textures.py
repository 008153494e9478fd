"""Procedural ARGB32 textures and BMP bitmap IO, copied from
``tpu_renderer.models.textures`` (a test holds the copy equal to it).
Texture memory layout is u32 ARGB: bits[31:24]=A, [23:16]=R, [15:8]=G,
[7:0]=B (projekt.cpp:440-443).
"""

from __future__ import annotations

import struct

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


def gradient_texture(height: int = 64, width: int = 64):
    """Horizontal-red / vertical-green ramp, full alpha."""
    r = (np.arange(width)[None, :] * 255 // max(width - 1, 1)).astype(np.uint32)
    g = (np.arange(height)[:, None] * 255 // max(height - 1, 1)).astype(
        np.uint32
    )
    r = np.broadcast_to(r, (height, width))
    g = np.broadcast_to(g, (height, width))
    return (np.uint32(255) << 24) | (r << 16) | (g << 8)


def load_bmp(path: str) -> np.ndarray:
    """Minimal uncompressed 24/32-bit BMP loader -> (H, W) u32 ARGB.

    Covers the file format the reference's platform layer would feed in as
    ``loaded_bitmap``. Rows are returned top-down.
    """
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    header_size = struct.unpack_from("<I", data, 14)[0]
    if header_size < 40:
        raise ValueError("unsupported BMP header")
    width, height = struct.unpack_from("<ii", data, 18)
    planes, bpp = struct.unpack_from("<HH", data, 26)
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression not in (0, 3) or bpp not in (24, 32):
        raise ValueError(f"unsupported BMP: bpp={bpp} compression={compression}")
    flipped = height > 0
    height = abs(height)
    out = np.zeros((height, width), np.uint32)
    row_bytes = (width * (bpp // 8) + 3) & ~3
    for row in range(height):
        src = pixel_offset + row * row_bytes
        dst = height - 1 - row if flipped else row
        px = np.frombuffer(
            data, np.uint8, count=width * (bpp // 8), offset=src
        ).reshape(width, bpp // 8)
        b = px[:, 0].astype(np.uint32)
        g = px[:, 1].astype(np.uint32)
        r = px[:, 2].astype(np.uint32)
        a = px[:, 3].astype(np.uint32) if bpp == 32 else np.uint32(255)
        out[dst] = (a << 24) | (r << 16) | (g << 8) | b
    return out


def save_bmp(path: str, argb: np.ndarray) -> None:
    """Write (H, W) u32 ARGB as a 32-bit BMP (top-down)."""
    argb = np.asarray(argb, np.uint32)
    h, w = argb.shape
    a = ((argb >> 24) & 0xFF).astype(np.uint8)
    r = ((argb >> 16) & 0xFF).astype(np.uint8)
    g = ((argb >> 8) & 0xFF).astype(np.uint8)
    b = (argb & 0xFF).astype(np.uint8)
    px = np.stack([b, g, r, a], axis=-1).tobytes()
    header = struct.pack(
        "<2sIHHI", b"BM", 14 + 40 + len(px), 0, 0, 14 + 40
    ) + struct.pack(
        "<IiiHHIIiiII", 40, w, -h, 1, 32, 0, len(px), 2835, 2835, 0, 0
    )
    with open(path, "wb") as f:
        f.write(header + px)
