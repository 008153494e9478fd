"""Dependency-free image IO for framebuffer dumps, copied from
``tpu_renderer.utils.image`` (NumPy only; a test holds the bytes written
equal to it).

ARGB32 framebuffers (the reference's pixel format, projekt.cpp:490-493) to
PPM (trivial) and PNG (zlib, pure stdlib). The platform layer the reference
relied on for blitting is a file here. Every function also takes a
framebuffer's colour tensor, on any device (``argb_array``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def argb_array(color) -> np.ndarray:
    """An (H, W) u32 ARGB array from a framebuffer's colour tensor (u32 or
    i32, on any device) or from an array."""
    if isinstance(color, torch.Tensor):
        return color.view(torch.int32).cpu().numpy().view(np.uint32)
    return np.asarray(color, np.uint32)


def argb_to_rgb(argb: np.ndarray) -> np.ndarray:
    a = argb_array(argb)
    return np.stack(
        [(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF], axis=-1
    ).astype(np.uint8)


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    a = argb_array(argb)
    return np.stack(
        [(a >> 16) & 0xFF, (a >> 8) & 0xFF, a & 0xFF, (a >> 24) & 0xFF],
        axis=-1,
    ).astype(np.uint8)


def write_ppm(path: str, argb: np.ndarray) -> None:
    rgb = argb_to_rgb(argb)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def write_png(path: str, argb: np.ndarray, alpha: bool = False) -> None:
    px = argb_to_rgba(argb) if alpha else argb_to_rgb(argb)
    h, w = px.shape[:2]
    channels = px.shape[2]
    color_type = 6 if channels == 4 else 2

    raw = b"".join(
        b"\x00" + px[row].tobytes() for row in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader (8-bit RGB/RGBA, no interlace) -> (H, W) u32 ARGB."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = channels = None
    while pos < len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            if depth != 8 or interlace != 0 or color_type not in (2, 6):
                raise ValueError("unsupported PNG variant")
            channels = 4 if color_type == 6 else 3
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for row in range(h):
        filt = raw[pos]
        line = np.frombuffer(
            raw, np.uint8, count=stride, offset=pos + 1
        ).astype(np.int32)
        pos += 1 + stride
        if filt == 0:
            cur = line
        elif filt == 1:  # Sub
            cur = line.copy()
            for i in range(channels, stride):
                cur[i] = (cur[i] + cur[i - channels]) & 0xFF
        elif filt == 2:  # Up
            cur = (line + prev) & 0xFF
        elif filt == 3:  # Average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - channels] if i >= channels else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            cur = line.copy()
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = prev[i]
                c = prev[i - channels] if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[row] = cur.astype(np.uint8)
        prev = cur
    px = out.reshape(h, w, channels).astype(np.uint32)
    alpha = px[:, :, 3] if channels == 4 else np.uint32(255)
    return (alpha << 24) | (px[:, :, 0] << 16) | (px[:, :, 1] << 8) | px[:, :, 2]
