"""A checkerboard texture, (H, W) u32 ARGB (the port's
``models.textures.checkerboard``), its two colours drawn from the seed."""

import numpy as np


def _argb(rgb):
    r, g, b = (np.uint32(c) for c in rgb)
    return (np.uint32(255) << 24) | (r << 16) | (g << 8) | b


def build(params, rng):
    """Texture of ``height`` x ``width`` texels in ``cell``-texel squares;
    opaque colours ``colors`` ([[r, g, b], [r, g, b]]) or, when that is
    "seed", two drawn from ``rng``."""
    colors = params.get("colors", "seed")
    if colors == "seed":
        colors = rng.integers(0, 256, size=(2, 3))
    ys = np.arange(params["height"])[:, None] // params["cell"]
    xs = np.arange(params["width"])[None, :] // params["cell"]
    sel = ((ys + xs) % 2).astype(bool)
    return np.where(sel, _argb(colors[0]), _argb(colors[1])).astype(
        np.uint32)
