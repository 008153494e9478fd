"""Texture sampling, plane-wise Blinn-Phong shading and ARGB packing.

PyTorch counterpart of ``sample_texture`` ('scalar' addressing, nearest
and bilinear), ``shade_planes`` and ``pack_argb_planes`` of
``tpu_renderer.ops.shading``: the channel axis unrolled into separate
planes, same f32 op order. The raster kernels' finalize
(``csrc/raster.cu``) is the same computation per pixel; ``sample_atlas``
is the plain version of its texel fetch, K5.
"""

from __future__ import annotations

import torch

from ..core.math import (
    clamp01,
    pack_channels,
    pow16,
    round_half_away,
    sqrt,
    to_i32,
    unpack_argb,
)

I64 = torch.int64


def sample_atlas(atlas, u, v, v_off: int, th: int, tw: int,
                 bilinear: bool):
    """Plain K5: the texel fetch of an object whose (th, tw) texture is
    rows [v_off, v_off + th), columns [0, tw) of ``atlas`` (AH, AW) u32
    ARGB (int32 or uint32 storage), at per-pixel u, v planes. Returns 4
    planes (r, g, b, a).

    Index math of sample_texture's 'scalar' addressing in the TPU
    finalize's op order (raster_pallas.py:1662-1689): nearest rounds
    u * (tw - 1) half away from zero; bilinear takes the fraction from the
    unclipped floor and clips the indices after, the second index
    min(i + 1, t - 1). Every f32 -> int32 conversion saturates, as XLA's."""
    aw = atlas.shape[1]
    flat = atlas.reshape(-1)

    def fetch(row, col):
        return unpack_argb(flat[(row + v_off).to(I64) * aw + col.to(I64)])

    if bilinear:
        tu = u * float(tw - 1)
        tv = v * float(th - 1)
        x0 = torch.floor(tu)
        y0 = torch.floor(tv)
        fx, fy = tu - x0, tv - y0
        xi = torch.clamp(to_i32(x0), 0, tw - 1)
        yi = torch.clamp(to_i32(y0), 0, th - 1)
        xi1 = torch.clamp(xi + 1, max=tw - 1)
        yi1 = torch.clamp(yi + 1, max=th - 1)
        c00, c10 = fetch(yi, xi), fetch(yi, xi1)
        c01, c11 = fetch(yi1, xi), fetch(yi1, xi1)
        out = []
        for c in range(4):
            top = c00[c] + fx * (c10[c] - c00[c])
            bot = c01[c] + fx * (c11[c] - c01[c])
            out.append(top + fy * (bot - top))
        return out
    tx = torch.clamp(to_i32(round_half_away(u * float(tw - 1))), 0, tw - 1)
    ty = torch.clamp(to_i32(round_half_away(v * float(th - 1))), 0, th - 1)
    return fetch(ty, tx)


def sample_texture(texture, u, v, filter_mode: str = "nearest"):
    """sample_texture (ops/shading.py:29) in 'scalar' addressing: a
    (th, tw) u32 ARGB texture at u, v planes -> 4 rgba planes in [0, 1].
    'avx' addressing belongs to the G-buffer path, not ported."""
    if filter_mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown filter_mode: {filter_mode}")
    th, tw = texture.shape
    return sample_atlas(texture, u, v, 0, th, tw, filter_mode == "bilinear")


def _inner3_planes(a, b):
    """core.math.inner for 3 channel planes, identical accumulation order."""
    acc = a[0] * b[0]
    acc = acc + a[1] * b[1]
    acc = acc + a[2] * b[2]
    return acc


def _normalize3_planes(v):
    """core.math.normalize for 3 channel planes (one shared 1/sqrt)."""
    d = _inner3_planes(v, v)
    inv = 1.0 / sqrt(d)
    return [v[0] * inv, v[1] * inv, v[2] * inv]


def shade_planes(z, col, nrm, px, py, cam, ambient, light_p, light_i,
                 phong: bool, n_lights: int):
    """Shading of UNTEXTURED pixels: Gouraud returns ``col``; Phong runs
    the unprojection + per-light Blinn-Phong (projekt.cpp:450-483).

    z/px/py: planes (global pixel coords); col: 4 planes; nrm: 3 planes
    (ignored unless phong); cam: (dat, fl, m2p, cx, cy) 0-d tensors;
    ambient: 4 scalars; light_p/light_i: per-light 3/4 scalar tuples.
    Scalars are 0-d tensors on the planes' device, so every division is
    an IEEE tensor division (a CUDA tensor divided by a host scalar is a
    multiply by its reciprocal in torch)."""
    if not phong:
        return list(col)
    dat, fl, m2p, cx, cy = cam
    dz = dat - z
    inv_m2p = 1.0 / m2p
    ax = (px - cx) * inv_m2p
    ay = (py - cy) * inv_m2p
    s = dz / fl
    pos = [s * ax, s * ay, z]
    nrm = _normalize3_planes(list(nrm))  # divergence #3: single normalize
    base = list(col)
    view = _normalize3_planes([-pos[0], -pos[1], -pos[2]])
    final = [torch.zeros_like(z) for _ in range(4)]
    for k in range(n_lights):
        if k == 0:
            final = [base[c] * ambient[c] for c in range(4)]
        to_light = _normalize3_planes(
            [light_p[k][i] - pos[i] for i in range(3)]
        )
        cosi = clamp01(_inner3_planes(nrm, to_light))
        half = _normalize3_planes(
            [to_light[i] + view[i] for i in range(3)]
        )
        spec = pow16(clamp01(_inner3_planes(nrm, half)))
        final = [
            final[c] + cosi * (base[c] * light_i[k][c])
            + spec * (1.0 * light_i[k][c])
            for c in range(4)
        ]
    return [clamp01(f) for f in final]


def pack_argb_planes(r, g, b, a):
    """core.math.pack_argb with the channel axis unrolled into planes."""
    return pack_channels(r, g, b, a)
