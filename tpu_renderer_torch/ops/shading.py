"""Texture sampling, Blinn-Phong shading and ARGB packing.

PyTorch counterpart of ``tpu_renderer.ops.shading``, same f32 op order:

- ``sample_texture`` ('scalar' and 'avx' addressing, nearest and
  bilinear), ``phong_shade`` and ``shade``, the deferred shading of a
  channel-first (11, H, W) G-buffer that the G-buffer path of
  ``engine.renderer.render_object`` runs after ``ops.gbuffer``;
- ``shade_planes`` and ``pack_argb_planes``, the same shading with the
  channel axis unrolled into planes, which the fused raster kernels'
  finalize (``csrc/raster.cu``) computes per pixel; ``sample_atlas`` is
  the plain version of its texel fetch, K5.

These are torch ops, as the JAX package's are XLA ops: no kernel here.
"""

from __future__ import annotations

import torch

from ..core.math import (
    clamp01,
    inner,
    normalize,
    pack_channels,
    pow16,
    round_half_away,
    sqrt,
    to_i32,
    unpack_argb,
)
from ..core.types import LightData, ObjectConfig, ProjectiveTransform
from ..geometry.vertex import unproject_vertices

F32 = torch.float32
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


def sample_texture(texture, u, v, uv_mode: str = "scalar",
                   filter_mode: str = "nearest"):
    """ARGB texture fetch (ops/shading.py:29) of a (th, tw) u32 texture
    (int32 or uint32 storage) at u, v planes -> (rgba (..., 4) in [0, 1],
    mask). 'scalar' nearest rounds u * (tw - 1) with clamped indices;
    'avx' nearest truncates u * tw, clipped, and masks u, v outside [0, 1];
    bilinear lerps 4 texels on the scalar convention (``sample_atlas``),
    with the [0, 1] mask under 'avx'. Raises ValueError for an unknown
    mode, as the JAX package does."""
    th, tw = texture.shape
    tex = texture.view(torch.int32)
    if filter_mode == "bilinear":
        rgba = torch.stack(sample_atlas(tex, u, v, 0, th, tw, True), -1)
        if uv_mode == "avx":
            return rgba, _in_unit_square(u, v)
        return rgba, torch.ones_like(u, dtype=torch.bool)
    if filter_mode != "nearest":
        raise ValueError(f"unknown filter_mode: {filter_mode}")
    if uv_mode == "scalar":
        rgba = sample_atlas(tex, u, v, 0, th, tw, False)
        return torch.stack(rgba, -1), torch.ones_like(u, dtype=torch.bool)
    if uv_mode != "avx":
        raise ValueError(f"unknown uv_mode: {uv_mode}")
    tx = torch.clamp(to_i32(torch.trunc(u * float(tw))), 0, tw - 1)
    ty = torch.clamp(to_i32(torch.trunc(v * float(th))), 0, th - 1)
    texel = tex.reshape(-1)[ty.to(I64) * tw + tx.to(I64)]
    return torch.stack(unpack_argb(texel), -1), _in_unit_square(u, v)


def _in_unit_square(u, v):
    return (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)


def phong_shade(pos, nrm, base, lights: LightData):
    """Blinn-Phong on (..., 3) positions and unit normals and (..., 4)
    base colours (ops/shading.py:83): ambient * base from the first light
    on, per-light diffuse plus white specular^16, clamped at the end; no
    lights give black."""
    white = torch.ones((4,), dtype=F32, device=base.device)
    final = torch.zeros_like(base)
    view = normalize(-pos)
    for k in range(lights.count):
        if k == 0:
            final = base * lights.ambient
        to_light = normalize(lights.light_p[k] - pos)
        cosi = clamp01(inner(nrm, to_light))
        half = normalize(to_light + view)
        spec = pow16(clamp01(inner(nrm, half)))
        final = (final + cosi[..., None] * (base * lights.light_intensity[k])
                 + spec[..., None] * (white * lights.light_intensity[k]))
    return clamp01(final)


def shade(covered, gbuf, transform: ProjectiveTransform, lights: LightData,
          cfg: ObjectConfig, texture=None, row0: int = 0, col0: int = 0):
    """Deferred shading of a channel-first (11, H, W) G-buffer [z, rgba,
    normal xyz, u/z, v/z, 1/z] (ops/shading.py:182) -> (rgba (H, W, 4),
    covered). The texture replaces the interpolated colour on covered
    pixels ('avx' also drops the pixels whose u or v leaves [0, 1] from
    ``covered``); Phong shades the textured or vertex colour at the
    unprojection of the global pixel coordinates (row0, col0: the local
    rect's origin). Every division is of tensors on the G-buffer's
    device."""
    height, width = covered.shape
    dev = gbuf.device
    col = gbuf[1:5].permute(1, 2, 0)
    if cfg.textured:
        assert texture is not None, "a textured object needs its texture"
        inv_oz = 1.0 / gbuf[10]
        u = torch.where(covered, inv_oz * gbuf[8], 0.0)
        v = torch.where(covered, inv_oz * gbuf[9], 0.0)
        tex_rgba, tmask = sample_texture(texture, u, v, cfg.uv_mode,
                                         cfg.filter_mode)
        col = torch.where(covered[..., None], tex_rgba, col)
        if cfg.uv_mode == "avx":
            covered = covered & tmask
    if not cfg.phong:
        return col, covered
    px = (torch.arange(width, dtype=F32, device=dev) + float(col0))[
        None, :].expand(height, width)
    py = (torch.arange(height, dtype=F32, device=dev) + float(row0))[
        :, None].expand(height, width)
    pos = unproject_vertices(px, py, gbuf[0], transform)
    nrm = normalize(gbuf[5:8].permute(1, 2, 0))  # divergence #3
    final = phong_shade(pos, nrm, col, lights)
    return torch.where(covered[..., None], final, col), covered


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
