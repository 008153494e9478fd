"""Vertex stage: projection, backface cull, Gouraud lighting, edge setup.

PyTorch counterpart of ``tpu_renderer.geometry.vertex``: FillEdgeTable
(projekt.cpp:3882-4121) vectorised over all triangles, channel-major, in
the JAX package's f32 op order, with ``core.math``'s IEEE ``sqrt`` and
tensor divisions. ``setup_fields`` is the one copy of the field math: the
small-object chain (``setup_records``, the channel-major (85, T) table the
JAX package writes with XLA below 4096 triangles) and the plain version of
the K1 setup kernel (``ops.setup.setup_plain``) both call it.

One record is one 128-lane f32 row: 3 edges x 28 field lanes, the global
triangle id at lane 84, then zeros. Per-edge lane order: [valid, ymin,
ymax, x0, xg, z0, zg, oz0, ozg, u0, ug, v0, vg, left, col0 rgba, colg rgba,
n0 xyz, ng xyz].

``setup_triangles`` gives the same fields as an ``EdgeTable``, the
(T, 3)-minor view that the reference rasterizer (``ops.raster_reference``)
walks triangle by triangle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.math import (
    clamp01,
    inner,
    maximum,
    normalize,
    round_half_away,
    sqrt,
)
from ..core.types import (
    NEAR_CLIP,
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    RenderObject,
)

F32 = torch.float32

EDGE_INDICES = ((0, 1), (1, 2), (2, 0))  # projekt.cpp:3936-3941
EDGE_STRIDE = 28
GID_LANE = 84  # 3 * EDGE_STRIDE
REC_ROWS = 85  # field rows incl. gid
REC_LANES = 128

F_VALID, F_YMIN, F_YMAX, F_X0, F_XG, F_Z0, F_ZG = range(7)
F_OZ0, F_OZG, F_U0, F_UG, F_V0, F_VG, F_LEFT = range(7, 14)
F_COL0 = 14  # 4 lanes
F_COLG = 18  # 4 lanes
F_N0 = 22  # 3 lanes
F_NG = 25  # 3 lanes


class EdgeTable(NamedTuple):
    """Per-triangle edge records (3 candidate edges each), the (T, 3)-minor
    view of ``setup_fields``: float fields (T, 3), col0 / colg (T, 3, 4),
    n0 / ng (T, 3, 3); ``valid`` (T, 3) bool folds in the backface cull."""

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

    @property
    def num_triangles(self) -> int:
        return self.valid.shape[0]


def concat_edge_tables(tables) -> EdgeTable:
    """Per-object edge tables concatenated along the triangle axis: row i
    of the result is scene-global triangle id i, objects in submission
    order (geometry/vertex.py:86)."""
    tables = list(tables)
    if len(tables) == 1:
        return tables[0]
    return EdgeTable(*[torch.cat(cols) for cols in zip(*tables)])


def _norm3(x, y, z):
    """normalize() on separate component rows: ((x*x + y*y) + z*z), then
    an explicit IEEE 1/sqrt."""
    d = x * x + y * y
    d = d + z * z
    inv = 1.0 / sqrt(d)
    return x * inv, y * inv, z * inv


def project_vertices(cam: torch.Tensor, transform: ProjectiveTransform):
    """Perspective projection (ProjectVertex, projekt.cpp:74-93) of (..., 3)
    camera-space points -> (..., 3) with z = DistanceToPZ; points behind
    the near plane degenerate to the zero vector."""
    dz = transform.distance_above_target - cam[..., 2]
    s = (1.0 / dz) * transform.focal_length
    px = transform.screen_center[0] + transform.meters_to_pixels * (
        s * cam[..., 0])
    py = transform.screen_center[1] + transform.meters_to_pixels * (
        s * cam[..., 1])
    out = torch.stack([px, py, dz], dim=-1)
    return torch.where((dz > NEAR_CLIP)[..., None], out, 0.0)


def unproject_vertices(px, py, z, transform: ProjectiveTransform):
    """Inverse projection (UnprojectVertex, projekt.cpp:147-160) of pixel
    coordinates px, py at camera-space z -> (..., 3) camera-space points,
    in geometry/vertex.py:116's op order. The camera's scalars are 0-d
    tensors on the planes' device, so both divisions are IEEE tensor
    divisions."""
    dz = transform.distance_above_target - z
    inv_m2p = 1.0 / transform.meters_to_pixels
    ax = (px - transform.screen_center[0]) * inv_m2p
    ay = (py - transform.screen_center[1]) * inv_m2p
    s = dz / transform.focal_length
    return torch.stack([s * ax, s * ay, z], dim=-1)


def backface_visible(proj: torch.Tensor):
    """Screen-space cull (projekt.cpp:3926-3943) of (T, 3, 3) projected
    triangles: visible iff dot((0,0,-1), cross(n(p1-p0), n(p2-p0))) > 0."""
    e1 = normalize(proj[:, 1] - proj[:, 0])
    e2 = normalize(proj[:, 2] - proj[:, 0])
    return -(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > 0.0


def gouraud_vertex_colors(colors, normals, cam, lights: LightData,
                          textured: bool):
    """Per-vertex ambient + clamped diffuse accumulation
    (projekt.cpp:4022-4063) over any leading axes, one clamp per light."""
    base = torch.ones_like(colors) if textured else colors
    if lights.count == 0:
        return base  # divergence #6: raw color passthrough
    out = base * lights.ambient
    for k in range(lights.count):
        to_light = normalize(lights.light_p[k] - cam)
        d = clamp01(inner(to_light, normals))
        out = clamp01(out + d[..., None] * (base * lights.light_intensity[k]))
    return out


def _param_parts(transform: ProjectiveTransform, lights: LightData):
    """(camera, lights) parts of ``setup_params``, each a flat tensor: the
    values before and after the object's position."""
    head = [
        transform.distance_above_target.reshape(1),
        transform.focal_length.reshape(1),
        transform.meters_to_pixels.reshape(1),
        transform.screen_center.reshape(2),
    ]
    tail = [lights.ambient.reshape(4)]
    for k in range(lights.count):
        tail.append(lights.light_p[k].reshape(3))
        tail.append(lights.light_intensity[k].reshape(4))
    return head, tail


def setup_params(obj_p, transform: ProjectiveTransform,
                 lights: LightData) -> torch.Tensor:
    """Flat f32 vector: [dat, fl, m2p, cx, cy, p xyz, ambient rgba,
    (light_p xyz, light_I rgba) per light]."""
    head, tail = _param_parts(transform, lights)
    return torch.cat([p.to(F32) for p in head + [obj_p.reshape(3)] + tail])


def scene_setup_params(ps: torch.Tensor, transform: ProjectiveTransform,
                       lights: LightData) -> torch.Tensor:
    """``setup_params`` of n objects at once, row i that of the object at
    ``ps[i]`` ((n, 3)): (n, 12 + 7 * lights.count) f32, the same values."""
    head, tail = _param_parts(transform, lights)
    n = ps.shape[0]
    head = torch.cat([p.to(F32) for p in head])
    tail = torch.cat([p.to(F32) for p in tail])
    return torch.cat([head.expand(n, -1), ps.to(F32),
                      tail.expand(n, -1)], dim=1)


def setup_fields(params, verts, cols, nrms, n_lights: int, phong: bool,
                 uvs=None):
    """FillEdgeTable, channel-major: the JAX package's ``_setup_fields``
    (geometry/vertex.py:169) on (3, T) rows.

    params: ``setup_params``; verts / nrms (3, 3, T), cols (4, 3, T);
    uvs (2, 3, T) for a textured object (its u/z, v/z and 1/z fields and
    the white Gouraud base), None for an untextured one (those six lanes
    0, divergence #5). Returns (fields (EDGE_STRIDE, 3, T) f32, every lane
    0 outside keep; keep (3, T) bool per-edge validity)."""
    dat, fl, m2p, cx, cy = (params[i] for i in range(5))
    p = (params[5], params[6], params[7])
    amb = tuple(params[8 + c] for c in range(4))
    lp = [tuple(params[12 + 7 * k + i] for i in range(3))
          for k in range(n_lights)]
    li = [tuple(params[12 + 7 * k + 3 + c] for c in range(4))
          for k in range(n_lights)]

    cam = [verts[c] + p[c] for c in range(3)]  # (3v, T) each component

    # ProjectVertex (projekt.cpp:74-93).
    dz = dat - cam[2]
    s = (1.0 / dz) * fl
    x = cx + m2p * (s * cam[0])
    y = cy + m2p * (s * cam[1])
    good = dz > NEAR_CLIP
    px = torch.where(good, x, 0.0)
    py = torch.where(good, y, 0.0)
    pz = torch.where(good, dz, 0.0)

    # Screen-space backface cull (projekt.cpp:3926-3943).
    e1 = _norm3(px[1] - px[0], py[1] - py[0], pz[1] - pz[0])
    e2 = _norm3(px[2] - px[0], py[2] - py[0], pz[2] - pz[0])
    visible = -(e1[0] * e2[1] - e1[1] * e2[0]) > 0.0  # (T,)

    colors = [cols[c] for c in range(4)]
    normals = [nrms[c] for c in range(3)]

    # Per-vertex colors: raw under Phong, Gouraud-baked otherwise
    # (projekt.cpp:4022-4063; textured => white base).
    textured = uvs is not None
    base = [torch.ones_like(colors[0])] * 4 if textured else colors
    if phong:
        gcol = colors
    elif n_lights == 0:
        gcol = base  # divergence #6: raw passthrough
    else:
        out = [base[c] * amb[c] for c in range(4)]
        for k in range(n_lights):
            tl = _norm3(lp[k][0] - cam[0], lp[k][1] - cam[1],
                        lp[k][2] - cam[2])
            d = tl[0] * normals[0]
            d = d + tl[1] * normals[1]
            d = d + tl[2] * normals[2]
            d = clamp01(d)  # (3v, T)
            out = [clamp01(out[c] + d * (base[c] * li[k][c]))
                   for c in range(4)]
        gcol = out

    # Edge e = (vertex e, vertex (e+1)%3), endpoints ordered by y.
    y_lo = py
    swap = y_lo > torch.roll(py, -1, 0)  # (3e, T)

    def sel(arr):
        hi = torch.roll(arr, -1, 0)
        return torch.where(swap, hi, arr), torch.where(swap, arr, hi)

    minv_x, maxv_x = sel(px)
    minv_y, maxv_y = sel(py)
    camz_mn, camz_mx = sel(cam[2])

    keep = (
        visible[None]
        & (maxv_y > 0.0)  # offscreen-top reject cpp:3968
        & (minv_y - maxv_y != 0.0)  # horizontal cpp:4066
    )  # (3e, T)

    ymax = round_half_away(maxv_y)  # cpp:3988
    ymin = maximum(0.0, round_half_away(minv_y))  # cpp:3999
    neg = minv_y < 0.0
    clipped_y = torch.where(neg, -minv_y, 0.0)
    tt = torch.where(neg, (-minv_y) / (maxv_y - minv_y), 0.0)

    ydiff = ymax - ymin
    xg = (maxv_x - minv_x) / (maxv_y - minv_y)  # cpp:4073
    zg = (camz_mx - camz_mn) / ydiff  # cpp:4072
    x0 = minv_x + clipped_y * xg  # cpp:4075
    z0 = camz_mn + clipped_y * zg  # cpp:4076
    zero = torch.zeros_like(ydiff)
    if textured:  # cpp:4078-4089
        minv_z, maxv_z = sel(pz)
        uvu_mn, uvu_mx = sel(uvs[0])
        uvv_mn, uvv_mx = sel(uvs[1])
        oz0 = 1.0 / minv_z  # cpp:4004 (inf when degenerate)
        u0 = uvu_mn / minv_z
        v0 = uvv_mn / minv_z
        ozmax = 1.0 / maxv_z
        u1 = uvu_mx * ozmax
        v1 = uvv_mx * ozmax
        ug = (u1 - u0) / ydiff
        vg = (v1 - v0) / ydiff
        ozg = (ozmax - oz0) / ydiff
        u0 = u0 + clipped_y * ug
        v0 = v0 + clipped_y * vg
        oz0 = oz0 + clipped_y * ozg
        uv_fields = [oz0, ozg, u0, ug, v0, vg]
    else:
        uv_fields = [zero] * 6  # divergence #5: untextured lanes are 0

    left = torch.where(ymin == round_half_away(y_lo), 1.0, 0.0)  # cpp:4093

    # Top-clip color lerp (cpp:4091); normals are NOT lerped (quirk).
    col0, colg = [], []
    for c in range(4):
        mn, mx = sel(gcol[c])
        c0 = (1.0 - tt) * mn + tt * mx
        col0.append(c0)
        colg.append((mx - c0) / ydiff)
    if phong:
        n0, ng = [], []
        for c in range(3):
            mn, mx = sel(normals[c])
            n0.append(mn)
            ng.append((mx - mn) / ydiff)
    else:
        n0 = ng = [zero] * 3

    fields = ([keep.to(F32), ymin, ymax, x0, xg, z0, zg]
              + uv_fields + [left] + col0 + colg + n0 + ng)
    assert len(fields) == EDGE_STRIDE
    return torch.where(keep[None], torch.stack(fields), 0.0), keep


def setup_records(obj: RenderObject, transform: ProjectiveTransform,
                  lights: LightData, cfg: ObjectConfig,
                  gid0: int = 0) -> torch.Tensor:
    """Channel-major packed record table (85, T) f32 of one object
    (geometry/vertex.py:320): row r < 84 is record lane r, row 84 the
    global triangle id ``gid0 + arange(T)``. ``ops.raster``'s
    ``finish_records`` pads and transposes it to the row-major table."""
    T = obj.num_triangles
    fields, _ = setup_fields(setup_params(obj.p, transform, lights),
                             obj.vertices, obj.colors, obj.normals,
                             lights.count, cfg.phong,
                             obj.uvs if cfg.textured else None)
    rec = fields.permute(1, 0, 2).reshape(3 * EDGE_STRIDE, T)
    gid = (torch.arange(T, dtype=torch.int32, device=rec.device)
           + int(gid0)).to(F32)
    return torch.cat([rec, gid[None]])


def setup_triangles(obj: RenderObject, transform: ProjectiveTransform,
                    lights: LightData, cfg: ObjectConfig) -> EdgeTable:
    """FillEdgeTable as an EdgeTable (geometry/vertex.py:344): the fields
    of ``setup_fields``, the same values re-stacked (T, 3)-minor."""
    fields, keep = setup_fields(setup_params(obj.p, transform, lights),
                                obj.vertices, obj.colors, obj.normals,
                                lights.count, cfg.phong,
                                obj.uvs if cfg.textured else None)

    def f(j):  # scalar field j -> (T, 3)
        return fields[j].t()

    def fvec(j0, n):  # n-channel field at lane j0 -> (T, 3, n)
        return fields[j0:j0 + n].permute(2, 1, 0)

    return EdgeTable(
        valid=keep.t(),
        ymin=f(F_YMIN), ymax=f(F_YMAX), x0=f(F_X0), xg=f(F_XG), z0=f(F_Z0),
        zg=f(F_ZG), oz0=f(F_OZ0), ozg=f(F_OZG), u0=f(F_U0), ug=f(F_UG),
        v0=f(F_V0), vg=f(F_VG), left=f(F_LEFT),
        col0=fvec(F_COL0, 4), colg=fvec(F_COLG, 4), n0=fvec(F_N0, 3),
        ng=fvec(F_NG, 3),
    )
