"""Frozen copy of the port's NumPy spec (``golden/cpu_reference.py``),
the plain reference the benchmark holds every compared frame to.

It is copied, not imported: the benchmark's yardstick must not move when
the program does, and it imports nothing of the program. Only NumPy, in
float32, one triangle at a time, in submission order; ``frame.py`` beside
it renders the same spec on a window of the frame.

The spec's own notes follow.

This is the port's own copy of ``tpu_renderer/golden/cpu_reference.py``: the
same NumPy float32 code, so the two render every scene bit for bit alike
(tests/test_torch_golden.py), kept here so that the port reaches the spec
where JAX is absent. It stays NumPy, not torch: it is independent of the
port's torch code, and torch's vectorised CPU float32 ``sqrt`` is not
correctly rounded, so a torch rewrite would stop being the spec.

This is a faithful float32 re-statement of the reference renderer's scalar
semantics (``FillEdgeTable`` projekt.cpp:3882-4121 + ``DrawModel``
projekt.cpp:162-601), written in *closed form*: where the reference steps
attributes incrementally (``attr += gradient`` once per row / per pixel), the
golden evaluates ``attr = attr0 + k * gradient`` directly. The JAX and Pallas
paths and the port's CUDA kernels (built without FMA contraction) implement
the same closed forms with the same float32 operation order, so they match
this golden bit-for-bit on an IEEE backend.

One triangle at a time: ``setup_edges`` and ``rasterize`` treat each
triangle on its own, in submission order, so the triangles whose projected
bbox (``project_vertex``, clamped to the frame) meets a window reproduce the
full frame inside that window bit for bit (chip_smoke.py's
``golden_windows``).

Documented divergences from the reference binary (SURVEY.md §2.1, §7):

1. Closed-form vs sequential accumulation: ulp-level z/color differences vs
   a literal edge-walk. The golden IS the parity target, so TPU-vs-golden is
   exact; golden-vs-hypothetical-MSVC-binary differs by accumulated rounding.
2. Per-triangle rasterization: the reference inserts ALL model edges into one
   active-edge list and fills between adjacent pairs (projekt.cpp:298-303),
   which mis-pairs edges of screen-overlapping triangles. We rasterize each
   triangle independently (strictly more correct; identical on non-overlapping
   front-facing surfaces, which every reference scene is). The
   model-level AET golden in ``aet_reference.py`` quantifies this:
   identical coverage on all baseline configs, ~1% of pixels differ where
   the active list interleaves adjacent triangles (tests/test_aet.py).
3. Normals: the reference renormalizes the running normal after every
   incremental step (projekt.cpp:504,551-552). We interpolate affinely and
   normalize once at the shading point.
4. Texture addressing: scalar path semantics (round, scale by dim-1) with
   index clamping (the reference reads out of bounds for uv outside [0,1]).
   The AVX path's truncate/scale-by-dim/uv-mask variant is selectable via
   ``ObjectConfig.uv_mode='avx'``.
5. Untextured u/v/1-z: the reference COMPUTES the left values
   (UMin/VMin/OneOverZMin are assigned unconditionally,
   projekt.cpp:4002-4004) but leaves the GRADIENTS stale arena memory
   (Bitmap-gated, projekt.cpp:4079-4089); none of the six is ever
   consumed untextured. We define ALL SIX as 0 — zeroing the left values
   too (round 4) is an optimization that lets every setup path skip the
   reference's 3 unconditional divides per edge, output-invisible.
6. Zero lights + Gouraud leaves edge colors uninitialized in the reference;
   we define them as the raw vertex colors (white if textured).

7. Horizontal clamping: spans whose rounded x lands exactly on W (x in
   (W-1, W)) write one past the row in the reference (OOB); we clamp to W-1.
8. Backend rounding: the JAX path is written with the identical op order,
   but compilers may still deviate by <=1 ulp per op — this XLA CPU build
   contracts a+b*c into FMA (no flag disables it), and TPU hardware divides
   via Newton iteration, so the error compounds along long spans. The
   SHIPPED on-chip contract (bench.py::run_parity, same budgets as the
   CPU-backend suite) is RELATIVE, not ulp-counted: depth within rtol
   1e-6 on >=99.5% of co-covered pixels (99% on the multi-object config,
   whose near-coplanar intersections flip winners), coverage flips
   <=0.2%, packed ARGB color mismatch <=1%. Raw >1-ulp depth fractions
   measured on the real chip run 0.01% (curved meshes) up to ~3-6% on
   long flat spans (measurements/r3/parity.log) — within the rtol budget;
   raw ulp counts also explode spuriously for z near 0 where absolute
   deltas are ~1e-9. tests/test_parity_jax.py holds the CPU backend to
   the same relative budgets.

The reference's broken untextured non-Phong AVX pack (projekt.cpp:1459-1467)
is NOT reproduced; the scalar Gouraud path is canonical (SURVEY §2.1 "bugs").
"""

from __future__ import annotations

import numpy as np

F = np.float32
WHITE = np.ones(4, F)

# Must match tpu_renderer_torch.core.types (and tpu_renderer.core.types).
DEPTH_CLEAR = F(-3.4028235e38)
NEAR_CLIP = F(0.2)

# Edge record layout (per triangle, 3 candidate edges). Mirrors edge_info
# (projekt.h:17-37) minus the linked-list plumbing.
EDGE_FIELDS = (
    "valid",  # bool: edge survived culling/horizontal/offscreen-top rejection
    "ymin",  # f32 (integer-valued): first active row, >= 0
    "ymax",  # f32 (integer-valued): first inactive row
    "x0", "xg",  # x at ymin, dx/dy (float-y slope, projekt.cpp:4073)
    "z0", "zg",  # camera z at ymin, dz/dy (rounded-y slope, projekt.cpp:4072)
    "oz0", "ozg",  # 1/viewz
    "u0", "ug", "v0", "vg",  # u/viewz, v/viewz
    "left",  # f32 0/1 insertion tie-break flag (projekt.cpp:4093)
)
# plus col0/colg (4,) and n0/ng (3,) handled as vectors.


def roundf(x):
    """C roundf: nearest, halves away from zero (RoundR32ToS32 semantics)."""
    x = np.asarray(x, F)
    return np.sign(x) * np.floor(np.abs(x) + F(0.5))


def clamp01(x):
    return np.clip(np.asarray(x, F), F(0), F(1))


def inner(a, b):
    """Fixed-order unrolled dot along the last axis (see core.math.inner —
    reduction primitives reassociate and break bit-parity)."""
    a = np.asarray(a, F)
    b = np.asarray(b, F)
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def normalize(v):
    v = np.asarray(v, F)
    d = inner(v, v)[..., None]
    return v * (F(1) / np.sqrt(d))


def pow16(x):
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * x8


def project_vertex(cam, transform):
    """ProjectVertex (projekt.cpp:74-93), vectorized over leading axes.

    cam: (..., 3) camera-space positions. Returns (..., 3) where z is the
    distance to the camera plane; positions behind the near plane project to
    the zero vector (the reference's degenerate no-clip behavior).
    """
    cam = np.asarray(cam, F)
    dat = F(transform["distance_above_target"])
    focal = F(transform["focal_length"])
    m2p = F(transform["meters_to_pixels"])
    cx, cy = F(transform["screen_center"][0]), F(transform["screen_center"][1])

    dz = dat - cam[..., 2]
    s = (F(1) / dz) * focal  # (1/dz)*F, then *xy — reference op order
    px = cx + m2p * (s * cam[..., 0])
    py = cy + m2p * (s * cam[..., 1])
    out = np.stack([px, py, dz], axis=-1).astype(F)
    return np.where((dz > NEAR_CLIP)[..., None], out, F(0))


def unproject_vertex(px, py, z, transform):
    """UnprojectVertex (projekt.cpp:147-160), vectorized."""
    dat = F(transform["distance_above_target"])
    focal = F(transform["focal_length"])
    inv_m2p = F(1) / F(transform["meters_to_pixels"])
    cx, cy = F(transform["screen_center"][0]), F(transform["screen_center"][1])
    dz = dat - z
    ax = (px - cx) * inv_m2p
    ay = (py - cy) * inv_m2p
    s = dz / focal
    return np.stack([s * ax, s * ay, z], axis=-1).astype(F)


def gouraud_vertex_color(color, normal, cam_vertex, lights, textured):
    """Per-vertex lighting baked at edge setup (projekt.cpp:4022-4063).

    Ambient is applied once (light 0), then per-light clamped accumulation of
    diffuse with the vertex color (or white when textured).
    """
    base = WHITE if textured else np.asarray(color, F)
    lp = np.asarray(lights["light_p"], F)
    li = np.asarray(lights["light_intensity"], F)
    if lp.shape[0] == 0:
        return np.asarray(base, F).copy()  # divergence #6: raw color
    out = base * np.asarray(lights["ambient"], F)
    for k in range(lp.shape[0]):
        to_light = normalize(lp[k] - np.asarray(cam_vertex, F))
        d = clamp01(inner(to_light, np.asarray(normal, F)))
        out = clamp01(out + d * (base * li[k]))
    return out.astype(F)


def setup_edges(obj, transform, lights, phong=False, textured=False):
    """FillEdgeTable (projekt.cpp:3882-4121) per triangle.

    obj: dict with p (3,), vertices (V,3), colors (V,4), normals (V,3),
    uvs (V,2). Returns a dict of (T, 3) arrays (+ (T,3,4)/(T,3,3) for
    color/normal) and a (T,) visible mask.
    """
    verts = np.asarray(obj["vertices"], F).reshape(-1, 3, 3)  # (T, 3 verts, 3)
    colors = np.asarray(obj["colors"], F).reshape(-1, 3, 4)
    normals = np.asarray(obj["normals"], F).reshape(-1, 3, 3)
    uvs = np.asarray(obj["uvs"], F).reshape(-1, 3, 2)
    T = verts.shape[0]

    cam = verts + np.asarray(obj["p"], F)  # (T, 3, 3)  projekt.cpp:3900-3903
    proj = project_vertex(cam, transform)  # (T, 3, 3)

    # Backface cull: dot(Eye=(0,0,-1), cross(n(p1-p0), n(p2-p0))) > 0
    # (projekt.cpp:3926-3943). NaNs from degenerate normals fail the compare
    # and cull, as in the reference.
    with np.errstate(divide="ignore", invalid="ignore"):
        e1 = normalize(proj[:, 1] - proj[:, 0])
        e2 = normalize(proj[:, 2] - proj[:, 0])
        visible = -(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > F(0)

    out = {k: np.zeros((T, 3), F) for k in EDGE_FIELDS}
    out["valid"] = np.zeros((T, 3), bool)
    out["col0"] = np.zeros((T, 3, 4), F)
    out["colg"] = np.zeros((T, 3, 4), F)
    out["n0"] = np.zeros((T, 3, 3), F)
    out["ng"] = np.zeros((T, 3, 3), F)
    out["visible"] = visible

    edge_idx = ((0, 1), (1, 2), (2, 0))  # projekt.cpp:3936-3941

    with np.errstate(divide="ignore", invalid="ignore"):
        for t in range(T):
            if not visible[t]:
                continue
            # Per-vertex Gouraud colors are endpoint properties; compute once.
            if not phong:
                gcol = [
                    gouraud_vertex_color(
                        colors[t, i], normals[t, i], cam[t, i], lights, textured
                    )
                    for i in range(3)
                ]
            for e, (i0, i1) in enumerate(edge_idx):
                mn, mx = i0, i1
                if proj[t, mn, 1] > proj[t, mx, 1]:
                    mn, mx = mx, mn
                minv, maxv = proj[t, mn], proj[t, mx]
                if not (maxv[1] > F(0)):  # offscreen-top reject (cpp:3968)
                    continue
                if minv[1] - maxv[1] == F(0):  # horizontal reject (cpp:4066)
                    continue

                ymax = roundf(maxv[1])
                ymin = max(F(0), roundf(minv[1]))
                clipped_y = -minv[1] if minv[1] < F(0) else F(0)
                tt = (
                    (-minv[1]) / (maxv[1] - minv[1])
                    if minv[1] < F(0)
                    else F(0)
                )

                ydiff = F(ymax) - F(ymin)
                xg = (maxv[0] - minv[0]) / (maxv[1] - minv[1])
                zg = (cam[t, mx, 2] - cam[t, mn, 2]) / ydiff
                x0 = minv[0] + clipped_y * xg
                z0 = cam[t, mn, 2] + clipped_y * zg

                if textured:
                    oz0 = F(1) / minv[2]
                    u0 = uvs[t, mn, 0] / minv[2]
                    v0 = uvs[t, mn, 1] / minv[2]
                    u1 = uvs[t, mx, 0] * (F(1) / maxv[2])
                    v1 = uvs[t, mx, 1] * (F(1) / maxv[2])
                    ug = (u1 - u0) / ydiff
                    vg = (v1 - v0) / ydiff
                    ozg = ((F(1) / maxv[2]) - oz0) / ydiff
                    u0 = u0 + clipped_y * ug
                    v0 = v0 + clipped_y * vg
                    oz0 = oz0 + clipped_y * ozg
                else:
                    # divergence #5: ALL six u/v/1-z fields are 0 when
                    # untextured (left values AND gradients) — never
                    # consumed; skipping their 3 per-edge divides is a
                    # real setup saving on the TPU path, so the spec
                    # zeroes them too.
                    u0 = v0 = oz0 = ug = vg = ozg = F(0)

                if phong:
                    cmin, cmax = colors[t, mn], colors[t, mx]
                    nmin, nmax = normals[t, mn], normals[t, mx]
                else:
                    cmin, cmax = gcol[mn], gcol[mx]
                    nmin = nmax = np.zeros(3, F)

                cmin = (F(1) - tt) * cmin + tt * cmax  # top-clip lerp cpp:4091
                colg = (cmax - cmin) / ydiff
                # normal NOT clip-lerped (quirk); zero (not 0/0) when unused
                ng = (nmax - nmin) / ydiff if phong else np.zeros(3, F)

                left = F(1) if ymin == roundf(proj[t, i0, 1]) else F(0)

                out["valid"][t, e] = True
                out["ymin"][t, e] = ymin
                out["ymax"][t, e] = ymax
                out["x0"][t, e] = x0
                out["xg"][t, e] = xg
                out["z0"][t, e] = z0
                out["zg"][t, e] = zg
                out["oz0"][t, e] = oz0
                out["ozg"][t, e] = ozg
                out["u0"][t, e] = u0
                out["ug"][t, e] = ug
                out["v0"][t, e] = v0
                out["vg"][t, e] = vg
                out["left"][t, e] = left
                out["col0"][t, e] = cmin
                out["colg"][t, e] = colg
                out["n0"][t, e] = nmin
                out["ng"][t, e] = ng
    return out


# G-buffer channel layout produced by rasterization (before deferred shading).
GBUF_CHANNELS = 11  # z, rgba, normal xyz, u/z, v/z, 1/z


def rasterize(edges, height, width):
    """Span rasterization of one object's edge table into a fresh G-buffer.

    Returns (covered(H,W) bool, gbuf(H,W,11) f32). The z channel carries the
    depth test (larger camera-z wins; strict >, so the first writer wins ties
    — matching the reference's sequential submission order, projekt.cpp:495).
    """
    H, W = height, width
    covered = np.zeros((H, W), bool)
    gbuf = np.zeros((H, W, GBUF_CHANNELS), F)
    gbuf[:, :, 0] = DEPTH_CLEAR
    T = edges["valid"].shape[0]

    with np.errstate(divide="ignore", invalid="ignore"):
        for t in range(T):
            if not edges["visible"][t]:
                continue
            valid = edges["valid"][t]
            if valid.sum() < 2:
                continue
            ymin = edges["ymin"][t]
            ymax = edges["ymax"][t]
            rows_lo = int(ymin[valid].min())
            rows_hi = min(int(ymax[valid].max()), H)
            if rows_hi <= rows_lo:
                continue
            for y in range(rows_lo, rows_hi):
                fy = F(y)
                active = valid & (ymin <= fy) & (fy < ymax)
                if active.sum() < 2:
                    continue
                idx = np.nonzero(active)[0]
                dy = fy - ymin[idx]
                xs = edges["x0"][t, idx] + dy * edges["xg"][t, idx]
                # Active-list ordering: (x, gradient, left) ascending
                # (projekt.cpp:212-216).
                order = np.lexsort(
                    (edges["left"][t, idx], edges["xg"][t, idx], xs)
                )
                iL, iR = idx[order[0]], idx[order[1]]
                _fill_span(
                    edges, t, iL, iR, y, covered, gbuf, W
                )
    return covered, gbuf


def _edge_attrs_at(edges, t, e, fy):
    """All interpolants of edge e at row fy (closed form)."""
    dy = fy - edges["ymin"][t, e]
    return dict(
        x=edges["x0"][t, e] + dy * edges["xg"][t, e],
        z=edges["z0"][t, e] + dy * edges["zg"][t, e],
        oz=edges["oz0"][t, e] + dy * edges["ozg"][t, e],
        u=edges["u0"][t, e] + dy * edges["ug"][t, e],
        v=edges["v0"][t, e] + dy * edges["vg"][t, e],
        col=edges["col0"][t, e] + dy * edges["colg"][t, e],
        n=edges["n0"][t, e] + dy * edges["ng"][t, e],
    )


def _fill_span(edges, t, iL, iR, y, covered, gbuf, W):
    """One span fill — DrawModel inner span setup (projekt.cpp:303-539)."""
    fy = F(y)
    L = _edge_attrs_at(edges, t, iL, fy)
    R = _edge_attrs_at(edges, t, iR, fy)
    xl, xr = L["x"], R["x"]

    xd = roundf(xr - xl)  # projekt.cpp:311-312
    if xd != F(0):
        zinc = (R["z"] - L["z"]) / xd
        ozinc = (R["oz"] - L["oz"]) / xd
        uinc = (R["u"] - L["u"]) / xd
        vinc = (R["v"] - L["v"]) / xd
        cinc = (R["col"] - L["col"]) / xd
        ninc = (R["n"] - L["n"]) / xd
    else:
        zinc = ozinc = uinc = vinc = F(0)
        cinc = np.zeros(4, F)
        ninc = np.zeros(3, F)

    xoff = -xl if xl < F(0) else F(0)  # projekt.cpp:381-386 (float, pre-round)
    lx = F(0) if xl < F(0) else (F(W - 1) if xl >= F(W) else xl)
    rx = F(0) if xr < F(0) else (F(W - 1) if xr >= F(W) else xr)
    # The reference rounds AFTER the >=W clamp, so x in (W-1, W) rounds to W
    # and writes one pixel past the row (an OOB bug, projekt.cpp:402-406).
    # Divergence #7: we clamp the rounded index back into the row.
    minx = min(int(roundf(lx)), W - 1)
    maxx = min(int(roundf(rx)), W - 1)
    if maxx < minx:
        return

    n = maxx - minx + 1  # inclusive span (projekt.cpp:423-425)
    # The reference advances attr += XOffset*inc once, then += inc per pixel;
    # closed form: attr0 + (XOffset + i)*inc. XOffset is folded into k before
    # the multiply; the JAX path uses the identical fold.
    k = xoff + np.arange(n, dtype=F)
    z = L["z"] + k * zinc
    oz = L["oz"] + k * ozinc
    u = L["u"] + k * uinc
    v = L["v"] + k * vinc
    col = L["col"][None, :] + k[:, None] * cinc[None, :]
    nrm = L["n"][None, :] + k[:, None] * ninc[None, :]

    zbuf = gbuf[y, minx : maxx + 1, 0]
    win = z > zbuf
    if not win.any():
        return
    sl = slice(minx, maxx + 1)
    gbuf[y, sl, 0] = np.where(win, z, zbuf)
    gbuf[y, sl, 1:5] = np.where(win[:, None], col, gbuf[y, sl, 1:5])
    gbuf[y, sl, 5:8] = np.where(win[:, None], nrm, gbuf[y, sl, 5:8])
    gbuf[y, sl, 8] = np.where(win, u, gbuf[y, sl, 8])
    gbuf[y, sl, 9] = np.where(win, v, gbuf[y, sl, 9])
    gbuf[y, sl, 10] = np.where(win, oz, gbuf[y, sl, 10])
    covered[y, sl] |= win


def _unpack_argb(texel):
    inv255 = F(1) / F(255)
    a = ((texel >> 24) & 0xFF).astype(F) * inv255
    r = ((texel >> 16) & 0xFF).astype(F) * inv255
    g = ((texel >> 8) & 0xFF).astype(F) * inv255
    b = (texel & 0xFF).astype(F) * inv255
    return np.stack([r, g, b, a], axis=-1)


def sample_texture(texture, u, v, mode="scalar", filter_mode="nearest"):
    """ARGB texture fetch.

    Nearest (reference-faithful): scalar mode rounds uv * (dim-1), clamped
    (projekt.cpp:429-445); avx mode truncates uv * dim with a uv-in-[0,1]
    validity mask (projekt.cpp:1044-1060). Bilinear: 4-texel lerp extension
    (same formulas as the JAX path). Returns (rgba, mask).
    """
    tex = np.asarray(texture, np.uint32)
    th, tw = tex.shape
    if filter_mode == "bilinear":
        u = np.asarray(u, F)
        v = np.asarray(v, F)
        tu = u * F(tw - 1)
        tv = v * F(th - 1)
        x0 = np.floor(tu)
        y0 = np.floor(tv)
        fx = (tu - x0)[..., None]
        fy = (tv - y0)[..., None]
        xi = np.clip(x0.astype(np.int64), 0, tw - 1)
        yi = np.clip(y0.astype(np.int64), 0, th - 1)
        xi1 = np.minimum(xi + 1, tw - 1)
        yi1 = np.minimum(yi + 1, th - 1)
        c00 = _unpack_argb(tex[yi, xi])
        c10 = _unpack_argb(tex[yi, xi1])
        c01 = _unpack_argb(tex[yi1, xi])
        c11 = _unpack_argb(tex[yi1, xi1])
        top = c00 + fx * (c10 - c00)
        bot = c01 + fx * (c11 - c01)
        rgba = (top + fy * (bot - top)).astype(F)
        if mode == "avx":
            mask = (u >= F(0)) & (u <= F(1)) & (v >= F(0)) & (v <= F(1))
        else:
            mask = np.ones(np.shape(u), bool)
        return rgba, mask
    if mode == "scalar":
        tx = np.clip(roundf(u * F(tw - 1)).astype(np.int64), 0, tw - 1)
        ty = np.clip(roundf(v * F(th - 1)).astype(np.int64), 0, th - 1)
        mask = np.ones(np.shape(u), bool)
    else:
        mask = (u >= F(0)) & (u <= F(1)) & (v >= F(0)) & (v <= F(1))
        tx = np.clip(np.trunc(u * F(tw)).astype(np.int64), 0, tw - 1)
        ty = np.clip(np.trunc(v * F(th)).astype(np.int64), 0, th - 1)
    texel = tex[ty, tx]
    return _unpack_argb(texel), mask


def shade(covered, gbuf, transform, lights, phong=False, texture=None,
          uv_mode="scalar", filter_mode="nearest"):
    """Deferred shading of the winning fragments (DrawModel pixel loop,
    projekt.cpp:427-529). Returns (rgba(H,W,4) f32, covered)."""
    H, W = covered.shape
    col = gbuf[:, :, 1:5].copy()
    if texture is not None:
        oz = gbuf[:, :, 10]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_oz = F(1) / oz
            u = np.where(covered, inv_oz * gbuf[:, :, 8], F(0))
            v = np.where(covered, inv_oz * gbuf[:, :, 9], F(0))
        tex_rgba, tmask = sample_texture(texture, u, v, uv_mode, filter_mode)
        col = np.where(covered[..., None], tex_rgba, col)
        if uv_mode == "avx":
            covered = covered & tmask

    if not phong:
        return col.astype(F), covered

    # Per-pixel Blinn-Phong (projekt.cpp:450-483).
    ys, xs = np.nonzero(covered)
    px = xs.astype(F)
    py = ys.astype(F)
    z = gbuf[ys, xs, 0]
    pos = unproject_vertex(px, py, z, transform)
    nrm = normalize(gbuf[ys, xs, 5:8])  # divergence #3: single normalize
    base = col[ys, xs]

    lp = np.asarray(lights["light_p"], F)
    li = np.asarray(lights["light_intensity"], F)
    final = np.zeros_like(base)
    with np.errstate(divide="ignore", invalid="ignore"):
        view = normalize(-pos)
        for k in range(lp.shape[0]):
            if k == 0:
                final = base * np.asarray(lights["ambient"], F)
            to_light = normalize(lp[k] - pos)
            cosi = clamp01(inner(nrm, to_light))
            half = normalize(to_light + view)
            spec = pow16(clamp01(inner(nrm, half)))
            final = final + cosi[:, None] * (base * li[k]) + spec[:, None] * (
                WHITE * li[k]
            )
    final = clamp01(final)
    out = col.astype(F).copy()
    out[ys, xs] = final
    return out, covered


def pack_argb(rgba):
    c = roundf(np.asarray(rgba, F) * F(255)).astype(np.uint32)
    return (c[..., 3] << 24) | (c[..., 0] << 16) | (c[..., 1] << 8) | c[..., 2]


def render(scene, transform, lights, height, width, clear_color=0):
    """End-to-end golden render of a scene.

    scene: list of (obj_dict, cfg_dict) where cfg has phong/textured/uv_mode.
    Objects draw sequentially over a shared z-buffer, exactly like successive
    FillEdgeTable+DrawModel calls in the reference frame loop.
    """
    color = np.full((height, width), np.uint32(clear_color), np.uint32)
    depth = np.full((height, width), DEPTH_CLEAR, F)
    for obj, cfg in scene:
        phong = bool(cfg.get("phong", False))
        textured = cfg.get("texture", None) is not None
        edges = setup_edges(obj, transform, lights, phong, textured)
        covered, gbuf = rasterize(edges, height, width)
        rgba, covered = shade(
            covered, gbuf, transform, lights, phong,
            cfg.get("texture"), cfg.get("uv_mode", "scalar"),
            cfg.get("filter_mode", "nearest"),
        )
        packed = pack_argb(rgba)
        win = covered & (gbuf[:, :, 0] > depth)
        depth = np.where(win, gbuf[:, :, 0], depth)
        color = np.where(win, packed, color)
    return color, depth
