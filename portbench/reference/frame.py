"""The plain reference of one benchmark frame, on windows of it.

The benchmark hands the reference what it hands the program: the meshes,
the texture, the camera, the lights and each frame's rotation matrix. The
reference rotates the meshes itself, in the program's float32 operation
order, places its windows from its own projection and a seeded generator,
and renders each window with the frozen spec (``spec.py``). The spec draws
one triangle at a time in submission order, so the triangles whose
projected bounding box meets a window, grown by ``MARGIN`` pixels, give
the whole frame's pixels inside it bit for bit; ``render_rect`` restates
the spec's ``render`` on such a rectangle alone (a test holds it equal to
the crop of the spec's whole frame).

NumPy only: nothing here imports torch or any part of the program.
"""

from __future__ import annotations

import numpy as np

from . import spec

F = np.float32
MESH_KEYS = ("vertices", "colors", "normals", "uvs")
MARGIN = 2  # px a triangle's bbox may lie off a window and still draw in it
# Edge-table fields that hold real-valued interpolants (the rest are row
# bounds and flags): what a lower-precision record table would round.
REAL_FIELDS = ("x0", "xg", "z0", "zg", "oz0", "ozg", "u0", "ug", "v0", "vg",
               "col0", "colg", "n0", "ng")


def bf16(a):
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32: the storage step below float32."""
    u = np.asarray(a, F).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F)


def rotate(obj, rot):
    """The object with its vertices and normals rotated by the 3x3 f32
    matrix ``rot``: out_i = (r_i0 x + r_i1 y) + r_i2 z, each product and sum
    rounded to float32, the program's order (geometry/transform.py)."""
    r = np.asarray(rot, F)
    out = dict(obj)
    for k in ("vertices", "normals"):
        a = np.asarray(obj[k], F)
        x, y, z = a[:, 0], a[:, 1], a[:, 2]
        out[k] = np.stack([(r[i, 0] * x + r[i, 1] * y) + r[i, 2] * z
                           for i in range(3)], axis=1)
    return out


def projected(obj, transform):
    """(projected (T, 3, 3) vertices, the spec's backface-cull mask (T,))
    of one object, vectorised as ``spec.setup_edges`` computes them."""
    verts = np.asarray(obj["vertices"], F).reshape(-1, 3, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        proj = spec.project_vertex(verts + np.asarray(obj["p"], F),
                                   transform)
        e1 = spec.normalize(proj[:, 1] - proj[:, 0])
        e2 = spec.normalize(proj[:, 2] - proj[:, 0])
        visible = -(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > F(0)
    return proj, visible


def visible_in_frame(proj, visible, height, width):
    """Mask of the kept triangles whose projected bbox meets the frame."""
    x, y = proj[..., 0], proj[..., 1]
    with np.errstate(invalid="ignore"):
        return (visible & (x.max(1) >= 0) & (x.min(1) <= width - 1)
                & (y.max(1) >= 0) & (y.min(1) <= height - 1))


def place_windows(scene, transform, height, width, n, size, rng,
                  projs=None):
    """(row0, col0) of ``n`` >= 2 size x size windows: one centred on the
    frame, one on the silhouette (the kept triangle whose projected
    centroid lies farthest along a direction drawn from ``rng``), and
    n - 2 centred on the centroids of kept triangles drawn from ``rng``.
    ``projs``: each object's ``projected``, where already computed."""
    cents = []
    projs = projs or [projected(o, transform) for o, _ in scene]
    for proj, visible in projs:
        keep = visible_in_frame(proj, visible, height, width)
        cents.append(proj[keep, :, :2].mean(axis=1))
    cents = np.concatenate(cents)
    if not len(cents):
        raise ValueError("place_windows: no triangle of the scene is kept")

    def at(x, y):
        return (int(min(max(round(float(y)) - size // 2, 0), height - size)),
                int(min(max(round(float(x)) - size // 2, 0), width - size)))

    theta = rng.uniform(0.0, 2.0 * np.pi)
    reach = ((cents - cents.mean(axis=0))
             @ np.array([np.cos(theta), np.sin(theta)]))
    picks = rng.integers(len(cents), size=n - 2)
    return ([at(width / 2, height / 2), at(*cents[int(np.argmax(reach))])]
            + [at(*cents[i]) for i in picks])


def window_scenes(scene, transform, height, width, rects, projs=None):
    """For each rect (row0, col0, h, w), the sub-scene that draws it: of
    each object, in order, the triangles whose projected bbox, clamped to
    the frame, meets the rect grown by MARGIN px, or whose projection is
    not finite. Each object is projected once for all the rects (or
    ``projs`` given)."""
    boxes = []
    projs = projs or [projected(o, transform) for o, _ in scene]
    for proj, _ in projs:
        odd = ~np.isfinite(proj[..., :2]).all(axis=(1, 2))
        with np.errstate(invalid="ignore"):
            x = np.clip(proj[..., 0], 0, width - 1)
            y = np.clip(proj[..., 1], 0, height - 1)
        boxes.append((odd, x.min(1), x.max(1), y.min(1), y.max(1)))
    subs = []
    for r0, c0, h, w in rects:
        sub = []
        for (obj, cfg), (odd, x0, x1, y0, y1) in zip(scene, boxes):
            with np.errstate(invalid="ignore"):
                hit = odd | ((x1 >= c0 - MARGIN) & (x0 <= c0 + w - 1 + MARGIN)
                             & (y1 >= r0 - MARGIN)
                             & (y0 <= r0 + h - 1 + MARGIN))
            idx = np.nonzero(hit)[0]
            if not len(idx):
                continue
            part = dict(obj)
            for k in MESH_KEYS:
                a = np.asarray(obj[k], F)
                d = a.shape[-1]
                part[k] = a.reshape(-1, 3, d)[idx].reshape(-1, d)
            sub.append((part, cfg))
        subs.append(sub)
    return subs


def gouraud(colors, normals, cam, lights, textured):
    """``spec.gouraud_vertex_color`` of every (triangle, vertex) at once."""
    base = np.broadcast_to(spec.WHITE, colors.shape) if textured else colors
    lp = np.asarray(lights["light_p"], F)
    li = np.asarray(lights["light_intensity"], F)
    if lp.shape[0] == 0:
        return np.array(base, F)
    out = base * np.asarray(lights["ambient"], F)
    for k in range(lp.shape[0]):
        to_light = spec.normalize(lp[k] - cam)
        d = spec.clamp01(spec.inner(to_light, normals))
        out = spec.clamp01(out + d[..., None] * (base * li[k]))
    return out.astype(F)


def setup_edges(obj, transform, lights, phong=False, textured=False):
    """``spec.setup_edges``, every triangle at once: the same float32
    operations in the same order on arrays (each IEEE-rounded alike), the
    per-triangle branches as masks. Returns the spec's dict (a test holds
    every field bit-equal to the spec's)."""
    verts = np.asarray(obj["vertices"], F).reshape(-1, 3, 3)
    colors = np.asarray(obj["colors"], F).reshape(-1, 3, 4)
    normals = np.asarray(obj["normals"], F).reshape(-1, 3, 3)
    uvs = np.asarray(obj["uvs"], F).reshape(-1, 3, 2)
    T = verts.shape[0]
    rows = np.arange(T)
    cam = verts + np.asarray(obj["p"], F)
    proj = spec.project_vertex(cam, transform)
    out = {k: np.zeros((T, 3), F) for k in spec.EDGE_FIELDS}
    out["valid"] = np.zeros((T, 3), bool)
    out["col0"] = np.zeros((T, 3, 4), F)
    out["colg"] = np.zeros((T, 3, 4), F)
    out["n0"] = np.zeros((T, 3, 3), F)
    out["ng"] = np.zeros((T, 3, 3), F)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        e1 = spec.normalize(proj[:, 1] - proj[:, 0])
        e2 = spec.normalize(proj[:, 2] - proj[:, 0])
        visible = -(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]) > F(0)
        out["visible"] = visible
        if not phong:
            gcol = gouraud(colors, normals, cam, lights, textured)
        for e, (i0, i1) in enumerate(((0, 1), (1, 2), (2, 0))):
            swap = proj[:, i0, 1] > proj[:, i1, 1]
            mn = np.where(swap, i1, i0)
            mx = np.where(swap, i0, i1)
            minv, maxv = proj[rows, mn], proj[rows, mx]
            keep = (visible & (maxv[:, 1] > F(0))
                    & ~(minv[:, 1] - maxv[:, 1] == F(0)))
            ymax = spec.roundf(maxv[:, 1])
            r = spec.roundf(minv[:, 1])
            ymin = np.where(r > F(0), r, F(0)).astype(F)
            neg = minv[:, 1] < F(0)
            clipped_y = np.where(neg, -minv[:, 1], F(0)).astype(F)
            tt = np.where(neg, (-minv[:, 1]) / (maxv[:, 1] - minv[:, 1]),
                          F(0)).astype(F)
            ydiff = ymax - ymin
            xg = (maxv[:, 0] - minv[:, 0]) / (maxv[:, 1] - minv[:, 1])
            zmn, zmx = cam[rows, mn, 2], cam[rows, mx, 2]
            zg = (zmx - zmn) / ydiff
            x0 = minv[:, 0] + clipped_y * xg
            z0 = zmn + clipped_y * zg
            fields = dict(ymin=ymin, ymax=ymax, x0=x0, xg=xg, z0=z0, zg=zg)
            if textured:
                oz0 = F(1) / minv[:, 2]
                u0 = uvs[rows, mn, 0] / minv[:, 2]
                v0 = uvs[rows, mn, 1] / minv[:, 2]
                u1 = uvs[rows, mx, 0] * (F(1) / maxv[:, 2])
                v1 = uvs[rows, mx, 1] * (F(1) / maxv[:, 2])
                ug = (u1 - u0) / ydiff
                vg = (v1 - v0) / ydiff
                ozg = ((F(1) / maxv[:, 2]) - oz0) / ydiff
                fields.update(u0=u0 + clipped_y * ug, v0=v0 + clipped_y * vg,
                              oz0=oz0 + clipped_y * ozg, ug=ug, vg=vg,
                              ozg=ozg)
            if phong:
                cmin, cmax = colors[rows, mn], colors[rows, mx]
                nmin, nmax = normals[rows, mn], normals[rows, mx]
            else:
                cmin, cmax = gcol[rows, mn], gcol[rows, mx]
            t4 = tt[:, None]
            cmin = (F(1) - t4) * cmin + t4 * cmax
            fields["left"] = np.where(
                ymin == spec.roundf(proj[:, i0, 1]), F(1), F(0))
            for k, v in fields.items():
                out[k][keep, e] = v[keep]
            out["valid"][keep, e] = True
            out["col0"][keep, e] = cmin[keep]
            out["colg"][keep, e] = ((cmax - cmin) / ydiff[:, None])[keep]
            if phong:
                out["n0"][keep, e] = nmin[keep]
                out["ng"][keep, e] = ((nmax - nmin) / ydiff[:, None])[keep]
    return out


def rasterize_rect(edges, height, width, rect):
    """``spec.rasterize`` restricted to the rect (row0, col0, h, w) of the
    frame: the same rows, spans and depth test, written only inside it.
    Returns (covered (h, w), gbuf (h, w, 11))."""
    r0, c0, h, w = rect
    covered = np.zeros((h, w), bool)
    gbuf = np.zeros((h, w, spec.GBUF_CHANNELS), F)
    gbuf[:, :, 0] = spec.DEPTH_CLEAR
    with np.errstate(divide="ignore", invalid="ignore"):
        for t in range(edges["valid"].shape[0]):
            if not edges["visible"][t]:
                continue
            valid = edges["valid"][t]
            if valid.sum() < 2:
                continue
            ymin = edges["ymin"][t]
            ymax = edges["ymax"][t]
            rows_lo = max(int(ymin[valid].min()), r0)
            rows_hi = min(int(ymax[valid].max()), height, r0 + h)
            for y in range(rows_lo, rows_hi):
                fy = F(y)
                active = valid & (ymin <= fy) & (fy < ymax)
                if active.sum() < 2:
                    continue
                idx = np.nonzero(active)[0]
                dy = fy - ymin[idx]
                xs = edges["x0"][t, idx] + dy * edges["xg"][t, idx]
                order = np.lexsort(
                    (edges["left"][t, idx], edges["xg"][t, idx], xs))
                _fill_span_rect(edges, t, idx[order[0]], idx[order[1]], y,
                                covered, gbuf, width, rect)
    return covered, gbuf


def _fill_span_rect(edges, t, iL, iR, y, covered, gbuf, width, rect):
    """``spec._fill_span`` written only on the rect's columns: the span's
    k values are the spec's (XOffset + i), taken for the pixels inside."""
    r0, c0, h, w = rect
    fy = F(y)
    L = spec._edge_attrs_at(edges, t, iL, fy)
    R = spec._edge_attrs_at(edges, t, iR, fy)
    xl, xr = L["x"], R["x"]

    xd = spec.roundf(xr - xl)
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

    xoff = -xl if xl < F(0) else F(0)
    lx = F(0) if xl < F(0) else (F(width - 1) if xl >= F(width) else xl)
    rx = F(0) if xr < F(0) else (F(width - 1) if xr >= F(width) else xr)
    minx = min(int(spec.roundf(lx)), width - 1)
    maxx = min(int(spec.roundf(rx)), width - 1)
    lo, hi = max(minx, c0), min(maxx, c0 + w - 1)
    if hi < lo:
        return

    k = xoff + np.arange(lo - minx, hi - minx + 1).astype(F)
    z = L["z"] + k * zinc
    oz = L["oz"] + k * ozinc
    u = L["u"] + k * uinc
    v = L["v"] + k * vinc
    col = L["col"][None, :] + k[:, None] * cinc[None, :]
    nrm = L["n"][None, :] + k[:, None] * ninc[None, :]

    row, sl = y - r0, slice(lo - c0, hi - c0 + 1)
    zbuf = gbuf[row, sl, 0]
    win = z > zbuf
    if not win.any():
        return
    gbuf[row, sl, 0] = np.where(win, z, zbuf)
    gbuf[row, sl, 1:5] = np.where(win[:, None], col, gbuf[row, sl, 1:5])
    gbuf[row, sl, 5:8] = np.where(win[:, None], nrm, gbuf[row, sl, 5:8])
    gbuf[row, sl, 8] = np.where(win, u, gbuf[row, sl, 8])
    gbuf[row, sl, 9] = np.where(win, v, gbuf[row, sl, 9])
    gbuf[row, sl, 10] = np.where(win, oz, gbuf[row, sl, 10])
    covered[row, sl] |= win


def shade_rect(covered, gbuf, rect, transform, lights, phong=False,
               texture=None, uv_mode="scalar", filter_mode="nearest"):
    """``spec.shade`` on the rect: the same arithmetic, each pixel at its
    frame coordinates (row0 + row, col0 + col)."""
    r0, c0, _, _ = rect
    col = gbuf[:, :, 1:5].copy()
    if texture is not None:
        oz = gbuf[:, :, 10]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_oz = F(1) / oz
            u = np.where(covered, inv_oz * gbuf[:, :, 8], F(0))
            v = np.where(covered, inv_oz * gbuf[:, :, 9], F(0))
        tex_rgba, tmask = spec.sample_texture(texture, u, v, uv_mode,
                                              filter_mode)
        col = np.where(covered[..., None], tex_rgba, col)
        if uv_mode == "avx":
            covered = covered & tmask
    if not phong:
        return col.astype(F), covered

    ys, xs = np.nonzero(covered)
    px = (xs + c0).astype(F)
    py = (ys + r0).astype(F)
    z = gbuf[ys, xs, 0]
    pos = spec.unproject_vertex(px, py, z, transform)
    nrm = spec.normalize(gbuf[ys, xs, 5:8])
    base = col[ys, xs]
    lp = np.asarray(lights["light_p"], F)
    li = np.asarray(lights["light_intensity"], F)
    final = np.zeros_like(base)
    with np.errstate(divide="ignore", invalid="ignore"):
        view = spec.normalize(-pos)
        for k in range(lp.shape[0]):
            if k == 0:
                final = base * np.asarray(lights["ambient"], F)
            to_light = spec.normalize(lp[k] - pos)
            cosi = spec.clamp01(spec.inner(nrm, to_light))
            half = spec.normalize(to_light + view)
            sp = spec.pow16(spec.clamp01(spec.inner(nrm, half)))
            final = final + cosi[:, None] * (base * li[k]) + sp[:, None] * (
                spec.WHITE * li[k])
    final = spec.clamp01(final)
    out = col.astype(F).copy()
    out[ys, xs] = final
    return out, covered


def render_rect(scene, transform, lights, height, width, rect,
                lower=False):
    """(color u32, depth f32), each (h, w): the spec's frame of the scene
    inside the rect (row0, col0, h, w) of the height x width frame, cleared
    to colour 0. ``lower`` computes it with the meshes and every
    real-valued field of the edge table rounded to bfloat16: the control
    that a sound comparison has to fail."""
    r0, c0, h, w = rect
    color = np.zeros((h, w), np.uint32)
    depth = np.full((h, w), spec.DEPTH_CLEAR, F)
    for obj, cfg in scene:
        if lower:
            obj = {k: (bf16(v) if k in MESH_KEYS else v)
                   for k, v in obj.items()}
        phong = bool(cfg.get("phong", False))
        texture = cfg.get("texture")
        edges = setup_edges(obj, transform, lights, phong,
                            texture is not None)
        if lower:
            edges.update({k: bf16(edges[k]) for k in REAL_FIELDS})
        covered, gbuf = rasterize_rect(edges, height, width, rect)
        rgba, covered = shade_rect(
            covered, gbuf, rect, transform, lights, phong, texture,
            cfg.get("uv_mode", "scalar"), cfg.get("filter_mode", "nearest"))
        packed = spec.pack_argb(rgba)
        win = covered & (gbuf[:, :, 0] > depth)
        depth = np.where(win, gbuf[:, :, 0], depth)
        color = np.where(win, packed, color)
    return color, depth


def render_window(job):
    """One process's work: ``job`` is (sub-scene, transform, lights, height,
    width, rect, lower); returns ``render_rect``'s planes."""
    return render_rect(*job)


def differing(got, want):
    """Pixels whose colour or depth bits differ between two (color u32,
    depth f32) pairs of one shape."""
    return int(((got[0] != want[0])
                | (np.asarray(got[1], F).view(np.int32)
                   != np.asarray(want[1], F).view(np.int32))).sum())
