"""Wavefront OBJ loader producing reference-style triangle soup.
Copied from ``tpu_renderer.models.obj``; a test holds the copy equal to it.

The reference's platform layer implied OBJ loading (SURVEY.md L7); meshes
become the same interleaved per-vertex arrays ``render_entry_3d_object``
carries (projekt.h:1-15): 3 vertices per triangle, no index buffer.

Supports v / vt / vn / f with arbitrary polygon fans and negative indices.
Missing normals are computed per-face; missing UVs default to 0; colors
default to a constant (or per-vertex height ramp when requested).
"""

from __future__ import annotations

import io
import numpy as np

F = np.float32


def load_obj(source, default_color=(0.8, 0.8, 0.8, 1.0), color_ramp=False):
    """Parse an OBJ file path, file object, or string.

    Returns dict(vertices, colors, normals, uvs) float32 triangle soup.
    """
    if hasattr(source, "read"):
        text = source.read()
    elif isinstance(source, str) and "\n" in source:
        text = source
    else:
        with open(source, "r") as f:
            text = f.read()

    positions, texcoords, normals = [], [], []
    faces = []  # list of [(vi, ti, ni), ...] per face
    for line in io.StringIO(text):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append([float(x) for x in parts[1:4]])
        elif tag == "vt":
            texcoords.append([float(x) for x in parts[1:3]])
        elif tag == "vn":
            normals.append([float(x) for x in parts[1:4]])
        elif tag == "f":
            corners = []
            for token in parts[1:]:
                fields = token.split("/")
                vi = int(fields[0])
                ti = int(fields[1]) if len(fields) > 1 and fields[1] else 0
                ni = int(fields[2]) if len(fields) > 2 and fields[2] else 0
                corners.append((vi, ti, ni))
            faces.append(corners)

    pos = np.asarray(positions, F).reshape(-1, 3)
    tex = np.asarray(texcoords, F).reshape(-1, 2)
    nrm = np.asarray(normals, F).reshape(-1, 3)

    def resolve(idx, count):
        return idx - 1 if idx > 0 else count + idx

    out_v, out_n, out_t = [], [], []
    for corners in faces:
        for a, b in zip(corners[1:-1], corners[2:]):  # triangle fan
            tri = [corners[0], a, b]
            tri_pos = [pos[resolve(vi, len(pos))] for vi, _, _ in tri]
            have_n = all(ni != 0 for _, _, ni in tri) and len(nrm) > 0
            if have_n:
                tri_nrm = [nrm[resolve(ni, len(nrm))] for _, _, ni in tri]
            else:
                e1 = tri_pos[1] - tri_pos[0]
                e2 = tri_pos[2] - tri_pos[0]
                fn = np.cross(e1, e2).astype(F)
                d = np.sqrt(np.sum(fn * fn, dtype=F))
                fn = fn / d if d > 0 else np.array([0, 0, 1], F)
                tri_nrm = [fn, fn, fn]
            tri_tex = [
                tex[resolve(ti, len(tex))] if ti != 0 and len(tex) > 0
                else np.zeros(2, F)
                for _, ti, _ in tri
            ]
            out_v.extend(tri_pos)
            out_n.extend(tri_nrm)
            out_t.extend(tri_tex)

    v = np.asarray(out_v, F).reshape(-1, 3)
    if color_ramp and len(v):
        y = v[:, 1]
        lo, hi = float(y.min()), float(y.max())
        s = (y - lo) / (hi - lo) if hi > lo else np.zeros_like(y)
        colors = np.stack(
            [s, F(1) - s, np.full_like(s, 0.3), np.ones_like(s)], axis=-1
        ).astype(F)
    else:
        colors = np.broadcast_to(
            np.asarray(default_color, F), (len(v), 4)
        ).copy()
    return dict(
        vertices=v,
        colors=colors,
        normals=np.asarray(out_n, F).reshape(-1, 3),
        uvs=np.asarray(out_t, F).reshape(-1, 2),
    )
