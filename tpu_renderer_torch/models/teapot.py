"""Utah-teapot-class OBJ mesh (procedural generator + loader).

Copied from ``tpu_renderer.models.teapot``; a test holds the copy equal to
the original, which loads the committed ``assets/teapot.obj``. This copy
never reads that file: ``construct_teapot()`` generates the OBJ text in
memory (body and lid as surfaces of revolution over smooth profile curves,
spout and handle as swept tubes; shared v/vt/vn lists, indexed f quads) and
loads it back through ``models.obj.load_obj``, so config 2's OBJ path is
exercised end to end.
"""

from __future__ import annotations

import numpy as np

from .obj import load_obj

F = np.float32


def _catmull_rom(points, samples):
    """Sample a Catmull-Rom spline through ``points`` ((N, 2) array) at
    ``samples`` parameter values in [0, 1] spanning the full chain."""
    pts = np.asarray(points, np.float64)
    n = len(pts) - 1  # segments
    ext = np.vstack([2 * pts[0] - pts[1], pts, 2 * pts[-1] - pts[-2]])
    out = []
    for s in samples:
        t = min(max(s, 0.0), 1.0) * n
        seg = min(int(t), n - 1)
        u = t - seg
        p0, p1, p2, p3 = ext[seg], ext[seg + 1], ext[seg + 2], ext[seg + 3]
        out.append(
            0.5 * (
                (2 * p1)
                + (-p0 + p2) * u
                + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u * u
                + (-p0 + 3 * p1 - 3 * p2 + p3) * u * u * u
            )
        )
    return np.asarray(out)


class _ObjBuilder:
    """Accumulates shared-vertex grids and serializes Wavefront OBJ text."""

    def __init__(self):
        self.v, self.vt, self.vn, self.f = [], [], [], []

    def add_grid(self, pos, nrm, uv, wrap_cols: bool):
        """Add a (rows, cols, 3) grid; quads between adjacent rows/cols
        become two triangles each. Degenerate (pole) triangles are skipped.
        Winding is fixed per triangle so the geometric normal agrees with
        the shading normals (outward), which is what the renderer's
        backface cull keys on."""
        rows, cols = pos.shape[:2]
        base = len(self.v) + 1  # OBJ indices are 1-based
        for r in range(rows):
            for c in range(cols):
                self.v.append(pos[r, c])
                self.vn.append(nrm[r, c])
                self.vt.append(uv[r, c])

        def idx(r, c):
            return base + r * cols + (c % cols if wrap_cols else c)

        ncols = cols if wrap_cols else cols - 1
        for r in range(rows - 1):
            for c in range(ncols):
                a, b = idx(r, c), idx(r, c + 1)
                d, e = idx(r + 1, c), idx(r + 1, c + 1)
                for tri in ((a, d, e), (a, e, b)):
                    p = [np.asarray(self.v[i - 1]) for i in tri]
                    n = [np.asarray(self.vn[i - 1]) for i in tri]
                    geo = np.cross(p[1] - p[0], p[2] - p[0])
                    area2 = float(np.dot(geo, geo))
                    if area2 < 1e-14:
                        continue  # pole-collapsed quad edge
                    if float(np.dot(geo, n[0] + n[1] + n[2])) < 0.0:
                        tri = (tri[0], tri[2], tri[1])
                    self.f.append(tri)

    def serialize(self) -> str:
        out = ["# teapot-class mesh generated by tpu_renderer.models.teapot"]
        for p in self.v:
            out.append(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}")
        for t in self.vt:
            out.append(f"vt {t[0]:.6f} {t[1]:.6f}")
        for n in self.vn:
            out.append(f"vn {n[0]:.6f} {n[1]:.6f} {n[2]:.6f}")
        for a, b, c in self.f:
            out.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
        return "\n".join(out) + "\n"


def _revolve(builder, profile_pts, rows: int, cols: int, v_lo, v_hi):
    """Surface of revolution about +y from an (r, y) profile polyline,
    Catmull-Rom smoothed. Normals come from the profile tangent:
    P(t, th) = (r cos, y, r sin) => outward n ~ (y' cos, -r', y' sin)."""
    s = np.linspace(0.0, 1.0, rows)
    prof = _catmull_rom(profile_pts, s)  # (rows, 2) = (r, y)
    dp = np.gradient(prof, axis=0)  # (dr, dy) per row
    th = np.linspace(0.0, 2 * np.pi, cols, endpoint=False)
    cos, sin = np.cos(th), np.sin(th)

    r = np.maximum(prof[:, 0], 0.0)[:, None]
    y = prof[:, 1][:, None]
    pos = np.stack(
        [r * cos[None, :], np.broadcast_to(y, (rows, cols)), r * sin[None, :]],
        axis=-1,
    )
    dr = dp[:, 0][:, None]
    dy = dp[:, 1][:, None]
    n = np.stack(
        [dy * cos[None, :], np.broadcast_to(-dr, (rows, cols)),
         dy * sin[None, :]],
        axis=-1,
    )
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12),
                 np.array([0.0, 1.0, 0.0]))
    # Poles (r == 0): use the axis direction the surface approaches.
    uv = np.stack(
        [np.broadcast_to((th / (2 * np.pi))[None, :], (rows, cols)),
         np.broadcast_to(np.linspace(v_lo, v_hi, rows)[:, None],
                         (rows, cols))],
        axis=-1,
    )
    builder.add_grid(pos, n, uv, wrap_cols=True)


def _sweep_tube(builder, centers, radii, cols: int, v_lo, v_hi,
                flatten=1.0):
    """Tube swept along a polyline of ``centers`` with per-ring ``radii``.
    Cross-sections are circles (scaled by ``flatten`` along the binormal)
    in planes normal to the path; normals are radial from the centerline."""
    centers = np.asarray(centers, np.float64)
    rows = len(centers)
    tang = np.gradient(centers, axis=0)
    tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True), 1e-12)
    # Parallel-transport-ish frame seeded with a stable reference axis.
    ref = np.array([0.0, 0.0, 1.0])
    if abs(np.dot(tang[0], ref)) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    th = np.linspace(0.0, 2 * np.pi, cols, endpoint=False)
    pos = np.zeros((rows, cols, 3))
    nrm = np.zeros((rows, cols, 3))
    b_prev = None
    for i in range(rows):
        t = tang[i]
        b = np.cross(t, ref) if b_prev is None else np.cross(t, b_prev)
        if np.linalg.norm(b) < 1e-9:
            b = np.cross(t, np.array([1.0, 0.0, 0.0]))
        b /= np.linalg.norm(b)
        u = np.cross(b, t)
        u /= np.linalg.norm(u)
        b_prev = u
        ring_dir = (np.cos(th)[:, None] * u[None, :]
                    + np.sin(th)[:, None] * (b * flatten)[None, :])
        pos[i] = centers[i][None, :] + radii[i] * ring_dir
        nd = ring_dir / np.maximum(
            np.linalg.norm(ring_dir, axis=-1, keepdims=True), 1e-12
        )
        nrm[i] = nd
    uv = np.stack(
        [np.broadcast_to((th / (2 * np.pi))[None, :], (rows, cols)),
         np.broadcast_to(np.linspace(v_lo, v_hi, rows)[:, None],
                         (rows, cols))],
        axis=-1,
    )
    builder.add_grid(pos, nrm, uv, wrap_cols=True)


def generate_teapot_obj() -> str:
    """Deterministic teapot-class OBJ text (~6k triangles)."""
    b = _ObjBuilder()

    # Body: bottom center -> belly -> shoulder -> rim.
    _revolve(
        b,
        [(0.00, -0.480), (0.260, -0.460), (0.425, -0.240),
         (0.455, -0.040), (0.380, 0.180), (0.270, 0.300)],
        rows=30, cols=48, v_lo=0.00, v_hi=0.55,
    )
    # Lid: rim overlap -> dome -> knob -> tip.
    _revolve(
        b,
        [(0.290, 0.295), (0.195, 0.375), (0.080, 0.415),
         (0.058, 0.455), (0.085, 0.515), (0.000, 0.560)],
        rows=18, cols=48, v_lo=0.55, v_hi=0.80,
    )
    # Spout: swept cone from the belly, out and up (root embedded in the
    # body wall so the joint is watertight on screen).
    sp = _catmull_rom(
        [(0.36, -0.16), (0.60, -0.04), (0.72, 0.14), (0.80, 0.32)],
        np.linspace(0.0, 1.0, 14),
    )
    spout_centers = np.stack([sp[:, 0], sp[:, 1], np.zeros(len(sp))], -1)
    spout_radii = np.linspace(0.115, 0.042, len(sp))
    _sweep_tube(b, spout_centers, spout_radii, cols=20,
                v_lo=0.80, v_hi=0.90)
    # Handle: smooth loop on the opposite side, endpoints embedded in the
    # body wall, slightly flattened cross-section.
    hp = _catmull_rom(
        [(-0.30, 0.16), (-0.55, 0.12), (-0.63, -0.03),
         (-0.53, -0.17), (-0.33, -0.22)],
        np.linspace(0.0, 1.0, 22),
    )
    hc = np.stack([hp[:, 0], hp[:, 1], np.zeros(len(hp))], -1)
    _sweep_tube(b, hc, np.full(len(hp), 0.042), cols=14,
                v_lo=0.90, v_hi=1.00, flatten=1.6)
    return b.serialize()


def construct_teapot(color_ramp: bool = True) -> dict:
    """dict(vertices, colors, normals, uvs) triangle soup (5,428
    triangles), via the OBJ loader from the text generated in memory."""
    return load_obj(generate_teapot_obj(), color_ramp=color_ramp)
