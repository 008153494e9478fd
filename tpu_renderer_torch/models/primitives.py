"""Procedural meshes (cube, quad, sphere grid, torus), copied from
``tpu_renderer.models.primitives``.

They are NumPy generators; they are copied rather than imported because
importing the originals pulls in JAX (``tpu_renderer/__init__.py``), which
the port never loads. A test holds the copies equal to the originals.
"""

from __future__ import annotations

import numpy as np

F = np.float32


def construct_cube(size: float = 1.0, face_colors=None):
    """Axis-aligned cube centered at the origin; 12 triangles.

    Winding: each face's two triangles are ordered so the projected
    screen-space cross product test (projekt.cpp:3943) keeps camera-facing
    faces. Default face colors: 6 distinct RGBs, alpha 1.
    """
    h = F(size) / F(2)
    if face_colors is None:
        face_colors = np.array(
            [
                [1, 0, 0, 1], [0, 1, 0, 1], [0, 0, 1, 1],
                [1, 1, 0, 1], [0, 1, 1, 1], [1, 0, 1, 1],
            ],
            F,
        )
    # Each face: 4 corners (CCW as seen from outside along the normal), normal.
    faces = [
        # +z (front, toward camera at -z view direction... camera looks down
        # -z so +z faces the camera)
        ([[-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h]], [0, 0, 1]),
        # -z (back)
        ([[h, -h, -h], [-h, -h, -h], [-h, h, -h], [h, h, -h]], [0, 0, -1]),
        # +x
        ([[h, -h, h], [h, -h, -h], [h, h, -h], [h, h, h]], [1, 0, 0]),
        # -x
        ([[-h, -h, -h], [-h, -h, h], [-h, h, h], [-h, h, -h]], [-1, 0, 0]),
        # +y
        ([[-h, h, h], [h, h, h], [h, h, -h], [-h, h, -h]], [0, 1, 0]),
        # -y
        ([[-h, -h, -h], [h, -h, -h], [h, -h, h], [-h, -h, h]], [0, -1, 0]),
    ]
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F)
    verts, colors, normals, uvs = [], [], [], []
    for fi, (corners, n) in enumerate(faces):
        c = np.asarray(corners, F)
        nn = np.asarray(n, F)
        col = face_colors[fi % len(face_colors)]
        for tri in ((0, 2, 1), (0, 3, 2)):
            for i in tri:
                verts.append(c[i])
                normals.append(nn)
                uvs.append(quad_uv[i])
                colors.append(col)
    return dict(
        vertices=np.stack(verts).astype(F),
        colors=np.stack(colors).astype(F),
        normals=np.stack(normals).astype(F),
        uvs=np.stack(uvs).astype(F),
    )


def construct_quad(size: float = 1.0, color=(1, 1, 1, 1)):
    """Single quad in the xy plane (2 triangles), facing +z."""
    h = F(size) / F(2)
    corners = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], F)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F)
    n = np.array([0, 0, 1], F)
    col = np.asarray(color, F)
    verts, colors, normals, uvs = [], [], [], []
    for tri in ((0, 2, 1), (0, 3, 2)):
        for i in tri:
            verts.append(corners[i])
            normals.append(n)
            uvs.append(quad_uv[i])
            colors.append(col)
    return dict(
        vertices=np.stack(verts).astype(F),
        colors=np.stack(colors).astype(F),
        normals=np.stack(normals).astype(F),
        uvs=np.stack(uvs).astype(F),
    )


def construct_sphere_grid(lat_steps: int, lon_steps: int, radius: float = 0.5):
    """Dense UV sphere built with NumPy broadcasting: body quads only,
    2 * lat_steps * lon_steps triangles."""
    lat = np.linspace(0, np.pi, lat_steps + 1, dtype=F)  # inclination
    lon = np.linspace(0, 2 * np.pi, lon_steps + 1, dtype=F)
    inc, az = np.meshgrid(lat, lon, indexing="ij")  # (lat+1, lon+1)
    pts = np.stack(
        [np.sin(inc) * np.cos(az), np.cos(inc), np.sin(inc) * np.sin(az)],
        axis=-1,
    ).astype(F)  # (lat+1, lon+1, 3) unit directions

    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[1:, :-1].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    p01 = pts[:-1, 1:].reshape(-1, 3)
    # two triangles per quad, wound like the reference body quads
    dirs = np.concatenate(
        [
            np.stack([p00, p11, p10], axis=1).reshape(-1, 3),
            np.stack([p00, p01, p11], axis=1).reshape(-1, 3),
        ]
    ).astype(F)
    verts = (F(radius) * dirs).astype(F)
    colors = np.concatenate(
        [
            (dirs + F(1)) / F(2),
            np.ones((len(dirs), 1), F),
        ],
        axis=1,
    ).astype(F)
    uvs = ((dirs[:, :2] + F(1)) / F(2)).astype(F)
    return dict(vertices=verts, colors=colors, normals=dirs, uvs=uvs)


def merge_meshes(*meshes):
    """One triangle soup from several (V, C) meshes, in order."""
    return {k: np.concatenate([m[k] for m in meshes]).astype(F)
            for k in ("vertices", "colors", "normals", "uvs")}


def construct_torus(major: float = 0.35, minor: float = 0.15,
                    major_steps: int = 32, minor_steps: int = 16):
    """Smooth torus with per-vertex normals and a hue ramp — the 'smooth
    Gouraud mesh' stand-in for the Utah teapot config (no teapot data ships
    with the reference either; any smooth multi-thousand-triangle mesh
    exercises the same path)."""
    verts, colors, normals, uvs = [], [], [], []
    two_pi = F(2) * F(np.pi)

    def point(i, j):
        a = two_pi * F(i) / F(major_steps)  # around the big ring
        b = two_pi * F(j) / F(minor_steps)  # around the tube
        ca, sa = np.cos(a, dtype=F), np.sin(a, dtype=F)
        cb, sb = np.cos(b, dtype=F), np.sin(b, dtype=F)
        center = np.array([F(major) * ca, F(major) * sa, F(0)], F)
        n = np.array([cb * ca, cb * sa, sb], F)
        v = center + F(minor) * n
        col = np.array(
            [(F(1) + ca) / F(2), (F(1) + sa) / F(2), (F(1) + sb) / F(2), F(1)],
            F,
        )
        uv = np.array([F(i) / F(major_steps), F(j) / F(minor_steps)], F)
        return v, n, uv, col

    for i in range(major_steps):
        for j in range(minor_steps):
            p00 = point(i, j)
            p10 = point(i + 1, j)
            p11 = point(i + 1, j + 1)
            p01 = point(i, j + 1)
            for p in (p00, p11, p10, p00, p01, p11):
                verts.append(p[0])
                normals.append(p[1])
                uvs.append(p[2])
                colors.append(p[3])
    return dict(
        vertices=np.stack(verts).astype(F),
        colors=np.stack(colors).astype(F),
        normals=np.stack(normals).astype(F),
        uvs=np.stack(uvs).astype(F),
    )
