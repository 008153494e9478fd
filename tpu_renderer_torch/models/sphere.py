"""Procedural UV sphere — faithful to ConstructSphere (projekt.cpp:4123-4289).
Copied from ``tpu_renderer.models.sphere`` (the original's package imports
JAX); a test holds the copy equal to it.

24 inclination bands x 48 azimuth bands, radius 0.5, triangle fans at the
poles and two triangles per quad in the body; per-vertex colors ramp red to
green down the inclination with an azimuthal blue term (1+cos(az))/2;
normals are the unit sphere directions; UVs are planar (x+1)/2,(y+1)/2 in the
body and the reference's pole quirks (0.5,0.5 at pole centers, (x,z) on pole
rings) elsewhere. Total 6,624 vertices = 2,208 triangles.

All math in float32, matching the reference's r32 arithmetic.
"""

from __future__ import annotations

import numpy as np

F = np.float32
PI32 = F(3.14159265)  # Pi32 in Handmade-Hero-style math libraries


def construct_sphere(step_count: int = 24):
    """Returns dict(vertices, colors, normals, uvs) as float32 arrays."""
    radius = F(0.5)
    up_color = np.array([1.0, 0.0, 0.0, 1.0], F)
    down_color = np.array([0.0, 1.0, 0.0, 1.0], F)
    color_inc = (down_color - up_color) / F(step_count)

    inc_step = PI32 / F(step_count)
    az_step = (F(2.0) * PI32) / F(step_count * 2)

    verts, colors, normals, uvs = [], [], [], []

    def emit(v, n, uv, c):
        verts.append(v)
        normals.append(n)
        uvs.append(uv)
        colors.append(c)

    def sdir(inc, az):
        return np.array(
            [np.sin(inc) * np.cos(az), np.cos(inc), np.sin(inc) * np.sin(az)],
            F,
        )

    def body_uv(v):
        return np.array([(v[0] + F(1)) / F(2), (v[1] + F(1)) / F(2)], F)

    current = up_color.copy()
    for ii in range(step_count):
        inc = F(ii) * inc_step
        ninc = F(ii + 1) * inc_step
        for ai in range(step_count * 2):
            az = F(ai) * az_step
            naz = F(ai + 1) * az_step
            blue = np.array([0, 0, (F(1) + np.cos(az)) / F(2), 0], F)
            nblue = np.array([0, 0, (F(1) + np.cos(naz)) / F(2), 0], F)
            if ii == 0:  # top fan (projekt.cpp:4156-4188)
                v1 = np.array([0.0, 1.0, 0.0], F)
                v2 = sdir(ninc, az)
                v3 = sdir(ninc, naz)
                emit(radius * v1, v1, np.array([0.5, 0.5], F), current + blue)
                emit(radius * v2, v2, np.array([v2[0], v2[2]], F),
                     current + color_inc + blue)
                emit(radius * v3, v3, np.array([v3[0], v3[2]], F),
                     current + color_inc + nblue)
            elif ii == step_count - 1:  # bottom fan (projekt.cpp:4190-4222)
                v1 = sdir(inc, az)
                v2 = np.array([0.0, -1.0, 0.0], F)
                v3 = sdir(inc, naz)
                emit(radius * v1, v1, np.array([0.5, 0.5], F), current + blue)
                emit(radius * v2, v2, np.array([v2[0], v2[2]], F),
                     current + color_inc + blue)
                emit(radius * v3, v3, np.array([v3[0], v3[2]], F),
                     current + color_inc + nblue)
            else:  # body quad = 2 triangles (projekt.cpp:4224-4281)
                v1 = sdir(inc, az)
                v2 = sdir(ninc, az)
                v3 = sdir(ninc, naz)
                v4 = sdir(inc, naz)
                emit(radius * v1, v1, body_uv(v1), current + blue)
                emit(radius * v2, v2, body_uv(v2), current + color_inc + blue)
                emit(radius * v3, v3, body_uv(v3), current + color_inc + nblue)
                emit(radius * v1, v1, body_uv(v1), current + blue)
                emit(radius * v3, v3, body_uv(v3), current + color_inc + nblue)
                emit(radius * v4, v4, body_uv(v4), current + nblue)
        current = current + color_inc

    return dict(
        vertices=np.stack(verts).astype(F),
        colors=np.stack(colors).astype(F),
        normals=np.stack(normals).astype(F),
        uvs=np.stack(uvs).astype(F),
    )
