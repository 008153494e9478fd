"""The reference's one built-in asset, ConstructSphere
(MacSpain/cpu-renderer projekt.cpp:4123-4289): 24 inclination bands x 48
azimuth bands of radius 0.5, triangle fans at the poles, 2,208 triangles
with its own vertex colours (the port's ``models.sphere.construct_sphere``,
copied), its vertices scaled by ``scale``."""

import numpy as np

F = np.float32
PI32 = F(3.14159265)  # Pi32 in Handmade-Hero-style math libraries
STEPS = 24


def _sphere():
    radius = F(0.5)
    up_color = np.array([1.0, 0.0, 0.0, 1.0], F)
    down_color = np.array([0.0, 1.0, 0.0, 1.0], F)
    color_inc = (down_color - up_color) / F(STEPS)
    inc_step = PI32 / F(STEPS)
    az_step = (F(2.0) * PI32) / F(STEPS * 2)
    verts, colors, normals, uvs = [], [], [], []

    def emit(v, uv, c):
        verts.append(radius * v)
        normals.append(v)
        uvs.append(uv)
        colors.append(c)

    def sdir(inc, az):
        return np.array(
            [np.sin(inc) * np.cos(az), np.cos(inc), np.sin(inc) * np.sin(az)],
            F)

    def body_uv(v):
        return np.array([(v[0] + F(1)) / F(2), (v[1] + F(1)) / F(2)], F)

    def ring_uv(v):
        return np.array([v[0], v[2]], F)

    centre = np.array([0.5, 0.5], F)
    current = up_color.copy()
    for ii in range(STEPS):
        inc = F(ii) * inc_step
        ninc = F(ii + 1) * inc_step
        for ai in range(STEPS * 2):
            az = F(ai) * az_step
            naz = F(ai + 1) * az_step
            blue = np.array([0, 0, (F(1) + np.cos(az)) / F(2), 0], F)
            nblue = np.array([0, 0, (F(1) + np.cos(naz)) / F(2), 0], F)
            if ii == 0:  # top fan (projekt.cpp:4156-4188)
                v1 = np.array([0.0, 1.0, 0.0], F)
                v2, v3 = sdir(ninc, az), sdir(ninc, naz)
                emit(v1, centre, current + blue)
                emit(v2, ring_uv(v2), current + color_inc + blue)
                emit(v3, ring_uv(v3), current + color_inc + nblue)
            elif ii == STEPS - 1:  # bottom fan (projekt.cpp:4190-4222)
                v1, v3 = sdir(inc, az), sdir(inc, naz)
                v2 = np.array([0.0, -1.0, 0.0], F)
                emit(v1, centre, current + blue)
                emit(v2, ring_uv(v2), current + color_inc + blue)
                emit(v3, ring_uv(v3), current + color_inc + nblue)
            else:  # body quad = 2 triangles (projekt.cpp:4224-4281)
                v1, v2 = sdir(inc, az), sdir(ninc, az)
                v3, v4 = sdir(ninc, naz), sdir(inc, naz)
                emit(v1, body_uv(v1), current + blue)
                emit(v2, body_uv(v2), current + color_inc + blue)
                emit(v3, body_uv(v3), current + color_inc + nblue)
                emit(v1, body_uv(v1), current + blue)
                emit(v3, body_uv(v3), current + color_inc + nblue)
                emit(v4, body_uv(v4), current + nblue)
        current = current + color_inc
    return {k: np.stack(a).astype(F) for k, a in (
        ("vertices", verts), ("colors", colors), ("normals", normals),
        ("uvs", uvs))}


def build(params, rng):
    """Mesh dict (vertices, colors, normals, uvs), each (V, C) f32, of
    ConstructSphere with its vertices multiplied by ``scale`` in f32
    (default 1: the reference's radius 0.5)."""
    mesh = _sphere()
    mesh["vertices"] = (mesh["vertices"]
                        * F(params.get("scale", 1.0))).astype(F)
    return mesh
