"""A dense UV sphere: 2 * lat * lon triangles (the port's
``models.primitives.construct_sphere_grid``, copied)."""

import numpy as np

F = np.float32


def build(params, rng):
    """Mesh dict (vertices, colors, normals, uvs), each (V, C) f32, of the
    sphere grid with ``params`` lat, lon and radius (default 0.5)."""
    lat_steps, lon_steps = int(params["lat"]), int(params["lon"])
    radius = params.get("radius", 0.5)
    lat = np.linspace(0, np.pi, lat_steps + 1, dtype=F)
    lon = np.linspace(0, 2 * np.pi, lon_steps + 1, dtype=F)
    inc, az = np.meshgrid(lat, lon, indexing="ij")
    pts = np.stack(
        [np.sin(inc) * np.cos(az), np.cos(inc), np.sin(inc) * np.sin(az)],
        axis=-1,
    ).astype(F)
    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[1:, :-1].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    p01 = pts[:-1, 1:].reshape(-1, 3)
    dirs = np.concatenate(
        [
            np.stack([p00, p11, p10], axis=1).reshape(-1, 3),
            np.stack([p00, p01, p11], axis=1).reshape(-1, 3),
        ]
    ).astype(F)
    verts = (F(radius) * dirs).astype(F)
    colors = np.concatenate(
        [(dirs + F(1)) / F(2), np.ones((len(dirs), 1), F)], axis=1).astype(F)
    uvs = ((dirs[:, :2] + F(1)) / F(2)).astype(F)
    return dict(vertices=verts, colors=colors, normals=dirs, uvs=uvs)
