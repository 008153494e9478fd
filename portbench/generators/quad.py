"""One quad in the xy plane facing +z, 2 triangles (the port's
``models.primitives.construct_quad``, copied), moved by ``offset``."""

import numpy as np

F = np.float32


def build(params, rng):
    """Mesh dict of a ``size`` quad, white, its vertices moved by
    ``offset`` (x, y, z; default none)."""
    h = F(params.get("size", 1.0)) / F(2)
    corners = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], F)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], F)
    idx = [0, 2, 1, 0, 3, 2]
    verts = corners[idx] + np.asarray(params.get("offset", (0, 0, 0)), F)
    return dict(
        vertices=verts.astype(F),
        colors=np.ones((6, 4), F),
        normals=np.tile(np.array([0, 0, 1], F), (6, 1)),
        uvs=quad_uv[idx].astype(F),
    )
