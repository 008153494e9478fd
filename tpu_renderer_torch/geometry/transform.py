"""Model transforms for animated scenes (PyTorch counterpart of
``tpu_renderer.geometry.transform``, elementwise form only)."""

from __future__ import annotations

import torch

from ..core.math import scalar
from ..core.types import RenderObject

F32 = torch.float32


def rotation_y(angle, device=None) -> torch.Tensor:
    """3x3 rotation about +y, computed in f32 on ``device``."""
    a = scalar(angle, device)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones_like(a), torch.zeros_like(a)
    return torch.stack([
        torch.stack([c, zero, s]),
        torch.stack([zero, one, zero]),
        torch.stack([-s, zero, c]),
    ])


def rotate_object(obj: RenderObject, rot: torch.Tensor) -> RenderObject:
    """Rotate vertices and normals by a 3x3 matrix (colors/uvs unchanged):
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes."""

    def rot3(arr):
        return torch.stack([
            rot[i, 0] * arr[0] + rot[i, 1] * arr[1] + rot[i, 2] * arr[2]
            for i in range(3)
        ])

    return obj._replace(vertices=rot3(obj.vertices),
                        normals=rot3(obj.normals))
