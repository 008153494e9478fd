"""Model transforms for animated scenes (PyTorch counterpart of
``tpu_renderer.geometry.transform``, elementwise form only): rotations and
the object's position.

The rotation matrices follow the entry points' device rule: a tensor
angle keeps its device; a Python number goes to ``device``, the card
unless the caller asks for the CPU (``core.types.resolve_device``)."""

from __future__ import annotations

import torch

from ..core.math import scalar
from ..core.types import RenderObject, resolve_device
from ..utils.profiling import annotate

F32 = torch.float32


def _cos_sin(angle, device):
    """(cos, sin, 1, 0) of ``angle`` as 0-d f32 tensors on its device (a
    tensor angle) or on ``resolve_device(device)``."""
    if not isinstance(angle, torch.Tensor):
        angle = scalar(angle, resolve_device(device))
    a = angle.to(F32)
    return torch.cos(a), torch.sin(a), torch.ones_like(a), torch.zeros_like(a)


def rotation_y(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +y, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([c, zero, s]),
        torch.stack([zero, one, zero]),
        torch.stack([-s, zero, c]),
    ])


def rotation_x(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +x, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([one, zero, zero]),
        torch.stack([zero, c, -s]),
        torch.stack([zero, s, c]),
    ])


def rotation_z(angle, device="cuda") -> torch.Tensor:
    """3x3 rotation about +z, computed in f32."""
    c, s, one, zero = _cos_sin(angle, device)
    return torch.stack([
        torch.stack([c, -s, zero]),
        torch.stack([s, c, zero]),
        torch.stack([zero, zero, one]),
    ])


def rotate_object(obj: RenderObject, rot: torch.Tensor) -> RenderObject:
    """Rotate vertices and normals by a 3x3 matrix (colors/uvs unchanged):
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes."""

    def rot3(arr):
        return torch.stack([
            rot[i, 0] * arr[0] + rot[i, 1] * arr[1] + rot[i, 2] * arr[2]
            for i in range(3)
        ])

    with annotate("tr.geometry"):
        return obj._replace(vertices=rot3(obj.vertices),
                            normals=rot3(obj.normals))


def translate_object(obj: RenderObject, p) -> RenderObject:
    """Set the object's camera-space position (the reference's Object->P):
    ``p`` as a (3,) f32 tensor on the object's device."""
    return obj._replace(p=torch.as_tensor(
        p, dtype=F32, device=obj.vertices.device).reshape(3))
