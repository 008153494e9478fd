"""Model transforms for animated scenes (PyTorch counterpart of
``tpu_renderer.geometry.transform``, elementwise form only): rotations and
the object's position.

``rotate_object`` runs K13 (``rotate_kernel``, csrc/transform.cu) on the
card, one launch an object, and ``rotate_plain``, the same f32 products
and sums as torch ops, on the CPU.

The rotation matrices follow the entry points' device rule: a tensor
angle keeps its device; a Python number goes to ``device``, the card
unless the caller asks for the CPU (``core.types.resolve_device``)."""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda
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


def rotate_plain(rot: torch.Tensor, vertices: torch.Tensor,
                 normals: torch.Tensor):
    """(vertices, normals) rotated by ``rot`` as torch ops, on any device:
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes."""

    def rot3(arr):
        return torch.stack([
            rot[i, 0] * arr[0] + rot[i, 1] * arr[1] + rot[i, 2] * arr[2]
            for i in range(3)
        ])

    return rot3(vertices), rot3(normals)


def rotate_kernel(rot: torch.Tensor, vertices: torch.Tensor,
                  normals: torch.Tensor):
    """K13: ``rotate_plain``'s planes, bit-equal. CUDA tensors launch
    ``tr_rotate`` (csrc/transform.cu), vertices and normals in one launch,
    counted in ``rotate_kernel.launches``; CPU tensors run
    ``rotate_plain``. ``rot`` is taken as f32 on the planes' device, as
    the plain version's products take it."""
    dev = vertices.device
    if dev.type == "cpu":
        return rotate_plain(rot, vertices, normals)
    if dev.type != "cuda":
        raise ValueError(f"K13 runs on CUDA or CPU tensors, not {dev}")
    T = vertices.shape[2]
    rot = rot.to(device=dev, dtype=F32).contiguous()
    _cuda.check_tensor("rot", rot, dev, F32, (3, 3))
    _cuda.check_tensor("vertices", vertices, dev, F32, (3, 3, T))
    _cuda.check_tensor("normals", normals, dev, F32, (3, 3, T))
    v_out, n_out = torch.empty_like(vertices), torch.empty_like(normals)
    if T:
        _cuda.launch("tr_rotate", dev, rot.data_ptr(), vertices.data_ptr(),
                     normals.data_ptr(), 3 * T, v_out.data_ptr(),
                     n_out.data_ptr())
        rotate_kernel.launches += 1
    return v_out, n_out


rotate_kernel.launches = 0
_cuda.declare("tr_rotate", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])


def rotate_object(obj: RenderObject, rot: torch.Tensor) -> RenderObject:
    """Rotate vertices and normals by a 3x3 matrix (colors/uvs unchanged):
    out_i = (rot[i,0]*x + rot[i,1]*y) + rot[i,2]*z on the channel planes,
    K13 on the card (``rotate_kernel``)."""
    with annotate("tr.geometry"):
        vertices, normals = rotate_kernel(rot, obj.vertices, obj.normals)
        return obj._replace(vertices=vertices, normals=normals)


def translate_object(obj: RenderObject, p) -> RenderObject:
    """Set the object's camera-space position (the reference's Object->P):
    ``p`` as a (3,) f32 tensor on the object's device."""
    return obj._replace(p=torch.as_tensor(
        p, dtype=F32, device=obj.vertices.device).reshape(3))
