"""Core data model: camera, lights, scene objects, framebuffer.

PyTorch counterpart of ``tpu_renderer.core.types``. The layouts are the
JAX package's, so the two compare like with like:

- ``RenderObject`` arrays are CHANNEL-MAJOR, (C, 3, T): component,
  vertex-within-triangle, triangle, with the triangle axis minor;
- ``Framebuffer`` holds (H, W) u32 ARGB color and (H, W) f32 depth,
  larger depth wins (projekt.cpp:495).

Every leaf is a float32 tensor on one explicit ``device``; scalars are 0-d
tensors on that device, so kernels and plain versions read them without a
host round trip. The constructors put them on the card unless given
``device="cpu"``, and raise without a card (``resolve_device``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

F32 = torch.float32

# Clear value of the depth buffer: the most negative float (stored z is
# camera-space z, larger wins, and can be negative).
DEPTH_CLEAR = float(np.float32(-3.4028235e38))

# Near clip plane, hardcoded in ProjectVertex (projekt.cpp:82).
NEAR_CLIP = float(np.float32(0.2))


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. Raises instead of falling back when no card is present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the kernels' plain "
            "versions on the CPU")
    return device


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


class ProjectiveTransform(NamedTuple):
    """Pinhole camera looking down -z from ``distance_above_target``."""

    distance_above_target: torch.Tensor  # 0-d f32
    focal_length: torch.Tensor  # 0-d f32
    meters_to_pixels: torch.Tensor  # 0-d f32
    screen_center: torch.Tensor  # (2,) f32, pixels


def make_transform(distance_above_target, focal_length, meters_to_pixels,
                   screen_center, device="cuda") -> ProjectiveTransform:
    device = resolve_device(device)
    return ProjectiveTransform(
        distance_above_target=_f32(distance_above_target, device).reshape(()),
        focal_length=_f32(focal_length, device).reshape(()),
        meters_to_pixels=_f32(meters_to_pixels, device).reshape(()),
        screen_center=_f32(screen_center, device).reshape(2),
    )


class LightData(NamedTuple):
    """Ambient + N point lights."""

    ambient: torch.Tensor  # (4,) f32 rgba intensity
    light_p: torch.Tensor  # (L, 3) f32 camera-space positions
    light_intensity: torch.Tensor  # (L, 4) f32 rgba intensities

    @property
    def count(self) -> int:
        return self.light_p.shape[0]


def make_lights(ambient, positions, intensities,
                device="cuda") -> LightData:
    device = resolve_device(device)
    positions = _f32(positions, device).reshape(-1, 3)
    intensities = _f32(intensities, device).reshape(-1, 4)
    assert positions.shape[0] == intensities.shape[0]
    return LightData(
        ambient=_f32(ambient, device).reshape(4),
        light_p=positions,
        light_intensity=intensities,
    )


def no_lights(device="cuda") -> LightData:
    """Zero lights: ambient never applied (the reference's per-light loop
    multiplies ambient only on light index 0, so 0 lights => raw
    colours)."""
    device = resolve_device(device)
    return LightData(
        ambient=torch.ones((4,), dtype=F32, device=device),
        light_p=torch.zeros((0, 3), dtype=F32, device=device),
        light_intensity=torch.zeros((0, 4), dtype=F32, device=device),
    )


class RenderObject(NamedTuple):
    """One model: triangle soup + per-vertex attributes (+ optional texture).

    ``vertices`` are model-space; ``p`` is the model's camera-space position
    (projekt.cpp:3900-3903)."""

    p: torch.Tensor  # (3,) f32
    vertices: torch.Tensor  # (3, 3, T) f32 [xyz][vertex 0..2][triangle]
    colors: torch.Tensor  # (4, 3, T) f32 rgba
    normals: torch.Tensor  # (3, 3, T) f32
    uvs: torch.Tensor  # (2, 3, T) f32
    texture: Optional[torch.Tensor] = None  # (Ht, Wt) u32 ARGB or None

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[2]

    @property
    def device(self) -> torch.device:
        """The device of its planes."""
        return self.vertices.device


def _to_channel_major(arr, channels: int, device=None) -> torch.Tensor:
    """(V, C) classic soup -> (C, 3, T) channel-major layout."""
    a = _f32(arr, device).reshape(-1, channels)
    v = a.shape[0]
    assert v % 3 == 0, "triangle soup requires a multiple of 3 vertices"
    return a.reshape(v // 3, 3, channels).permute(2, 1, 0).contiguous()


def make_object(p, vertices, colors, normals, uvs, texture=None,
                device="cuda") -> RenderObject:
    """Build a RenderObject from classic (V, C) triangle-soup arrays."""
    device = resolve_device(device)
    tex = None
    if texture is not None:
        tex = torch.as_tensor(
            np.asarray(texture, np.uint32), device=device
        )
    return RenderObject(
        p=_f32(p, device).reshape(3),
        vertices=_to_channel_major(vertices, 3, device),
        colors=_to_channel_major(colors, 4, device),
        normals=_to_channel_major(normals, 3, device),
        uvs=_to_channel_major(uvs, 2, device),
        texture=tex,
    )


def classic_arrays(obj: RenderObject) -> dict:
    """The object's soup back in classic (V, C) vertex-major NumPy form
    (serialization, goldens, debugging)."""
    out = {}
    for name in ("vertices", "colors", "normals", "uvs"):
        a = getattr(obj, name).cpu().numpy()
        out[name] = a.transpose(2, 1, 0).reshape(-1, a.shape[0])
    return out


@dataclasses.dataclass(frozen=True)
class ObjectConfig:
    """Per-object rendering switches (see tpu_renderer.core.types).

    phong: per-pixel Blinn-Phong; False => Gouraud baked at the vertex
    stage. textured / uv_mode / filter_mode: texture sampling, 'scalar' or
    'avx' addressing, 'nearest' or 'bilinear' filtering. 'scalar' objects
    whose texture fits the fused atlas limits sample in the raster kernel's
    finalize; 'avx' ones and larger textures take the G-buffer path and the
    deferred ``shade``."""

    phong: bool = False
    textured: bool = False
    uv_mode: str = "scalar"
    filter_mode: str = "nearest"


class Framebuffer(NamedTuple):
    """Color (u32 ARGB) + depth (f32, larger wins)."""

    color: torch.Tensor  # (H, W) u32
    depth: torch.Tensor  # (H, W) f32

    @property
    def height(self) -> int:
        return self.color.shape[0]

    @property
    def width(self) -> int:
        return self.color.shape[1]


def make_framebuffer(height: int, width: int, clear_color: int = 0,
                     device="cuda") -> Framebuffer:
    device = resolve_device(device)
    color = torch.full(
        (height, width), np.int32(np.uint32(clear_color).view(np.int32)),
        dtype=torch.int32, device=device,
    ).view(torch.uint32)
    return Framebuffer(
        color=color,
        depth=torch.full((height, width), DEPTH_CLEAR, dtype=F32,
                         device=device),
    )
