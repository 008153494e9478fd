"""Supersampled rendering (SSAA), an extension over the reference (which
renders aliased, one sample per pixel).

PyTorch counterpart of ``tpu_renderer.engine.antialias``: render at an
integer multiple of the target resolution by scaling the camera
(meters_to_pixels and screen_center are the only resolution-coupled
parameters of the camera model, projekt.cpp:86-90), then box-filter down.
Depth is the max over the subsamples (larger wins). The frame renders on
the device of the scene's tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.math import pack_argb, unpack_argb
from ..core.types import Framebuffer, ProjectiveTransform, make_framebuffer
from .renderer import render_scene


def scale_transform(transform: ProjectiveTransform,
                    factor: int) -> ProjectiveTransform:
    """Camera for a factor-times-larger framebuffer covering the same
    view."""
    f = float(factor)
    return transform._replace(
        meters_to_pixels=transform.meters_to_pixels * f,
        screen_center=transform.screen_center * f)


def render_scene_ssaa(scene, transform: ProjectiveTransform, lights,
                      height: int, width: int, factor: int = 2,
                      backend: str = "kernels",
                      clear_color: int = 0) -> Framebuffer:
    """Render at factor x resolution and box-filter down to (height,
    width): each channel the f32 sum of the factor x factor samples (over
    the subsample column first, then the row) times 1 / factor**2."""
    hi = make_framebuffer(height * factor, width * factor, clear_color,
                          device=transform.focal_length.device)
    hi = render_scene(hi, scene, scale_transform(transform, factor), lights,
                      backend=backend)
    rgba = torch.stack(unpack_argb(hi.color), dim=-1).reshape(
        height, factor, width, factor, 4)
    inv = float(np.float32(1.0) / np.float32(factor * factor))
    avg = rgba.sum(dim=3).sum(dim=1) * inv
    depth = hi.depth.reshape(height, factor, width, factor).amax(
        dim=3).amax(dim=1)
    return Framebuffer(color=pack_argb(avg), depth=depth)
