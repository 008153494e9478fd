"""tpu_renderer_torch: the PyTorch + CUDA port of tpu_renderer.

The JAX package ``tpu_renderer`` stays the reference; this package mirrors
its layout (core, geometry, models, ops, engine) and keeps its layouts at
the public functions. Its kernels are CUDA C++ for Hopper (``csrc/``),
built with nvcc at first use; on CPU tensors each kernel's wrapper runs
its plain-PyTorch version instead. It imports torch and never jax.

It renders the fused path, one or several objects per launch, textured
('scalar' addressing, nearest or bilinear, within the fused atlas limits)
or not: K1 (setup, from 4096 triangles) or the small-object chain + K7
(record transpose); then the mask strategy's per-tile lists and K6 up to
512 triangles, or the sorted binning and K2, K3 or K4 (fused raster +
shade on 8-row tiles with two or one streams, or on 16-row tiles) above;
K5 samples textures in the raster kernels' finalize. Textured objects the
fused path cannot take (``uv_mode='avx'``, textures over the atlas limits)
take the G-buffer path: K8 (mask) or K9 with the side-list fold K10
(sorted) rasterize into an (11, H, W) G-buffer, and the deferred
``shade`` samples, lights and packs it. K11, the occlusion skip, is K2
and K3 with a per-batch cull (``Renderer(zcull=True)``). The Renderer
takes the JAX package's knobs (backend 'kernels' or 'reference',
clear_color, capacity, budget_factor and calibrate, zcull).

Quick start (entry points run on the card and raise without one unless
given ``device="cpu"``):

    from tpu_renderer_torch import Renderer, ObjectConfig, make_object, ...
    r = Renderer(1080, 1920)
    fb = r.render(scene, transform, lights)   # fb.color: (H, W) u32 ARGB
"""

from .core.types import (
    DEPTH_CLEAR,
    Framebuffer,
    LightData,
    ObjectConfig,
    ProjectiveTransform,
    RenderObject,
    make_framebuffer,
    make_lights,
    make_object,
    make_transform,
    no_lights,
)
from .engine.renderer import (
    Renderer,
    calibrate_budget_factor,
    render_object,
    render_scene,
)

__version__ = "0.1.0"

__all__ = [
    "DEPTH_CLEAR",
    "Framebuffer",
    "LightData",
    "ObjectConfig",
    "ProjectiveTransform",
    "RenderObject",
    "Renderer",
    "calibrate_budget_factor",
    "make_framebuffer",
    "make_lights",
    "make_object",
    "make_transform",
    "no_lights",
    "render_object",
    "render_scene",
    "__version__",
]
