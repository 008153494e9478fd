"""Inputs of the deferred shade's tests (``ops.shading.shade_merge``): a
seeded textured sphere with a quad behind it, rasterized through the
G-buffer's sorted route (K9 with K10 on the card) into a local rect off
the frame's origin, planted values in the G-buffer, and a prior
framebuffer, a crop of padded planes. Imports no JAX: the card's tests
use it too."""

import functools

import numpy as np
import torch

from tpu_renderer_torch.core.types import (
    DEPTH_CLEAR,
    Framebuffer,
    LightData,
    ObjectConfig,
)
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops.gbuffer import rasterize_gbuffer
from tpu_renderer_torch.ops.setup import setup_for_raster

FRAME_H, FRAME_W = 72, 100
ROW0, COL0 = 13, 9
HEIGHT = 51
WIDTHS = (67, 84)  # odd: the 4-pixel tail; a multiple of 4: 16-byte rows
SEED = 20
# ObjectConfig's texture fields of each mode the kernel takes.
TEX_MODES = {
    "untextured": None,
    "scalar-nearest": ("scalar", "nearest"),
    "scalar-bilinear": ("scalar", "bilinear"),
    "avx-nearest": ("avx", "nearest"),
    "avx-bilinear": ("avx", "bilinear"),
}


def config(phong: bool, tex_mode: str) -> ObjectConfig:
    fields = TEX_MODES[tex_mode]
    if fields is None:
        return ObjectConfig(phong=phong)
    return ObjectConfig(phong=phong, textured=True, uv_mode=fields[0],
                        filter_mode=fields[1])


def _mesh(rng):
    """The sphere with a quad 0.5 behind it whose u, v run over [-0.2,
    1.2] (so 'avx' drops a border), turned by a seeded angle."""
    quad = tp.construct_quad(1.8)
    quad["vertices"][:, 2] -= 0.5
    quad["uvs"] = quad["uvs"] * np.float32(1.4) - np.float32(0.2)
    mesh = tp.merge_meshes(tp.construct_sphere_grid(14, 13), quad)
    a = np.float32(rng.uniform(0.2, 1.2))
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    mesh["vertices"] = mesh["vertices"] @ rot.T
    mesh["normals"] = mesh["normals"] @ rot.T
    return mesh


def _plant(rng, covered, gbuf):
    """NaN, +-inf and u, v outside [0, 1] in the G-buffer's covered
    pixels: z, the colour, the normal and u/z, v/z, 1/z."""
    ys, xs = np.nonzero(covered.numpy())
    pick = rng.choice(len(ys), size=48, replace=False)
    vals = [np.nan, np.inf, -np.inf]
    for j, i in enumerate(pick):
        y, x = int(ys[i]), int(xs[i])
        kind = j % 8
        if kind == 0:
            gbuf[0, y, x] = vals[j % 3]
        elif kind == 1:
            gbuf[1 + j % 4, y, x] = vals[j % 3]
        elif kind == 2:
            gbuf[5 + j % 3, y, x] = vals[j % 3]
        elif kind == 3:
            gbuf[8 + j % 3, y, x] = vals[j % 3]
        elif kind == 4:
            gbuf[10, y, x] = 0.0
        elif kind == 5:  # u = 1.5, v = -0.25
            gbuf[8, y, x] = 1.5 * gbuf[10, y, x]
            gbuf[9, y, x] = -0.25 * gbuf[10, y, x]
        elif kind == 6:
            gbuf[5:8, y, x] = 0.0
        else:
            gbuf[1:5, y, x] = torch.tensor([2.0, -0.5, 1e9, -1e9])


@functools.lru_cache(maxsize=None)
def _case(phong: bool, width: int, device: str):
    rng = np.random.default_rng(SEED + width + 100 * phong)
    tr_d, li_d = ts.camera_for(FRAME_H, FRAME_W), ts.default_lights()
    texture = checkerboard(40, 56, 6, tuple(rng.integers(0, 256, 3)),
                           tuple(rng.integers(0, 256, 3)))
    sg = [(dict(p=(0.0, 0.0, 0.0), **_mesh(rng)),
           dict(phong=phong, texture=texture, filter_mode="bilinear"))]
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=device)
    obj, cfg = scene[0]
    table = setup_for_raster(obj, tr, li, cfg, frame_height=FRAME_H,
                             frame_width=FRAME_W)
    covered, gbuf, _ = rasterize_gbuffer(table, HEIGHT, width, None, FRAME_H,
                                         FRAME_W, ROW0, COL0,
                                         strategy="sorted")
    assert gbuf.stride(1) > width, "a crop of the raster's padded planes"
    _plant(rng, covered.cpu(), gbuf)
    z = gbuf[0].cpu()
    depth = torch.full_like(z, DEPTH_CLEAR)
    pick = torch.from_numpy(rng.integers(0, 4, z.shape))
    finite = torch.isfinite(z)
    depth = torch.where((pick == 1) & finite, z, depth)  # equal: kept
    depth = torch.where((pick == 2) & finite, z + 0.25, depth)  # greater
    depth = torch.where((pick == 3) & finite, z - 0.25, depth)  # smaller
    color = torch.from_numpy(
        rng.integers(0, 2 ** 32, z.shape, dtype=np.uint32).view(np.int32))
    # A crop of padded planes, as the fused route's frame is.
    pad = torch.zeros((HEIGHT + 5, width + 12), dtype=torch.int32)
    planes = [pad.clone().to(device), pad.float().to(device)]
    planes[0][:HEIGHT, :width] = color.to(device)
    planes[1][:HEIGHT, :width] = depth.to(device)
    prior = Framebuffer(color=planes[0][:HEIGHT, :width].view(torch.uint32),
                        depth=planes[1][:HEIGHT, :width])
    return covered, gbuf, tr, li, obj.texture, prior


def case(phong: bool, width: int, n_lights: int, device):
    """(covered, gbuf, transform, lights, texture, prior framebuffer) on
    ``device``: the G-buffer of the textured object, Phong or Gouraud,
    rasterized on ``device`` into the rect (ROW0, COL0, HEIGHT, width) of
    the frame, a crop of the raster's padded planes, with planted values;
    the first ``n_lights`` lights. Shared between cases: read only."""
    covered, gbuf, tr, li, texture, prior = _case(phong, width,
                                                  str(torch.device(device)))
    lights = LightData(li.ambient, li.light_p[:n_lights],
                       li.light_intensity[:n_lights])
    return covered, gbuf, tr, lights, texture, prior
