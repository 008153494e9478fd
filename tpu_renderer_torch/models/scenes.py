"""The five suite scene configs, copied from ``tpu_renderer.models.scenes``,
plus the conversion of a golden-form scene to the port's tensors.

Configs (``baseline_scene``):
  1. Flat-shaded rotating cube, 512x512
  2. Gouraud-shaded OBJ mesh (the generated teapot, via the OBJ loader)
  3. Texture-mapped cube, perspective-correct UVs, bilinear
  4. Per-pixel Phong sphere, 2 point lights, 1080p
  5. Multi-object scene: Phong sphere, Gouraud torus and cube, textured quad

Textures are carried as data (u32 ARGB arrays in the config dicts) and
sampled in the raster kernels' finalize.

``stack_scene`` is ``bench.py --scale``'s depth-complex scene: concentric
Phong spheres, in bench.py's order or the one that hides every later
layer, the scene the occlusion skip (zcull, K11) is for.
"""

from __future__ import annotations

import numpy as np

from ..core.types import (
    ObjectConfig,
    make_lights,
    make_object,
    make_transform,
    resolve_device,
)
from .primitives import (
    construct_cube,
    construct_quad,
    construct_sphere_grid,
    construct_torus,
)
from .sphere import construct_sphere
from .teapot import construct_teapot
from .textures import checkerboard

F = np.float32


def rotate_y(mesh: dict, angle: float) -> dict:
    """Rotate a mesh's vertices/normals about +y (host-side, NumPy f32)."""
    c, s = np.cos(F(angle), dtype=F), np.sin(F(angle), dtype=F)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], F)
    out = dict(mesh)
    out["vertices"] = mesh["vertices"] @ rot.T
    out["normals"] = mesh["normals"] @ rot.T
    return out


def camera_for(height: int, width: int, dat: float = 3.0,
               m2p_scale: float = 1.2):
    """Camera framing the unit-ish meshes at the frame center."""
    m2p = m2p_scale * min(height, width)
    return dict(
        distance_above_target=float(dat),
        focal_length=1.0,
        meters_to_pixels=float(m2p),
        screen_center=(width / 2.0, height / 2.0),
    )


def default_lights():
    return dict(
        ambient=np.array([0.25, 0.25, 0.3, 1.0], F),
        light_p=np.array([[2.0, 2.0, 1.5], [-2.5, 1.0, 2.0]], F),
        light_intensity=np.array(
            [[0.9, 0.85, 0.8, 1.0], [0.25, 0.3, 0.45, 1.0]], F
        ),
    )


def baseline_camera_lights(height: int, width: int):
    """(transform_dict, lights_dict) of ``baseline_scene``: every config
    shares one camera framing and the default lights."""
    return camera_for(height, width), default_lights()


def baseline_scene(config: int, height: int, width: int, angle: float = 0.3):
    """(scene_golden, transform_dict, lights_dict) for config 1-5, where
    scene_golden is a list of (obj_dict, cfg_dict)."""
    tr = camera_for(height, width)
    lights = default_lights()
    if config == 1:  # flat cube
        mesh = rotate_y(construct_cube(), angle)
        scene = [(dict(p=(0.0, 0.0, 0.0), **mesh), {})]
    elif config == 2:  # Gouraud-shaded OBJ mesh (teapot via the loader)
        mesh = rotate_y(construct_teapot(), angle)
        scene = [(dict(p=(0.0, 0.0, 0.0), **mesh), {})]
    elif config == 3:  # textured mesh, perspective-correct UVs, bilinear
        mesh = rotate_y(construct_cube(), angle)
        scene = [
            (dict(p=(0.0, 0.0, 0.0), **mesh),
             {"texture": checkerboard(64, 64, 8),
              "filter_mode": "bilinear"})
        ]
    elif config == 4:  # phong multi-light
        mesh = construct_sphere()
        scene = [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": True})]
    elif config == 5:  # multi-object
        sph = construct_sphere()
        tor = rotate_y(construct_torus(), angle)
        cub = rotate_y(construct_cube(0.7), -angle)
        quad = construct_quad(2.2)
        scene = [
            (dict(p=(-0.45, 0.3, 0.3), **sph), {"phong": True}),
            (dict(p=(0.55, -0.35, 0.0), **tor), {}),
            (dict(p=(0.5, 0.55, -0.3), **cub), {}),
            (dict(p=(0.0, 0.0, -1.0), **quad),
             {"texture": checkerboard(64, 64, 8)}),
        ]
    else:
        raise ValueError(f"config must be 1-5, got {config}")
    return scene, tr, lights


def to_torch_scene(scene_golden, tr_dict, lights_dict, device="cuda"):
    """Golden-form scene -> (scene, transform, lights) on ``device``: the
    same NumPy arrays that ``to_jax_scene`` feeds the JAX package. The
    default is the card; without one it raises unless ``device='cpu'``."""
    device = resolve_device(device)
    transform = make_transform(
        tr_dict["distance_above_target"],
        tr_dict["focal_length"],
        tr_dict["meters_to_pixels"],
        tr_dict["screen_center"],
        device=device,
    )
    lights = make_lights(
        lights_dict["ambient"],
        lights_dict["light_p"],
        lights_dict["light_intensity"],
        device=device,
    )
    scene = []
    for obj_d, cfg_d in scene_golden:
        texture = cfg_d.get("texture")
        obj = make_object(
            obj_d["p"], obj_d["vertices"], obj_d["colors"],
            obj_d["normals"], obj_d["uvs"], texture, device=device,
        )
        cfg = ObjectConfig(
            phong=bool(cfg_d.get("phong", False)),
            textured=texture is not None,
            uv_mode=cfg_d.get("uv_mode", "scalar"),
            filter_mode=cfg_d.get("filter_mode", "nearest"),
        )
        scene.append((obj, cfg))
    return scene, transform, lights


def stack_scene(lat: int, lon: int, layers: int, height: int, width: int,
                device="cuda", inner_first: bool = False):
    """(scene, transform, lights) on ``device`` of ``stack_scene_golden``'s
    scene."""
    return to_torch_scene(*stack_scene_golden(lat, lon, layers, height,
                                              width, inner_first),
                          device=device)


def stack_scene_golden(lat: int, lon: int, layers: int, height: int,
                       width: int, inner_first: bool = False):
    """(scene_golden, transform_dict, lights_dict) of ``layers`` concentric
    ``construct_sphere_grid(lat, lon)`` spheres, layer i's vertices scaled
    by 1 - 0.1 i, each a Phong object at the origin, with
    ``baseline_scene(4)``'s camera and lights (bench.py:350-365;
    ``stack_scene(409, 409, 6, 1080, 1920)`` is its 2,007,372-triangle
    stack).

    bench.py submits the outermost layer first, meaning the nearest.
    Under the reference's winding a sphere grid shows its far hemisphere
    (the headline sphere's frame reads z in [-0.5, 0.086]), so in that
    order each layer is drawn in front of the last and nothing is hidden.
    ``inner_first=True`` submits the innermost layer first: every later
    layer then lies behind what is drawn, the occluded order the skip
    (zcull, K11) is for."""
    mesh = construct_sphere_grid(lat, lon)
    meshes = [mesh]
    for i in range(1, layers):
        s = F(1.0 - 0.1 * i)  # descending radius
        meshes.append({k: (np.asarray(v) * s if k == "vertices" else v)
                       for k, v in mesh.items()})
    if inner_first:
        meshes.reverse()
    _, tr_d, li_d = baseline_scene(4, height, width)
    sg = [(dict(p=(0.0, 0.0, 0.0), **m), {"phong": True}) for m in meshes]
    return sg, tr_d, li_d


def sphere_cluster_scene(n: int, height: int, width: int, device="cuda",
                         twins: bool = False):
    """(scene, transform, lights) of ``n`` overlapping
    ``construct_sphere(12)`` spheres, one untextured Gouraud config, at
    staggered positions and depths, with ``baseline_scene(1)``'s camera and
    lights: occlusion between objects, the scene that holds the
    object-sharded fold to the submission order (tests/test_parallel.py's
    ``_multi_sphere_scene``). ``twins`` submits each sphere twice, the
    second time Phong-shaded: the twins' surfaces coincide, so every pixel
    they cover is a depth tie between two objects of two configs, which
    the first of the two must win."""
    mesh = construct_sphere(12)
    _, tr_d, li_d = baseline_scene(1, height, width)
    sg = []
    for i in range(n):
        obj = dict(p=(-0.6 + 0.3 * i, 0.15 * (i % 3) - 0.15, 0.2 * (i % 2)),
                   **mesh)
        sg += [(obj, {}), (obj, {"phong": True})] if twins else [(obj, {})]
    return to_torch_scene(sg, tr_d, li_d, device=device)
