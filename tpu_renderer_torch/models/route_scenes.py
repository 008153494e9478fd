"""Small scenes, one for each of the port's routes off the headline frame,
with their frame sizes: what the tests render against the JAX package and
what chip_smoke.py renders on the card against the CPU.

| Name | Route | Scene |
| --- | --- | --- |
| k3 | K1 -> K3 | config 2's teapot, 5,428 tris, Gouraud, 256x256 |
| k4 | setup_records -> K7 -> K4 | construct_sphere(12), 528 tris, Phong, 384x384 |
| mixed | K1's grouped form, both objects (the cube below 4096) -> K2 | construct_sphere_grid(46, 45) + a 0.15-unit cube, 4,152 tris, 128x128 |
| k4multi | setup_records x 3 -> K7 -> K4 | sphere(12) Phong + torus(16, 8) + cube, 796 tris (1,024 padded), 512x512 |
| k2multi | setup_records x 3 -> K7 -> K2 | config 5's three untextured objects, 3,244 tris (3,456 padded), 96x128 |
| k6 | setup_records -> K7 -> K6, 16-row tiles | config 1's cube, 12 tris, 128x128 |
| k6multi | setup_records x 2 -> K7 -> K6, 8-row tiles | torus(8, 6) Phong + cube, 108 tris (256 padded), 128x128 |

Side-list variants (sorted routes): a quad merged into one object's mesh
(k3, k4: 2.2 units; mixed: 1.2 units, into the cube; k4multi: 2.2 units,
into the sphere), or config 5's quad, untextured, as a fourth object
(k2multi). Textured variants, so that every route's finalize runs K5:
k3 the teapot bilinear (32x32 checkerboard, Gouraud: unlit texture); k4
the sphere nearest (16x16, Phong: the texel lit); mixed the sphere grid
bilinear (16x16) and the cube nearest (8x32), two widths in one atlas;
k2multi config 5 in full (its quad nearest, 64x64); k6 config 3 (bilinear
64x64); k6multi two quads sharing one 32x32 texture, nearest and bilinear
(tests/test_pallas.py:257).

K11's stacks (``ZCULL_STACKS``): ``scenes.stack_scene`` with the
innermost layer first (each later layer hidden), six Phong layers at
640x640, where the 128-column tile at the centre lies inside even the
innermost disc (78 px radius), so the skip fires from the second layer
on: 6 x construct_sphere_grid(24, 24), 6,912 tris, takes K3's route
(rows 1); 6 x construct_sphere_grid(60, 60), 43,200 tris, K2's (rows 2).

G-buffer variants, textured objects the fused kernels cannot take: k3 the
teapot with 'avx' nearest (32x32; K1 -> K9, 8-row tiles); k4 the
side-list scene with a 16x600 nearest texture, over the fused width limit
(K7 -> K9, 16-row tiles, with the side list, K10); mixed the sphere grid
Phong with a 256x256 bilinear texture (K1 -> K9, 8-row tiles) and the
cube nearest (8x32, fused: K7 -> K6), drawn object by object; k6 config 3
with 'avx' addressing (K7 -> K8, 16-row tiles).
"""

from . import primitives as tp
from . import scenes as ts
from .sphere import construct_sphere
from .textures import checkerboard

MESH_KEYS = ("vertices", "colors", "normals", "uvs")
ROUTE_NAMES = ("k3", "k4", "mixed", "k4multi", "k2multi")  # sorted routes
MASK_NAMES = ("k6", "k6multi")
TEXTURED_NAMES = ("k3", "k4", "mixed", "k2multi", "k6", "k6multi")
GBUFFER_NAMES = ("k3", "k4", "mixed", "k6")
# rows of the route -> stack_scene's (lat, lon, layers, frame side)
ZCULL_STACKS = {1: (24, 24, 6, 640), 2: (60, 60, 6, 640)}


def mesh_only(mesh):
    return {k: mesh[k] for k in MESH_KEYS}


def with_quad(entry, size):
    """A scene entry with a quad merged into its object's mesh."""
    obj, cfg = entry
    merged = tp.merge_meshes(mesh_only(obj), tp.construct_quad(size))
    return dict(p=obj["p"], **merged), cfg


def textured(entry, texture, filter_mode="nearest", uv_mode="scalar"):
    """A scene entry with a texture, filter mode and addressing added."""
    obj, cfg = entry
    return obj, dict(cfg, texture=texture, filter_mode=filter_mode,
                     uv_mode=uv_mode)


def route_scene(name, variant="base"):
    """(scene_golden, (h, w)) of a route's scene, its side-list variant
    (sorted routes), its textured variant (TEXTURED_NAMES) or its G-buffer
    variant (GBUFFER_NAMES)."""
    side = variant == "sidelist"
    tex = variant == "textured"
    gbuf = variant == "gbuffer"
    if name == "k3":
        hw = (256, 256)
        sg = ts.baseline_scene(2, *hw)[0]
        if side:
            sg = [with_quad(sg[0], 2.2)]
        if tex:
            sg = [textured(sg[0], checkerboard(32, 32, 4), "bilinear")]
        if gbuf:
            sg = [textured(sg[0], checkerboard(32, 32, 4), uv_mode="avx")]
    elif name == "k4":
        hw = (384, 384)
        sg = [(dict(p=(0.0, 0.0, 0.0), **construct_sphere(12)),
               {"phong": True})]
        if side or gbuf:
            sg = [with_quad(sg[0], 2.2)]
        if tex:
            sg = [textured(sg[0], checkerboard(16, 16, 2))]
        if gbuf:
            sg = [textured(sg[0], checkerboard(16, 600, 4))]
    elif name == "mixed":
        hw = (128, 128)
        sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(46, 45)),
               {"phong": True}),
              (dict(p=(0.5, 0.55, -0.3), **ts.rotate_y(
                  tp.construct_cube(0.15), -0.3)), {})]
        if side:
            sg = [sg[0], with_quad(sg[1], 1.2)]
        if tex:
            sg = [textured(sg[0], checkerboard(16, 16, 2), "bilinear"),
                  textured(sg[1], checkerboard(8, 32, 4))]
        if gbuf:
            sg = [textured(sg[0], checkerboard(256, 256, 32), "bilinear"),
                  textured(sg[1], checkerboard(8, 32, 4))]
    elif name == "k4multi":
        hw = (512, 512)
        sg = [(dict(p=(-0.45, 0.3, 0.3), **construct_sphere(12)),
               {"phong": True}),
              (dict(p=(0.55, -0.35, 0.0), **ts.rotate_y(
                  tp.construct_torus(major_steps=16, minor_steps=8), 0.3)),
               {}),
              (dict(p=(0.5, 0.55, -0.3), **ts.rotate_y(
                  tp.construct_cube(0.7), -0.3)), {})]
        if side:
            sg = [with_quad(sg[0], 2.2)] + sg[1:]
    elif name == "k2multi":
        hw = (96, 128)
        sg5 = ts.baseline_scene(5, *hw)[0]
        sg = sg5[:3]
        if side:
            quad = sg5[3][0]
            sg = sg + [(dict(p=quad["p"], **mesh_only(quad)), {})]
        if tex:
            sg = sg5
    elif name == "k6":
        hw = (128, 128)
        sg = ts.baseline_scene(3 if tex or gbuf else 1, *hw)[0]
        if gbuf:
            sg = [(sg[0][0], dict(sg[0][1], uv_mode="avx"))]
    elif name == "k6multi":
        hw = (128, 128)
        if tex:
            check = checkerboard(32, 32, 4)
            quad = tp.construct_quad(1.2)
            sg = [(dict(p=(-0.35, 0.0, 0.0), **quad), {"texture": check}),
                  (dict(p=(0.45, 0.2, 0.3), **quad),
                   {"texture": check, "filter_mode": "bilinear"})]
        else:
            sg = [(dict(p=(-0.3, 0.1, 0.2), **ts.rotate_y(
                      tp.construct_torus(major_steps=8, minor_steps=6),
                      0.3)), {"phong": True}),
                  (dict(p=(0.35, -0.2, 0.0), **ts.rotate_y(
                      tp.construct_cube(0.6), -0.3)), {})]
    else:
        raise ValueError(name)
    return sg, hw


def torch_scene(name, variant, device):
    """(scene, transform, lights, (h, w)) of a route's scene on device."""
    sg, hw = route_scene(name, variant)
    tr_d, li_d = ts.baseline_camera_lights(*hw)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=device)
    return scene, tr, li, hw


def zcull_stack(rows, device):
    """(scene, transform, lights, (h, w)) of K11's stack on the route with
    ``rows`` streams per tile."""
    lat, lon, layers, side = ZCULL_STACKS[rows]
    return ts.stack_scene(lat, lon, layers, side, side, device=device,
                          inner_first=True) + ((side, side),)
