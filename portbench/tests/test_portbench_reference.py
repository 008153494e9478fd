"""The frozen reference: its windows equal the spec's whole frame, and the
port's CPU frame of a small sphere, rotated by the benchmark's matrix,
inside them; its bfloat16 control differs."""

import numpy as np
import pytest

from portbench import scene as scenes
from portbench import traffic
from portbench.reference import frame, spec

H, W = 80, 144


def small_scene(textured):
    obj = {"p": [0.0, 0.0, 0.0], "phong": True,
           "mesh": [{"kind": "sphere_grid", "lat": 20, "lon": 21}]}
    if textured:
        obj["mesh"].append({"kind": "quad", "size": 2.2,
                            "offset": [0.0, 0.0, -0.6]})
        obj.update(texture={"kind": "checkerboard", "height": 64,
                            "width": 64, "cell": 8, "colors": "seed"},
                   filter_mode="bilinear")
    cfg = {"objects": [obj],
           "camera": {"distance_above_target": 3.0, "focal_length": 1.0,
                      "m2p_scale": 1.2},
           "lights": {"ambient": [0.25, 0.25, 0.3, 1.0],
                      "positions": [[2.0, 2.0, 1.5], [-2.5, 1.0, 2.0]],
                      "intensities": [[0.9, 0.85, 0.8, 1.0],
                                      [0.25, 0.3, 0.45, 1.0]]}}
    return scenes.build(cfg, H, W, np.random.default_rng(3))


def rotated(sg, k):
    rot = traffic.rotation("y", 2 * np.pi * k / 240)
    return [(frame.rotate(o, rot), c) for o, c in sg], rot


def windows(sg, tr, seed=1):
    return frame.place_windows(sg, tr, H, W, 6, 32,
                               np.random.default_rng(seed))


@pytest.mark.parametrize("textured", [False, True])
def test_windows_equal_the_spec_whole_frame(textured):
    sg, tr, li = small_scene(textured)
    sg, _ = rotated(sg, 17)
    whole = spec.render(sg, tr, li, H, W)
    for r0, c0 in windows(sg, tr):
        rect = (r0, c0, 32, 32)
        got = frame.render_rect(frame.window_scenes(sg, tr, H, W, [rect])[0],
                                tr, li, H, W, rect)
        want = (whole[0][r0:r0 + 32, c0:c0 + 32],
                whole[1][r0:r0 + 32, c0:c0 + 32])
        assert frame.differing(got, want) == 0
        assert (want[1] > spec.DEPTH_CLEAR).any()


@pytest.mark.parametrize("textured", [False, True])
def test_port_cpu_frame_equals_the_windows(textured):
    import torch

    from portbench import harness
    import tpu_renderer_torch as trt
    from tpu_renderer_torch.geometry.transform import rotate_object

    sg, tr, li = small_scene(textured)
    rsg, rot = rotated(sg, 101)
    prog, ptr, pli = harness.device_scene(sg, tr, li, torch.device("cpu"))
    r = torch.as_tensor(rot)
    fb = trt.Renderer(H, W, device="cpu").render(
        [(rotate_object(o, r), c) for o, c in prog], ptr, pli)
    got = (fb.color.view(torch.int32).numpy().view(np.uint32),
           fb.depth.numpy())
    for r0, c0 in windows(rsg, tr, seed=2):
        rect = (r0, c0, 32, 32)
        want = frame.render_rect(frame.window_scenes(rsg, tr, H, W, [rect])[0],
                                 tr, li, H, W, rect)
        crop = (got[0][r0:r0 + 32, c0:c0 + 32], got[1][r0:r0 + 32,
                                                        c0:c0 + 32])
        assert frame.differing(crop, want) == 0


def test_rotation_is_the_programs_order():
    import torch

    from tpu_renderer_torch.core.types import make_object
    from tpu_renderer_torch.geometry.transform import rotate_object

    sg, _, _ = small_scene(False)
    o = sg[0][0]
    rot = traffic.rotation("y", 0.7)
    want = frame.rotate(o, rot)
    obj = make_object(o["p"], o["vertices"], o["colors"], o["normals"],
                      o["uvs"], device="cpu")
    got = rotate_object(obj, torch.as_tensor(rot))
    for k in ("vertices", "normals"):
        a = getattr(got, k).numpy()
        a = a.transpose(2, 1, 0).reshape(-1, 3)
        assert np.array_equal(a.view(np.int32), want[k].view(np.int32))


@pytest.mark.parametrize("textured", [False, True])
def test_the_bfloat16_control_differs(textured):
    sg, tr, li = small_scene(textured)
    sg, _ = rotated(sg, 5)
    bad = 0
    for r0, c0 in windows(sg, tr):
        rect = (r0, c0, 32, 32)
        sub = frame.window_scenes(sg, tr, H, W, [rect])[0]
        bad += frame.differing(
            frame.render_rect(sub, tr, li, H, W, rect, lower=True),
            frame.render_rect(sub, tr, li, H, W, rect))
    assert bad > 100


def test_bf16_rounds_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, 3.0e-3], np.float32)
    y = frame.bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0 and y[2] == 1.015625
    assert (y.view(np.uint32) & 0xFFFF == 0).all()


@pytest.mark.parametrize("scale", [1.2, 3.0])
@pytest.mark.parametrize("phong", [True, False])
@pytest.mark.parametrize("tex", [False, True])
def test_vectorised_setup_equals_the_spec_field_by_field(scale, phong, tex):
    """Every field of every triangle bit-equal to the frozen per-triangle
    spec, also where the sphere overflows the frame (top-clipped edges,
    offscreen-top rejects)."""
    sg, tr, li = small_scene(False)
    tr = dict(tr, meters_to_pixels=tr["meters_to_pixels"] * scale / 1.2)
    for k in (0, 7, 100):
        o, _ = rotated([(dict(sg[0][0], p=(0.1, -0.2, 0.3)), {})], k)
        o = o[0][0]
        a = spec.setup_edges(o, tr, li, phong, tex)
        b = frame.setup_edges(o, tr, li, phong, tex)
        assert set(a) == set(b)
        for f in a:
            assert np.array_equal(np.asarray(a[f]).view(np.uint8),
                                  np.asarray(b[f]).view(np.uint8)), f
