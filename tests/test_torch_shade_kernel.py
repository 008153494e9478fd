"""The deferred shade's kernel (``deferred_shade_kernel``, csrc/shade.cu)
against its plain chain on the card, bit for bit: ``shade_merge`` on CUDA
tensors against ``shade_merge_plain`` (``shade`` -> ``pack_argb`` -> the
strict '>' merge) on the same tensors, over Phong and Gouraud, every
texture mode, 0 to 2 lights, an odd width (the 4-pixel tail) and one that
takes 16-byte rows, a fresh frame and a prior framebuffer with equal and
greater depths, on G-buffers rasterized by K9 + K10 off the frame's origin
with planted NaN, infinities and u, v outside [0, 1] (``shade_cases``);
and one deferred ``render_object`` counts one launch.

Every test here needs an NVIDIA GPU and skips without one. The file
imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_shade_kernel.py
"""

import pytest
import torch

import shade_cases as sc
from tpu_renderer_torch.engine import renderer as er
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import shading as tsh

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits(fb):
    return fb.color.view(torch.int32), fb.depth.view(torch.int32)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "prior"])
@pytest.mark.parametrize("width", sc.WIDTHS)
@pytest.mark.parametrize("n_lights", [0, 1, 2])
@pytest.mark.parametrize("tex_mode", list(sc.TEX_MODES))
@pytest.mark.parametrize("phong", [True, False], ids=["phong", "gouraud"])
def test_kernel_equals_plain_chain(cuda, phong, tex_mode, n_lights, width,
                                   fresh):
    covered, gbuf, tr, li, tex, prior = sc.case(phong, width, n_lights, cuda)
    cfg = sc.config(phong, tex_mode)
    fb = None if fresh else prior
    before = tsh.shade_merge.launches
    got = tsh.shade_merge(covered, gbuf, tr, li, cfg, tex, sc.ROW0, sc.COL0,
                          fb)
    torch.cuda.synchronize()
    assert tsh.shade_merge.launches == before + 1
    want = tsh.shade_merge_plain(covered, gbuf, tr, li, cfg, tex, sc.ROW0,
                                 sc.COL0, fb)
    assert got.color.dtype == torch.uint32 and got.color.is_cuda
    for g, w in zip(bits(got), bits(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_deferred_render_object_launches_once(cuda):
    """One G-buffer draw ('avx', so the fused path cannot take it) is one
    launch of the deferred shade, and its frame is the CPU run's."""
    tr_d, li_d = ts.camera_for(96, 128), ts.default_lights()
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_quad(1.0)),
           dict(phong=True, texture=checkerboard(16, 16, 4), uv_mode="avx"))]
    frames = []
    for dev in (cuda, torch.device("cpu")):
        scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=dev)
        (obj, cfg), = scene
        before = tsh.shade_merge.launches
        frames.append(er.render_object(None, obj, tr, li, cfg, "kernels", 96,
                                       128))
        assert tsh.shade_merge.launches == before + (dev.type == "cuda")
    torch.cuda.synchronize()
    for g, w in zip(bits(frames[0]), bits(frames[1])):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_deferred_over_a_fused_frame(cuda):
    """A scene of a fused sphere and an 'avx' quad at a width off the
    128-column tiles: the quad's shade merges over the fused draw's
    frame, a crop of its padded planes, and the frame is the CPU run's."""
    tr_d, li_d = ts.camera_for(90, 100), ts.default_lights()
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_sphere_grid(12, 11)),
           dict(phong=True)),
          (dict(p=(0.0, 0.0, 0.0), **tp.construct_quad(1.4)),
           dict(phong=True, texture=checkerboard(16, 16, 4), uv_mode="avx"))]
    frames = []
    for dev in (cuda, torch.device("cpu")):
        scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device=dev)
        before = tsh.shade_merge.launches
        frames.append(er.render_scene(None, scene, tr, li, "kernels", 90,
                                      100))
        assert tsh.shade_merge.launches == before + (dev.type == "cuda")
    torch.cuda.synchronize()
    for g, w in zip(bits(frames[0]), bits(frames[1])):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
