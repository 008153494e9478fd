"""The deferred shade's wrapper on the CPU (``ops.shading.shade_merge``):
CPU tensors take the plain chain, ``shade`` -> ``pack_argb`` -> the strict
'>' merge (``engine.renderer._merge_into``), over every Phong flag,
texture mode and light count the kernel takes, a fresh frame and a prior
framebuffer, on a G-buffer with planted NaN, infinities and u, v outside
[0, 1] (``shade_cases``); the 'reference' backend keeps the plain chain.
``test_torch_shade_kernel.py`` holds the kernel to the same chain on the
card."""

import pytest
import torch

import shade_cases as sc
from tpu_renderer_torch import _cuda
from tpu_renderer_torch.core.math import pack_argb
from tpu_renderer_torch.core.types import (
    DEPTH_CLEAR,
    ObjectConfig,
    make_framebuffer,
)
from tpu_renderer_torch.engine import renderer as er
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import shading as tsh
from torch_threads import one_torch_thread  # noqa: F401


def bits(fb):
    return fb.color.view(torch.int32), fb.depth.view(torch.int32)


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "prior"])
@pytest.mark.parametrize("width", sc.WIDTHS)
@pytest.mark.parametrize("n_lights", [0, 1, 2])
@pytest.mark.parametrize("tex_mode", list(sc.TEX_MODES))
@pytest.mark.parametrize("phong", [True, False], ids=["phong", "gouraud"])
def test_shade_merge_is_the_plain_chain_on_cpu(phong, tex_mode, n_lights,
                                               width, fresh):
    covered, gbuf, tr, li, tex, prior = sc.case(phong, width, n_lights,
                                                "cpu")
    cfg = sc.config(phong, tex_mode)
    fb = None if fresh else prior
    got = tsh.shade_merge(covered, gbuf, tr, li, cfg, tex, sc.ROW0, sc.COL0,
                          fb)
    rgba, cov = tsh.shade(covered, gbuf, tr, li, cfg, tex, sc.ROW0, sc.COL0)
    base = (make_framebuffer(sc.HEIGHT, width, device="cpu") if fresh
            else prior)
    want = er._merge_into(base, cov, gbuf[0], pack_argb(rgba))
    assert got.color.dtype == torch.uint32
    assert got.depth.dtype == torch.float32
    for g, w in zip(bits(got), bits(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    won = cov & (gbuf[0] > base.depth)
    assert 0 < int(won.sum()) < int(covered.sum())
    if fresh:  # the clear values where nothing won
        assert (got.color.view(torch.int32)[~won] == 0).all()
        assert (got.depth[~won] == DEPTH_CLEAR).all()
    else:  # equal depths keep the prior pixel
        tie = covered & (gbuf[0] == prior.depth)
        assert int(tie.sum()) > 0
        assert torch.equal(got.color.view(torch.int32)[tie],
                           prior.color.view(torch.int32)[tie])


@pytest.mark.parametrize("uv_mode, filter_mode, mode", [
    ("scalar", "nearest", 1), ("scalar", "bilinear", 2), ("avx", "nearest", 3),
    ("avx", "bilinear", 4), ("other", "bilinear", 2),
    ("other", "nearest", None), ("scalar", "other", None)])
def test_tex_mode_follows_sample_texture(uv_mode, filter_mode, mode):
    """The kernel's texture mode of each config, and sample_texture's
    ValueError for a mode it does not know (bilinear reads no uv_mode but
    'avx')."""
    cfg = ObjectConfig(textured=True, uv_mode=uv_mode,
                       filter_mode=filter_mode)
    assert tsh._tex_mode(ObjectConfig(phong=True)) == 0
    if mode is None:
        with pytest.raises(ValueError):
            tsh._tex_mode(cfg)
        u = torch.zeros((2, 2))
        with pytest.raises(ValueError):
            tsh.sample_texture(torch.zeros((4, 4), dtype=torch.int32), u, u,
                               uv_mode, filter_mode)
    else:
        assert tsh._tex_mode(cfg) == mode


@pytest.mark.parametrize("view, ok", [
    (lambda t: t[:, :5, :7], True), (lambda t: t[:, :5, :7].double(), False),
    (lambda t: t[:, :7, :5].transpose(1, 2), False),
    (lambda t: t[:2, :5, :7], False)])
def test_check_rows_takes_crops_of_padded_planes(view, ok):
    """The kernel's inputs may be crops of padded planes, rows contiguous;
    another dtype, shape or a strided row raises."""
    t = view(torch.zeros((11, 9, 12)))
    if ok:
        _cuda.check_rows("gbuf", t, torch.device("cpu"), torch.float32,
                         (11, 5, 7))
    else:
        with pytest.raises(ValueError):
            _cuda.check_rows("gbuf", t, torch.device("cpu"), torch.float32,
                             (11, 5, 7))


def _deferred_scene():
    """A textured quad the fused path cannot take ('avx'), on the CPU."""
    from tpu_renderer_torch.models import primitives as tp

    tr_d, li_d = ts.camera_for(40, 56), ts.default_lights()
    sg = [(dict(p=(0.0, 0.0, 0.0), **tp.construct_quad(1.0)),
           dict(phong=True, texture=checkerboard(16, 16, 4), uv_mode="avx"))]
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    return scene[0], tr, li


@pytest.mark.parametrize("backend, plain", [("kernels", False),
                                            ("reference", True)])
def test_draw_deferred_backend_picks_the_shade(monkeypatch, backend, plain):
    """The G-buffer draw calls ``shade_merge`` on the 'kernels' backend
    and the plain chain, explicitly, on 'reference', over a fresh frame and
    over a prior one, where the nearer pixel stays."""
    (obj, cfg), tr, li = _deferred_scene()
    calls = []

    def spy(name, fn):
        def wrapped(*args):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(er, name, wrapped)
    spy("shade_merge", tsh.shade_merge)
    spy("shade_merge_plain", tsh.shade_merge_plain)
    prior = er.render_object(None, obj, tr, li, ObjectConfig(phong=True),
                             backend, 40, 56)
    calls.clear()
    fb = er.render_object(None, obj, tr, li, cfg, backend, 40, 56)
    assert calls == ["shade_merge_plain" if plain else "shade_merge"]
    assert int((fb.depth > DEPTH_CLEAR).sum()) > 0
    calls.clear()
    over = er.render_object(prior, obj, tr, li, cfg, backend, 40, 56)
    assert calls == ["shade_merge_plain" if plain else "shade_merge"]
    assert torch.equal(over.depth, torch.maximum(prior.depth, fb.depth))
