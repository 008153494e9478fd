"""The reference path's rasterizer (``ops.raster_reference``:
``rasterize_reference``, ``merge_fragments``) and the G-buffer entry point
on an EdgeTable against the JAX package and the NumPy golden, with the
bars of tests/test_torch_reference.py's module docstring. (Split from that
file so that each file keeps under ten cases.)"""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_reference import (
    H,
    W,
    assert_gbuffer_parity,
    jax_edges,
    port_edges,
    scene,
)
from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer.ops import raster_reference as jrr
from tpu_renderer_torch.geometry import vertex as tvx
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import raster_reference as trr
from tpu_renderer_torch.ops import spans as tsp
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("config", [1, 3, 4])
def test_rasterize_reference_vs_golden(config):
    """The chunked merge equals the golden's sequential rasterize, every
    channel bit for bit."""
    sg, (tr_d, li_d), (obj, cfg, tr, li), _ = scene(config)
    covered, gbuf = trr.rasterize_reference(
        tvx.setup_triangles(obj, tr, li, cfg), H, W)
    ge = gold.setup_edges(sg[0][0], tr_d, li_d, phong=cfg.phong,
                          textured=cfg.textured)
    gcov, ggbuf = gold.rasterize(ge, H, W)
    np.testing.assert_array_equal(covered.numpy(), gcov)
    np.testing.assert_array_equal(
        gbuf.permute(1, 2, 0).numpy().view(np.uint32),
        ggbuf.astype(np.float32).view(np.uint32))
    assert covered.sum() > 500


def test_rasterize_reference_chunks_equal_merge_fragments():
    """Chunks of any size give the sequential merge_fragments walk's
    G-buffer (the cube's 12 triangles, some chunks holding depth ties)."""
    _, _, (obj, cfg, tr, li), _ = scene(1)
    edges = tvx.setup_triangles(obj, tr, li, cfg)
    rows = torch.arange(H, dtype=torch.float32)
    cols = torch.arange(W, dtype=torch.float32)
    covered, gbuf = trr.empty_gbuffer(H, W, device="cpu")
    for t in range(edges.num_triangles):
        covered, gbuf = trr.merge_fragments(covered, gbuf, tsp.span_block(
            tsp.TriangleSlice(*(f[t] for f in edges)), rows, cols, W))
    for chunk_px in (H * W, 5 * H * W, 1 << 21):
        trr._CHUNK_PX, old = chunk_px, trr._CHUNK_PX
        try:
            c2, g2 = trr.rasterize_reference(edges, H, W)
        finally:
            trr._CHUNK_PX = old
        np.testing.assert_array_equal(c2.numpy(), covered.numpy())
        np.testing.assert_array_equal(g2.numpy().view(np.uint32),
                                      gbuf.numpy().view(np.uint32))


def test_rasterize_reference_vs_jax():
    """Against JAX's scan on the same EdgeTable (assert_gbuffer_parity)."""
    _, _, (obj, cfg, tr, li), _ = scene(4)
    edges = tvx.setup_triangles(obj, tr, li, cfg)
    cov, gbuf = trr.rasterize_reference(edges, H, W)
    jcov, jgbuf = jax.jit(jrr.rasterize_reference, static_argnums=(1, 2))(
        jax_edges(edges), H, W)
    assert_gbuffer_parity(cov, gbuf, jcov, jgbuf)


@pytest.mark.parametrize("config, strategy", [(1, "mask"), (4, "sorted")])
def test_rasterize_gbuffer_on_edge_table_vs_jax(config, strategy):
    """rasterize_gbuffer takes an EdgeTable as rasterize_pallas does: on
    JAX's own EdgeTable, the same stats and assert_gbuffer_parity; and the
    same G-buffer as from the port's setup_records table."""
    _, _, (obj, cfg, tr, li), (oj, cj, trj, lij) = scene(config)
    je = jvx.setup_triangles(oj, trj, lij, cj)
    jcov, jgbuf, jst = jax.jit(functools.partial(
        jrp.rasterize_pallas, height=H, width=W))(je)
    cov, gbuf, st = tgb.rasterize_gbuffer(port_edges(je), H, W)
    assert tgb.prepare_gbuffer(port_edges(je), H, W).route.strategy == (
        strategy)
    for key in ("bins_dropped", "bins_real_entries"):
        if key in jst:
            assert int(st[key]) == int(jst[key]), key
    assert_gbuffer_parity(cov, gbuf, jcov, jgbuf)
    _, gbuf2, _ = tgb.rasterize_gbuffer(
        tvx.setup_triangles(obj, tr, li, cfg), H, W)
    _, gbuf3, _ = tgb.rasterize_gbuffer(
        tvx.setup_records(obj, tr, li, cfg), H, W)
    np.testing.assert_array_equal(gbuf2.numpy(), gbuf3.numpy())
