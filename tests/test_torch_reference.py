"""The reference path's modules against the JAX package and the NumPy
golden: ``setup_triangles`` (the EdgeTable view), ``concat_edge_tables``,
``pack_records``, ``ops.spans`` (``span_block``), ``ops.raster_reference``
(``rasterize_reference``, ``merge_fragments``) and the G-buffer entry
point on an EdgeTable (``rasterize_gbuffer``).

Bars: bit-exact against the golden (the port contracts no FMA); against
XLA's CPU backend, which contracts a + b * c (golden divergence #8), the
tolerances of tests/test_torch_setup.py and tests/test_torch_gbuffer.py;
bit-exact wherever both packages are fed the same inputs and do no such
arithmetic (packing, integer binning).

This file holds the helpers and the setup, packing and span tests; the
rasterizer's sit in test_torch_reference_raster.py, so that each file
keeps under ten cases and pytest-xdist's ``--dist loadfile`` hands both
out after tests/test_parallel.py, the suite's longest file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer.ops import spans as jsp
from tpu_renderer_torch.geometry import vertex as tvx
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.ops import raster as trp
from tpu_renderer_torch.ops import spans as tsp

from test_torch_render import assert_depth_parity
from torch_threads import one_torch_thread  # noqa: F401

H, W = 96, 128
FIELDS = ("ymin", "ymax", "x0", "xg", "z0", "zg", "oz0", "ozg", "u0", "ug",
          "v0", "vg", "left", "col0", "colg", "n0", "ng")


def scene(config, h=H, w=W):
    """(golden scene, dicts, port (obj, cfg, tr, li), JAX (obj, cfg, tr,
    li)) of baseline config ``config``'s first object."""
    sg, tr_d, li_d = js.baseline_scene(config, h, w)
    sc_t, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    sc_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    return sg, (tr_d, li_d), (*sc_t[0], tr, li), (*sc_j[0], trj, lij)


def assert_gbuffer_parity(cov, gbuf, jcov, jgbuf):
    """tests/test_torch_gbuffer.py's bar against XLA: coverage exact, z
    within the depth budget, every channel within rtol 1e-6 + atol 2.4e-7
    where z agrees."""
    cov, gbuf, jcov, jg = (cov.numpy(), gbuf.numpy(), np.asarray(jcov),
                           np.asarray(jgbuf))
    np.testing.assert_array_equal(cov, jcov)
    assert_depth_parity(gbuf[0], jg[0])
    same_z = cov & (gbuf[0] == jg[0])
    assert same_z.mean() > 0.5 * cov.mean()
    np.testing.assert_allclose(gbuf[:, same_z], jg[:, same_z], rtol=1e-6,
                               atol=2.4e-7)


def jax_edges(port_edges):
    """The port's EdgeTable as JAX arrays."""
    return jvx.EdgeTable(*[jnp.asarray(f.numpy()) for f in port_edges])


def port_edges(jax_edges):
    """JAX's EdgeTable as the port's tensors."""
    return tvx.EdgeTable(*[torch.from_numpy(np.array(f)) for f in jax_edges])


@pytest.mark.parametrize("config", [2, 3, 4])
def test_setup_triangles_vs_golden_and_setup_records(config):
    """Every field bit-exact against the golden's setup_edges (zero where
    the edge is invalid, as the records hold it), and packed, the port's
    own setup_records table."""
    sg, (tr_d, li_d), (obj, cfg, tr, li), _ = scene(config)
    edges = tvx.setup_triangles(obj, tr, li, cfg)
    ge = gold.setup_edges(sg[0][0], tr_d, li_d, phong=cfg.phong,
                          textured=cfg.textured)
    valid = ge["valid"]
    np.testing.assert_array_equal(edges.valid.numpy(), valid)
    for name in FIELDS:
        got = getattr(edges, name).numpy()
        v = valid if got.ndim == 2 else valid[..., None]
        want = np.where(v, ge[name], 0).astype(np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    rec = tvx.setup_records(obj, tr, li, cfg)
    np.testing.assert_array_equal(
        trp.record_table(edges).numpy().view(np.uint32),
        rec.numpy().view(np.uint32))


def test_concat_and_pack_records_vs_jax():
    """concat_edge_tables and pack_records on JAX's own EdgeTables: the
    same (T, 128) records bit for bit, the gid lane the scene order."""
    _, _, _, (oj, cj, trj, lij) = scene(4)
    _, _, _, (oc, cc, _, _) = scene(1)
    je = [jvx.setup_triangles(oj, trj, lij, cj),
          jvx.setup_triangles(oc, trj, lij, cc)]
    want = np.asarray(jrp.pack_records(jvx.concat_edge_tables(je)))
    got = trp.pack_records(tvx.concat_edge_tables(
        [port_edges(e) for e in je])).numpy()
    assert got.shape == want.shape == (2208 + 12, 128)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("tri", [0, 700, 1500])
def test_span_block_vs_jax(tri):
    """span_block of one triangle (fed the same EdgeTable row to both
    packages) over a frame block: the same coverage; interpolants within
    rtol 1e-6 (XLA contracts left + k * inc); batched over a chunk of
    triangles, each row of the batch equal to its own span_block."""
    _, _, (obj, cfg, tr, li), _ = scene(4)
    edges = tvx.setup_triangles(obj, tr, li, cfg)
    rows = torch.arange(H, dtype=torch.float32)
    cols = torch.arange(W, dtype=torch.float32)
    one = tsp.TriangleSlice(*(f[tri] for f in edges))
    got = tsp.span_block(one, rows, cols, W)
    want = jsp.span_block(jsp.TriangleSlice(*(jnp.asarray(f.numpy())
                                              for f in one)),
                          jnp.asarray(rows.numpy()),
                          jnp.asarray(cols.numpy()), W)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = got.mask.numpy()
    for name in ("z", "col", "n", "u", "v", "oz"):
        np.testing.assert_allclose(getattr(got, name).numpy()[m],
                                   np.asarray(getattr(want, name))[m],
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    batch = tsp.span_block(tsp.TriangleSlice(*(f[tri:tri + 5]
                                                for f in edges)),
                           rows, cols, W)
    for name in ("mask", "z", "col", "n"):
        np.testing.assert_array_equal(getattr(batch, name)[0].numpy(),
                                      getattr(got, name).numpy())
