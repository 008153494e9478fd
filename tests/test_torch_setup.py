"""Port K1 setup (tpu_renderer_torch.ops.setup) vs the JAX package.

Scene: construct_sphere_grid(46, 45) -- 4,140 triangles, above the fused
setup's 4,096 threshold, so the JAX side runs its Pallas kernel (in
interpret mode on the CPU) -- at 128x128 with the baseline_scene(4)
camera and lights. On the CPU the port runs K1's plain version.

Bars:
- against the NumPy golden's edge setup (the spec): every record lane
  bit-exact;
- against JAX's setup_records_fused: lanes valid, ymin, ymax, left and gid
  exact, as are z0, zg, the colors, normals and the zero lanes. Two lanes
  are not exact, both from XLA's CPU backend contracting the projection's
  cx + m2p * (s * x) into an FMA (golden divergence #8), which moves a
  projected endpoint by 1 ulp:
    * x0 (the min-y endpoint's x): held to rtol 1e-6;
    * xg = dx / dy: the 1-ulp endpoint shift is divided by dy, so short,
      near-horizontal edges amplify it (up to ~1% on this mesh). Held to
      rtol 2e-2 here; the golden comparison above holds it bit-exact.
  Under Gouraud the baked color lanes col0 / colg also carry XLA's
  contractions of the light loop: col0 to rtol 1e-6, colg (a difference
  of colors in [0, 1] over the row count) to an absolute 2.4e-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer.geometry import vertex as jvx
from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import binning as jbin
from tpu_renderer.ops import setup_pallas as jsp
from tpu_renderer_torch.geometry import vertex as tvx
from tpu_renderer_torch.models import primitives as tp
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models import sphere as tsm
from tpu_renderer_torch.ops import binning as tbin
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
EDGE_FIELDS = ["valid", "ymin", "ymax", "x0", "xg", "z0", "zg", "oz0", "ozg",
               "u0", "ug", "v0", "vg", "left"]
VEC_FIELDS = (("col0", 14, 4), ("colg", 18, 4), ("n0", 22, 3), ("ng", 25, 3))


def scene_golden(phong=True):
    tr_d, li_d = ts.baseline_camera_lights(H, W)
    mesh = tp.construct_sphere_grid(46, 45)
    return [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": phong})], tr_d, li_d


@pytest.fixture(scope="module", params=[True, False], ids=["phong", "gouraud"])
def case(request):
    phong = request.param
    sg, tr_d, li_d = scene_golden(phong)
    (oj, cj), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    T = oj.num_triangles
    blk = jsp._setup_blk(T)
    jrecs, jbbox = jax.jit(jsp.setup_records_fused,
                           static_argnums=(3, 4, 5, 6, 7))(
        oj, trj, lij, cj, 0, H, W, blk)
    st, trt, lit = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    ot, ct = st[0]
    pre = tsp.setup_for_raster(ot, trt, lit, ct, frame_height=H,
                               frame_width=W)
    return dict(
        phong=phong, T=T, sg=sg, tr_d=tr_d, li_d=li_d,
        jrecs=np.asarray(jrecs), jbbox=[np.asarray(a) for a in jbbox],
        recs=pre.recs.numpy(), bbox=[a.numpy() for a in pre.bbox], pre=pre,
        scene=(ot, ct, trt, lit),
    )


def test_route_reaches_k1(case):
    assert case["T"] == 4140 >= tsp.FUSED_SETUP_MIN
    assert case["pre"].num_triangles == 4140
    assert case["recs"].shape == case["jrecs"].shape == (4608, 128)
    assert tsp._setup_blk(4140) == jsp._setup_blk(4140) == 512


def test_records_bit_exact_vs_golden(case):
    obj_d, cfg_d = case["sg"][0]
    ge = gold.setup_edges(obj_d, case["tr_d"], case["li_d"],
                          phong=case["phong"], textured=False)
    recs = case["recs"][: case["T"]]
    for e in range(3):
        v = ge["valid"][:, e]
        for f, name in enumerate(EDGE_FIELDS):
            want = np.where(v, ge[name][:, e].astype(np.float32), 0)
            got = recs[:, e * 28 + f]
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.astype(np.float32).view(np.uint32),
                                          err_msg=f"edge {e} {name}")
        for name, off, c in VEC_FIELDS:
            want = np.where(v[:, None], ge[name][:, e], 0).astype(np.float32)
            got = recs[:, e * 28 + off:e * 28 + off + c]
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"edge {e} {name}")
    np.testing.assert_array_equal(recs[:, 84], np.arange(case["T"]))


def test_records_vs_jax(case):
    jr, tr_ = case["jrecs"], case["recs"]
    fuzzy = {}
    for e in range(3):
        fuzzy[e * 28 + 3] = 1e-6  # x0
        fuzzy[e * 28 + 4] = 2e-2  # xg
        if not case["phong"]:
            # Gouraud-baked colors: XLA also contracts the light loop's
            # d + t * n and out + d * (base * I).
            for c in range(8):
                fuzzy[e * 28 + 14 + c] = 1e-6
    for lane in range(128):
        a, b = tr_[:, lane], jr[:, lane]
        if lane in fuzzy:
            # colg = (mx - c0) / ydiff of colors in [0, 1]: a 1-ulp color
            # difference is absolute, 2**-23 / ydiff at most.
            atol = 2.4e-7 if 18 <= lane % 28 < 22 else 0
            np.testing.assert_allclose(a, b, rtol=fuzzy[lane], atol=atol,
                                       err_msg=f"lane {lane}")
        else:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32),
                                          err_msg=f"lane {lane}")
    # The named lanes are close to exact on most edges.
    for e in range(3):
        a, b = tr_[:, e * 28 + 3], jr[:, e * 28 + 3]
        assert (a == b).mean() > 0.9


def test_bbox_matches_bbox_core(case):
    """The bbox rows equal the JAX package's _bbox_core on the same record
    lanes: tri_valid / ylo / yhi exact; xlo / xhi to rtol 1e-6 (XLA
    contracts x0 + (ymax - 1 - ymin) * xg)."""
    r = case["recs"]

    def lanes(j):
        return [jax.numpy.asarray(r[:, e * 28 + j]) for e in range(3)]

    want = jbin._bbox_core([l > 0.5 for l in lanes(0)], lanes(1), lanes(2),
                           lanes(3), lanes(4), H, W)
    got = case["bbox"]
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(want[i]))
    for i in (3, 4):
        np.testing.assert_allclose(got[i], np.asarray(want[i]), rtol=1e-6)
    # Padded rows are invalid records and invalid bboxes.
    T = case["T"]
    assert not got[0][T:].any()
    assert (r[T:, [0, 28, 56]] == 0).all()


def test_setup_params_equal(case):
    ot, ct, trt, lit = case["scene"]
    sg, tr_d, li_d = case["sg"], case["tr_d"], case["li_d"]
    (oj, _), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    np.testing.assert_array_equal(
        tsp.setup_params(ot.p, trt, lit).numpy(),
        np.asarray(jsp.setup_params(oj.p, trj, lij)))


@pytest.mark.parametrize("T", [100, 1023, 1024, 4095, 16383, 16384, 10 ** 6])
def test_setup_blk_policy(T):
    assert tsp._setup_blk(T) == jsp._setup_blk(T)


def test_small_objects_raise_until_their_slice():
    """Below FUSED_SETUP_MIN triangles setup_for_raster takes the
    small-object chain and returns the channel-major (85, T) table, as the
    JAX package does, textured objects too (their u/z, v/z and 1/z lanes
    written, which untextured ones leave 0)."""
    sg, tr_d, li_d = scene_golden()
    mesh = tp.construct_sphere_grid(10, 10)  # 200 triangles
    st, trt, lit = ts.to_torch_scene(
        [(dict(p=(0.0, 0.0, 0.0), **mesh), {"phong": True})], tr_d, li_d,
        device="cpu")
    ot, ct = st[0]
    table = tsp.setup_for_raster(ot, trt, lit, ct, gid0=7, frame_height=H,
                                 frame_width=W)
    assert isinstance(table, torch.Tensor) and table.shape == (85, 200)
    np.testing.assert_array_equal(table[84].numpy(), np.arange(7, 207))
    assert not table[7:13].any()
    tex = tsp.setup_for_raster(ot, trt, lit, dataclasses.replace(
        ct, textured=True), frame_height=H, frame_width=W)
    assert tex.shape == (85, 200) and bool(tex[7].any())


# ---------------------------------------------------------------------------
# The small-object chain (geometry.vertex.setup_records), T < 4096
# ---------------------------------------------------------------------------


def small_scene(name):
    """construct_sphere(12) (528 triangles, Phong), config 5's torus
    (1,024, Gouraud) and config 2's teapot (5,428, Gouraud: the chain
    itself has no lower or upper bound)."""
    _, tr_d, li_d = js.baseline_scene(5, 384, 384)
    if name == "sphere12":
        mesh, cfg = tsm.construct_sphere(12), {"phong": True}
    elif name == "torus":
        mesh, cfg = ts.rotate_y(tp.construct_torus(), 0.3), {}
    else:
        mesh, cfg = ts.baseline_scene(2, 384, 384)[0][0][0], {}
        mesh = {k: mesh[k] for k in ("vertices", "colors", "normals", "uvs")}
    return [(dict(p=(0.1, -0.05, 0.2), **mesh), cfg)], tr_d, li_d


@pytest.fixture(scope="module", params=["sphere12", "torus", "teapot"])
def small(request):
    sg, tr_d, li_d = small_scene(request.param)
    (oj, cj), trj, lij = (lambda s: (s[0][0], s[1], s[2]))(
        js.to_jax_scene(sg, tr_d, li_d))
    jrec = np.asarray(jax.jit(jvx.setup_records, static_argnums=(3, 4))(
        oj, trj, lij, cj, 3))
    st, trt, lit = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    ot, ct = st[0]
    rec = tvx.setup_records(ot, trt, lit, ct, gid0=3).numpy()
    return dict(sg=sg, tr_d=tr_d, li_d=li_d, phong=cj.phong, jrec=jrec,
                rec=rec, scene=(ot, ct, trt, lit), jscene=(oj, cj, trj, lij))


def test_setup_records_bit_exact_vs_golden(small):
    obj_d, cfg_d = small["sg"][0]
    ge = gold.setup_edges(obj_d, small["tr_d"], small["li_d"],
                          phong=small["phong"], textured=False)
    rec = small["rec"]
    assert rec.shape == (85, ge["valid"].shape[0]) and rec.dtype == np.float32
    for e in range(3):
        v = ge["valid"][:, e]
        for f, name in enumerate(EDGE_FIELDS):
            want = np.where(v, ge[name][:, e], 0).astype(np.float32)
            np.testing.assert_array_equal(rec[e * 28 + f].view(np.uint32),
                                          want.view(np.uint32),
                                          err_msg=f"edge {e} {name}")
        for name, off, c in VEC_FIELDS:
            want = np.where(v[:, None], ge[name][:, e], 0).astype(np.float32)
            np.testing.assert_array_equal(
                rec[e * 28 + off:e * 28 + off + c].T.view(np.uint32),
                want.view(np.uint32), err_msg=f"edge {e} {name}")
    np.testing.assert_array_equal(rec[84], np.arange(rec.shape[1]) + 3)


def test_setup_records_vs_jax(small):
    """Against JAX's XLA chain: the lanes K1's test names (x0 rtol 1e-6,
    xg rtol 2e-2, Gouraud col0 rtol 1e-6 / colg atol 2.4e-7, all from XLA's
    FMA contraction, golden divergence #8) and every other lane exact."""
    jr, tr_ = small["jrec"], small["rec"]
    assert jr.shape == tr_.shape
    for lane in range(85):
        a, b = tr_[lane], jr[lane]
        e, f = divmod(lane, 28)
        rtol = {3: 1e-6, 4: 2e-2}.get(f)
        if not small["phong"] and lane < 84 and 14 <= f < 22:
            rtol = 1e-6
        if rtol is None or lane == 84:
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32),
                                          err_msg=f"lane {lane}")
        else:
            atol = 2.4e-7 if 18 <= f < 22 else 0
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"lane {lane}")


def test_setup_records_equals_k1_plain_rows(small):
    """The chain and K1's plain version share setup_fields: the K1 table's
    first T rows, transposed, are the chain's table."""
    ot, ct, trt, lit = small["scene"]
    T = ot.num_triangles
    recs, bbox = tsp.setup_plain(
        tvx.setup_params(ot.p, trt, lit), ot.vertices, ot.colors, ot.normals,
        n_lights=lit.count, phong=ct.phong, gid0=3, frame_height=384,
        frame_width=384, tp=T + 5)
    np.testing.assert_array_equal(recs[:T, :85].t().numpy(), small["rec"])
    want = tbin.triangle_bbox_rows(torch.from_numpy(small["rec"]), 384, 384)
    for got, w in zip([bbox[0][:T] > 0.5] + list(bbox[1:5, :T]), want):
        np.testing.assert_array_equal(got.numpy(), w.numpy())


def test_vertex_helpers_vs_jax(small):
    """project_vertices / backface_visible / gouraud_vertex_colors on the
    (T, 3v, 3c) layout: the projection bit-exact against the NumPy
    golden's; all three within rtol 1e-6 of JAX, or 0.5% of the culling
    bits (XLA contracts cx + m2p * (s * x) and the unrolled dots)."""
    ot, ct, trt, lit = small["scene"]
    oj, cj, trj, lij = small["jscene"]
    cam_t = (ot.vertices + ot.p[:, None, None]).permute(2, 1, 0)
    cam_j = jnp.transpose(oj.vertices + oj.p[:, None, None], (2, 1, 0))
    proj_t = tvx.project_vertices(cam_t, trt)
    proj_j = jvx.project_vertices(cam_j, trj)
    np.testing.assert_allclose(proj_t.numpy(), np.asarray(proj_j), rtol=1e-6)
    np.testing.assert_array_equal(
        proj_t.numpy(), gold.project_vertex(cam_t.numpy(), small["tr_d"]))
    vis_t = tvx.backface_visible(proj_t).numpy()
    vis_j = np.asarray(jvx.backface_visible(proj_j))
    assert (vis_t == vis_j).mean() > 0.995
    cols_t = ot.colors.permute(2, 1, 0)
    nrm_t = ot.normals.permute(2, 1, 0)
    g_t = tvx.gouraud_vertex_colors(cols_t, nrm_t, cam_t, lit, False)
    g_j = jvx.gouraud_vertex_colors(
        jnp.transpose(oj.colors, (2, 1, 0)),
        jnp.transpose(oj.normals, (2, 1, 0)), cam_j, lij, False)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-7)
    tex = tvx.gouraud_vertex_colors(cols_t, nrm_t, cam_t, lit, True)
    tex_j = jvx.gouraud_vertex_colors(
        jnp.transpose(oj.colors, (2, 1, 0)),
        jnp.transpose(oj.normals, (2, 1, 0)), cam_j, lij, True)
    np.testing.assert_allclose(tex.numpy(), np.asarray(tex_j), rtol=1e-6,
                               atol=1e-7)
