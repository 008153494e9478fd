"""The port's G-buffer path (``ops.gbuffer``: K8, K9, K10's plain
versions; ``ops.shading.shade``; the G-buffer branch of ``render_object``)
against the JAX package and the NumPy golden.

Scenes come from the suite's ``baseline_scene`` and the route scenes of
``tpu_renderer_torch/models/route_scenes.py`` (NumPy, deterministic). The
JAX side runs jitted, its Pallas kernels in interpret mode as its own
tests run them: ``rasterize_pallas`` on its own setup's table, ``shade``,
and ``Renderer(backend="pallas")``; the port runs its kernels' plain
versions.

Bars:
- ``rasterize_gbuffer`` against ``rasterize_pallas``, both on JAX's own
  setup table (the raster stage alone; tests/test_pallas.py:67):
  coverage exact, depth equal or within rtol 1e-6 on >= 99.5% of pixels,
  and where z agrees every attribute channel within rtol 1e-6 + atol
  2.4e-7 (XLA's CPU backend contracts al + k * inc into an FMA, golden
  divergence #8: up to 6.5% of a Gouraud colour channel differs by about
  1e-7); binning counts equal, budget utilization within 1 ulp (XLA turns
  the division by the static budget into a product with its reciprocal).
  Against ``gold.rasterize`` per object, on the port's own setup: coverage
  and every channel bit-exact.
- ``shade`` on JAX's own G-buffer: bit-exact against ``gold.shade``;
  against JAX's ``shade`` coverage exact, packed colour mismatch <= 0.2%.
- Frames: against the golden bit-exact; against JAX the budgets of
  tests/test_parity_jax.py (colour mismatch <= 0.2%, depth within rtol
  1e-6 on >= 99.5% of pixels; 'avx' coverage follows u, v at 1 +- 1 ulp).

JAX's interpret-mode compiles set these files' time, so each is made once
and only where it adds a route: the G-buffer cases hold JAX on the mask
strategy at 16 and 8 rows and the sorted one at 8 and 16 rows with the
side list (every case against the golden), the shade cases reuse config
3's G-buffer, and the sphere frame is the mixed frame's G-buffer object.

This file holds the helpers, the cases and their routes; the tests sit in
files of at most nine cases, which pytest-xdist's ``--dist loadfile``
hands out after tests/test_parallel.py, the suite's longest file:
test_torch_gbuffer_golden.py and test_torch_gbuffer_jax.py (the cases
against the golden and JAX), test_torch_gbuffer_shade.py (shade),
test_torch_gbuffer_knobs.py (tile height, capacity, sub-rects, 'avx'
sampling, fused against deferred), test_torch_gbuffer_frames.py and
test_torch_gbuffer_frames_jax.py (frames through Renderer).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_renderer.golden import cpu_reference as gold
from tpu_renderer.models import scenes as js
from tpu_renderer.ops import setup_pallas as jsp
from tpu_renderer.ops.raster_pallas import rasterize_pallas
from tpu_renderer_torch.models import scenes as ts
from tpu_renderer_torch.models.route_scenes import route_scene
from tpu_renderer_torch.ops import gbuffer as tgb
from tpu_renderer_torch.ops import setup as tsp
from torch_threads import one_torch_thread  # noqa: F401

H = W = 128
J_SETUP = jax.jit(jsp.setup_for_raster, static_argnums=(3, 4, 5, 6))
J_RASTER = jax.jit(rasterize_pallas, static_argnums=(1, 2, 3, 4, 5, 8))


def scene_of(name):
    """(scene_golden, (h, w)) of a case: 'configN' at 128x128, else a
    route scene 'name' or 'name-variant'."""
    if name.startswith("config"):
        return js.baseline_scene(int(name[-1]), H, W)[0], (H, W)
    return route_scene(*name.split("-"))


def port_table(sg, h, w):
    """The port's setup of the scene's first object on the CPU: (table,
    (obj, cfg), transform, lights)."""
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    obj, cfg = scene[0]
    table = tsp.setup_for_raster(obj, tr, li, cfg, frame_height=h,
                                 frame_width=w)
    return table, scene[0], tr, li


def jax_gbuffer(sg, h, w, strategy="auto"):
    """JAX's setup and rasterize_pallas on the scene's first object ->
    ((covered, gbuf (11, H, W), stats) as NumPy, JAX's setup table as the
    port's: a SetupOut or the channel-major tensor)."""
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    obj, cfg = scene_j[0]
    table = J_SETUP(obj, trj, lij, cfg, 0, h, w)
    cov, gbuf, stats = J_RASTER(table, h, w, None, h, w, 0, 0, strategy)
    if isinstance(table, jsp.SetupOut):
        ttable = tsp.SetupOut(torch.tensor(np.asarray(table.recs)),
                              [torch.tensor(np.asarray(a))
                               for a in table.bbox], table.num_triangles)
    else:
        ttable = torch.tensor(np.asarray(table))
    return (np.asarray(cov), np.asarray(gbuf),
            {k: np.asarray(v) for k, v in stats.items()}), ttable


def golden_gbuffer(sg, h, w):
    """gold.rasterize of the scene's first object -> (covered, gbuf
    (11, H, W))."""
    obj_d, cfg_d = sg[0]
    tr_d, li_d = ts.baseline_camera_lights(h, w)
    edges = gold.setup_edges(obj_d, tr_d, li_d,
                             phong=bool(cfg_d.get("phong", False)),
                             textured=cfg_d.get("texture") is not None)
    cov, gbuf = gold.rasterize(edges, h, w)
    return cov, np.ascontiguousarray(gbuf.transpose(2, 0, 1))


# ---------------------------------------------------------------------------
# rasterize_gbuffer
# ---------------------------------------------------------------------------

RASTER_CASES = {  # case -> (scene, strategy, (strategy, tile_h) taken)
    "config3-mask": ("config3", "mask", ("mask", 16)),
    "config3-sorted": ("config3", "sorted", ("sorted", 16)),
    "config4-mask": ("config4", "mask", ("mask", 8)),
    "config4-sorted": ("config4", "sorted", ("sorted", 8)),
    "k3": ("k3", "auto", ("sorted", 8)),
    "k3-sidelist": ("k3-sidelist", "auto", ("sorted", 8)),
    "k4": ("k4", "auto", ("sorted", 16)),
    "k4-sidelist": ("k4-sidelist", "auto", ("sorted", 16)),
}
# Against JAX: each strategy and tile height once, the sorted ones with
# the side list (K10) beside the stream.
JAX_CASES = ["config3-mask", "config4-mask", "k3-sidelist", "k4-sidelist"]


@functools.lru_cache(maxsize=None)
def jax_case(case):
    """JAX's G-buffer of a case, and the port's on JAX's table."""
    name, strategy, _ = RASTER_CASES[case]
    sg, (h, w) = scene_of(name)
    jout, jtable = jax_gbuffer(sg, h, w, strategy)
    cov, gbuf, stats = tgb.rasterize_gbuffer(jtable, h, w, strategy=strategy)
    return jout, (cov.numpy(), gbuf.numpy(), stats)


@pytest.fixture(scope="module", params=list(RASTER_CASES))
def gcase(request):
    name, strategy, route = RASTER_CASES[request.param]
    sg, (h, w) = scene_of(name)
    table, _, _, _ = port_table(sg, h, w)
    launch = tgb.prepare_gbuffer(table, h, w, strategy=strategy)
    cov, gbuf, stats = tgb.rasterize_gbuffer(table, h, w, strategy=strategy)
    return dict(name=request.param, route=route, launch=launch,
                port=(cov.numpy(), gbuf.numpy(), stats),
                gold=golden_gbuffer(sg, h, w))


def test_gbuffer_route(gcase):
    """The route JAX's rasterize_pallas takes: one stream at every tile
    height (no row packing), K9 with the side list on the side-list
    scenes, K8 on the mask strategy."""
    r = gcase["launch"].route
    assert (r.strategy, r.tile_h, r.rows) == gcase["route"] + (1,)
    assert gcase["launch"].kernel is (
        tgb.raster_pass if r.strategy == "mask" else tgb.raster_pass_queue)
    n_large = int(gcase["launch"].qbins.n_large)
    assert (n_large > 0) == gcase["name"].endswith("sidelist")
    assert gcase["port"][0].sum() > 1000
