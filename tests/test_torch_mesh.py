"""The port's sharded rendering (tpu_renderer_torch.parallel.mesh) on four
gloo ranks on the CPU, against the port's unsharded render_scene and, for
config 5, against the JAX package's unsharded frame.

The ranks are spawned once for the whole file through the port's own
helpers (``entry.run_ranks`` with ``entry.mesh_frames``), each
single-threaded on the kernels' plain versions, at tests/test_parallel.py's
64x512. Every sharded frame, each rank's own rect and the gathered whole,
must be bit-equal to the unsharded one: the tiles share no pixel, and the
folds keep the submission order (the 'tr' and 'obj' cases draw through the
G-buffer path and ``shade``, the unsharded frame through the fused
kernels, and the two agree bit for bit).

The JAX case holds the gathered tiled and object-sharded config 5 frames
to the JAX package's jitted Renderer(backend="pallas") with
tests/test_parity_jax.py's budgets (XLA's CPU backend contracts FMAs,
golden divergence #8). JAX's own sharded frames are held to its unsharded
ones by tests/test_parallel.py, which is not repeated here.

At most nine cases, so that pytest-xdist's ``--dist loadfile`` hands this
file out after tests/test_parallel.py, the suite's longest file.
"""

import numpy as np
import pytest

from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.models import scenes as js
from tpu_renderer_torch import entry
from tpu_renderer_torch.engine.renderer import render_scene
from torch_threads import one_torch_thread  # noqa: F401

H, W = 64, 512
RANKS = 4
CASES = (
    ("tiled config1", "tiled", (2, 2), ("ty", "tx"), "config1", "kernels"),
    ("tiled config5", "tiled", (2, 2), ("ty", "tx"), "config5", "kernels"),
    ("geometry kernels", "geometry", (2, 1, 2), ("tr", "ty", "tx"),
     "config1", "kernels"),
    ("geometry reference", "geometry", (2, 1, 2), ("tr", "ty", "tx"),
     "config1", "reference"),
    ("2level", "2level", (2, 2), ("host", "ty"), "config1", "kernels"),
    # Five overlapping spheres over four ranks: a group of five pads to
    # eight slots, two a rank, so rank 3 draws nothing and rank 2 one.
    ("object spheres5", "object", (4,), ("obj",), "spheres5", "kernels"),
    # Each of the five twice, Gouraud then Phong: two groups, drawn group
    # after group on each rank, and a depth tie on every pixel of a twin.
    ("object twins5", "object", (4,), ("obj",), "twins5", "kernels"),
    ("object config5", "object", (2, 2), ("obj", "ty"), "config5",
     "kernels"),
)
SPEC = {c[0]: c for c in CASES}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's {case: (local frame, whole frame, render ms, gather ms,
    launches)}."""
    return entry.run_ranks(entry.mesh_frames, RANKS,
                           tuple(c + (H, W) for c in CASES), device="cpu")


def unsharded(scene_name):
    """The port's unsharded frame on its default backend, 'kernels' (the
    'reference' backend renders the same bits)."""
    scene, tr, li = entry.scene_by_name(scene_name, H, W, "cpu")
    fb = render_scene(None, scene, tr, li, "kernels", H, W)
    return entry.host_frame(fb)


def assert_bits(got, want, what):
    diff = entry.frame_difference(got, want)
    assert diff is None, f"{what}: {diff}"


def assert_case(ranks, name):
    """Every rank's rect is its crop of the unsharded frame, and every
    rank's whole frame is the unsharded frame, bit for bit."""
    _, _, shape, names, scene_name, _ = SPEC[name]
    want = unsharded(scene_name)
    dims = dict(zip(names, shape))
    lh, lw = H // dims.get("ty", 1), W // dims.get("tx", 1)
    for rank, frames in enumerate(ranks):
        local, full, _, _, launches = frames[name]
        coord = dict(zip(names, np.unravel_index(rank, shape)))
        r0, c0 = coord.get("ty", 0) * lh, coord.get("tx", 0) * lw
        crop = tuple(p[r0:r0 + lh, c0:c0 + lw] for p in want)
        assert_bits(local, crop, f"{name}, rank {rank}'s rect")
        assert_bits(full, want, f"{name}, rank {rank}'s whole frame")
        # On the CPU every wrapper runs its plain version: no launch.
        assert not any(launches.values()), launches
    assert int((want[1] > -3.0e38).sum()) > 0


@pytest.mark.parametrize("config", [1, 5])
def test_tiled_matches_unsharded(ranks, config):
    assert_case(ranks, f"tiled config{config}")


@pytest.mark.parametrize("backend", ["kernels", "reference"])
def test_geometry_sharded_matches_unsharded(ranks, backend):
    assert_case(ranks, f"geometry {backend}")


def test_2level_host_mesh_matches_unsharded(ranks):
    assert_case(ranks, "2level")


def test_object_sharded_overlapping_spheres(ranks):
    """Padding slots: same-config spheres in one group, dealt out two a
    rank. Ties: with each sphere submitted twice in two configs, a rank
    draws the Phong twin after a later Gouraud sphere, and the key-aware
    merge must still give every tie to the first twin."""
    assert_case(ranks, "object spheres5")
    assert_case(ranks, "object twins5")


def test_object_sharded_with_tiles_config5(ranks):
    """Config 5's mixed Phong, Gouraud and textured objects group by
    config over ('obj', 'ty')."""
    assert_case(ranks, "object config5")


def test_gather_framebuffer_assembles_the_tiles(ranks):
    """The tiled ranks return disjoint rects that tile the frame, and
    gather_framebuffer gives every rank the same whole frame."""
    locals_ = [frames["tiled config5"][0] for frames in ranks]
    assert {c.shape for c, _ in locals_} == {(H // 2, W // 2)}
    top = np.concatenate([locals_[0][0], locals_[1][0]], axis=1)
    bottom = np.concatenate([locals_[2][0], locals_[3][0]], axis=1)
    whole = np.concatenate([top, bottom], axis=0)
    for frames in ranks:
        np.testing.assert_array_equal(frames["tiled config5"][1][0], whole)
    np.testing.assert_array_equal(whole, unsharded("config5")[0])


def test_config5_frames_match_jax(ranks):
    """The gathered tiled and object-sharded config 5 frames against the
    JAX package's unsharded frame: coverage exact, color mismatch <= 0.2%,
    depth within rtol 1e-6 on >= 99.5% of covered pixels."""
    sg, tr_d, li_d = js.baseline_scene(5, H, W)
    scene_j, tr, li = js.to_jax_scene(sg, tr_d, li_d)
    jfb = JRenderer(H, W, backend="pallas").render(scene_j, tr, li)
    jc, jd = np.asarray(jfb.color), np.asarray(jfb.depth)
    cov = jd > -3.0e38
    for name in ("tiled config5", "object config5"):
        color, depth = ranks[0][name][1]
        np.testing.assert_array_equal(depth > -3.0e38, cov)
        assert 1.0 - (color == jc).mean() <= 0.002, name
        ok = (depth == jd) | np.isclose(depth, jd, rtol=1e-6, atol=0.0)
        assert 1.0 - ok[cov].mean() <= 0.005, name
