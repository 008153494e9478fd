"""The port's golden package against the JAX package's, and chip_smoke's
golden windows against the whole golden frame.

- ``tpu_renderer_torch.golden.cpu_reference`` is a copy of the NumPy spec:
  bit-equal to ``tpu_renderer.golden.cpu_reference`` on configs 1-5;
- ``aet_reference`` is a copy of the model-level AET walk;
- ``golden.native`` builds ``tpu_renderer_torch/native/golden.cpp`` under
  ``tpu_renderer_torch/_build/`` with the JAX binding's flags, so it
  renders bit for bit as a library of the JAX package's source built with
  those flags (skipped where there is no g++, as tests/test_native.py
  is);
- ``chip_smoke.window_scene`` picks the triangles whose projected bbox
  meets a window; their golden equals the whole scene's in every window.
"""

import importlib.util
import os

import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401

from tpu_renderer.golden import aet_reference as aet_jax
from tpu_renderer.golden import cpu_reference as gold_jax
from tpu_renderer.models import scenes as scenes_jax
from tpu_renderer_torch.golden import aet_reference as aet
from tpu_renderer_torch.golden import cpu_reference as gold
from tpu_renderer_torch.golden import native
from tpu_renderer_torch.models import primitives as prim
from tpu_renderer_torch.models import scenes
from tpu_renderer_torch.models.sphere import construct_sphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE_SRC = os.path.join(ROOT, "tpu_renderer", "native", "golden.cpp")
needs_gxx = pytest.mark.skipif(not native.available(), reason="no g++")


def assert_bits_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_spec_equals_jax_spec(config):
    sg, tr, li = scenes_jax.baseline_scene(config, 128, 128)
    sg_p, tr_p, li_p = scenes.baseline_scene(config, 128, 128)
    got = gold.render(sg_p, tr_p, li_p, 128, 128)
    assert_bits_equal(got, gold_jax.render(sg, tr, li, 128, 128))
    assert (got[1] > gold.DEPTH_CLEAR).sum() > 500


def test_aet_equals_jax_aet():
    sg, tr, li = scenes.baseline_scene(1, 64, 64)
    got = aet.render(sg, tr, li, 64, 64)
    assert_bits_equal(got, aet_jax.render(sg, tr, li, 64, 64))
    assert (got[1] > gold.DEPTH_CLEAR).sum() > 100


def _files(root):
    return {os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d}


@needs_gxx
def test_native_equals_jax_native(tmp_path):
    """The port's library, built under tpu_renderer_torch/_build/ and
    keyed by the host's CPU, renders config 5 as a library of the JAX
    package's own source does; building it writes nothing under
    tpu_renderer/.

    The JAX package's source is built here into this test's own
    directory, never through ``tpu_renderer.golden.native``: that module
    builds ``tpu_renderer/native/libgolden.so`` in place at its first
    use and keeps its first error for the life of the process, so with
    six test workers collecting tests/test_native.py at once, a worker
    that loads the file while another is still writing it cannot render
    with it at all."""
    sg, tr, li = scenes.baseline_scene(5, 128, 128)
    before = _files(os.path.join(ROOT, "tpu_renderer"))
    got = native.render(sg, tr, li, 128, 128)
    jax_lib = native.build(JAX_NATIVE_SRC, tmp_path)
    want = native.render(sg, tr, li, 128, 128,
                         library=native.open_library(jax_lib))
    assert _files(os.path.join(ROOT, "tpu_renderer")) == before
    lib = native.library_path()
    assert lib.exists() and lib.parent == native.BUILD_DIR
    assert lib.parent.parent.name == "tpu_renderer_torch"
    assert jax_lib.parent == tmp_path and jax_lib != lib
    assert_bits_equal(got, want)
    assert (got[1] > gold.DEPTH_CLEAR).sum() > 500


@needs_gxx
def test_native_thread_count_does_not_change_output():
    sg, tr, li = scenes.baseline_scene(5, 128, 128)
    assert_bits_equal(native.render(sg, tr, li, 128, 128, num_threads=4),
                      native.render(sg, tr, li, 128, 128, num_threads=1))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_golden_windows_equal_whole_frame():
    """The windows' sub-scene renders the whole frame inside each window:
    on a 39,480-triangle sphere grid at 256x256 (windows placed as on the
    card: the centre, the silhouette, drawn ones), and on two coincident
    spheres, Gouraud then Phong (a depth tie on every pixel, the first
    object winning), half off the frame's left edge, where spans off the
    frame land on column 0 (windows there and at the frame's corners)."""
    cs = _chip_smoke()
    h = w = 256
    tr, li = scenes.baseline_camera_lights(h, w)
    m = construct_sphere(12)
    twins = [(dict(p=(-1.2, 0.3, 0.0), **m), {}),
             (dict(p=(-1.2, 0.3, 0.0), **m), {"phong": True})]
    for sg, edges in (
            (cs.phong_mesh_scene(prim.construct_sphere_grid(141, 140)), False),
            (twins, True)):
        want = gold.render(sg, tr, li, h, w)
        covered = want[1] > gold.DEPTH_CLEAR
        windows = cs.place_windows(covered, 6, 13)
        if edges:
            r0 = int(np.nonzero(covered[:, 0])[0].mean()) - cs.WINDOW // 2
            windows += [(r0, 0), (0, 0), (h - cs.WINDOW, w - cs.WINDOW)]
        color, depth, counts = cs.golden_windows(sg, tr, li, h, w, windows)
        total = sum(len(o["vertices"]) // 3 for o, _ in sg)
        assert 0 < max(counts) < total, counts
        n_cov = 0
        for r0, c0 in windows:
            win = (slice(r0, r0 + cs.WINDOW), slice(c0, c0 + cs.WINDOW))
            assert_bits_equal((color[win], depth[win]),
                              (want[0][win], want[1][win]))
            n_cov += int(covered[win].sum())
        assert n_cov > 2000, n_cov
    # The twins: the first (Gouraud) object wins every tie, and their
    # spans off the frame's left edge cover column 0.
    alone = gold.render(twins[:1], tr, li, h, w)
    assert_bits_equal(want, alone)
    assert covered[:, 0].sum() > 50
