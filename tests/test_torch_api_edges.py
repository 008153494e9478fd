"""The port's API edges against the JAX package: ``Renderer`` called by
JAX's positions (``device`` after them), ``geometry.transform.
translate_object``, ``core.math.round_to_s32``, ``cross`` and
``hadamard``, and ``__version__``.

Inputs are made with NumPy from a seed and handed to both packages. Bars:
the math and the position bit for bit; the frame within the budgets of
tests/test_parity_jax.py (coverage exact, colour mismatch <= 0.2%, depth
within rtol 1e-6 on >= 99.5% of pixels).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_renderer
import tpu_renderer_torch as trt
from test_torch_render import assert_frame_parity
from tpu_renderer.core import math as jm
from tpu_renderer.core import types as jt
from tpu_renderer.engine.renderer import Renderer as JRenderer
from tpu_renderer.geometry import transform as jtf
from tpu_renderer.models import scenes as js
from tpu_renderer_torch.core import math as tm
from tpu_renderer_torch.core import types as tt
from tpu_renderer_torch.geometry import transform as ttf
from tpu_renderer_torch.models import scenes as ts
from torch_threads import one_torch_thread  # noqa: F401

H, W = 64, 96


def test_renderer_by_jax_positions_renders_jax_frame():
    """Renderer(h, w, backend, clear_color, capacity, budget_factor, zcull)
    by position means what it means in the JAX package ('reference' is a
    backend name in both); the frame over a non-zero clear colour is
    JAX's."""
    args = ("reference", 0xFF203040, 64, 1.5, True)
    r = trt.Renderer(H, W, *args, device="cpu")
    assert (r.backend, r.clear_color, r.capacity, r.budget_factor,
            r.zcull, r.device.type) == args + ("cpu",)
    sg, tr_d, li_d = js.baseline_scene(4, H, W)
    scene, tr, li = ts.to_torch_scene(sg, tr_d, li_d, device="cpu")
    fb = r.render(scene, tr, li)
    scene_j, trj, lij = js.to_jax_scene(sg, tr_d, li_d)
    jfb = JRenderer(H, W, *args).render(scene_j, trj, lij)
    color, depth = fb.color.numpy(), fb.depth.numpy()
    assert_frame_parity(color, depth, np.asarray(jfb.color),
                        np.asarray(jfb.depth))
    assert (depth > -3.0e38).sum() > 300
    assert (color == np.uint32(0xFF203040)).sum() > 300


def test_renderer_device_defaults_to_the_card(monkeypatch):
    """Renderer(h, w, 'reference') runs on the card, as the other entry
    points, and without one says how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.Renderer(8, 8, "reference")
    assert trt.Renderer(8, 8, "reference", device="cpu").backend == (
        "reference")


def test_translate_object_equals_jax():
    rng = np.random.default_rng(11)
    arrs = dict(vertices=rng.standard_normal((6, 3)).astype(np.float32),
                colors=rng.random((6, 4)).astype(np.float32),
                normals=rng.standard_normal((6, 3)).astype(np.float32),
                uvs=rng.random((6, 2)).astype(np.float32))
    p = rng.standard_normal(3)  # f64: both round it to f32
    moved = ttf.translate_object(tt.make_object((0.0, 0.0, 0.0), **arrs,
                                                device="cpu"), p)
    jmoved = jtf.translate_object(jt.make_object((0.0, 0.0, 0.0), **arrs), p)
    assert moved.p.dtype == torch.float32 and moved.p.shape == (3,)
    np.testing.assert_array_equal(moved.p.numpy().view(np.uint32),
                                  np.asarray(jmoved.p).view(np.uint32))
    assert torch.equal(moved.vertices, tt.make_object(
        (0.0, 0.0, 0.0), **arrs, device="cpu").vertices)


def test_round_to_s32_equals_jax():
    """Halves away from zero, the f32 neighbours of the int32 limits,
    infinities and NaN as JAX's astype(int32) gives them, and seeded
    values."""
    edges = [0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997, -0.49999997, 0.0,
             -0.0, 2147483520.0, 2147483648.0, -2147483648.0,
             -2147483904.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan]
    rng = np.random.default_rng(7)
    x = np.concatenate([np.float32(edges),
                        (rng.standard_normal(512) * 1e3).astype(np.float32),
                        np.float32(rng.integers(-8, 8, 64)) + 0.5])
    got = tm.round_to_s32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jm.round_to_s32(jnp.asarray(x))))


@pytest.mark.parametrize("fn", ["cross", "hadamard"])
def test_vector_math_equals_jax(fn):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((5, 7, 3)).astype(np.float32)
            for _ in range(2))
    got = getattr(tm, fn)(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_version_equals_jax():
    assert trt.__version__ == tpu_renderer.__version__ == "0.1.0"
    assert "__version__" in trt.__all__
