"""Port core (tpu_renderer_torch.core) vs the JAX package's core.

The same seeded NumPy inputs -- exact halves, signed zeros, NaN and Inf
included -- go through tpu_renderer.core.math and its PyTorch counterpart.
Elementwise f32 primitives involve no contraction, so the bar is bit
equality, signed zeros and NaN positions included.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_renderer.core import math as jm
from tpu_renderer.core import types as jt
from tpu_renderer_torch.core import math as tm
from tpu_renderer_torch.core import types as tt
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32


def special_values(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3.0, 3.0, n).astype(F)
    halves = (np.arange(-8, 9) + F(0.5)).astype(F)
    edges = np.array(
        [0.0, -0.0, np.nan, np.inf, -np.inf, 0.49999997, -0.49999997,
         0.5, -0.5, 1.0, -1.0, 1.2e-38, -1.2e-38, 3.4028235e38, -3.4028235e38,
         254.5 / 255.0, 0.5 / 255.0, 1.5 / 255.0],
        F,
    )
    # No subnormals: XLA's CPU backend flushes them to zero, while NumPy,
    # torch and the CUDA kernels (-ftz=false) keep them.
    return np.concatenate([x, halves, halves / F(255.0), edges]).astype(F)


def assert_bits_equal(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1])
def test_round_half_away_bits(seed):
    x = special_values(seed)
    got = tm.round_half_away(torch.from_numpy(x)).numpy()
    want = np.asarray(jm.round_half_away(jnp.asarray(x)))
    # NaN stays NaN in both; compare the rest bit for bit (signed zeros too).
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert_bits_equal(got[ok], want[ok])
    # 0.49999997 + 0.5 rounds to 1.0 in f32: the floor form gives 1, not 0.
    assert got[x == F(0.49999997)][0] == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_clamp01_and_minmax_bits(seed):
    x = special_values(seed)
    y = np.roll(x, 7)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in (
        (tm.clamp01(tx), jm.clamp01(jnp.asarray(x))),
        (tm.maximum(tx, ty), jnp.maximum(x, y)),
        (tm.minimum(tx, ty), jnp.minimum(x, y)),
        (tm.maximum(0.0, tx), jnp.maximum(F(0.0), x)),
        (tm.clip(tx, 0.0, 127.0), jnp.clip(x, 0.0, 127.0)),
    ):
        got = got.numpy()
        want = np.asarray(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert_bits_equal(got[ok], want[ok])
    # Signed-zero ties resolve as XLA does: max(-0, +0) = +0.
    z = tm.maximum(torch.tensor([-0.0]), torch.tensor([0.0]))
    assert not torch.signbit(z).item()


def test_to_i32_matches_xla_on_nan_and_range():
    x = np.array([np.nan, 0.0, -0.0, 254.9999, 255.0, 3.7, -3.7], F)
    got = tm.to_i32(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_argb_bits(seed):
    rng = np.random.default_rng(seed)
    rgba = rng.uniform(-0.2, 1.2, (512, 4)).astype(F)
    rgba[:17, 0] = (np.arange(17) + F(0.5)) / F(255.0)  # exact halves
    rgba[17:40] = np.clip(rgba[17:40], 0, 1)
    rgba = np.clip(rgba, 0, 1)  # pack's domain: clamped channels
    rgba[40] = [np.nan, 0.0, 1.0, 0.5]
    got = tm.pack_argb(torch.from_numpy(rgba)).numpy()
    want = np.asarray(jm.pack_argb(jnp.asarray(np.nan_to_num(rgba))))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got[:40], want[:40])
    # NaN channels pack as 0 (XLA's NaN -> int convert), the rest as usual.
    assert got[40] == want[40]


@pytest.mark.parametrize("seed", [0, 1])
def test_inner_normalize_pow16(seed):
    """Bit-exact against the NumPy golden's formulas; against JAX to
    rtol 1e-6, because XLA's CPU backend contracts the unrolled dot's
    acc + a * b into an FMA (golden divergence #8)."""
    from tpu_renderer.golden import cpu_reference as gold

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(1024, 3)).astype(F)
    v[0] = 0.0  # zero vector: inf * 0 = NaN everywhere
    w = rng.normal(size=(1024, 3)).astype(F)
    tv, tw = torch.from_numpy(v), torch.from_numpy(w)
    cases = (
        (tm.inner(tv, tw), gold.inner(v, w), jm.inner(jnp.asarray(v), jnp.asarray(w))),
        (tm.normalize(tv), gold.normalize(v), jm.normalize(jnp.asarray(v))),
        (tm.pow16(tv), gold.pow16(v), jm.pow16(jnp.asarray(v))),
    )
    for got, spec, ref in cases:
        got, spec, ref = got.numpy(), np.asarray(spec, F), np.asarray(ref)
        assert np.array_equal(np.isnan(got), np.isnan(spec))
        ok = ~np.isnan(spec)
        assert_bits_equal(got[ok], spec[ok])
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-6, atol=1e-30)


def test_make_object_channel_major_layout():
    rng = np.random.default_rng(3)
    T = 37
    arrs = {
        "vertices": rng.normal(size=(3 * T, 3)).astype(F),
        "colors": rng.uniform(size=(3 * T, 4)).astype(F),
        "normals": rng.normal(size=(3 * T, 3)).astype(F),
        "uvs": rng.uniform(size=(3 * T, 2)).astype(F),
    }
    jo = jt.make_object((0.1, 0.2, 0.3), **arrs)
    to = tt.make_object((0.1, 0.2, 0.3), **arrs, device="cpu")
    assert to.num_triangles == jo.num_triangles == T
    for name in ("p", "vertices", "colors", "normals", "uvs"):
        assert_bits_equal(getattr(to, name).numpy(), np.asarray(getattr(jo, name)))
    assert tt.DEPTH_CLEAR == float(jt.DEPTH_CLEAR)
    assert tt.NEAR_CLIP == float(jt.NEAR_CLIP)
    fb = tt.make_framebuffer(4, 5, clear_color=0xFF102030, device="cpu")
    jfb = jt.make_framebuffer(4, 5, clear_color=0xFF102030)
    np.testing.assert_array_equal(fb.color.numpy(), np.asarray(jfb.color))
    np.testing.assert_array_equal(fb.depth.numpy(), np.asarray(jfb.depth))


def test_port_imports_no_jax():
    """The port runs where JAX is absent: importing every module of it must
    load neither jax nor the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import tpu_renderer_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith(('jax.', 'jaxlib', 'tpu_renderer.')) or "
        "k == 'tpu_renderer')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", ["chip_smoke.py", "tpu_renderer_torch/models/route_scenes.py",
             "tpu_renderer_torch/entry.py",
             "tpu_renderer_torch/examples/demo.py",
             "tpu_renderer_torch/examples/multichip.py"])
def test_card_side_scripts_import_no_jax(path):
    """chip_smoke.py, the route scenes it shares with the tests, the
    entry hooks and the demos run where JAX is absent: they import
    neither jax nor the JAX package."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module if n.level == 0 else "tpu_renderer_torch"
             for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and (n.module or n.level)]
    tops = {m.split(".")[0] for m in mods}
    assert "tpu_renderer_torch" in tops or "torch" in tops
    assert not tops & {"jax", "jaxlib", "tpu_renderer"}, tops
