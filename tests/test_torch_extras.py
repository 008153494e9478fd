"""The port's small modules against the JAX package: rotations
(``geometry.transform``), supersampling (``engine.antialias``), image IO
(``utils.image``), scene and framebuffer files (``utils.checkpoint``),
``no_lights`` / ``classic_arrays`` (``core.types``) and the texture
helpers and BMP IO (``models.textures``).

Bars: bytes and arrays equal to the JAX package's; files each package
writes load in the other; SSAA bit-exact against the golden's frame at the
factor's resolution, box-filtered in NumPy f32, and within
tests/test_parity_jax.py's budgets of JAX's.

This file holds the rotations against JAX; the other tests sit in
test_torch_extras_io.py, so that each file keeps under ten cases and
pytest-xdist's ``--dist loadfile`` hands both out after
tests/test_parallel.py, the suite's longest file.
"""

import numpy as np
import pytest

from tpu_renderer.geometry import transform as jtf
from tpu_renderer_torch.geometry import transform as ttf
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32


@pytest.mark.parametrize("axis", ["x", "y", "z"])
@pytest.mark.parametrize("angle", [0.0, 0.7, -2.3])
def test_rotations_vs_jax(axis, angle):
    """cos and sin come from two libraries: entries agree to 1 ulp."""
    got = getattr(ttf, f"rotation_{axis}")(angle, device="cpu").numpy()
    want = np.asarray(getattr(jtf, f"rotation_{axis}")(angle))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)
    assert got.dtype == np.float32
