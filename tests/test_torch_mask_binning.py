"""The mask strategy's binning against the JAX package: ``bin_triangles``
(ids, counts, drops) on seeded bboxes, ``_mask_guard`` and the capacity
default, exactly as JAX's. (Split from tests/test_torch_mask.py so that
each file keeps under ten cases.)"""

import numpy as np
import pytest
import torch

from test_torch_mask import (
    F,
    H,
    W,
)
from tpu_renderer.ops import binning as jbin
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer_torch.ops import binning as tbin
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401


def seeded_bboxes(T, h, w, seed):
    """Global-frame bboxes of T triangles, as _bbox_core returns them: a
    validity mask, rows in [0, h], columns in [0, w - 1]."""
    rng = np.random.default_rng(seed)
    ylo = rng.uniform(0, h, T).astype(F)
    yhi = np.minimum(ylo + rng.exponential(h / 6, T), h).astype(F)
    xlo = rng.uniform(0, w - 1, T).astype(F)
    xhi = np.minimum(xlo + rng.exponential(w / 6, T), w - 1).astype(F)
    valid = rng.uniform(size=T) < 0.9
    return valid, ylo, yhi, xlo, xhi


@pytest.mark.parametrize("T, tile_h, capacity, origin", [
    (12, 16, 16, (0, 0)),
    (300, 8, 304, (0, 0)),
    (300, 8, 24, (0, 0)),      # capacity below demand: drops counted
    (500, 16, 40, (37, 21)),   # sub-rectangle at an offset, drops
])
def test_bin_triangles_vs_jax(T, tile_h, capacity, origin):
    """Per-tile lists in submission order, counts and n_dropped integer-
    exact against JAX's bin_triangles on seeded bboxes."""
    row0, col0 = origin
    h, w = (H - row0, W - col0) if origin != (0, 0) else (H, W)
    bbox = seeded_bboxes(T, H, W, T + capacity)
    want = jbin.bin_triangles(None, h, w, tile_h, trp.TILE_W, capacity, H,
                              W, row0, col0, bbox=tuple(map(np.asarray,
                                                            bbox)))
    got = tbin.bin_triangles(h, w, tile_h, trp.TILE_W, capacity, row0, col0,
                             tuple(torch.from_numpy(a) for a in bbox))
    for name in ("ids", "counts", "n_dropped"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.ids.is_contiguous() and got.ids.dtype == torch.int32
    assert (int(got.n_dropped) > 0) == (capacity < T)


@pytest.mark.parametrize("capacity, tiles", [
    (512, (64, 4)), (512, (135, 15)), (8192, (1, 1)), (4096, (300, 15)),
    (8, (1, 1))])
def test_mask_guard_and_capacity_as_jax(capacity, tiles):
    """_mask_guard raises the same errors for the same inputs, and the
    capacity default follows the table's length."""
    try:
        jrp._mask_guard(capacity, *tiles)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        trp._mask_guard(capacity, *tiles)
    else:
        with pytest.raises(ValueError) as err:
            trp._mask_guard(capacity, *tiles)
        assert str(err.value) == want
    for T in (1, 7, 8, 12, 300, 512, 4095, 10 ** 6):
        assert trp.mask_capacity(T) == min(max(8, -(-T // 8) * 8), 4096)
