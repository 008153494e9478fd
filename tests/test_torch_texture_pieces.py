"""The texture path's small pieces against the JAX package: f32 -> i32
saturation, ARGB unpacking, the scene atlas and the planes a scene's
finalize reads. (Split from tests/test_torch_texture.py so that each file
keeps under ten cases.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_texture import F, SIX
from tpu_renderer.core import math as jm
from tpu_renderer.ops import raster_pallas as jrp
from tpu_renderer_torch.core import math as tm
from tpu_renderer_torch.models.textures import checkerboard
from tpu_renderer_torch.ops import raster as trp
from torch_threads import one_torch_thread  # noqa: F401


def test_to_i32_saturates_like_xla():
    """Fault 2: f32 -> int32 saturates at the limits (infinities too) and
    maps NaN to 0, as XLA's convert; torch's own cast gives INT_MIN."""
    want = np.asarray(jnp.asarray(SIX).astype(jnp.int32))
    np.testing.assert_array_equal(want, [2 ** 31 - 1, -2 ** 31, 0,
                                         2 ** 31 - 1, -2 ** 31, 2])
    np.testing.assert_array_equal(tm.to_i32(torch.from_numpy(SIX)).numpy(),
                                  want)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(0, 12, 4096)
         ).astype(F)
    np.testing.assert_array_equal(
        tm.to_i32(torch.from_numpy(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_unpack_argb_vs_jax():
    rng = np.random.default_rng(12)
    px = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    px[:4] = [0, 0xFFFFFFFF, 0xFF000000, 0x00FFFFFF]
    want = np.asarray(jm.unpack_argb(jnp.asarray(px)))
    got = tm.unpack_argb(torch.from_numpy(px.view(np.int32)))
    np.testing.assert_array_equal(np.stack([g.numpy() for g in got], -1),
                                  want)


def test_pack_texture_atlas_vs_jax():
    """Two textures of different widths (tests/test_batch.py:82): the same
    row offsets and atlas dimensions, and texels that decode to JAX's
    channel-blocked atlas entries (zero padding included)."""
    texs = [checkerboard(32, 64, 4), checkerboard(16, 16, 2)]
    rng = np.random.default_rng(13)
    texs.append(rng.integers(0, 2 ** 32, (8, 40), dtype=np.uint64)
                .astype(np.uint32))
    jatlas, joffs = jrp.pack_texture_atlas([jnp.asarray(t) for t in texs])
    atlas, offs = trp.pack_texture_atlas(
        [torch.from_numpy(t.view(np.int32)) for t in texs])
    assert offs == joffs == [0, 32, 48]
    jatlas = np.asarray(jatlas.astype(jnp.float32))
    ah, aw = atlas.shape
    assert (ah, 4 * aw) == jatlas.shape == (56, 4 * 64)
    specs = [trp.ObjSpec(0, 1, False, (o, t.shape[0], t.shape[1]))
             for o, t in zip(offs, texs)]
    assert trp._atlas_dims(specs) == jrp._atlas_dims(specs) == (56, 64)
    p = atlas.to(torch.int64) & 0xFFFFFFFF
    for c, shift in enumerate((16, 8, 0, 24)):  # r, g, b, a blocks
        np.testing.assert_array_equal(
            ((p >> shift) & 0xFF).numpy().astype(F),
            jatlas[:, c * aw:(c + 1) * aw])


@pytest.mark.parametrize("specs", [
    ((0, 10, False, None),),
    ((0, 10, True, None),),
    ((0, 10, False, (0, 16, 16)),),
    ((0, 10, True, (0, 16, 16, "bilinear")),),
    ((0, 10, True, None), (10, 20, False, (0, 16, 16)),
     (20, 30, False, None)),
    ((0, 2, False, (0, 32, 32)), (128, 130, False, (32, 32, 32,
                                                     "bilinear"))),
])
def test_scene_fields_vs_jax(specs):
    """The planes a scene's finalize reads, and their offsets, as JAX's
    _scene_fields; the same from a launch's tables (launch_fields)."""
    want = jrp._scene_fields(tuple(jrp.ObjSpec(*o) for o in specs))
    ours = tuple(trp.ObjSpec(*o) for o in specs)
    assert trp._scene_fields(ours) == want
    objs = trp.obj_table(ours, torch.device("cpu"))
    assert trp.launch_fields(objs, trp.tex_table(ours, objs.device)) == want
    assert [o.bilinear for o in ours] == [
        jrp.ObjSpec(*o).bilinear for o in specs]
