"""K13, an object's rotation (``rotate_kernel``, csrc/transform.cu).

On the CPU ``rotate_kernel`` runs ``rotate_plain`` and launches nothing,
and both equal the rotation spelt out in NumPy f32, each product and sum
rounded on its own. On the card (tests marked ``cuda``, skipped without
one) the kernel equals ``rotate_plain`` on the same tensors bit for bit,
over sizes around its 256-thread blocks, planted signed zeros, NaN and
infinities, a matrix given as a view into a stack of matrices or as
float64, and counts one launch an object.

The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_rotate.py
"""

import numpy as np
import pytest
import torch

from tpu_renderer_torch.core.types import make_object
from tpu_renderer_torch.geometry import transform as ttf

SIZES = (1, 5, 85, 86, 4096, 30001)


def planes(T, seed, device="cpu"):
    """(rot (3, 3), vertices, normals (3, 3, T)) f32 from ``seed``, with a
    signed zero, NaN and infinities planted where T allows."""
    g = torch.Generator().manual_seed(seed)
    rot = torch.randn((3, 3), generator=g)
    v = torch.randn((3, 3, T), generator=g) * 3
    n = torch.randn((3, 3, T), generator=g)
    if T >= 5:
        v[0, 0, 0], v[1, 1, 1], v[2, 2, 2] = -0.0, float("nan"), float("inf")
        n[0, 1, 3], n[2, 0, 4] = float("-inf"), -0.0
    return rot.to(device), v.to(device), n.to(device)


def numpy_rotate(rot, arr):
    r, a = rot.numpy().astype(np.float32), arr.numpy().astype(np.float32)
    with np.errstate(invalid="ignore"):
        return np.stack([(r[i, 0] * a[0] + r[i, 1] * a[1]) + r[i, 2] * a[2]
                         for i in range(3)])


def bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("T", SIZES)
def test_plain_is_the_f32_rotation(T):
    rot, v, n = planes(T, T)
    before = ttf.rotate_kernel.launches
    got = ttf.rotate_kernel(rot, v, n)
    assert ttf.rotate_kernel.launches == before
    for g, a in zip(got, (v, n)):
        want = torch.from_numpy(numpy_rotate(rot, a))
        assert g.shape == a.shape and g.dtype == torch.float32
        assert torch.equal(bits(g), bits(want))


def test_rotate_object_keeps_the_other_fields():
    rng = np.random.default_rng(3)
    soup = rng.normal(size=(12, 3)).astype(np.float32)
    obj = make_object((0.1, 0.2, -0.3), soup, np.ones((12, 4), np.float32),
                      soup, np.zeros((12, 2), np.float32), device="cpu")
    rot = ttf.rotation_y(0.7, device="cpu")
    out = ttf.rotate_object(obj, rot)
    want_v, want_n = ttf.rotate_plain(rot, obj.vertices, obj.normals)
    assert torch.equal(bits(out.vertices), bits(want_v))
    assert torch.equal(bits(out.normals), bits(want_n))
    for name in ("p", "colors", "uvs"):
        assert getattr(out, name) is getattr(obj, name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T", SIZES)
def test_kernel_equals_plain_on_the_card(cuda, T):
    rot, v, n = planes(T, 100 + T, cuda)
    before = ttf.rotate_kernel.launches
    got = ttf.rotate_kernel(rot, v, n)
    torch.cuda.synchronize()
    assert ttf.rotate_kernel.launches == before + 1
    want = ttf.rotate_plain(rot, v, n)
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        assert torch.equal(bits(g), bits(w))


@pytest.mark.cuda
def test_kernel_takes_a_view_and_float64(cuda):
    rot, v, n = planes(777, 9, cuda)
    stack = torch.stack([rot * 0.5, rot, rot * 2.0])
    for r in (stack[1], rot.double()):
        got = ttf.rotate_kernel(r, v, n)
        want = ttf.rotate_plain(r, v, n)
        for g, w in zip(got, want):
            assert torch.equal(bits(g), bits(w))


@pytest.mark.cuda
def test_kernel_refuses_strided_planes(cuda):
    rot, v, n = planes(64, 4, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ttf.rotate_kernel(rot, v.transpose(1, 2).contiguous().transpose(
            1, 2), n)
