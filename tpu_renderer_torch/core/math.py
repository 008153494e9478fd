"""Scalar/vector math primitives shared by every stage.

PyTorch counterpart of ``tpu_renderer.core.math``. Operation order is part
of the spec: the JAX package, the NumPy golden and the CUDA kernels
(``csrc/common.cuh``) use the same formulas in the same float32 order.

Three semantics are spelled out instead of left to library defaults,
because the libraries disagree and the kernels must match:

- ``maximum``/``minimum`` follow ``jnp.maximum``/``jnp.minimum``: NaN
  propagates and +0 > -0 (torch's own pick an operand on signed-zero ties;
  CUDA's fmaxf/fminf drop NaN);
- ``round_half_away`` is sign(x) * floor(|x| + 0.5) with jnp.sign's
  semantics (sign(-0) = -0, sign(NaN) = NaN), which is NOT C ``roundf``:
  the two differ at 0.49999997;
- ``to_i32`` converts f32 -> int32 as XLA's convert does: truncation,
  saturation at the int32 limits (infinities included) and NaN -> 0
  (torch's CPU cast gives INT_MIN for NaN and for everything out of
  range; CUDA's ``__float2int_rz`` saturates like XLA);
- ``sqrt`` is correctly rounded: torch's vectorised f32 sqrt on the CPU
  is not (about 0.6% of results 1 ulp off), so it takes the square root
  in f64 and rounds once to f32, which is exact for sqrt.
"""

from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


def scalar(x, device) -> torch.Tensor:
    """A 0-d f32 tensor of ``x`` on ``device``, made by a fill: a Python
    number copied to the card would make the host wait for the device."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=F32)
    return torch.full((), float(x), dtype=F32, device=device)


def _pair(a, b):
    """Both operands as f32 tensors on the device of the tensor one."""
    ref = a if isinstance(a, torch.Tensor) else b
    return scalar(a, ref.device), scalar(b, ref.device)


def maximum(a, b):
    """jnp.maximum: NaN-propagating, +0 wins a signed-zero tie."""
    a, b = _pair(a, b)
    take_a = torch.isnan(a) | (a > b) | ((a == b) & ~torch.signbit(a))
    return torch.where(take_a, a, b)


def minimum(a, b):
    """jnp.minimum: NaN-propagating, -0 wins a signed-zero tie."""
    a, b = _pair(a, b)
    take_a = torch.isnan(a) | (a < b) | ((a == b) & torch.signbit(a))
    return torch.where(take_a, a, b)


def clip(x, lo, hi):
    """jnp.clip: minimum(hi, maximum(lo, x))."""
    return minimum(maximum(x, lo), hi)


def sign(x):
    """jnp.sign: -1, 0 or 1, keeping -0 and NaN as they are."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def sqrt(x):
    """IEEE f32 square root on any device (see the module docstring)."""
    return torch.sqrt(x.to(torch.float64)).to(F32)


def round_half_away(x):
    """Round to nearest, halves away from zero (RoundR32ToS32,
    projekt.cpp:402-403, 433-434, 490-493), as sign * floor(|x| + 0.5)."""
    return sign(x) * torch.floor(torch.abs(x) + 0.5)


_I32_LIMIT = 2147483648.0  # 2**31, exact in f32


def to_i32(x):
    """f32 -> int32 as XLA's convert: truncate, saturate, NaN -> 0."""
    hi = x >= _I32_LIMIT
    safe = torch.where(torch.isnan(x) | hi, 0.0,
                       torch.where(x < -_I32_LIMIT, -_I32_LIMIT, x))
    return torch.where(hi, torch.iinfo(torch.int32).max,
                       safe.to(torch.int32))


def round_to_s32(x):
    """RoundR32ToS32: ``round_half_away`` then f32 -> int32 as ``to_i32``
    (truncate, saturate at the int32 limits, NaN -> 0), as the JAX
    package's ``astype(int32)`` converts."""
    return to_i32(round_half_away(x))


def clamp01(x):
    """Clamp01 (projekt.cpp:483), NaN-propagating like jnp.clip."""
    return clip(x, 0.0, 1.0)


def inner(a, b):
    """Dot product along the last axis, unrolled left to right so the f32
    accumulation order is fixed."""
    n = a.shape[-1]
    acc = a[..., 0] * b[..., 0]
    for i in range(1, n):
        acc = acc + a[..., i] * b[..., i]
    return acc


def cross(a, b):
    """Cross: 3D cross product along the last axis."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def hadamard(a, b):
    """Hadamard: the elementwise product (kept for the reference's map)."""
    return a * b


def normalize(v):
    """v * (1/sqrt(dot(v, v))): an explicit IEEE reciprocal of the sqrt,
    never rsqrt."""
    d = inner(v, v)[..., None]
    return v * (1.0 / sqrt(d))


def pow16(x):
    """x**16 via four squarings (projekt.cpp:1261-1266)."""
    x2 = x * x
    x4 = x2 * x2
    x8 = x4 * x4
    return x8 * x8


def pack_channels(r, g, b, a):
    """Pack rounded 8-bit channels into u32 ARGB (projekt.cpp:490-493):
    each channel is round_half_away(x * 255) cast f32 -> int32."""
    ri, gi, bi, ai = (to_i32(round_half_away(c * 255.0)).to(torch.int64)
                      for c in (r, g, b, a))
    packed = (ai << 24) | (ri << 16) | (gi << 8) | bi
    return packed.to(torch.int32).view(torch.uint32)


def pack_argb(color_rgba):
    """Pack float RGBA in [0, 1], shape (..., 4) in (r, g, b, a) order,
    into u32 ARGB."""
    return pack_channels(color_rgba[..., 0], color_rgba[..., 1],
                         color_rgba[..., 2], color_rgba[..., 3])


INV255 = float(np.float32(1.0) / np.float32(255.0))  # f32(1) / f32(255)


def unpack_argb(pixel):
    """u32 ARGB (any int32 / uint32 tensor) -> 4 f32 planes (r, g, b, a)
    in [0, 1]: each 8-bit channel as f32 times the f32 1/255
    (projekt.cpp:440-443). Shifts run on int64, which every device has."""
    p = pixel.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return [((p >> s) & 0xFF).to(F32) * INV255 for s in (16, 8, 0, 24)]
