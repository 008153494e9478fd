// Shared device helpers of the port's kernels: the packed-record layout and
// the f32 primitives with the JAX package's exact semantics
// (tpu_renderer/core/math.py, tpu_renderer_torch/core/math.py).
//
// Built with -fmad=false -prec-div=true -prec-sqrt=true -ftz=false: every
// a + b * c below rounds twice, '/' and sqrtf are IEEE, so each kernel is
// bit-equal to its plain-PyTorch version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tr {

constexpr float kBig = 3.4028235e38f;
constexpr float kDepthClear = -3.4028235e38f;
constexpr float kNearClip = 0.2f;

constexpr int kEdgeStride = 28;
constexpr int kGidLane = 84;
constexpr int kRecLanes = 128;

// Per-edge field lanes of a packed record.
constexpr int F_VALID = 0, F_YMIN = 1, F_YMAX = 2, F_X0 = 3, F_XG = 4;
constexpr int F_Z0 = 5, F_ZG = 6, F_OZ0 = 7, F_OZG = 8, F_U0 = 9, F_UG = 10;
constexpr int F_V0 = 11, F_VG = 12, F_LEFT = 13;
constexpr int F_COL0 = 14, F_COLG = 18, F_N0 = 22, F_NG = 25;

__device__ __forceinline__ bool is_nan(float x) { return x != x; }
__device__ __forceinline__ bool sign_bit(float x) {
  return (__float_as_uint(x) >> 31) != 0u;
}
__device__ __forceinline__ bool is_finite(float x) { return fabsf(x) <= kBig; }

// jnp.maximum / jnp.minimum: NaN propagates, +0 > -0 on a signed-zero tie.
// (fmaxf/fminf return the non-NaN operand instead.)
__device__ __forceinline__ float max_ieee(float a, float b) {
  return (is_nan(a) || a > b || (a == b && !sign_bit(a))) ? a : b;
}
__device__ __forceinline__ float min_ieee(float a, float b) {
  return (is_nan(a) || a < b || (a == b && sign_bit(a))) ? a : b;
}
// jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)).
__device__ __forceinline__ float clip_ieee(float x, float lo, float hi) {
  return min_ieee(max_ieee(x, lo), hi);
}
__device__ __forceinline__ float clamp01(float x) {
  return clip_ieee(x, 0.0f, 1.0f);
}

// jnp.sign: keeps -0 and NaN.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}
// sign(x) * floor(|x| + 0.5): NOT roundf, which differs at 0.49999997.
__device__ __forceinline__ float round_half_away(float x) {
  return sign_of(x) * floorf(fabsf(x) + 0.5f);
}

// f32 -> int32 as XLA's convert: truncate, saturate at the int32 limits,
// NaN -> 0 (cvt.rzi.s32.f32).
__device__ __forceinline__ int to_i32(float x) { return __float2int_rz(x); }

// jnp.nan_to_num(x, nan=, posinf=, neginf=).
__device__ __forceinline__ float nan_to_num(float x, float nan, float posinf,
                                            float neginf) {
  if (is_nan(x)) return nan;
  if (x == __int_as_float(0x7f800000)) return posinf;
  if (x == __int_as_float(0xff800000)) return neginf;
  return x;
}

// normalize() on three components: ((x*x + y*y) + z*z), then 1/sqrt.
__device__ __forceinline__ void norm3(float x, float y, float z, float& ox,
                                      float& oy, float& oz) {
  float d = x * x + y * y;
  d = d + z * z;
  const float inv = 1.0f / sqrtf(d);
  ox = x * inv;
  oy = y * inv;
  oz = z * inv;
}

__device__ __forceinline__ float inner3(float a0, float a1, float a2,
                                        float b0, float b1, float b2) {
  float acc = a0 * b0;
  acc = acc + a1 * b1;
  acc = acc + a2 * b2;
  return acc;
}

__device__ __forceinline__ float pow16(float x) {
  const float x2 = x * x;
  const float x4 = x2 * x2;
  const float x8 = x4 * x4;
  return x8 * x8;
}

}  // namespace tr
