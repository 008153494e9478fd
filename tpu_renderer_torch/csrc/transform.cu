// K13: an object's rotation, vertices and normals in one launch
// (rotate_kernel, C entry tr_rotate).
//
// Replaces no Pallas kernel: the JAX package's rotate_object
// (tpu_renderer/geometry/transform.py, its elementwise form) is XLA ops,
// and so is the port's plain version (geometry/transform.py
// rotate_plain): 32 torch launches an object, a product and a sum per
// output plane. A scene of many objects turned each frame paid them per
// object (137 objects: 4,384 launches a frame). This kernel computes the
// same planes, out_i = (rot[i][0] * x + rot[i][1] * y) + rot[i][2] * z,
// each product and sum rounded on its own (the build's -fmad=false, and
// the _rn intrinsics say so here too), so they are bit-equal.
//
// Bound on the H100: bytes. Each of the 9 T floats of the vertices and of
// the normals is read once and written once: 144 B a triangle, 0.043 ms
// for 1M triangles at 3.35 TB/s; 15 f32 operations an element are nothing.
//
// Design: a thread an element index of the (3 T) vertex-and-triangle plane,
// blockIdx.y picking vertices or normals; it reads x, y and z at that index
// of the three component planes and writes the three rotated components.
// The matrix's 9 floats come through the read-only cache.

#include "common.cuh"

namespace tr {

constexpr int kRotateThreads = 256;

__global__ void __launch_bounds__(kRotateThreads)
    rotate_kernel(const float* __restrict__ rot,
                  const float* __restrict__ verts,
                  const float* __restrict__ nrms, long long n,
                  float* __restrict__ verts_out,
                  float* __restrict__ nrms_out) {
  const long long k = (long long)blockIdx.x * kRotateThreads + threadIdx.x;
  if (k >= n) return;
  const float* in = blockIdx.y ? nrms : verts;
  float* out = blockIdx.y ? nrms_out : verts_out;
  const float x = in[k], y = in[n + k], z = in[2 * n + k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float xy = __fadd_rn(__fmul_rn(__ldg(rot + 3 * i), x),
                               __fmul_rn(__ldg(rot + 3 * i + 1), y));
    out[i * n + k] = __fadd_rn(xy, __fmul_rn(__ldg(rot + 3 * i + 2), z));
  }
}

}  // namespace tr

// rot (3, 3) f32; verts, nrms, verts_out, nrms_out (3, n) f32 (an object's
// (3, 3, T) planes, n = 3 T >= 1).
extern "C" int tr_rotate(const float* rot, const float* verts,
                         const float* nrms, long long n, float* verts_out,
                         float* nrms_out, void* stream) {
  if (n < 1) return 1;  // cudaErrorInvalidValue
  const dim3 grid((unsigned)((n + tr::kRotateThreads - 1) /
                             tr::kRotateThreads), 2);
  tr::rotate_kernel<<<grid, tr::kRotateThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rot, verts, nrms, n, verts_out, nrms_out);
  return static_cast<int>(cudaGetLastError());
}
