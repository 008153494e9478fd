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
//
// The grouped form (rotate_kernel_grouped, C entry tr_rotate_grouped)
// rotates every object of a scene in one launch, each by its own matrix,
// into one allocation: a scene of many objects costs one launch instead of
// one an object, and one output allocation instead of two. A device table
// holds each object's matrix and plane pointers, its element count, its
// output offset and its first block; a block covers kGroupElems x 256
// elements of one object's plane, so it finds its object as K1's grouped
// form does (the last whose first block is at or before its own) and each
// thread reads its kGroupElems elements before it writes any. The
// arithmetic is the one-object kernel's, so both are bit-equal.

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

// One object of a grouped launch: a row of the (n, 6) int64 table.
struct RotateObject {
  const float* rot;    // (3, 3)
  const float* verts;  // (3, n): the (3, 3, t) vertex planes, n = 3 t
  const float* nrms;   // (3, n)
  long long n;         // elements of a component plane
  long long out;       // offset of its rotated vertices in the output;
                       // its normals follow at out + 3 n
  long long block0;    // its first block in the launch
};
static_assert(sizeof(RotateObject) == 48, "the table's rows are 6 int64");

constexpr int kGroupElems = 4;  // elements a thread in the grouped form
constexpr long long kGroupBlock = (long long)kRotateThreads * kGroupElems;

__global__ void __launch_bounds__(kRotateThreads)
    rotate_kernel_grouped(const RotateObject* __restrict__ objs, int n_objs,
                          float* __restrict__ out) {
  const long long block = blockIdx.x;
  int found = 0;
  for (int base = 0; base < n_objs; base += kRotateThreads) {
    const int j = base + threadIdx.x;
    found += __syncthreads_count(j < n_objs && objs[j].block0 <= block);
  }
  const RotateObject o = objs[found - 1];
  const long long n = o.n;
  const float* in = blockIdx.y ? o.nrms : o.verts;
  float* dst = out + o.out + (blockIdx.y ? 3 * n : 0);
  const long long k0 = (block - o.block0) * kGroupBlock + threadIdx.x;
  float r[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) r[i] = __ldg(o.rot + i);
  float x[kGroupElems], y[kGroupElems], z[kGroupElems];
#pragma unroll
  for (int e = 0; e < kGroupElems; ++e) {
    const long long k = k0 + e * kRotateThreads;
    if (k < n) {
      x[e] = in[k];
      y[e] = in[n + k];
      z[e] = in[2 * n + k];
    }
  }
#pragma unroll
  for (int e = 0; e < kGroupElems; ++e) {
    const long long k = k0 + e * kRotateThreads;
    if (k >= n) break;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float xy = __fadd_rn(__fmul_rn(r[3 * i], x[e]),
                                 __fmul_rn(r[3 * i + 1], y[e]));
      dst[i * n + k] = __fadd_rn(xy, __fmul_rn(r[3 * i + 2], z[e]));
    }
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

// objs: n_objs rows of RotateObject in block order, each object's n >= 1
// and its blocks ceil(n / kGroupBlock), blocks in all; out: the objects'
// rotated planes, each object's 6 n floats at its offset.
extern "C" int tr_rotate_grouped(const void* objs, int n_objs, int blocks,
                                 float* out, void* stream) {
  if (n_objs < 1 || blocks < 1) return 1;  // cudaErrorInvalidValue
  tr::rotate_kernel_grouped<<<dim3((unsigned)blocks, 2), tr::kRotateThreads,
                              0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const tr::RotateObject*>(objs), n_objs, out);
  return static_cast<int>(cudaGetLastError());
}
