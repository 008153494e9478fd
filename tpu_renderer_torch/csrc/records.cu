// K7: the record transpose of finish_records.
//
// Replaces the Pallas kernel finish_records.kern
// (tpu_renderer/ops/raster_pallas.py:469, launched at :472), which
// transposes the channel-major (128, Tp) record table, zero padded from the
// (85, T) table that the small-object setup chain writes, into the
// row-major (Tp, 128) table whose rows the raster kernels read one record
// at a time. Tp is T rounded up to 512 (_PACK_T_BLK).
//
// Bound on the H100: device memory. It reads R * T * 4 bytes and writes
// Tp * 512 bytes and does no arithmetic: 2,208 triangles (config 4) move
// 2.1 MB, 0.6 us at 3.35 TB/s, so the launch itself, and the wrapper's host
// work before it, cost more than the copy at the suite's sizes (the
// wrapper's lean path: ops/raster.py finish_records, _cuda.entry).
//
// Design: one block of 8 warps moves 32 triangles, whole 512 B record rows.
// It reads only the R live lanes: warp w loads lane rows w, w + 8, ... of
// the 32 triangles (128 B each, coalesced) into a (32, 132) shared tile, row
// i holding triangle i (the row stride keeps each row's 16-byte chunks
// aligned), zeros where the lane (R..127) or the triangle (T..Tp-1) is not
// live, without a load. Then each warp writes whole records, one row a
// turn, thread l storing lanes 4l..4l+3 with one 16-byte store: no padded
// copy of the input is ever made. The tile's stores are 4-way bank
// conflicted (32 rows of one lane), a few cycles a block.

#include "common.cuh"

namespace tr {

constexpr int kRecTris = 32;    // triangles (output rows) per block
constexpr int kRecWarps = 8;    // warps per block
constexpr int kRecStride = kRecLanes + 4;  // shared row stride, 16 B aligned

__global__ void __launch_bounds__(32 * kRecWarps)
    records_kernel(const float* __restrict__ rec_t, int rows, int t,
                   float* __restrict__ out) {
  __shared__ __align__(16) float tile[kRecTris][kRecStride];
  const int t0 = blockIdx.x * kRecTris;  // first triangle of the block
  const int live = min(kRecTris, t - t0);  // <= 0 on the padding's blocks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // Every lane of every row of the tile is written, zeros where the lane
  // or the triangle is not live, and all of a warp's loads are issued before
  // its first store to shared memory, so their latencies overlap.
  constexpr int kPerWarp = kRecLanes / kRecWarps;
  float v[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int c = warp + j * kRecWarps;
    v[j] = lane < live && c < rows
               ? __ldg(rec_t + (size_t)c * t + t0 + lane)
               : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) tile[lane][warp + j * kRecWarps] = v[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRecTris / kRecWarps; ++j) {
    const int i = warp + j * kRecWarps;
    reinterpret_cast<float4*>(out + (size_t)(t0 + i) * kRecLanes)[lane] =
        reinterpret_cast<const float4*>(tile[i])[lane];
  }
}

}  // namespace tr

// rec_t (rows, t) f32 -> out (tp, 128) f32; 1 <= rows <= 128, t >= 1, tp a
// multiple of 32 in [t, 2^24).
extern "C" int tr_records(const float* rec_t, int rows, int t, int tp,
                          float* out, void* stream) {
  if (rows < 1 || rows > tr::kRecLanes || t < 1 || tp < t ||
      tp % tr::kRecTris || tp >= (1 << 24))
    return 1;  // cudaErrorInvalidValue
  tr::records_kernel<<<tp / tr::kRecTris, 32 * tr::kRecWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(rec_t, rows, t,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}
