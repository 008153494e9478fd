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
// 2.1 MB, 0.6 us at 3.35 TB/s, so the launch itself costs more than the
// copy at the suite's sizes.
//
// Design: a tiled transpose through shared memory. One block of 32 x 8
// threads moves a 32 (lanes) x 32 (triangles) tile: each warp reads 32
// consecutive triangles of one lane row (coalesced 128 B) into a 32 x 33
// shared tile (the extra column keeps the transposed reads free of bank
// conflicts) and writes 32 consecutive lanes of one record row. The zero
// padding (lanes R..127, triangles T..Tp-1) is written by the same stores,
// so no padded copy of the input is ever made.

#include "common.cuh"

namespace tr {

constexpr int kTr = 32;      // tile edge
constexpr int kTrRows = 8;   // thread rows per block; each moves 4 tile rows

__global__ void __launch_bounds__(kTr * kTrRows)
    records_kernel(const float* __restrict__ rec_t, int rows, int t, int tp,
                   float* __restrict__ out) {
  __shared__ float tile[kTr][kTr + 1];
  const int t0 = blockIdx.x * kTr;  // first triangle of the tile
  const int c0 = blockIdx.y * kTr;  // first lane of the tile
  const int tx = threadIdx.x, ty = threadIdx.y;
#pragma unroll
  for (int i = ty; i < kTr; i += kTrRows) {
    const int c = c0 + i, tri = t0 + tx;
    tile[i][tx] = (c < rows && tri < t) ? __ldg(rec_t + (size_t)c * t + tri)
                                        : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kTr; i += kTrRows)
    out[(size_t)(t0 + i) * kRecLanes + c0 + tx] = tile[tx][i];
}

}  // namespace tr

extern "C" int tr_records(const float* rec_t, int rows, int t, int tp,
                          float* out, void* stream) {
  if (rows < 1 || rows > tr::kRecLanes || t < 1 || tp < t || tp % tr::kTr)
    return 1;  // cudaErrorInvalidValue
  const dim3 grid(tp / tr::kTr, tr::kRecLanes / tr::kTr);
  const dim3 block(tr::kTr, tr::kTrRows);
  tr::records_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      rec_t, rows, t, tp, out);
  return static_cast<int>(cudaGetLastError());
}
