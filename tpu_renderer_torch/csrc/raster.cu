// K2, K3, K4: fused raster + shade for the sorted strategy.
//
// Replaces the Pallas kernel _raster_kernel_queue_shaded
// (tpu_renderer/ops/raster_pallas.py:2192, launched at :2777) on its three
// untextured routes, one C entry each:
//   tr_raster         K2: 8-row tiles, row packing 2 (wide=True,
//                     rows_packed=2; two strip streams per tile);
//   tr_raster_rows1   K3: 8-row tiles, one stream (wide=True,
//                     rows_packed=1, :2355-2371);
//   tr_raster_narrow  K4: 16-row tiles, one stream (the narrow form,
//                     :2372-2380, _chunk_best :910 per CHUNK_T chunk).
// Each runs stage-A span setup (_stage_a_fill :1120, which has the same
// span formulas in the same op order as the narrow _chunk_best: the narrow
// form masks entries through span_ok in the coverage test, the wide one
// through maxx = -BIG, and both reject the same pixels), the fold
// (_fold_chunk :1029, _merge_chunk_shaded :1489), the side-list fold
// (_chunk_best, _merge_chunk_shaded_bygid :1498) on tiles with lcounts > 0,
// and the finalize (_write_tile_color :1543, _finalize_shade :1600):
// per-pixel object selection by the winner's gid against the scene's
// [gid_lo, gid_hi) ranges, Blinn-Phong shade_planes where that object is
// Phong, the interpolated colour elsewhere, and pack_argb_planes.
//
// Bound on the H100: the busiest tile. Device-memory traffic is small (one
// 352 B record read per entry, 12 B written per pixel); the work is the
// per-(entry, row) span setup (~120 f32 operations with IEEE divisions) and
// the per-pixel fold, and one block walks a tile's entries in series. Dense
// meshes concentrate entries: on the 1M-triangle 1080p sphere 215 of 2,025
// tiles hold entries, one of them 7,165, and that tile sets the kernel's
// time while most SMs idle. Sparse scenes (K3, K4) launch few tiles with
// entries and are bound by launch latency and the finalize of the covered
// tiles. Splitting a tile's entries over several blocks merged by the
// (z, gid) key is the next step.
//
// Design: the TPU ran a sequential grid of (tile, record block) work items
// that carried each tile's z / gid / attribute scratch from one item to the
// next. Here one block of 128 threads owns one TILE_H x 128 framebuffer tile
// and loops over all of its entries itself, so nothing crosses blocks and
// no work-item table (wi_tile / item_start) or stream gather is needed: the
// block reads recs[sorted_tri[i]] directly for each of the tile's STREAMS
// streams (starts / counts at STREAMS * tile + stream). Entries go in
// batches of 128 (entry, row) pairs:
//   1. the block stages the batch's record rows in shared memory with
//      16-byte loads;
//   2. thread p runs stage A for pair p (span bounds, z and attribute left
//      values and per-pixel increments) into shared memory;
//   3. thread x, owning column x of the tile, folds every pair of the batch
//      into its TILE_H per-row winners held in registers.
// The winner rule is the lexicographic best (z descending, gid ascending)
// over fragments with z > DEPTH_CLEAR, which is what the TPU's strict '>'
// first-writer folds plus the gid-aware side-list merge compute; any order
// that keeps that key is exact. Every tile is written, so empty tiles need
// no masking afterwards. Tensor cores, TMA and a persistent schedule are
// left for later work.

#include "common.cuh"

namespace tr {

constexpr int kTileW = 128;
constexpr int kThreads = 128;   // one thread per tile column
constexpr int kMaxBatch = 32;   // entries per batch at 4 rows per entry
constexpr int kRecStride = 132; // shared row stride: 16 B aligned, banks spread
constexpr int kRecLoad = 88;    // lanes 0..87 hold every field and the gid
constexpr int kMaxFields = 7;   // rgba + normal xyz
// Span quantities of one (entry, row) pair.
constexpr int Q_MINX = 0, Q_MAXX = 1, Q_XOFF = 2, Q_ZL = 3, Q_ZINC = 4;
constexpr int Q_ATTR = 5;  // al, inc per field
constexpr int kNumQ = Q_ATTR + 2 * kMaxFields;

template <int NF, int TILE_H>
struct Winners {
  float z[TILE_H];
  int g[TILE_H];
  float a[TILE_H][NF];
};

struct Shared {
  float rec[kMaxBatch][kRecStride];
  float span[kNumQ][kThreads];
  int gid[kThreads];
};

// Active-edge order (projekt.cpp:212-216): lexicographic (x, xg, left, e).
__device__ __forceinline__ bool edge_less(const float* kx, const float* kg,
                                          const float* kl, int i, int j) {
  return kx[i] < kx[j] ||
         (kx[i] == kx[j] &&
          (kg[i] < kg[j] ||
           (kg[i] == kg[j] && (kl[i] < kl[j] || (kl[i] == kl[j] && i < j)))));
}

__device__ __forceinline__ float pick(const int* rank, const float* v, int r) {
  return rank[0] == r ? v[0] : (rank[1] == r ? v[1] : v[2]);
}

// Stage A of one (entry, row) pair: _stage_a_fill's formulas, same f32 op
// order, written to column p of the span table.
template <int NF>
__device__ __forceinline__ void stage_a(const float* rec, float yf, float w_f,
                                        Shared& sh, int p) {
  float dy[3], xs[3], kx[3], kg[3], kl[3];
  bool act[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* r = rec + e * kEdgeStride;
    const bool valid = r[F_VALID] > 0.5f;
    const float ymin = r[F_YMIN], ymax = r[F_YMAX];
    dy[e] = yf - ymin;
    act[e] = valid && (ymin <= yf) && (yf < ymax);
    xs[e] = r[F_X0] + dy[e] * r[F_XG];
    kx[e] = act[e] ? xs[e] : kBig;
    kg[e] = act[e] ? r[F_XG] : kBig;
    kl[e] = act[e] ? r[F_LEFT] : kBig;
  }
  int rank[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j != i) cnt += edge_less(kx, kg, kl, j, i) ? 1 : 0;
    rank[i] = cnt;
  }
  const float xl = pick(rank, xs, 0), xr = pick(rank, xs, 1);
  const int nact = (act[0] ? 1 : 0) + (act[1] ? 1 : 0) + (act[2] ? 1 : 0);

  // Span setup (projekt.cpp:306-421, closed form).
  const float xd = round_half_away(xr - xl);
  const bool nz = xd != 0.0f;
  const float xoff = xl < 0.0f ? -xl : 0.0f;
  const float w1 = w_f - 1.0f;
  const float lx = xl < 0.0f ? 0.0f : (xl >= w_f ? w1 : xl);
  const float rx = xr < 0.0f ? 0.0f : (xr >= w_f ? w1 : xr);
  const float minx = min_ieee(round_half_away(lx), w1);
  const float maxx = min_ieee(round_half_away(rx), w1);

  auto attr_lr = [&](int j0, int jg, float& al, float& ar) {
    float v[3];
#pragma unroll
    for (int e = 0; e < 3; ++e)
      v[e] = rec[e * kEdgeStride + j0] + dy[e] * rec[e * kEdgeStride + jg];
    al = pick(rank, v, 0);
    ar = pick(rank, v, 1);
  };
  float zl, zr;
  attr_lr(F_Z0, F_ZG, zl, zr);
  sh.span[Q_MINX][p] = minx;
  sh.span[Q_MAXX][p] = nact >= 2 ? maxx : -kBig;  // coverage gate
  sh.span[Q_XOFF][p] = xoff;
  sh.span[Q_ZL][p] = zl;
  sh.span[Q_ZINC][p] = nz ? (zr - zl) / xd : 0.0f;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const int j0 = i < 4 ? F_COL0 + i : F_N0 + (i - 4);
    const int jg = i < 4 ? F_COLG + i : F_NG + (i - 4);
    float al, ar;
    attr_lr(j0, jg, al, ar);
    sh.span[Q_ATTR + 2 * i][p] = al;
    sh.span[Q_ATTR + 2 * i + 1][p] = nz ? (ar - al) / xd : 0.0f;
  }
  sh.gid[p] = to_i32(rec[kGidLane]);
}

// Stage the records ids[0..ne), run stage A on their (entry, row) pairs for
// tile rows [row_lo, row_lo + NROWS), and fold the pairs into the winners
// of this thread's column. ne * NROWS <= kThreads.
template <int NF, int TILE_H, int NROWS>
__device__ __forceinline__ void fold_batch(const float* __restrict__ recs,
                                           const int* __restrict__ ids, int ne,
                                           int row_lo, int row_base, float w_f,
                                           float xc, Shared& sh,
                                           Winners<NF, TILE_H>& win) {
  static_assert(kThreads / NROWS <= kMaxBatch, "batch exceeds shared rows");
  constexpr int kPer = kRecLoad / 4;
  __syncthreads();  // the previous batch has been folded
  for (int i = threadIdx.x; i < ne * kPer; i += kThreads) {
    const int e = i / kPer, q = i - e * kPer;
    const float4* src =
        reinterpret_cast<const float4*>(recs + (size_t)ids[e] * kRecLanes);
    *reinterpret_cast<float4*>(&sh.rec[e][4 * q]) = __ldg(src + q);
  }
  __syncthreads();
  {
    const int p = threadIdx.x, e = p / NROWS, rr = p - e * NROWS;
    if (e < ne) {
      stage_a<NF>(sh.rec[e], static_cast<float>(row_base + row_lo + rr), w_f,
                  sh, p);
    } else {
      sh.span[Q_MINX][p] = 0.0f;
      sh.span[Q_MAXX][p] = -kBig;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    if (r < row_lo || r >= row_lo + NROWS) continue;
    for (int e = 0; e < ne; ++e) {
      const int p = e * NROWS + (r - row_lo);
      const float minx = sh.span[Q_MINX][p];
      if (!(xc >= minx && xc <= sh.span[Q_MAXX][p])) continue;
      const float k = sh.span[Q_XOFF][p] + (xc - minx);
      const float z = sh.span[Q_ZL][p] + k * sh.span[Q_ZINC][p];
      const int g = sh.gid[p];
      if (z > win.z[r] || (z == win.z[r] && g < win.g[r])) {
        win.z[r] = z;
        win.g[r] = g;
#pragma unroll
        for (int i = 0; i < NF; ++i)
          win.a[r][i] =
              sh.span[Q_ATTR + 2 * i][p] + k * sh.span[Q_ATTR + 2 * i + 1][p];
      }
    }
  }
}

// shade_planes' Phong branch for one pixel (ops/shading.py): unproject,
// per-light Blinn-Phong, clamp. prm = [dat, fl, m2p, cx, cy, ambient rgba,
// (light_p xyz, light_I rgba) per light].
__device__ __forceinline__ void shade_phong(float z, const float* a, float px,
                                            float py,
                                            const float* __restrict__ prm,
                                            int n_lights, float* out) {
  const float dat = prm[0], fl = prm[1], m2p = prm[2], cx = prm[3];
  const float cy = prm[4];
  const float dz = dat - z;
  const float inv_m2p = 1.0f / m2p;
  const float ax = (px - cx) * inv_m2p;
  const float ay = (py - cy) * inv_m2p;
  const float s = dz / fl;
  const float pos0 = s * ax, pos1 = s * ay, pos2 = z;
  float n0, n1, n2, v0, v1, v2;
  norm3(a[4], a[5], a[6], n0, n1, n2);  // divergence #3: single normalize
  norm3(-pos0, -pos1, -pos2, v0, v1, v2);
  float fin[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < n_lights; ++k) {
    const float* l = prm + 9 + 7 * k;
    if (k == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) fin[c] = a[c] * prm[5 + c];
    }
    float t0, t1, t2, h0, h1, h2;
    norm3(l[0] - pos0, l[1] - pos1, l[2] - pos2, t0, t1, t2);
    const float cosi = clamp01(inner3(n0, n1, n2, t0, t1, t2));
    norm3(t0 + v0, t1 + v1, t2 + v2, h0, h1, h2);
    const float spec = pow16(clamp01(inner3(n0, n1, n2, h0, h1, h2)));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      fin[c] = fin[c] + cosi * (a[c] * l[3 + c]) + spec * (1.0f * l[3 + c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c] = clamp01(fin[c]);
}

__device__ __forceinline__ unsigned pack_argb(const float* rgba) {
  unsigned ch[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    ch[c] = static_cast<unsigned>(to_i32(round_half_away(rgba[c] * 255.0f)));
  return (ch[3] << 24) | (ch[0] << 16) | (ch[1] << 8) | ch[2];
}

// _finalize_shade's per-object masks (raster_pallas.py:1630-1639) for a
// covered pixel won by triangle g, OR-ed over the Phong objects: is the
// pixel shaded? objs holds [gid_lo, gid_hi, phong] per object; with
// several objects a range end is compared only where a neighbour lies
// beyond it.
__device__ __forceinline__ bool pixel_is_phong(int g,
                                               const int* __restrict__ objs,
                                               int n_obj) {
  const bool multi = n_obj > 1;
  const int last_hi = __ldg(objs + 3 * (n_obj - 1) + 1);
  bool pm = false;
  for (int o = 0; o < n_obj; ++o) {
    const int lo = __ldg(objs + 3 * o), hi = __ldg(objs + 3 * o + 1);
    bool m = true;
    if (multi && lo > 0) m = m && g >= lo;
    if (multi && hi < last_hi) m = m && g < hi;
    if (m && __ldg(objs + 3 * o + 2) != 0) pm = true;
  }
  return pm;
}

template <int TILE_H, int STREAMS, bool ANY_PHONG>
__global__ void __launch_bounds__(kThreads) raster_kernel(
    const float* __restrict__ recs, const int* __restrict__ sorted_tri,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ large_ids, const int* __restrict__ n_large,
    const int* __restrict__ lcounts, const float* __restrict__ params,
    const int* __restrict__ objs, int n_obj, int n_lights, int tiles_x,
    int row0, int col0, float w_f, int out_w, float* __restrict__ z_out,
    int* __restrict__ gid_out, unsigned* __restrict__ color_out) {
  constexpr int NF = ANY_PHONG ? 7 : 4;
  constexpr int kStrip = TILE_H / STREAMS;  // rows each stream covers
  __shared__ __align__(16) Shared sh;
  const int tile = blockIdx.x;
  const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
  const int row_base = row0 + ty * TILE_H;
  const float xc = static_cast<float>(col0 + tx * kTileW + threadIdx.x);

  Winners<NF, TILE_H> win;
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    win.z[r] = kDepthClear;
    win.g[r] = -1;
#pragma unroll
    for (int i = 0; i < NF; ++i) win.a[r][i] = 0.0f;
  }

  // The tile's streams: stream h covers rows [h * kStrip, (h + 1) * kStrip).
#pragma unroll
  for (int h = 0; h < STREAMS; ++h) {
    constexpr int kBatch = kThreads / kStrip;
    const int s = starts[STREAMS * tile + h], n = counts[STREAMS * tile + h];
    for (int b0 = 0; b0 < n; b0 += kBatch)
      fold_batch<NF, TILE_H, kStrip>(recs, sorted_tri + s + b0,
                                     min(kBatch, n - b0), h * kStrip,
                                     row_base, w_f, xc, sh, win);
  }
  // The large-triangle side list, over all rows, where its bboxes reach.
  if (lcounts[tile] > 0) {
    constexpr int kSide = kThreads / TILE_H;
    const int nl = *n_large;
    for (int b0 = 0; b0 < nl; b0 += kSide)
      fold_batch<NF, TILE_H, TILE_H>(recs, large_ids + b0,
                                     min(kSide, nl - b0), 0, row_base, w_f,
                                     xc, sh, win);
  }

#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    const size_t o =
        (size_t)(ty * TILE_H + r) * out_w + tx * kTileW + threadIdx.x;
    z_out[o] = win.z[r];
    gid_out[o] = win.g[r];
    unsigned color = 0u;  // uncovered pixels pack the zero base color
    if (win.g[r] >= 0) {
      float rgba[4];
      bool shaded = false;
      if constexpr (ANY_PHONG) shaded = pixel_is_phong(win.g[r], objs, n_obj);
      if (shaded) {
        shade_phong(win.z[r], win.a[r], xc,
                    static_cast<float>(row_base + r), params, n_lights, rgba);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) rgba[c] = win.a[r][c];
      }
      color = pack_argb(rgba);
    }
    color_out[o] = color;
  }
}

template <int TILE_H, int STREAMS>
int launch_raster(const float* recs, const int* sorted_tri, const int* starts,
                  const int* counts, const int* large_ids, const int* n_large,
                  const int* lcounts, const float* params, const int* objs,
                  int n_obj, int n_lights, int any_phong, int tiles_y,
                  int tiles_x, int row0, int col0, int frame_w, float* z,
                  int* gid, unsigned* color, void* stream) {
  if (n_obj < 1 || tiles_y < 1 || tiles_x < 1) return 1;  // invalid value
  const dim3 grid(tiles_y * tiles_x);
  const dim3 block(kThreads);
  const int out_w = tiles_x * kTileW;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_phong)
    raster_kernel<TILE_H, STREAMS, true><<<grid, block, 0, s>>>(
        recs, sorted_tri, starts, counts, large_ids, n_large, lcounts, params,
        objs, n_obj, n_lights, tiles_x, row0, col0, (float)frame_w, out_w, z,
        gid, color);
  else
    raster_kernel<TILE_H, STREAMS, false><<<grid, block, 0, s>>>(
        recs, sorted_tri, starts, counts, large_ids, n_large, lcounts, params,
        objs, n_obj, n_lights, tiles_x, row0, col0, (float)frame_w, out_w, z,
        gid, color);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tr

#define TR_RASTER_ENTRY(NAME, TILE_H, STREAMS)                                 \
  extern "C" int NAME(const float* recs, const int* sorted_tri,                \
                      const int* starts, const int* counts,                    \
                      const int* large_ids, const int* n_large,                \
                      const int* lcounts, const float* params,                 \
                      const int* objs, int n_obj, int n_lights, int any_phong, \
                      int tiles_y, int tiles_x, int row0, int col0,            \
                      int frame_w, float* z, int* gid, unsigned* color,        \
                      void* stream) {                                          \
    return tr::launch_raster<TILE_H, STREAMS>(                                 \
        recs, sorted_tri, starts, counts, large_ids, n_large, lcounts, params, \
        objs, n_obj, n_lights, any_phong, tiles_y, tiles_x, row0, col0,        \
        frame_w, z, gid, color, stream);                                       \
  }

TR_RASTER_ENTRY(tr_raster, 8, 2)         // K2
TR_RASTER_ENTRY(tr_raster_rows1, 8, 1)   // K3
TR_RASTER_ENTRY(tr_raster_narrow, 16, 1) // K4
