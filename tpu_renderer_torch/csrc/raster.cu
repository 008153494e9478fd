// K2, K3, K4, K6: fused raster + shade, and K5, the texture sampler of
// their finalize (its code and the shading math in shade.cuh); K8, K9, K10:
// raster into a G-buffer; K11: the occlusion skip of K2 and K3.
//
// Replaces the Pallas kernels _raster_kernel_queue_shaded
// (tpu_renderer/ops/raster_pallas.py:2192, launched at :2777) on its three
// routes, _raster_kernel_tilelist_shaded (:2121, launched at :2598) and the
// G-buffer family (_raster_kernel_tilelist :1756, _raster_kernel_queue
// :1853, _raster_kernel_bcast :2018), one C entry each:
//   tr_raster         K2: sorted, 8-row tiles, row packing 2 (wide=True,
//                     rows_packed=2; two strip streams per tile);
//   tr_raster_rows1   K3: sorted, 8-row tiles, one stream (wide=True,
//                     rows_packed=1, :2355-2371);
//   tr_raster_narrow_any
//                     K4: sorted, one stream, tiles of any multiple of 8
//                     rows above 8 (the narrow form, :2372-2380,
//                     _chunk_best :910 per CHUNK_T chunk), the height a
//                     runtime value (the band form, below);
//   tr_raster_mask    K6: mask strategy, tiles of any multiple of 8 rows,
//                     each tile's padded triangle list (bin_triangles), no
//                     side list, folded a frame row a block (see "The
//                     mask strategy" below);
//   tr_gbuffer_mask   K8: K6's fold, the G-buffer finalize (gbuffer_tile);
//   tr_gbuffer_queue  K9 + K10: one sorted stream into a G-buffer, 8-row
//                     tiles in the split form, any other multiple of 8
//                     rows in the band form;
//   tr_raster_zcull, tr_raster_rows1_zcull
//                     K11: K2 and K3 with the zcull branch (zcull and wide,
//                     :2384-2394, bound _spanex_block_zmax :2151): a batch
//                     that cannot win a pixel skips its fold
//                     (batch_occluded). Output-exact; a batch's bound and
//                     min cost one more barrier, two shuffle reductions and
//                     a read of its strip's keys.
// The sorted entries (K2, K3, K4, K9 + K10, K11) split each tile's streams
// into parts that many blocks fold in parallel, the side list (K10 on the
// G-buffer route) one more part of each tile it reaches, and merge the
// parts by a (z desc, gid asc) key per pixel before a finalize per tile
// (see "The sorted strategy, each tile's entries split" below): on 8-row
// tiles (K2, K3, K11, K9) in the split form, whose blocks fold a part into
// winners in registers; on every other multiple of 8 rows (K4, K9 + K10)
// in the band form, whose blocks merge each fragment into its key. The TPU
// ran K10 as a second grid and merged the two G-buffers by that rule; here
// the key merge does it, so no second (11, H, W) buffer exists.
// Each runs stage-A span setup (_stage_a_fill :1120, which has the same
// span formulas in the same op order as the narrow _chunk_best: the narrow
// form masks entries through span_ok in the coverage test, the wide one
// through maxx = -BIG, and both reject the same pixels), the fold
// (_fold_chunk :1029, _merge_chunk_shaded :1489), on the sorted routes the
// side-list fold (_chunk_best, _merge_chunk_shaded_bygid :1498) on tiles
// with lcounts > 0, and the finalize (_write_tile_color :1543,
// _finalize_shade :1600): per-pixel object selection by the winner's gid
// against the scene's [gid_lo, gid_hi) ranges; for a textured object the
// perspective-correct u, v and K5, the atlas fetch (nearest
// _sample_texture_atlas :755, bilinear _sample_texture_atlas_bilinear
// :863), as its base colour; Blinn-Phong shade_planes where the object is
// Phong, the base colour elsewhere; pack_argb_planes.
//
// Bound on the H100: the busiest tile's work. Device-memory traffic is small
// (one 352 B record read per entry, 12 B written per pixel, 48 B for a
// G-buffer pixel, 8 B a pixel of keys on the sorted routes); the work is
// the per-(entry, row) span setup (~60 f32 operations with IEEE divisions)
// and the per-pixel fold. Dense meshes concentrate entries: on the
// 1M-triangle 1080p sphere 215 of 2,025 tiles hold entries, one of them
// 7,165. One block walking a tile's entries in series let that tile set the
// kernel's time while most SMs idled (and a 32-row tile, two 16-row tiles'
// entries, about doubled it), so the sorted routes split a tile's entries
// over many blocks. The mask strategy (K6, K8), whose lists hold at most a
// few thousand small-scene entries, splits each tile into row strips
// instead: its frames are small (128 16-row tiles at 512x512), and one block
// a tile left the card nearly empty, each thread finalizing 16 pixels in
// series with nothing to hide their latency.
//
// Design: the TPU ran a sequential grid of (tile, record block) work items
// that carried each tile's z / gid / attribute scratch from one item to the
// next. Here a block of 128 threads folds a run of one tile's entries (the
// mask strategy: all of them, over one of its rows; the split form: a part)
// into the winners of those rows' 128 columns in registers, reading
// recs[ids[i]] directly, from the sorted streams
// (starts / counts at STREAMS * tile + stream) or the mask strategy's
// per-tile list (ids at tile * capacity, counts[tile]). Entries go in
// batches of one (entry, row) pair per thread:
//   1. the block stages the batch's record rows in shared memory with
//      16-byte loads;
//   2. thread p runs stage A's depth part for pair p (span bounds, z left
//      value and per-pixel increment) into shared memory;
//   3. thread x, owning column x of the tile, folds every pair of the batch
//      into its per-row winners: (z, gid, k), k the step from the span's
//      left end.
// The winner rule is the lexicographic best (z descending, gid ascending)
// over fragments with z > DEPTH_CLEAR, which is what the TPU's strict '>'
// first-writer folds over gid-ordered lists plus the gid-aware side-list
// merge compute; any order that keeps that key is exact. The winners carry
// no attributes: the finalize recomputes the winner's stage A from its
// record (row gid of the table) for only the planes that pixel's object
// reads (colour, normal, u/z v/z 1/z), with the same f32 operations, so
// the value al + k * inc is the one the fold would have kept. Registers
// stay at 3 * rows winner values (rows 8 or 1) whatever the scene's planes
// (config 5 needs 10), and one template serves every field set. Every tile
// is written, so empty tiles need no masking afterwards. Tensor cores and
// TMA are left for later work.

#include "common.cuh"
#include "shade.cuh"

namespace tr {

constexpr int kTileW = 128;
constexpr int kThreads = 128;    // one thread per tile column
constexpr int kMaxBatch = 32;    // entries per batch at 4 rows per entry
constexpr int kMaxStripBatch = 64;  // mask strip batch: 48 KB static smem
constexpr int kRecLoad = 88;     // lanes 0..87 hold every field and the gid
constexpr int kRecStride = 92;   // shared row stride: 16 B aligned
// Depth part of stage A for one (entry, row) pair.
constexpr int Q_MINX = 0, Q_MAXX = 1, Q_XOFF = 2, Q_ZL = 3, Q_ZINC = 4;
constexpr int kNumQ = 5;

// The winners of a thread's column over ROWS rows of a tile (the split
// form's 8, a mask strip's 1): thread x of a block owns column x.
template <int ROWS>
struct Winners {
  float z[ROWS];
  int g[ROWS];
  float k[ROWS];
};

// A block's batch: BATCH staged records, one (entry, row) pair a thread.
template <int BATCH = kMaxBatch>
struct SharedT {
  float rec[BATCH][kRecStride];
  float span[kNumQ][kThreads];
  int gid[kThreads];
};
using Shared = SharedT<>;

// Everything the finalize reads besides the winners. The shaded kernels
// write z, gid and colour; the G-buffer kernels gid and the 11 planes.
struct Finalize {
  const float* recs;     // (Tp, 128): record of gid g is row g
  const float* params;   // shade_params
  const int* objs;       // (n_obj, 3) [gid_lo, gid_hi, phong]
  const int* texs;       // (n_obj, 4) [v_off, th, tw, bilinear], th 0 = none
  const unsigned* atlas; // (AH, aw) u32 ARGB, or null
  int aw, n_obj, n_lights;
  int tiles_x, row0, col0, out_w;
  float w_f;
  float* z_out;
  int* gid_out;
  unsigned* color_out;
  float* gbuf_out;  // (11, out_h, out_w)
  size_t plane;     // out_h * out_w
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

// One record's edges on one row: the active edges' order, their row
// offsets, the span's ends and its rounded width (_stage_a_fill's first
// half, same f32 op order).
struct RowSpan {
  float dy[3];
  int rank[3];
  float xl, xr, xd;
  int nact;
};

__device__ __forceinline__ void row_span(const float* rec, float yf,
                                         RowSpan& s) {
  float xs[3], kx[3], kg[3], kl[3];
  s.nact = 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* r = rec + e * kEdgeStride;
    const bool valid = r[F_VALID] > 0.5f;
    const float ymin = r[F_YMIN], ymax = r[F_YMAX];
    s.dy[e] = yf - ymin;
    const bool act = valid && (ymin <= yf) && (yf < ymax);
    xs[e] = r[F_X0] + s.dy[e] * r[F_XG];
    kx[e] = act ? xs[e] : kBig;
    kg[e] = act ? r[F_XG] : kBig;
    kl[e] = act ? r[F_LEFT] : kBig;
    s.nact += act ? 1 : 0;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j != i) cnt += edge_less(kx, kg, kl, j, i) ? 1 : 0;
    s.rank[i] = cnt;
  }
  s.xl = pick(s.rank, xs, 0);
  s.xr = pick(s.rank, xs, 1);
  s.xd = round_half_away(s.xr - s.xl);
}

// Left value and per-pixel increment of the attribute at lanes (j0, jg).
__device__ __forceinline__ void attr_span(const float* rec, const RowSpan& s,
                                          int j0, int jg, float& al,
                                          float& inc) {
  float v[3];
#pragma unroll
  for (int e = 0; e < 3; ++e)
    v[e] = rec[e * kEdgeStride + j0] + s.dy[e] * rec[e * kEdgeStride + jg];
  al = pick(s.rank, v, 0);
  const float ar = pick(s.rank, v, 1);
  inc = s.xd != 0.0f ? (ar - al) / s.xd : 0.0f;
}

// The attribute's value k pixels from the span's left end.
__device__ __forceinline__ float attr_at(const float* rec, const RowSpan& s,
                                         int j0, int jg, float k) {
  float al, inc;
  attr_span(rec, s, j0, jg, al, inc);
  return al + k * inc;
}

// Span setup (projekt.cpp:306-421, closed form): the span's first and last
// column on this row, clipped to the frame, and the step of the first from
// the unclipped left end. Stage A and K9's finalize both call it, so the k
// the finalize recomputes is the fold's, bit for bit.
__device__ __forceinline__ void span_cols(const RowSpan& s, float w_f,
                                          float& minx, float& maxx,
                                          float& xoff) {
  const float xl = s.xl, xr = s.xr;
  xoff = xl < 0.0f ? -xl : 0.0f;
  const float w1 = w_f - 1.0f;
  const float lx = xl < 0.0f ? 0.0f : (xl >= w_f ? w1 : xl);
  const float rx = xr < 0.0f ? 0.0f : (xr >= w_f ? w1 : xr);
  minx = min_ieee(round_half_away(lx), w1);
  maxx = min_ieee(round_half_away(rx), w1);
}

// Stage A's depth part for one (entry, row) pair, written to column p of
// the span table (the attribute planes are recomputed at the finalize).
template <class SH>
__device__ __forceinline__ void stage_a(const float* rec, float yf, float w_f,
                                        SH& sh, int p) {
  RowSpan s;
  row_span(rec, yf, s);
  float minx, maxx, xoff;
  span_cols(s, w_f, minx, maxx, xoff);
  float zl, zinc;
  attr_span(rec, s, F_Z0, F_ZG, zl, zinc);
  sh.span[Q_MINX][p] = minx;
  sh.span[Q_MAXX][p] = s.nact >= 2 ? maxx : -kBig;  // coverage gate
  sh.span[Q_XOFF][p] = xoff;
  sh.span[Q_ZL][p] = zl;
  sh.span[Q_ZINC][p] = zinc;
  sh.gid[p] = to_i32(rec[kGidLane]);
}

// The merge key of a partial winner: unsigned order is the fold's order.
// High word: z's bits made monotone (the sign flip: negative floats
// inverted, positive ones with the sign bit set), after -0 is made +0, since
// the fold's `z > win.z || (z == win.z && g < win.g)` treats +-0 as one z
// that the smaller gid wins; low word: 0xFFFFFFFF - g, larger for the
// smaller gid. A partial winner has z > kDepthClear (the fold starts there
// with gid -1 and takes only strictly larger z or, at the same z, a smaller
// gid, which no g >= 0 is than -1), so z is never NaN, -inf or -FLT_MAX,
// its high word is above that of -FLT_MAX, and the key is never 0. The bit
// order holds for subnormals as for normal numbers (built -ftz=false).
__device__ __forceinline__ unsigned long long winner_key(float z, int g) {
  unsigned u = __float_as_uint(z);
  if (u == 0x80000000u) u = 0u;
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(ord) << 32) |
         (0xFFFFFFFFu - static_cast<unsigned>(g));
}

// The z of a key (winner_key's high word undone; -0 comes back as +0), and
// kDepthClear for key 0, no winner.
__device__ __forceinline__ float key_z(unsigned long long key) {
  if (key == 0ull) return kDepthClear;
  const unsigned ord = static_cast<unsigned>(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7FFFFFFFu) : ~ord);
}

// A key as it stands now, while other blocks may raise it: a relaxed load
// at device scope, which reads L2, where the atomics are performed.
__device__ __forceinline__ unsigned long long load_key(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// K11: can no pair of this batch win a pixel? Replaces the zcull branch of
// _raster_kernel_queue_shaded (raster_pallas.py:2384-2394) and its bound
// _spanex_block_zmax (:2151). zmax is the max over the batch's (entry,
// row) pairs of z at the span's ends minx and maxx, by the fold's own
// formula (z is linear in k and f32 rounding is monotone, so no pixel of
// the span lies above its ends); rows without a span (maxx = -BIG) are left
// out, and a NaN end counts as +inf, which never culls. zmin is the min,
// over the pixels of the rows the batch folds (a stream's entries touch
// only its strip's rows), of max(this part's partial winner z, the z of
// the pixel's merge key as it stands now; key 0 counts as DEPTH_CLEAR).
// The skip is exact, whatever the order in which the parts run and
// whatever key values this block reads:
//   - keys only grow (atomicMax), and every key ever stored is the key of
//     a partial winner at that pixel, so the z read from a key, stale or
//     not, is at or below the z of the pixel's final winner (the largest
//     key); this part's partial winner is merged into that key too, so its
//     z is at or below it as well;
//   - when zmax + |zmax| * 1e-6 < zmin, every fragment of the batch lies
//     strictly below the final winner of its pixel, so it is not that
//     winner and cannot tie it: skipping the fold removes only fragments
//     that lose, and the winner's own fragment is never skipped (its z
//     would be below itself).
// The margin is the one of the serial form; nothing else is loosened.
// ``keys`` points at this thread's column in tile row 0, rows key_stride
// apart. The reduction is block-wide (warp shuffles, one shared slot per
// warp) and every thread returns the same answer.
template <int TILE_H, int NROWS>
__device__ __forceinline__ bool batch_occluded(
    const Shared& sh, const Winners<TILE_H>& win, int row_lo,
    const unsigned long long* keys, size_t key_stride) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[2][kWarps];
  const float inf = __int_as_float(0x7f800000);
  const int p = threadIdx.x;
  const float minx = sh.span[Q_MINX][p], maxx = sh.span[Q_MAXX][p];
  float zmax = -kBig;
  if (maxx != -kBig) {
    const float xoff = sh.span[Q_XOFF][p], zl = sh.span[Q_ZL][p];
    const float zinc = sh.span[Q_ZINC][p];
    const float z_lo = zl + (xoff + (minx - minx)) * zinc;
    const float z_hi = zl + (xoff + (maxx - minx)) * zinc;
    zmax = max_ieee(z_lo, z_hi);
    if (is_nan(zmax)) zmax = inf;
  }
  float zmin = inf;
#pragma unroll
  for (int r = 0; r < TILE_H; ++r)
    if (r >= row_lo && r < row_lo + NROWS)
      zmin = fminf(zmin, fmaxf(win.z[r],
                               key_z(load_key(keys + r * key_stride))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, o));
    zmin = fminf(zmin, __shfl_xor_sync(0xffffffffu, zmin, o));
  }
  if ((p & 31) == 0) {
    red[0][p >> 5] = zmax;
    red[1][p >> 5] = zmin;
  }
  __syncthreads();
  zmax = red[0][0];
  zmin = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    zmax = fmaxf(zmax, red[0][w]);
    zmin = fminf(zmin, red[1][w]);
  }
  return zmax + fabsf(zmax) * 1e-6f < zmin;
}

// Stage the records ids[0..ne), run stage A on their (entry, row) pairs for
// tile rows [row_lo, row_lo + NROWS), and fold the pairs into the winners
// of this thread's column. ne <= BATCH and ne * NROWS <= kThreads. With
// CULL (K11) a batch that cannot win a pixel (batch_occluded, against
// ``keys``) skips its fold and, when ``skipped`` is not null, adds one to
// it.
template <int TILE_H, int NROWS, bool CULL = false, int BATCH = kMaxBatch>
__device__ __forceinline__ void fold_batch(
    const float* __restrict__ recs, const int* __restrict__ ids, int ne,
    int row_lo, int row_base, float w_f, float xc, SharedT<BATCH>& sh,
    Winners<TILE_H>& win, int* skipped = nullptr,
    const unsigned long long* keys = nullptr, size_t key_stride = 0) {
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
      stage_a(sh.rec[e], static_cast<float>(row_base + row_lo + rr), w_f, sh,
              p);
    } else {
      sh.span[Q_MINX][p] = 0.0f;
      sh.span[Q_MAXX][p] = -kBig;
    }
  }
  __syncthreads();
  if constexpr (CULL) {
    if (batch_occluded<TILE_H, NROWS>(sh, win, row_lo, keys, key_stride)) {
      if (threadIdx.x == 0 && skipped != nullptr) atomicAdd(skipped, 1);
      return;
    }
  }
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
        win.k[r] = k;
      }
    }
  }
}

// _finalize_shade's per-object masks (raster_pallas.py:1630-1639) for a
// covered pixel won by triangle g: is it Phong (OR over the Phong objects'
// masks), and which textured object's texture does it sample (the last
// textured object whose mask holds it, as the TPU merges the indices; -1
// for none)? With several objects a range end is compared only where a
// neighbour lies beyond it.
__device__ __forceinline__ void pixel_object(int g, const Finalize& f,
                                             bool& phong, int& tex) {
  const bool multi = f.n_obj > 1;
  const int last_hi = __ldg(f.objs + 3 * (f.n_obj - 1) + 1);
  phong = false;
  tex = -1;
  for (int o = 0; o < f.n_obj; ++o) {
    const int lo = __ldg(f.objs + 3 * o), hi = __ldg(f.objs + 3 * o + 1);
    bool m = true;
    if (multi && lo > 0) m = m && g >= lo;
    if (multi && hi < last_hi) m = m && g < hi;
    if (!m) continue;
    if (__ldg(f.objs + 3 * o + 2) != 0) phong = true;
    if (__ldg(f.texs + 4 * o + 1) > 0) tex = o;
  }
}

// Colour of one covered pixel: the winner's record re-run through stage A
// on this row for the planes its object reads, then texture, shading and
// packing in _finalize_shade's order.
__device__ __forceinline__ unsigned shade_pixel(const Finalize& f, int g,
                                                float z, float k, float px,
                                                float py) {
  bool phong;
  int tex;
  pixel_object(g, f, phong, tex);
  const float* rec = f.recs + (size_t)g * kRecLanes;
  RowSpan s;
  row_span(rec, py, s);
  float col[4], rgba[4];
  if (tex >= 0) {
    const float uoz = attr_at(rec, s, F_U0, F_UG, k);
    const float voz = attr_at(rec, s, F_V0, F_VG, k);
    const float oz = attr_at(rec, s, F_OZ0, F_OZG, k);
    const float inv_oz = 1.0f / oz;
    const int* t = f.texs + 4 * tex;
    sample_texture(f.atlas, f.aw, inv_oz * uoz, inv_oz * voz, __ldg(t),
                   __ldg(t + 1), __ldg(t + 2), __ldg(t + 3) != 0, col);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      col[c] = attr_at(rec, s, F_COL0 + c, F_COLG + c, k);
  }
  if (phong) {
    float nrm[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      nrm[c] = attr_at(rec, s, F_N0 + c, F_NG + c, k);
    shade_phong(z, col, nrm, px, py, f.params, f.n_lights, rgba);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) rgba[c] = col[c];
  }
  return pack_argb(rgba);
}

// Write this thread's pixels of the tile: z, gid and colour; uncovered
// pixels pack the zero base.
template <int TILE_H>
__device__ __forceinline__ void finalize_tile(const Finalize& f,
                                              const Winners<TILE_H>& win,
                                              int ty, int tx, int row_base,
                                              float xc) {
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    const size_t o = (size_t)(ty * TILE_H + r) * f.out_w + tx * kTileW +
                     threadIdx.x;
    f.z_out[o] = win.z[r];
    f.gid_out[o] = win.g[r];
    f.color_out[o] =
        win.g[r] >= 0 ? shade_pixel(f, win.g[r], win.z[r], win.k[r], xc,
                                    static_cast<float>(row_base + r))
                      : 0u;
  }
}

// ---------------------------------------------------------------------------
// K8 / K9 / K10: the G-buffer finalize. Replaces _init_gbuf_tile
// (raster_pallas.py:1728) and _merge_chunk_gbuf (:1478): covered pixels
// get z and the 10 attribute planes of the winner, re-run from its record
// at the winner's k like shade_pixel's planes; uncovered ones DEPTH_CLEAR,
// zeros and gid -1. Thread x writes column x of every plane: coalesced.
// ---------------------------------------------------------------------------

constexpr int kAttrPlanes = 10;

// Lanes (left value, gradient) of G-buffer channel 1 + c, in channel order:
// rgba, normal xyz, u/z, v/z, 1/z.
__device__ __forceinline__ void attr_lanes(int c, int& j0, int& jg) {
  if (c < 4) {
    j0 = F_COL0 + c;
    jg = F_COLG + c;
  } else if (c < 7) {
    j0 = F_N0 + c - 4;
    jg = F_NG + c - 4;
  } else if (c == 7) {
    j0 = F_U0;
    jg = F_UG;
  } else if (c == 8) {
    j0 = F_V0;
    jg = F_VG;
  } else {
    j0 = F_OZ0;
    jg = F_OZG;
  }
}

template <int TILE_H>
__device__ __forceinline__ void gbuffer_tile(const Finalize& f,
                                             const Winners<TILE_H>& win,
                                             int ty, int tx, int row_base) {
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    const size_t o = (size_t)(ty * TILE_H + r) * f.out_w + tx * kTileW +
                     threadIdx.x;
    const int g = win.g[r];
    f.gid_out[o] = g;
    float* px = f.gbuf_out + o;
    px[0] = win.z[r];
    if (g >= 0) {
      const float* rec = f.recs + (size_t)g * kRecLanes;
      RowSpan s;
      row_span(rec, static_cast<float>(row_base + r), s);
#pragma unroll
      for (int c = 0; c < kAttrPlanes; ++c) {
        int j0, jg;
        attr_lanes(c, j0, jg);
        px[(c + 1) * f.plane] = attr_at(rec, s, j0, jg, win.k[r]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kAttrPlanes; ++c) px[(c + 1) * f.plane] = 0.0f;
    }
  }
}

template <int ROWS>
__device__ __forceinline__ void init_winners(Winners<ROWS>& win) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    win.z[r] = kDepthClear;
    win.g[r] = -1;
    win.k[r] = 0.0f;
  }
}

// The tile's outputs: the G-buffer (GBUF) or z, gid and colour.
template <int TILE_H, bool GBUF>
__device__ __forceinline__ void write_tile(const Finalize& f,
                                           const Winners<TILE_H>& win, int ty,
                                           int tx, int row_base, float xc) {
  if constexpr (GBUF)
    gbuffer_tile<TILE_H>(f, win, ty, tx, row_base);
  else
    finalize_tile<TILE_H>(f, win, ty, tx, row_base, xc);
}

// ---------------------------------------------------------------------------
// K6 (shaded) and K8 (G-buffer): the mask strategy, one block per (tile,
// row). Tile t's triangles are ids[t * capacity + i] for i < counts[t], in
// submission order; each covers all of the tile's rows.
//
// One block a tile, each thread finalizing its column's TILE_H pixels in
// series, left the card nearly empty on the frames this strategy draws
// (128 blocks of 4 warps for config 3's 16-row tiles at 512x512, 64 of 8
// warps at 32 rows), and each thread's chain of dependent divisions, texel
// loads and square roots uncovered: the finalize took 0.030 of its 0.037
// ms there (PERF.md, section 6). Here the frame is cut into strips of S =
// 1 row, the fastest on every scene of a sweep of 1, 2, 4 and 8 rows on an
// H100 (PERF.md): strip sy is frame row row0 + sy, and block (sy, tx) folds
// the WHOLE list of tile (sy / tile_h, tx) over that row only, then writes
// it. 128 threads, one a column, one winner each; a batch stages
// kMaxStripBatch records. Stage A still runs once per (entry, row) pair
// over the whole tile; only the record staging repeats in each row, from
// L2. Exact: each row folds the whole list with the fold's (z desc, gid
// asc) rule, and row sy of the strips is the int the one-block form
// computed as row0 + ty * tile_h + r, so every float is the same.
// ---------------------------------------------------------------------------

template <int S, bool GBUF>
__global__ void __launch_bounds__(kThreads) mask_kernel(
    const int* __restrict__ ids, const int* __restrict__ counts, int capacity,
    int strips, Finalize f) {
  constexpr int kBatch =
      kThreads / S < kMaxStripBatch ? kThreads / S : kMaxStripBatch;
  __shared__ __align__(16) SharedT<kBatch> sh;
  const int sy = blockIdx.x / f.tiles_x, tx = blockIdx.x - sy * f.tiles_x;
  const int tile = sy / strips * f.tiles_x + tx;
  const int row_base = f.row0 + sy * S;
  const float xc = static_cast<float>(f.col0 + tx * kTileW + threadIdx.x);
  Winners<S> win;
  init_winners(win);
  const int* list = ids + (size_t)tile * capacity;
  const int n = counts[tile];
  for (int b0 = 0; b0 < n; b0 += kBatch)
    fold_batch<S, S>(f.recs, list + b0, min(kBatch, n - b0), 0, row_base,
                     f.w_f, xc, sh, win);
  write_tile<S, GBUF>(f, win, sy, tx, row_base, xc);
}

// One mask launch: tiles of tile_h rows (a multiple of 8), one block a
// (row, tile column).
template <bool GBUF>
int mask_launch(const int* ids, const int* counts, int capacity, int tile_h,
                int tiles_y, const Finalize& f, cudaStream_t s) {
  if (tile_h < 8 || tile_h % 8 != 0) return 1;  // invalid value
  const int strips = tile_h;  // a tile's strips of one row
  const long long grid = (long long)tiles_y * strips * f.tiles_x;
  if (grid > 0x7FFFFFFFLL) return 1;
  mask_kernel<1, GBUF><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      ids, counts, capacity, strips, f);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The sorted strategy, each tile's entries split over many blocks: K2, K3,
// K4 (raster + shade), K11 (K2 and K3 with the occlusion skip) and K9 + K10
// (into a G-buffer). Replaces _raster_kernel_queue_shaded
// (raster_pallas.py:2192) on its routes, _raster_kernel_queue (:1853) and
// _raster_kernel_bcast (:2018) with its merge _merge_gbuf_by_gid (:2954),
// whose sequential grids of (tile, record block) work items carried a
// tile's scratch from one item to the next.
//
// One block walking a tile's entries in series left the busiest tile to set
// the time (7,165 entries on the 1M-triangle 1080p sphere, while 1,810 of
// 2,025 tiles hold none). Here the work items run in parallel:
//   1. part_scan_kernel: a stream part is a run of at most P entries of one
//      stream h of tile t (STREAMS streams a tile, stream h covering the
//      strip of rows [h * TILE_H / STREAMS, (h + 1) * TILE_H / STREAMS)),
//      and where lcounts[t] > 0 the side list is one more part of t, over
//      all rows; one block counts each tile's parts and writes their
//      exclusive prefix sum (part_off[nfb] is the total), on the device, so
//      the host never waits. A tile's parts are numbered stream by stream,
//      in stream order, the side-list part last;
//   2. split_walk_kernel: a grid of about as many blocks as the card holds
//      at once strides over the parts; a block finds its part's tile by
//      binary search in part_off, folds the part with fold_batch into
//      registers (a stream part over its strip's rows, the side list over
//      all of them), then each pixel whose partial winner has g >= 0 does
//      one atomicMax on its 64-bit key;
//   3. split_finalize_kernel: one block a tile decodes each pixel's winning
//      gid from the key, recomputes the fold's k and z from recs[g] at the
//      pixel's own row with the same f32 operations (fold_kz: the row the
//      fold took as row_base + h * strip + rr is the same int, so the same
//      float), and writes z, gid and colour (finalize_tile: K5, the object
//      masks, Phong) or gid and the 11 planes (gbuffer_tile).
// The key orders partial winners as the fold does, z descending then gid
// ascending (winner_key), so the merge is exact in any order of the parts.
// The keys are (hp, wp) u64 over the whole padded frame, zeroed each
// launch; 0 stands for no winner. K11 culls a stream batch against its
// part's partial winners and the keys as they stand (batch_occluded).
// ---------------------------------------------------------------------------

constexpr int kScanThreads = 1024;

__device__ __forceinline__ int stream_parts(int n, int part_entries) {
  return n > 0 ? (n - 1) / part_entries + 1 : 0;  // no overflow at INT_MAX
}

// part_off[t] = the parts of tiles [0, t), t <= nfb; stream h of tile t has
// counts[STREAMS * t + h] entries. One block of kScanThreads threads,
// kScanThreads tiles a round.
template <int STREAMS>
__global__ void __launch_bounds__(kScanThreads) part_scan_kernel(
    const int* __restrict__ counts, const int* __restrict__ lcounts, int nfb,
    int part_entries, int* __restrict__ part_off) {
  constexpr int kWarps = kScanThreads / 32;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < nfb; base += kScanThreads) {
    const int t = base + threadIdx.x;
    int n = 0;
    if (t < nfb) {
      n = lcounts[t] > 0 ? 1 : 0;
#pragma unroll
      for (int h = 0; h < STREAMS; ++h)
        n += stream_parts(counts[STREAMS * t + h], part_entries);
    }
    int v = n;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' sums
      int w = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      warp_sum[lane] = w;
    }
    __syncthreads();
    if (t < nfb)
      part_off[t] = carry + v - n + (warp > 0 ? warp_sum[warp - 1] : 0);
    carry += warp_sum[kWarps - 1];
    __syncthreads();  // every thread has read warp_sum
  }
  if (threadIdx.x == 0) part_off[nfb] = carry;
}

// The fold's k and z for record rec at pixel (xc, yf): stage A's span
// setup and attr_span, then the fold's two lines, the same f32 operations
// in the same order, so z carries the bits (and the sign of a zero) the
// fold compared.
__device__ __forceinline__ void fold_kz(const float* rec, float yf, float w_f,
                                        float xc, float& k, float& z) {
  RowSpan s;
  row_span(rec, yf, s);
  float minx, maxx, xoff;
  span_cols(s, w_f, minx, maxx, xoff);
  k = xoff + (xc - minx);
  float zl, zinc;
  attr_span(rec, s, F_Z0, F_ZG, zl, zinc);
  z = zl + k * zinc;
}

template <int TILE_H>
__device__ __forceinline__ size_t tile_pixel(const Finalize& f, int ty,
                                             int tx, int r) {
  return (size_t)(ty * TILE_H + r) * f.out_w + tx * kTileW + threadIdx.x;
}

// Fold ids[0..ne) in batches of kThreads / NROWS entries over tile rows
// [row_lo, row_lo + NROWS).
template <int TILE_H, int NROWS, bool CULL>
__device__ __forceinline__ void fold_run(const int* ids, int ne, int row_lo,
                                         int row_base, float xc,
                                         const Finalize& f, Shared& sh,
                                         Winners<TILE_H>& win, int* skipped,
                                         const unsigned long long* keys) {
  constexpr int kBatch = kThreads / NROWS;
  static_assert(kBatch <= kMaxBatch, "batch exceeds shared rows");
  for (int b0 = 0; b0 < ne; b0 += kBatch)
    fold_batch<TILE_H, NROWS, CULL>(f.recs, ids + b0, min(kBatch, ne - b0),
                                    row_lo, row_base, f.w_f, xc, sh, win,
                                    skipped, keys, f.out_w);
}

// The tile of part ``part`` (part_off[tile] <= part < part_off[tile + 1],
// by binary search), the part's stream h (STREAMS: the side list, numbered
// after the streams' parts) and its run of entries ids[0..ne).
template <int STREAMS>
__device__ __forceinline__ int part_run(
    int part, const int* __restrict__ part_off, int nfb,
    const int* __restrict__ sorted_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ large_ids,
    const int* __restrict__ n_large, int part_entries, int& h,
    const int*& ids, int& ne) {
  int lo = 0, hi = nfb;  // part_off[lo] <= part < part_off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (part_off[mid] <= part)
      lo = mid;
    else
      hi = mid;
  }
  const int tile = lo;
  int j = part - part_off[lo];
  for (h = 0; h < STREAMS; ++h) {
    const int np = stream_parts(counts[STREAMS * tile + h], part_entries);
    if (j < np) break;
    j -= np;
  }
  ids = large_ids;
  ne = *n_large;
  if (h < STREAMS) {
    const int first = j * part_entries;
    ids = sorted_tri + starts[STREAMS * tile + h] + first;
    ne = min(counts[STREAMS * tile + h] - first, part_entries);
  }
  return tile;
}

template <int TILE_H, int STREAMS, bool CULL>
__global__ void __launch_bounds__(kThreads) split_walk_kernel(
    const int* __restrict__ sorted_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ large_ids,
    const int* __restrict__ n_large, const int* __restrict__ part_off,
    int nfb, int part_entries, Finalize f,
    unsigned long long* __restrict__ keys, int* skipped) {
  __shared__ __align__(16) Shared sh;
  constexpr int kStrip = TILE_H / STREAMS;  // rows each stream covers
  const int n = part_off[nfb];
  for (int part = blockIdx.x; part < n; part += gridDim.x) {
    int h, ne;
    const int* ids;
    const int tile = part_run<STREAMS>(part, part_off, nfb, sorted_tri,
                                       starts, counts, large_ids, n_large,
                                       part_entries, h, ids, ne);
    const int ty = tile / f.tiles_x, tx = tile - ty * f.tiles_x;
    const int row_base = f.row0 + ty * TILE_H;
    const float xc = static_cast<float>(f.col0 + tx * kTileW + threadIdx.x);
    const unsigned long long* tile_keys =
        keys + tile_pixel<TILE_H>(f, ty, tx, 0);
    Winners<TILE_H> win;
    init_winners(win);
    if constexpr (kStrip == TILE_H && !CULL) {
      // One stream: its parts and the side list fold over the same rows.
      fold_run<TILE_H, TILE_H, false>(ids, ne, 0, row_base, xc, f, sh, win,
                                      nullptr, nullptr);
    } else {
      // The side list is never culled, as the TPU kernel never culled its
      // side-list fold.
      if (h < STREAMS)
        fold_run<TILE_H, kStrip, CULL>(ids, ne, h * kStrip, row_base, xc, f,
                                       sh, win, skipped, tile_keys);
      else
        fold_run<TILE_H, TILE_H, false>(ids, ne, 0, row_base, xc, f, sh, win,
                                        nullptr, nullptr);
    }
#pragma unroll
    for (int r = 0; r < TILE_H; ++r)
      if (win.g[r] >= 0)
        atomicMax(keys + tile_pixel<TILE_H>(f, ty, tx, r),
                  winner_key(win.z[r], win.g[r]));
  }
}

// The tile's outputs from the keys: z, gid and colour, or (GBUF) gid and
// the 11 planes.
template <int TILE_H, bool GBUF>
__global__ void __launch_bounds__(kThreads)
    split_finalize_kernel(const unsigned long long* __restrict__ keys,
                          Finalize f) {
  const int tile = blockIdx.x;
  const int ty = tile / f.tiles_x, tx = tile - ty * f.tiles_x;
  const int row_base = f.row0 + ty * TILE_H;
  const float xc = static_cast<float>(f.col0 + tx * kTileW + threadIdx.x);
  Winners<TILE_H> win;
  init_winners(win);
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    const unsigned long long key = keys[tile_pixel<TILE_H>(f, ty, tx, r)];
    if (key == 0ull) continue;  // no winner: DEPTH_CLEAR, gid -1, k 0
    const int g = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
    win.g[r] = g;
    fold_kz(f.recs + (size_t)g * kRecLanes, static_cast<float>(row_base + r),
            f.w_f, xc, win.k[r], win.z[r]);
  }
  write_tile<TILE_H, GBUF>(f, win, ty, tx, row_base, xc);
}

constexpr int kMaxDevices = 64;

// Blocks of ``kernel`` (``threads`` a block) that the current card runs at
// once, into *blocks; ``cached`` keeps a successful answer for each device
// index. The current card is the tensors' own: every C entry is called
// through ``_cuda.launch``, which makes it current for the call.
template <class Kernel>
cudaError_t occupancy_blocks(Kernel kernel, int threads, int* cached,
                             int* blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0);
  if (e != cudaSuccess) return e;
  if (sms * per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = sms * per_sm;
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

// Blocks of split_walk_kernel<TILE_H, STREAMS, CULL> that the current card
// runs at once.
template <int TILE_H, int STREAMS, bool CULL>
cudaError_t resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {};
  return occupancy_blocks(split_walk_kernel<TILE_H, STREAMS, CULL>,
                          kThreads, cached, blocks);
}

// The four device ops of one split launch: zero the keys, count the parts,
// walk them, finalize. part_off: nfb + 1 ints.
template <int TILE_H, int STREAMS, bool CULL, bool GBUF>
int split_raster(const int* sorted_tri, const int* starts, const int* counts,
                 const int* large_ids, const int* n_large, const int* lcounts,
                 int entries, int part_entries, const Finalize& f, int nfb,
                 int* part_off, unsigned long long* keys, size_t n_keys,
                 int* skipped, cudaStream_t s) {
  int resident = 0;
  cudaError_t e = resident_blocks<TILE_H, STREAMS, CULL>(&resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaMemsetAsync(keys, 0, n_keys * sizeof(*keys), s)) != cudaSuccess)
    return static_cast<int>(e);
  part_scan_kernel<STREAMS><<<1, kScanThreads, 0, s>>>(
      counts, lcounts, nfb, part_entries, part_off);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  // At most entries / P + STREAMS * nfb stream parts and nfb side-list
  // parts.
  const long long most =
      (long long)entries / part_entries + (STREAMS + 1LL) * nfb;
  const int grid = static_cast<int>(most < resident ? most : resident);
  split_walk_kernel<TILE_H, STREAMS, CULL>
      <<<grid, kThreads, 0, s>>>(
          sorted_tri, starts, counts, large_ids, n_large, part_off, nfb,
          part_entries, f, keys, skipped);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  split_finalize_kernel<TILE_H, GBUF>
      <<<nfb, kThreads, 0, s>>>(keys, f);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The band form: K4 and K9 + K10 at every multiple of 8 rows above 8 (16,
// 24, 32, ...), the tile height a runtime value. The Pallas kernels take
// any multiple of 8 rows; the split form above is compiled for 8 only.
// At 16 and 32 rows the band form took 0.13-0.63x of the device time of
// split forms compiled for those heights, on every scene timed on an H100
// (PERF.md, section 6), so they were retired.
//
// The walk's unit of work is the part (part_scan_kernel<1> unchanged: a
// stream part of at most P entries, or a tile's side list), and a block
// folds it over only the rows its entries reach, fragment by fragment:
//   1. the block stages a batch of at most kMaxBatch of the part's records
//      in shared memory once (88 lanes a record, 16-byte loads);
//   2. each entry's reach: the tile rows [lo, hi) covering every row where
//      two or more of its edges are active. An edge is active on row yf
//      when valid && ymin <= yf && yf < ymax (row_span's comparisons on the
//      same f32 yf); over the tile's rows that holds on one run of rows,
//      found by two binary searches, and the reach is the hull of the
//      pairwise overlaps of the three runs. A NaN end leaves its edge no
//      row, and rows past the frame are tile rows like any other, so the
//      reach holds every row where stage A gives a span (nact >= 2) and
//      folds nothing the old walk did not;
//   3. one warp's exclusive scan of the batch's reach lengths numbers its
//      (entry, row) pairs; rounds of kThreads pairs, a thread each, run
//      stage A on them (row_span, span_cols, attr_span for z): a band no
//      entry reaches, or a row outside an entry's reach, costs nothing;
//   4. each warp shares out its pairs' fragments (the span's columns
//      within the tile, [minx, maxx], the column test of fold_batch kept
//      as it is) over its 32 lanes by a scan of their counts, so a
//      128-column span of the side list is 4 rounds of the warp, not 128
//      steps of one thread; each fragment computes k and z with the fold's
//      operations and, where z > DEPTH_CLEAR (the fold's start: that also
//      rejects a NaN z), raises the pixel's key by atomicMax.
// Every fragment the per-thread fold of fold_batch could take goes into
// its pixel's key, and the final key is the largest one, the fold's
// (z desc, gid asc) winner over all fragments: exact in any order. There
// are no winners in registers; split_finalize_kernel<8, GBUF> recomputes k
// and z from the key's gid (fold_kz) one block per (tile, 8-row band) of
// an 8-row tiling of the frame, band b of tile (ty, tx) being rows row0 +
// (ty * bands + b) * 8 + r, the same ints as the walk's rows.
// Why fragments and not column threads: on the taller heights a part's
// entries are runs of nearby small triangles that reach one or two of the
// tile's bands; a column-thread fold (each of 128 threads testing every
// pair of a batch on its column) spends 128 tests a pair for the one to
// three fragments a small triangle has. Here the work is a scan and one
// atomic a fragment (PERF.md, section 6).
// ---------------------------------------------------------------------------

constexpr int kBand = 8;

// The first row r in [0, n) with ymin <= (float)(row_base + r), n if none
// (NaN ymin: none); with AFTER, the first row with !((float)(row_base + r)
// < y). Both tests turn from false to true once as r grows, since a row's
// float does not decrease.
template <bool AFTER>
__device__ __forceinline__ int first_row(float y, int row_base, int n) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float yf = static_cast<float>(row_base + mid);
    if (AFTER ? !(yf < y) : (y <= yf))
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// An entry's reach in a tile of n rows from row_base: [lo, hi), empty when
// hi <= lo.
__device__ __forceinline__ void entry_reach(const float* rec, int row_base,
                                            int n, int& lo, int& hi) {
  int a[3], b[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float* r = rec + e * kEdgeStride;
    const bool valid = r[F_VALID] > 0.5f;
    a[e] = valid ? first_row<false>(r[F_YMIN], row_base, n) : n;
    b[e] = valid ? first_row<true>(r[F_YMAX], row_base, n) : 0;
  }
  lo = n;
  hi = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i + 1; j < 3; ++j) {
      const int l = max(a[i], a[j]), h = min(b[i], b[j]);
      if (l < h) {
        lo = min(lo, l);
        hi = max(hi, h);
      }
    }
}

struct BandShared {
  float rec[kMaxBatch][kRecStride];
  int reach_lo[kMaxBatch];
  int pair_off[kMaxBatch + 1];  // exclusive scan of the reach lengths
};

__global__ void __launch_bounds__(kThreads) band_walk_kernel(
    const int* __restrict__ sorted_tri, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ large_ids,
    const int* __restrict__ n_large, const int* __restrict__ part_off,
    int nfb, int part_entries, int tile_h, Finalize f,
    unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) BandShared sh;
  constexpr int kPer = kRecLoad / 4;
  const int lane = threadIdx.x & 31;
  const int n = part_off[nfb];
  for (int part = blockIdx.x; part < n; part += gridDim.x) {
    int h, ne;
    const int* ids;
    const int tile = part_run<1>(part, part_off, nfb, sorted_tri, starts,
                                 counts, large_ids, n_large, part_entries, h,
                                 ids, ne);
    const int ty = tile / f.tiles_x, tx = tile - ty * f.tiles_x;
    const int row_base = f.row0 + ty * tile_h;
    const int xbase = f.col0 + tx * kTileW;
    unsigned long long* tile_keys =
        keys + (size_t)ty * tile_h * f.out_w + tx * kTileW;
    for (int b0 = 0; b0 < ne; b0 += kMaxBatch) {
      const int nb = min(kMaxBatch, ne - b0);
      __syncthreads();  // the previous batch's pairs are set up
      for (int i = threadIdx.x; i < nb * kPer; i += kThreads) {
        const int e = i / kPer, q = i - e * kPer;
        const float4* src = reinterpret_cast<const float4*>(
            f.recs + (size_t)ids[b0 + e] * kRecLanes);
        *reinterpret_cast<float4*>(&sh.rec[e][4 * q]) = __ldg(src + q);
      }
      __syncthreads();
      if (threadIdx.x < 32) {
        int lo = 0, hi = 0;
        if (lane < nb) entry_reach(sh.rec[lane], row_base, tile_h, lo, hi);
        const int len = hi > lo ? hi - lo : 0;
        int v = len;  // inclusive scan over the batch's entries
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        sh.reach_lo[lane] = lo;
        sh.pair_off[lane + 1] = v;
        if (lane == 0) sh.pair_off[0] = 0;
      }
      __syncthreads();
      const int pairs = sh.pair_off[nb];
      for (int p0 = 0; p0 < pairs; p0 += kThreads) {
        const int p = p0 + threadIdx.x;
        // This thread's pair: stage A's depth part, and its columns within
        // the tile, [c0, c0 + cn).
        float minx = 0.0f, maxx = -kBig, xoff = 0.0f, zl = 0.0f, zinc = 0.0f;
        int g = 0, row = 0, c0 = 0, cn = 0;
        if (p < pairs) {
          int lo = 0, hi = nb - 1;  // the last entry with pair_off <= p
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (sh.pair_off[mid] <= p)
              lo = mid;
            else
              hi = mid - 1;
          }
          const float* rec = sh.rec[lo];
          row = sh.reach_lo[lo] + (p - sh.pair_off[lo]);
          RowSpan s;
          row_span(rec, static_cast<float>(row_base + row), s);
          span_cols(s, f.w_f, minx, maxx, xoff);
          if (s.nact >= 2 && minx <= maxx) {  // coverage gate; no NaN end
            c0 = max(0, static_cast<int>(minx) - xbase);
            cn = min(kTileW - 1, static_cast<int>(maxx) - xbase) - c0 + 1;
            if (cn > 0) {
              attr_span(rec, s, F_Z0, F_ZG, zl, zinc);
              g = to_i32(rec[kGidLane]);
            } else {
              cn = 0;
            }
          }
        }
        int end = cn;  // inclusive scan of the warp's fragment counts
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, end, o);
          if (lane >= o) end += u;
        }
        const int frags = __shfl_sync(0xffffffffu, end, 31);
        for (int q0 = 0; q0 < frags; q0 += 32) {
          const int q = q0 + lane;
          int src = 0;  // the first lane whose inclusive count exceeds q
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            const int e = __shfl_sync(0xffffffffu, end, src + step - 1);
            if (e <= q) src += step;
          }
          const int first = __shfl_sync(0xffffffffu, end - cn, src);
          const float s_minx = __shfl_sync(0xffffffffu, minx, src);
          const float s_maxx = __shfl_sync(0xffffffffu, maxx, src);
          const float s_xoff = __shfl_sync(0xffffffffu, xoff, src);
          const float s_zl = __shfl_sync(0xffffffffu, zl, src);
          const float s_zinc = __shfl_sync(0xffffffffu, zinc, src);
          const int s_g = __shfl_sync(0xffffffffu, g, src);
          const int s_row = __shfl_sync(0xffffffffu, row, src);
          const int s_c0 = __shfl_sync(0xffffffffu, c0, src);
          if (q < frags) {
            const int c = s_c0 + (q - first);
            const float xc = static_cast<float>(xbase + c);
            if (xc >= s_minx && xc <= s_maxx) {
              const float k = s_xoff + (xc - s_minx);
              const float z = s_zl + k * s_zinc;
              if (z > kDepthClear)
                atomicMax(tile_keys + (size_t)s_row * f.out_w + c,
                          winner_key(z, s_g));
            }
          }
        }
      }
    }
  }
}

// The band form's four device ops: zero the keys, count the parts, walk
// them, finalize one block per (tile, band). tile_h: a multiple of 8;
// part_off: nfb + 1 ints.
template <bool GBUF>
int band_raster(int tile_h, const int* sorted_tri, const int* starts,
                const int* counts, const int* large_ids, const int* n_large,
                const int* lcounts, int entries, int part_entries,
                const Finalize& f, int nfb, int* part_off,
                unsigned long long* keys, size_t n_keys, cudaStream_t s) {
  if (tile_h < kBand || tile_h % kBand != 0) return 1;  // invalid value
  const long long finals = (long long)nfb * (tile_h / kBand);
  if (finals > 0x7FFFFFFFLL) return 1;
  static int cached[kMaxDevices] = {};
  int blocks = 0;
  cudaError_t e = occupancy_blocks(band_walk_kernel, kThreads, cached,
                                   &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaMemsetAsync(keys, 0, n_keys * sizeof(*keys), s)) != cudaSuccess)
    return static_cast<int>(e);
  part_scan_kernel<1><<<1, kScanThreads, 0, s>>>(counts, lcounts, nfb,
                                                 part_entries, part_off);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  // At most entries / P + nfb stream parts and nfb side-list parts.
  const long long most = (long long)entries / part_entries + 2LL * nfb;
  const int grid = static_cast<int>(most < blocks ? most : blocks);
  band_walk_kernel<<<grid, kThreads, 0, s>>>(sorted_tri, starts, counts,
                                             large_ids, n_large, part_off,
                                             nfb, part_entries, tile_h, f,
                                             keys);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  split_finalize_kernel<kBand, GBUF>
      <<<static_cast<unsigned>(finals), kThreads, 0, s>>>(keys, f);
  return static_cast<int>(cudaGetLastError());
}

Finalize make_finalize(const float* recs, const float* params, const int* objs,
                       const int* texs, const unsigned* atlas, int aw,
                       int n_obj, int n_lights, int tiles_x, int row0,
                       int col0, int frame_w, float* z, int* gid,
                       unsigned* color) {
  Finalize f;
  f.recs = recs;
  f.params = params;
  f.objs = objs;
  f.texs = texs;
  f.atlas = atlas;
  f.aw = aw;
  f.n_obj = n_obj;
  f.n_lights = n_lights;
  f.tiles_x = tiles_x;
  f.row0 = row0;
  f.col0 = col0;
  f.out_w = tiles_x * kTileW;
  f.w_f = static_cast<float>(frame_w);
  f.z_out = z;
  f.gid_out = gid;
  f.color_out = color;
  f.gbuf_out = nullptr;
  f.plane = 0;
  return f;
}

// The G-buffer kernels' operands: no shading inputs, gid and the planes of
// a (tiles_y * tile_h, tiles_x * 128) frame out.
Finalize make_gbuffer(const float* recs, int tile_h, int tiles_y, int tiles_x,
                      int row0, int col0, int frame_w, int* gid, float* gbuf) {
  Finalize f = make_finalize(recs, nullptr, nullptr, nullptr, nullptr, 0, 0,
                             0, tiles_x, row0, col0, frame_w, nullptr, gid,
                             nullptr);
  f.gbuf_out = gbuf;
  f.plane = (size_t)tiles_y * tile_h * f.out_w;
  return f;
}

}  // namespace tr

// K2 / K3: the sorted strategy's streams and side list on 8-row tiles, split
// into parts of at most part_entries stream entries, the side list one more
// part of each tile whose lcounts gate is open. entries: the length of
// sorted_tri (the parts' bound, for the grid). keys: (hp * wp) u64
// scratch, hp = tiles_y * 8, wp = tiles_x * 128. part_off: (tiles_y *
// tiles_x + 1) i32, left holding each tile's first part and, last, the
// parts' total.
#define TR_RASTER_ENTRY(NAME, STREAMS)                                         \
  extern "C" int NAME(const float* recs, const int* sorted_tri,                \
                      const int* starts, const int* counts,                    \
                      const int* large_ids, const int* n_large,                \
                      const int* lcounts, const float* params,                 \
                      const int* objs, const int* texs,                        \
                      const unsigned* atlas, int n_obj, int n_lights, int aw,  \
                      int tiles_y, int tiles_x, int row0, int col0,            \
                      int frame_w, int entries, int part_entries,              \
                      unsigned long long* keys, int* part_off, float* z,       \
                      int* gid, unsigned* color, void* stream) {               \
    if (n_obj < 1 || tiles_y < 1 || tiles_x < 1 || entries < 0 ||              \
        part_entries < 1)                                                      \
      return 1;                                                                \
    const int nfb = tiles_y * tiles_x;                                         \
    return tr::split_raster<8, STREAMS, false, false>(                         \
        sorted_tri, starts, counts, large_ids, n_large, lcounts, entries,      \
        part_entries,                                                          \
        tr::make_finalize(recs, params, objs, texs, atlas, aw, n_obj,          \
                          n_lights, tiles_x, row0, col0, frame_w, z, gid,      \
                          color),                                              \
        nfb, part_off, keys, (size_t)nfb * 8 * tr::kTileW, nullptr,            \
        static_cast<cudaStream_t>(stream));                                    \
  }

TR_RASTER_ENTRY(tr_raster, 2)        // K2
TR_RASTER_ENTRY(tr_raster_rows1, 1)  // K3

// K4: tiles of any multiple of 8 rows (the routes send it 16 rows and
// more), one stream, in the band form: K2's operands and tile_h; keys (hp *
// wp) u64, hp = tiles_y * tile_h.
extern "C" int tr_raster_narrow_any(
    const float* recs, const int* sorted_tri, const int* starts,
    const int* counts, const int* large_ids, const int* n_large,
    const int* lcounts, const float* params, const int* objs, const int* texs,
    const unsigned* atlas, int n_obj, int n_lights, int aw, int tile_h,
    int tiles_y, int tiles_x, int row0, int col0, int frame_w, int entries,
    int part_entries, unsigned long long* keys, int* part_off, float* z,
    int* gid, unsigned* color, void* stream) {
  if (n_obj < 1 || tiles_y < 1 || tiles_x < 1 || entries < 0 ||
      part_entries < 1 || tile_h < 1)
    return 1;
  const int nfb = tiles_y * tiles_x;
  return tr::band_raster<false>(
      tile_h, sorted_tri, starts, counts, large_ids, n_large, lcounts,
      entries, part_entries,
      tr::make_finalize(recs, params, objs, texs, atlas, aw, n_obj, n_lights,
                        tiles_x, row0, col0, frame_w, z, gid, color),
      nfb, part_off, keys, (size_t)nfb * tile_h * tr::kTileW,
      static_cast<cudaStream_t>(stream));
}

// K11 on K2's and K3's routes: the same operands as K2's entry, and
// ``skipped`` (null, or one int the kernel adds its skipped batches to).
#define TR_RASTER_ZCULL_ENTRY(NAME, STREAMS)                                   \
  extern "C" int NAME(const float* recs, const int* sorted_tri,                \
                      const int* starts, const int* counts,                    \
                      const int* large_ids, const int* n_large,                \
                      const int* lcounts, const float* params,                 \
                      const int* objs, const int* texs,                        \
                      const unsigned* atlas, int n_obj, int n_lights, int aw,  \
                      int tiles_y, int tiles_x, int row0, int col0,            \
                      int frame_w, int entries, int part_entries,              \
                      unsigned long long* keys, int* part_off, float* z,       \
                      int* gid, unsigned* color, int* skipped,                 \
                      void* stream) {                                          \
    if (n_obj < 1 || tiles_y < 1 || tiles_x < 1 || entries < 0 ||              \
        part_entries < 1)                                                      \
      return 1;                                                                \
    const int nfb = tiles_y * tiles_x;                                         \
    return tr::split_raster<8, STREAMS, true, false>(                          \
        sorted_tri, starts, counts, large_ids, n_large, lcounts, entries,      \
        part_entries,                                                          \
        tr::make_finalize(recs, params, objs, texs, atlas, aw, n_obj,          \
                          n_lights, tiles_x, row0, col0, frame_w, z, gid,      \
                          color),                                              \
        nfb, part_off, keys, (size_t)nfb * 8 * tr::kTileW, skipped,            \
        static_cast<cudaStream_t>(stream));                                    \
  }

TR_RASTER_ZCULL_ENTRY(tr_raster_zcull, 2)        // K11 on K2's route
TR_RASTER_ZCULL_ENTRY(tr_raster_rows1_zcull, 1)  // K11 on K3's route

// K6: tiles of any multiple of 8 rows, folded a row a block.
extern "C" int tr_raster_mask(const float* recs, const int* ids,
                              const int* counts, const float* params,
                              const int* objs, const int* texs,
                              const unsigned* atlas, int capacity, int tile_h,
                              int n_obj, int n_lights, int aw, int tiles_y,
                              int tiles_x, int row0, int col0, int frame_w,
                              float* z, int* gid, unsigned* color,
                              void* stream) {
  if (n_obj < 1 || tiles_y < 1 || tiles_x < 1 || capacity < 1) return 1;
  return tr::mask_launch<false>(
      ids, counts, capacity, tile_h, tiles_y,
      tr::make_finalize(recs, params, objs, texs, atlas, aw, n_obj, n_lights,
                        tiles_x, row0, col0, frame_w, z, gid, color),
      static_cast<cudaStream_t>(stream));
}

// K8: the mask strategy into a G-buffer, as K6 any multiple of 8 rows a
// row a block; gid (out_h, out_w) i32 and gbuf (11, out_h, out_w) f32,
// out_h = tiles_y * tile_h.
extern "C" int tr_gbuffer_mask(const float* recs, const int* ids,
                               const int* counts, int capacity, int tile_h,
                               int tiles_y, int tiles_x, int row0, int col0,
                               int frame_w, int* gid, float* gbuf,
                               void* stream) {
  if (tiles_y < 1 || tiles_x < 1 || capacity < 1) return 1;
  return tr::mask_launch<true>(
      ids, counts, capacity, tile_h, tiles_y,
      tr::make_gbuffer(recs, tile_h, tiles_y, tiles_x, row0, col0, frame_w,
                       gid, gbuf),
      static_cast<cudaStream_t>(stream));
}

// K9 + K10: the sorted strategy's single stream into a G-buffer, 8-row
// tiles in the split form, any other multiple of 8 rows in the band form;
// each tile's stream split into parts of at most part_entries entries, the
// side list one more part of each tile whose lcounts gate is open. entries:
// the length of sorted_tri (the parts' bound, for the grid). keys: (hp *
// wp) u64 scratch, hp = tiles_y * tile_h, wp = tiles_x * 128. part_off:
// (tiles_y * tiles_x + 1) i32, left holding each tile's first part and,
// last, the parts' total.
extern "C" int tr_gbuffer_queue(const float* recs, const int* sorted_tri,
                                const int* starts, const int* counts,
                                const int* large_ids, const int* n_large,
                                const int* lcounts, int tile_h, int tiles_y,
                                int tiles_x, int row0, int col0, int frame_w,
                                int entries, int part_entries,
                                unsigned long long* keys, int* part_off,
                                int* gid, float* gbuf, void* stream) {
  if (tiles_y < 1 || tiles_x < 1 || entries < 0 || part_entries < 1)
    return 1;  // cudaErrorInvalidValue
  const tr::Finalize f = tr::make_gbuffer(recs, tile_h, tiles_y, tiles_x,
                                          row0, col0, frame_w, gid, gbuf);
  const int nfb = tiles_y * tiles_x;
  const size_t n_keys = f.plane;  // hp * wp
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_h == 8)
    return tr::split_raster<8, 1, false, true>(
        sorted_tri, starts, counts, large_ids, n_large, lcounts, entries,
        part_entries, f, nfb, part_off, keys, n_keys, nullptr, s);
  return tr::band_raster<true>(tile_h, sorted_tri, starts, counts, large_ids,
                               n_large, lcounts, entries, part_entries, f,
                               nfb, part_off, keys, n_keys, s);
}
