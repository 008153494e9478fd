// K14: the sorted strategy's binning around one sort a draw
// (bin_entries_kernel, bin_bounds_kernel, bin_finish_kernel; C entries
// tr_bin_entries and tr_bin_finish, with torch.sort between them).
//
// Replaces no Pallas kernel: the JAX package bins with XLA ops
// (tpu_renderer/ops/binning.py bin_triangles_queue, _bin_queue_rows,
// _large_side_list, count_subset_per_tile), and so does the port's plain
// version (ops/binning.py), some 230-320 torch launches a draw and one or
// two sorts of 64-bit (tile << 32 | tri) keys. These kernels compute the
// same QueueBins and side-list gate, integer for integer.
//
// Design. A draw's entries are laid out triangle-major: triangle t's slot j
// of stream s sits at t * (rs * E) + s * E + j, with the key
// s * (nfb + 1) + tile (tile nfb, the sentinel, for a dead slot). A stable
// sort of those keys alone orders each key's entries by triangle, which is
// the (tile << 32 | tri) order of the plain version; the triangle of a
// sorted entry is its source index over rs * E. The keys take 16 bits
// where rs * (nfb + 1) <= 32768 (every benchmark frame), else 32, so the
// sort makes two or four radix passes where the plain version made eight
// a stream. Then:
// - bin_entries_kernel, a thread a triangle: its strip or tile range from
//   K1's five bbox planes (IEEE division by the tile or strip height,
//   never a product with a reciprocal), small or large, every slot's key
//   (in 8-byte stores); a warp's large flags as one word of a bit mask,
//   a block's count of them;
// - torch.sort (cub's radix sort on the card), stable;
// - bin_bounds_kernel, a thread a sorted entry: each stream's first entry
//   of every tile (the position where the key first reaches it), without
//   a search; its first block compacts the large mask into the side list in
//   submission order (one block scan over the entry blocks' counts) and
//   counts it;
// - bin_finish_kernel: the budget clamp, starts and counts interleaved at
//   rs * tile + s, the triangle ids with the plain version's dead tails,
//   the side-list gate per tile over the <= lcap listed triangles (their
//   tile ranges staged in shared memory; integer counts, order-free), and
//   the stats.
//
// Bound on the H100: bytes. Per triangle the five bbox planes are read
// (17 B) and rs * E keys written; the sort reads and writes each key and
// its 8-byte index once a pass (two passes of 16-bit keys); the outputs are
// written once. At the benchmark's 1M triangles and 4 slots that is ~190
// MB, ~0.056 ms at 3.35 TB/s, most of it the sort's passes (chip_smoke.py's
// K14 row counts it).

#include "common.cuh"

namespace tr {

constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;  // = large-mask words a block
constexpr int kBoundsBlocks = 132 * 8;  // the bounds' grid-stride blocks
constexpr int kCountLoads = 16;

// The draw's binning grid: rs streams of E slots a triangle; the bbox rows
// are cut into n_units strips (rs > 1) or tile rows of unit_h rows each,
// the columns into tiles of tile_w; tile nfb is the dead sentinel.
struct BinGrid {
  int T, rs, E, tiles_y, tiles_x, nfb, n_units, unit_h, tile_h, tile_w;
  float row0, col0;
};

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// to_i32(x) + 1 in int32 as torch adds it: INT_MAX + 1 wraps to INT_MIN.
__device__ __forceinline__ int inc_wrap(int v) {
  return static_cast<int>(static_cast<unsigned>(v) + 1u);
}

// Python's a % b for b > 0.
__device__ __forceinline__ int py_mod(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

// A thread a triangle: its keys, packed into 8-byte stores (a triangle's
// rs * E keys fill whole words: rs * E is 4, 8 or 32 on every route); a
// warp's large flags as one mask word, a block's count of them. RS, the
// stream count (1, or 2 under row packing), is a template argument so that
// its divisions are shifts; the slots' tile offsets step without one.
template <typename Key, int RS>
__global__ void __launch_bounds__(kBinThreads) bin_entries_kernel(
    const unsigned char* __restrict__ valid, const float* __restrict__ ylo,
    const float* __restrict__ yhi, const float* __restrict__ xlo,
    const float* __restrict__ xhi, BinGrid g, Key* __restrict__ keys,
    unsigned* __restrict__ large_bits, int* __restrict__ block_large) {
  constexpr int kKeyBits = 8 * sizeof(Key);
  constexpr int kPerWord = 64 / kKeyBits;
  constexpr int rs = RS;
  const int t = blockIdx.x * kBinThreads + threadIdx.x;
  bool large = false;
  if (t < g.T) {
    const float uh = static_cast<float>(g.unit_h);
    const float tw = static_cast<float>(g.tile_w);
    const int u_lo =
        clamp_int(to_i32(floorf((ylo[t] - g.row0) / uh)), 0, g.n_units);
    const int u_hi =
        clamp_int(to_i32(ceilf((yhi[t] - g.row0) / uh)), 0, g.n_units);
    const int tx_lo =
        clamp_int(to_i32(floorf((xlo[t] - g.col0) / tw)), 0, g.tiles_x);
    const int tx_hi = clamp_int(
        inc_wrap(to_i32(floorf((xhi[t] - g.col0) / tw))), 0, g.tiles_x);
    const int wx = max(tx_hi - tx_lo, 0);
    const bool covers = valid[t] != 0 && u_hi > u_lo && wx > 0;
    // Stream s's units within [u_lo, u_hi) start at u_lo + ((s - u_lo) mod
    // rs) and step rs; ns slots = those units x wx.
    bool small = covers;
    for (int s = 0; s < rs; ++s) {
      const int base = u_lo + py_mod(s - u_lo, rs);
      const long long ns =
          u_hi > base ? (long long)((u_hi - base + rs - 1) / rs) * wx : 0;
      small = small && ns <= g.E;
    }
    large = covers && !small;
    const int wxs = max(wx, 1);
    const int per = rs * g.E;
    unsigned long long* words =
        reinterpret_cast<unsigned long long*>(keys) + (long long)t * per /
                                                          kPerWord;
    unsigned long long acc = 0;
    int n = 0;
    for (int s = 0; s < rs; ++s) {
      const int base = u_lo + py_mod(s - u_lo, rs);
      const long long ns =
          u_hi > base ? (long long)((u_hi - base + rs - 1) / rs) * wx : 0;
      const int key0 = s * (g.nfb + 1);
      // slot j: unit base + rs * (j / wxs), column tx_lo + j % wxs; the
      // unit's tile row is base / rs + j / wxs
      const int tile_row = base / rs;
      int jq = 0, jr = 0;
      for (int j = 0; j < g.E; ++j) {
        const int tile = (tile_row + jq) * g.tiles_x + tx_lo + jr;
        const bool ok = small && j < ns;
        const int key = key0 + (ok ? tile : g.nfb);
        if (++jr == wxs) {
          jr = 0;
          ++jq;
        }
        acc |= static_cast<unsigned long long>(static_cast<unsigned>(key))
               << (kKeyBits * (n % kPerWord));
        if (++n % kPerWord == 0) {
          words[n / kPerWord - 1] = acc;
          acc = 0;
        }
      }
    }
  }
  // Every thread of the grid reaches the ballot and the count (the block
  // is whole warps).
  const unsigned word = __ballot_sync(0xffffffffu, large);
  if ((threadIdx.x & 31) == 0 && t < g.T) large_bits[t >> 5] = word;
  const int count = __syncthreads_count(large);
  if (threadIdx.x == 0) block_large[blockIdx.x] = count;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  __shared__ int warp_sums[kBinWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int i = 0; i < kBinWarps; ++i) {
    const int w = warp_sums[i];
    before += i < warp ? w : 0;
    sum += w;
  }
  __syncthreads();  // warp_sums is read by all before the next call
  *total = sum;
  return before + x - v;
}

// The side list: the first lcap large triangles in submission order, -1
// after; *n_large the unclamped count. One block: a thread sums the counts
// of a run of entry blocks, one block scan places the runs, and each thread
// walks the mask words of its blocks that hold large triangles.
__device__ void side_list(const unsigned* __restrict__ large_bits,
                          const int* __restrict__ block_large, int T,
                          int lcap, int* __restrict__ large_ids,
                          int* __restrict__ n_large) {
  const int nwords = (T + 31) >> 5;
  const int nblocks = (T + kBinThreads - 1) / kBinThreads;
  const int run = (nblocks + kBinThreads - 1) / kBinThreads;
  const int b0 = min(static_cast<int>(threadIdx.x) * run, nblocks);
  const int b1 = min(b0 + run, nblocks);
  int cnt = 0;
  for (int c = b0; c < b1; c += kCountLoads) {  // the loads issued together
#pragma unroll
    for (int k = 0; k < kCountLoads; ++k)
      cnt += c + k < b1 ? block_large[c + k] : 0;
  }
  int total;
  int slot = block_exclusive_sum(cnt, &total);
  for (int b = b0; b < b1 && slot < lcap; ++b) {
    if (block_large[b] == 0) continue;
    const int w1 = min((b + 1) * kBinWarps, nwords);
    for (int w = b * kBinWarps; w < w1 && slot < lcap; ++w) {
      unsigned bits = large_bits[w];
      while (bits && slot < lcap) {
        large_ids[slot++] = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1;
      }
    }
  }
  for (int i = threadIdx.x; i < lcap; i += kBinThreads)
    if (i >= total) large_ids[i] = -1;
  if (threadIdx.x == 0) *n_large = total;
}

// Block 0: the side list. The others, a thread a sorted entry at a time
// (a grid-stride loop over a few blocks an SM): stream s's first entry of
// tile t, first[s * (nfb + 1) + t], is the position where the stream's key
// first reaches t (its entry count past the last key). A lane whose key
// steps past tiles owns their run; each warp fills its lanes' runs
// together, 32 tiles a step, so a long run of empty tiles costs no single
// thread a serial loop.
template <typename Key>
__global__ void __launch_bounds__(kBinThreads) bin_bounds_kernel(
    const Key* __restrict__ skeys, const unsigned* __restrict__ large_bits,
    const int* __restrict__ block_large, BinGrid g, int lcap,
    int* __restrict__ first, int* __restrict__ large_ids,
    int* __restrict__ n_large) {
  if (blockIdx.x == 0) {
    side_list(large_bits, block_large, g.T, lcap, large_ids, n_large);
    return;
  }
  const int m = g.T * g.E;  // entries a stream
  const int n = m * g.rs;
  const int lane = threadIdx.x & 31;
  const int stride = (gridDim.x - 1) * kBinThreads;
  for (int p0 = (blockIdx.x - 1) * kBinThreads; p0 < n; p0 += stride) {
    const int p = p0 + threadIdx.x;
    int lo = 0, hi = -1, q = 0, key0 = 0, tail_lo = 0, tail_hi = -1;
    if (p < n) {
      const int s = p / m;
      q = p - s * m;
      key0 = s * (g.nfb + 1);
      hi = static_cast<int>(skeys[p]) - key0;
      lo = q == 0 ? 0 : static_cast<int>(skeys[p - 1]) - key0 + 1;
      if (q == m - 1) {
        tail_lo = hi + 1;
        tail_hi = g.nfb;
      }
    }
    for (int pass = 0; pass < 2; ++pass) {
      const int a = pass ? tail_lo : lo, b = pass ? tail_hi : hi;
      const int v = pass ? m : q;
      unsigned todo = __ballot_sync(0xffffffffu, a <= b);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const int a_ = __shfl_sync(0xffffffffu, a, src);
        const int b_ = __shfl_sync(0xffffffffu, b, src);
        const int v_ = __shfl_sync(0xffffffffu, v, src);
        int* out = first + __shfl_sync(0xffffffffu, key0, src);
        for (int t = a_ + lane; t <= b_; t += 32) out[t] = v_;
      }
    }
  }
}

// A thread an index of the outputs: sorted_tri (rs * eb), starts and
// counts (rs * (nfb + 1)), lcounts (nfb, the blocks that hold tiles), the
// stats (block 0, thread 0): n_large, n_dropped, n_real, budget_util bits.
__global__ void __launch_bounds__(kBinThreads) bin_finish_kernel(
    const long long* __restrict__ perm, const int* __restrict__ first,
    const int* __restrict__ n_large_all, const int* __restrict__ large_ids,
    const unsigned char* __restrict__ valid, const float* __restrict__ ylo,
    const float* __restrict__ yhi, const float* __restrict__ xlo,
    const float* __restrict__ xhi, BinGrid g, int eb, int lcap,
    int* __restrict__ sorted_tri, int* __restrict__ starts,
    int* __restrict__ counts, int* __restrict__ lcounts,
    int* __restrict__ stats) {
  const long long m = (long long)g.T * g.E;
  const int i = blockIdx.x * kBinThreads + threadIdx.x;
  const int shift = __ffs(g.rs * g.E) - 1;  // rs * E: a power of two
  if (i < g.rs * eb) {
    const int s = i / eb, li = i - s * eb;
    int tri;
    if (g.rs > 1) {
      // The strip streams: the kept prefix, then idx % T.
      const int kept = min(first[s * (g.nfb + 1) + g.nfb], eb);
      const long long src = li < kept ? perm[s * m + li] : 0;
      tri = li >= kept ? li % g.T : static_cast<int>(src >> shift);
    } else {
      // One stream: every sorted entry (the dead ones ordered by
      // triangle), then zeros past the sort.
      const long long src = li < m ? perm[li] : 0;
      tri = static_cast<int>(src >> shift);
    }
    sorted_tri[i] = tri;
  }
  if (i < g.rs * (g.nfb + 1)) {
    const int tile = i / g.rs, s = i - tile * g.rs;
    const int* f = first + s * (g.nfb + 1);
    const int a = min(f[tile], eb);
    starts[i] = a + s * eb;
    counts[i] = tile < g.nfb ? min(f[tile + 1], eb) - a : 0;
  }
  if (blockIdx.x * kBinThreads < g.nfb) {  // uniform over the block
    __shared__ int4 ranges[kBinThreads];
    const int n = min(*n_large_all, lcap);
    const int ty = i / g.tiles_x, tx = i - ty * g.tiles_x;
    const float th = static_cast<float>(g.tile_h);
    const float tw = static_cast<float>(g.tile_w);
    int cnt = 0;
    for (int c0 = 0; c0 < n; c0 += kBinThreads) {
      const int c = c0 + threadIdx.x;
      int4 r = make_int4(0, 0, 0, 0);  // an empty range
      if (c < n) {
        const int id = large_ids[c];
        if (valid[id]) {
          r.x = to_i32(floorf((ylo[id] - g.row0) / th));
          r.y = to_i32(ceilf((yhi[id] - g.row0) / th));
          r.z = to_i32(floorf((xlo[id] - g.col0) / tw));
          r.w = inc_wrap(to_i32(floorf((xhi[id] - g.col0) / tw)));
        }
      }
      ranges[threadIdx.x] = r;
      __syncthreads();
      const int len = min(kBinThreads, n - c0);
      for (int k = 0; k < len; ++k) {
        const int4 q = ranges[k];
        cnt += (ty >= q.x && ty < q.y && tx >= q.z && tx < q.w) ? 1 : 0;
      }
      __syncthreads();
    }
    if (i < g.nfb) lcounts[i] = cnt;
  }
  if (i == 0) {
    const int nl = *n_large_all;
    int real = 0, drops = 0, most = 0;
    for (int s = 0; s < g.rs; ++s) {
      const int r = first[s * (g.nfb + 1) + g.nfb];
      real += r;
      drops += max(r - eb, 0);
      most = max(most, r);
    }
    stats[0] = min(nl, lcap);
    stats[1] = drops + max(nl - lcap, 0);
    stats[2] = real;
    stats[3] = __float_as_int(static_cast<float>(most) /
                              static_cast<float>(eb));
  }
}

template <typename Key>
void launch_entries(int rs, unsigned blocks, cudaStream_t s,
                    const unsigned char* valid, const float* ylo,
                    const float* yhi, const float* xlo, const float* xhi,
                    const BinGrid& g, Key* keys, unsigned* large_bits,
                    int* block_large) {
  auto kernel = rs == 1 ? bin_entries_kernel<Key, 1>
                        : bin_entries_kernel<Key, 2>;
  kernel<<<blocks, kBinThreads, 0, s>>>(valid, ylo, yhi, xlo, xhi, g, keys,
                                        large_bits, block_large);
}

inline BinGrid bin_grid(int T, int rs, int E, int tiles_y, int tiles_x,
                        int tile_h, int tile_w, int row0, int col0) {
  BinGrid g;
  g.T = T;
  g.rs = rs;
  g.E = E;
  g.tiles_y = tiles_y;
  g.tiles_x = tiles_x;
  g.nfb = tiles_y * tiles_x;
  g.n_units = tiles_y * rs;
  g.unit_h = tile_h / rs;
  g.tile_h = tile_h;
  g.tile_w = tile_w;
  g.row0 = static_cast<float>(row0);
  g.col0 = static_cast<float>(col0);
  return g;
}

// The layouts the kernels take (ops/binning.py bin_queue_kernel checks the
// same): one or two streams, rs * E a power of two of at least 4 (whole
// 8-byte words of 16-bit keys; a shift to the triangle), under 2^31 keys.
inline bool bin_grid_ok(int T, int rs, int E, int tiles_y, int tiles_x,
                        int tile_h, int tile_w, int key_bytes) {
  const int per = rs * E;
  return T >= 1 && (rs == 1 || rs == 2) && per >= 4 &&
         (per & (per - 1)) == 0 && tiles_y >= 1 && tiles_x >= 1 &&
         tile_h >= rs && tile_w >= 1 && (key_bytes == 2 || key_bytes == 4) &&
         (long long)T * per < (1LL << 31);
}

}  // namespace tr

// The bbox planes (T,): valid (bool as bytes), ylo, yhi, xlo, xhi (f32, the
// global frame); keys (T * rs * E,) of key_bytes (2: int16, 4: int32), 8-byte
// aligned; large_bits ((T + 31) / 32,) u32; block_large ((T + 255) / 256,)
// i32.
extern "C" int tr_bin_entries(const unsigned char* valid, const float* ylo,
                              const float* yhi, const float* xlo,
                              const float* xhi, int T, int rs, int E,
                              int tiles_y, int tiles_x, int tile_h,
                              int tile_w, int row0, int col0, int key_bytes,
                              void* keys, unsigned* large_bits,
                              int* block_large, void* stream) {
  if (!tr::bin_grid_ok(T, rs, E, tiles_y, tiles_x, tile_h, tile_w,
                       key_bytes))
    return 1;  // cudaErrorInvalidValue
  const tr::BinGrid g =
      tr::bin_grid(T, rs, E, tiles_y, tiles_x, tile_h, tile_w, row0, col0);
  const unsigned blocks = (T + tr::kBinThreads - 1) / tr::kBinThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 2)
    tr::launch_entries<short>(rs, blocks, s, valid, ylo, yhi, xlo, xhi, g,
                              static_cast<short*>(keys), large_bits,
                              block_large);
  else
    tr::launch_entries<int>(rs, blocks, s, valid, ylo, yhi, xlo, xhi, g,
                            static_cast<int*>(keys), large_bits, block_large);
  return static_cast<int>(cudaGetLastError());
}

// skeys (T * rs * E,) the sorted keys, perm (T * rs * E,) i64 their source
// indices; large_bits and block_large tr_bin_entries'; first (rs * (nfb +
// 1),) and n_large_all (1,) i32 scratch; the outputs i32: sorted_tri (rs *
// eb), starts and counts (rs * (nfb + 1)), large_ids (lcap), lcounts (nfb),
// stats (4).
extern "C" int tr_bin_finish(
    const void* skeys, int key_bytes, const long long* perm,
    const unsigned* large_bits, const int* block_large,
    const unsigned char* valid, const float* ylo,
    const float* yhi, const float* xlo, const float* xhi, int T, int rs,
    int E, int tiles_y, int tiles_x, int tile_h, int tile_w, int row0,
    int col0, int eb, int lcap, int* first, int* n_large_all,
    int* sorted_tri, int* starts, int* counts, int* large_ids, int* lcounts,
    int* stats, void* stream) {
  if (!tr::bin_grid_ok(T, rs, E, tiles_y, tiles_x, tile_h, tile_w,
                       key_bytes) ||
      eb < 1 || lcap < 1)
    return 1;  // cudaErrorInvalidValue
  const tr::BinGrid g =
      tr::bin_grid(T, rs, E, tiles_y, tiles_x, tile_h, tile_w, row0, col0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)T * rs * E;
  const long long want = (n + tr::kBinThreads - 1) / tr::kBinThreads;
  const unsigned bounds_blocks =
      1 + (unsigned)(want < tr::kBoundsBlocks ? want : tr::kBoundsBlocks);
  if (key_bytes == 2)
    tr::bin_bounds_kernel<short><<<bounds_blocks, tr::kBinThreads, 0, s>>>(
        static_cast<const short*>(skeys), large_bits, block_large, g, lcap,
        first, large_ids, n_large_all);
  else
    tr::bin_bounds_kernel<int><<<bounds_blocks, tr::kBinThreads, 0, s>>>(
        static_cast<const int*>(skeys), large_bits, block_large, g, lcap,
        first, large_ids, n_large_all);
  const long long tris = (long long)rs * eb;
  const long long tiles = (long long)rs * (g.nfb + 1);
  const long long outs = tris > tiles ? tris : tiles;
  const unsigned finish_blocks =
      (unsigned)((outs + tr::kBinThreads - 1) / tr::kBinThreads);
  tr::bin_finish_kernel<<<finish_blocks, tr::kBinThreads, 0, s>>>(
      perm, first, n_large_all, large_ids, valid, ylo, yhi, xlo, xhi, g, eb,
      lcap, sorted_tri, starts, counts, lcounts, stats);
  return static_cast<int>(cudaGetLastError());
}
