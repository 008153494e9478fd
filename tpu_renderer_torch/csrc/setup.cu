// K1: triangle setup -> packed record table + binning bboxes.
//
// Replaces the Pallas kernel _setup_kernel (tpu_renderer/ops/setup_pallas.py
// :174, launched at :447 by setup_records_fused), which ran FillEdgeTable
// (projekt.cpp:3882-4121) on blocks of 1024 triangles in VMEM.
//
// Bound on the H100: device memory. Per triangle it reads 30 floats of
// vertex data (120 B; 144 B textured) and writes one 512 B record row and
// 32 B of bbox: 664 B a triangle, 688 textured, against ~300 f32
// operations, far below the card's ops-per-byte balance. At 3.35 TB/s
// that is 0.1985 ms for the 1,001,112-triangle headline.
//
// Textured objects (TEXTURED) also read the (2, 3, T) uvs and write the
// perspective-correct u/z, v/z and 1/z fields with their gradients and the
// top-clip advance (setup_pallas.py:278-292); their Gouraud base is white.
//
// Design: one thread per triangle runs the whole setup in registers, in the
// same f32 op order as the Pallas kernel and as setup_plain
// (ops/setup.py). The inputs stay channel-major (C, 3, T) as the JAX
// package keeps them, so the loads of a warp are coalesced; triangles in
// [T, Tp) read zeros, exactly like the Pallas kernel's padded blocks. The
// bbox columns go out as coalesced 4-byte stores.
//
// The record rows are what costs: a row is 512 B, so a thread storing its
// own row makes each warp store touch 32 rows 512 B apart, 32 half-filled
// sectors that reach L2 piecemeal (1.1255 ms on the headline, 18% of the
// bound: NVIDIA H100 80GB HBM3, 700 W). So each thread writes its row's
// 21 chunks of edge fields into its warp's stage in shared memory
// (32 rows x 336 B, 43,008 B a 128-thread block), and after __syncwarp
// the warp writes its rows out one at a time, lane l storing chunk l:
// every store instruction is one whole row, four full 128-byte lines. The
// gid and zero chunks (lanes 84..127) are made during the write-out and
// never staged.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 0.2684 ms on the headline (74% of the bound; 1.1255 ms before),
// 0.1049 ms textured on 250,632 triangles (bound 0.0515 ms). ptxas: 74-83
// registers, 43,008 B of shared memory, no spill, in all four forms; the
// stage limits an SM to 5 resident blocks (20 warps; registers allow 6).

#include "common.cuh"

namespace tr {

constexpr int kSetupThreads = 128;
// A record row in 16-byte chunks: 21 hold the three edges' fields (lanes
// 0..83), chunk 21 the gid and chunks 22..31 zeros.
constexpr int kEdgeChunks = kGidLane / 4;
constexpr int kRowChunks = kRecLanes / 4;

template <bool PHONG, bool TEXTURED>
__global__ void __launch_bounds__(kSetupThreads) setup_kernel(
    const float* __restrict__ params, int n_lights,
    const float* __restrict__ verts, const float* __restrict__ cols,
    const float* __restrict__ nrms, const float* __restrict__ uvs, int T,
    int Tp, int gid0, float frame_h,
    float frame_w, float* __restrict__ recs, float* __restrict__ bbox) {
  // Each warp's 32 rows of edge chunks, row after row. The stride of 21
  // chunks is odd, so the 8 lanes of a quarter-warp storing one chunk of
  // their rows, and 8 consecutive chunks of one row read back, fall in 8
  // distinct 16-byte bank groups.
  __shared__ float4 stage[kSetupThreads / 32][32 * kEdgeChunks];
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int t0 = t - lane;  // the warp's first row
  if (t0 >= Tp) return;     // whole warps only: the write-out needs them all
  const bool real = t < T;
  float4* const staged = stage[threadIdx.x >> 5];
  // Element [c][v] of a channel-major (C, 3, T) array; zeros past T.
  auto ld = [&](const float* a, int c, int v) -> float {
    return real ? a[(size_t)(c * 3 + v) * T + t] : 0.0f;
  };

  const float dat = params[0], fl = params[1], m2p = params[2];
  const float cx = params[3], cy = params[4];

  float cam[3][3];  // [component][vertex]
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int v = 0; v < 3; ++v) cam[c][v] = ld(verts, c, v) + params[5 + c];

  // ProjectVertex (projekt.cpp:74-93).
  float px[3], py[3], pz[3];
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const float dz = dat - cam[2][v];
    const float s = (1.0f / dz) * fl;
    const float x = cx + m2p * (s * cam[0][v]);
    const float y = cy + m2p * (s * cam[1][v]);
    const bool good = dz > kNearClip;
    px[v] = good ? x : 0.0f;
    py[v] = good ? y : 0.0f;
    pz[v] = good ? dz : 0.0f;
  }

  // Screen-space backface cull (projekt.cpp:3926-3943).
  float e1x, e1y, e1z, e2x, e2y, e2z;
  norm3(px[1] - px[0], py[1] - py[0], pz[1] - pz[0], e1x, e1y, e1z);
  norm3(px[2] - px[0], py[2] - py[0], pz[2] - pz[0], e2x, e2y, e2z);
  const bool visible = -(e1x * e2y - e1y * e2x) > 0.0f;

  float nrm[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int v = 0; v < 3; ++v) nrm[c][v] = ld(nrms, c, v);

  // Per-vertex colors: raw under Phong, Gouraud-baked otherwise
  // (projekt.cpp:4022-4063; textured => white base; 0 lights = the base
  // passed through, divergence #6).
  float gcol[4][3];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int v = 0; v < 3; ++v)
      gcol[c][v] = (TEXTURED && !PHONG) ? 1.0f : ld(cols, c, v);
  if (!PHONG && n_lights > 0) {
    float base[4][3];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        base[c][v] = gcol[c][v];
        gcol[c][v] = base[c][v] * params[8 + c];
      }
    for (int k = 0; k < n_lights; ++k) {
      const float* l = params + 12 + 7 * k;
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        float tx, ty, tz;
        norm3(l[0] - cam[0][v], l[1] - cam[1][v], l[2] - cam[2][v], tx, ty,
              tz);
        float d = tx * nrm[0][v];
        d = d + ty * nrm[1][v];
        d = d + tz * nrm[2][v];
        d = clamp01(d);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          gcol[c][v] = clamp01(gcol[c][v] + d * (base[c][v] * l[3 + c]));
      }
    }
  }

  bool keep[3];
  float e_ymin[3], e_ymax[3], e_x0[3], e_xg[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int lo = e, hi = (e + 1) % 3;
    const bool swap = py[lo] > py[hi];
    // Endpoints ordered by y; selects keep the arrays in registers.
    auto mn_of = [&](const float* v) { return swap ? v[hi] : v[lo]; };
    auto mx_of = [&](const float* v) { return swap ? v[lo] : v[hi]; };
    const float minv_x = mn_of(px), maxv_x = mx_of(px);
    const float minv_y = mn_of(py), maxv_y = mx_of(py);
    const float camz_mn = mn_of(cam[2]), camz_mx = mx_of(cam[2]);
    const float minv_z = mn_of(pz), maxv_z = mx_of(pz);

    keep[e] = visible && (maxv_y > 0.0f) && (minv_y - maxv_y != 0.0f);
    const float ymax = round_half_away(maxv_y);
    const float ymin = max_ieee(0.0f, round_half_away(minv_y));
    const bool neg = minv_y < 0.0f;
    const float clipped_y = neg ? -minv_y : 0.0f;
    const float tt = neg ? (-minv_y) / (maxv_y - minv_y) : 0.0f;
    const float ydiff = ymax - ymin;
    const float xg = (maxv_x - minv_x) / (maxv_y - minv_y);
    const float zg = (camz_mx - camz_mn) / ydiff;
    const float x0 = minv_x + clipped_y * xg;
    const float z0 = camz_mn + clipped_y * zg;
    const float left = (ymin == round_half_away(py[lo])) ? 1.0f : 0.0f;
    e_ymin[e] = ymin;
    e_ymax[e] = ymax;
    e_x0[e] = x0;
    e_xg[e] = xg;

    float f[kEdgeStride];
    f[F_VALID] = 1.0f;
    f[F_YMIN] = ymin;
    f[F_YMAX] = ymax;
    f[F_X0] = x0;
    f[F_XG] = xg;
    f[F_Z0] = z0;
    f[F_ZG] = zg;
    if (TEXTURED) {  // cpp:4078-4089
      float u[3], vv[3];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        u[v] = ld(uvs, 0, v);
        vv[v] = ld(uvs, 1, v);
      }
      float oz0 = 1.0f / minv_z;  // cpp:4004 (inf when degenerate)
      float u0 = mn_of(u) / minv_z;
      float v0 = mn_of(vv) / minv_z;
      const float ozmax = 1.0f / maxv_z;
      const float u1 = mx_of(u) * ozmax;
      const float v1 = mx_of(vv) * ozmax;
      const float ug = (u1 - u0) / ydiff;
      const float vg = (v1 - v0) / ydiff;
      const float ozg = (ozmax - oz0) / ydiff;
      u0 = u0 + clipped_y * ug;
      v0 = v0 + clipped_y * vg;
      oz0 = oz0 + clipped_y * ozg;
      f[F_OZ0] = oz0;
      f[F_OZG] = ozg;
      f[F_U0] = u0;
      f[F_UG] = ug;
      f[F_V0] = v0;
      f[F_VG] = vg;
    } else {
#pragma unroll
      for (int j = F_OZ0; j < F_LEFT; ++j) f[j] = 0.0f;  // divergence #5
    }
    f[F_LEFT] = left;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float mn = mn_of(gcol[c]), mx = mx_of(gcol[c]);
      const float c0 = (1.0f - tt) * mn + tt * mx;
      f[F_COL0 + c] = c0;
      f[F_COLG + c] = (mx - c0) / ydiff;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float mn = mn_of(nrm[c]), mx = mx_of(nrm[c]);
      f[F_N0 + c] = PHONG ? mn : 0.0f;
      f[F_NG + c] = PHONG ? (mx - mn) / ydiff : 0.0f;
    }
    float4* dst = staged + lane * kEdgeChunks + e * (kEdgeStride / 4);
#pragma unroll
    for (int q = 0; q < kEdgeStride / 4; ++q) {
      const bool k = keep[e];
      dst[q] = make_float4(k ? f[4 * q] : 0.0f, k ? f[4 * q + 1] : 0.0f,
                           k ? f[4 * q + 2] : 0.0f, k ? f[4 * q + 3] : 0.0f);
    }
  }
  // Binning bbox (tpu_renderer/ops/binning.py:_bbox_core).
  bool valid[3];
  int nvalid = 0;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    valid[e] = keep[e] && (e_ymax[e] > e_ymin[e]);
    nvalid += valid[e] ? 1 : 0;
  }
  float ylo = kBig, yhi = -kBig, xlo = kBig, xhi = -kBig;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float xa = e_x0[e];
    const float xb = e_x0[e] + (e_ymax[e] - 1.0f - e_ymin[e]) * e_xg[e];
    const float ylo_e = valid[e] ? e_ymin[e] : kBig;
    const float yhi_e = valid[e] ? e_ymax[e] : -kBig;
    const float xlo_e = valid[e] ? min_ieee(xa, xb) : kBig;
    const float xhi_e = valid[e] ? max_ieee(xa, xb) : -kBig;
    // min(min(a0, a1), a2): the first edge seeds the chain.
    ylo = e == 0 ? ylo_e : min_ieee(ylo, ylo_e);
    yhi = e == 0 ? yhi_e : max_ieee(yhi, yhi_e);
    xlo = e == 0 ? xlo_e : min_ieee(xlo, xlo_e);
    xhi = e == 0 ? xhi_e : max_ieee(xhi, xhi_e);
  }
  yhi = min_ieee(yhi, frame_h);
  const bool tri_valid =
      nvalid >= 2 && yhi > ylo && is_finite(ylo) && is_finite(yhi);
  const float w1 = frame_w - 1.0f;
  xlo = clip_ieee(nan_to_num(xlo, 0.0f, w1, 0.0f) - 1.0f, 0.0f, w1);
  xhi = clip_ieee(nan_to_num(xhi, w1, w1, 0.0f) + 1.0f, 0.0f, w1);
  ylo = clip_ieee(ylo, 0.0f, frame_h);
  yhi = clip_ieee(yhi, 0.0f, frame_h);
  if (t < Tp) {
    bbox[0 * (size_t)Tp + t] = tri_valid ? 1.0f : 0.0f;
    bbox[1 * (size_t)Tp + t] = ylo;
    bbox[2 * (size_t)Tp + t] = yhi;
    bbox[3 * (size_t)Tp + t] = xlo;
    bbox[4 * (size_t)Tp + t] = xhi;
    bbox[5 * (size_t)Tp + t] = 0.0f;
    bbox[6 * (size_t)Tp + t] = 0.0f;
    bbox[7 * (size_t)Tp + t] = 0.0f;
  }

  // Write-out: one store instruction a row, lane l writing chunk l, so
  // each is 512 contiguous bytes (four whole 128-byte lines): the staged
  // edge chunks, then the gid, then zeros. A ragged last warp stops at Tp.
  __syncwarp();
  const float4* src = staged + lane;
  float4* out = reinterpret_cast<float4*>(recs + (size_t)t0 * kRecLanes) + lane;
  const int rows = min(32, Tp - t0);
#pragma unroll 4
  for (int i = 0; i < rows; ++i) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane < kEdgeChunks)
      v = src[i * kEdgeChunks];
    else if (lane == kEdgeChunks)
      v.x = static_cast<float>(t0 + i + gid0);
    out[(size_t)i * kRowChunks] = v;
  }
}

}  // namespace tr

namespace tr {

template <bool PHONG, bool TEXTURED>
void launch_setup(const float* params, int n_lights, const float* verts,
                  const float* cols, const float* nrms, const float* uvs,
                  int T, int Tp, int gid0, int frame_h, int frame_w,
                  float* recs, float* bbox, cudaStream_t s) {
  setup_kernel<PHONG, TEXTURED>
      <<<(Tp + kSetupThreads - 1) / kSetupThreads, kSetupThreads, 0, s>>>(
      params, n_lights, verts, cols, nrms, uvs, T, Tp, gid0, (float)frame_h,
      (float)frame_w, recs, bbox);
}

}  // namespace tr

// uvs is null for an untextured object.
extern "C" int tr_setup(const float* params, int n_lights, int phong,
                        const float* verts, const float* cols,
                        const float* nrms, const float* uvs, int T, int Tp,
                        int gid0, int frame_h, int frame_w, float* recs,
                        float* bbox, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = phong ? (uvs ? tr::launch_setup<true, true>
                             : tr::launch_setup<true, false>)
                      : (uvs ? tr::launch_setup<false, true>
                             : tr::launch_setup<false, false>);
  launch(params, n_lights, verts, cols, nrms, uvs, T, Tp, gid0, frame_h,
         frame_w, recs, bbox, s);
  return static_cast<int>(cudaGetLastError());
}
