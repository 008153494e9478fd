// The deferred shade: shade, pack and merge each pixel of a G-buffer in one
// pass (deferred_shade_kernel, C entry tr_deferred_shade).
//
// Replaces no Pallas kernel: the JAX package's deferred shade
// (tpu_renderer/ops/shading.py shade, core/math.py pack_argb and the
// engine's strict '>' merge) is XLA ops, and so is the port's plain version
// (ops/shading.py shade_merge_plain), some 500 torch launches a frame over
// the (11, H, W) planes. This kernel computes the same frame: the texture
// replaces the interpolated colour ('avx' addressing also drops the pixels
// whose u or v leaves [0, 1]), Phong shades at the unprojection of the
// global pixel coordinates, ARGB packing, then the merge over the
// framebuffer, all in the plain version's f32 op order (shade.cuh), so the
// frames are bit-equal.
//
// Bound on the H100: bytes. Every pixel reads its coverage (1 B), z and the
// framebuffer's depth and colour (12 B) and writes colour and depth (8 B);
// a pixel that wins the merge also reads the planes its object uses: the
// normal (12 B, Phong) and u/z, v/z, 1/z (12 B, textured) or the colour
// (16 B, untextured). At most 45 B a textured Phong pixel, 0.111 ms for
// 3840 x 2160 at 3.35 TB/s; its ~200 f32 operations take a fifth of that
// at 67 TFLOP/s, and the texels come from L2.
//
// Design: one thread takes 4 neighbouring pixels of a row, with 16-byte
// loads and stores where the rows allow (width a multiple of 4, aligned
// planes), a scalar tail otherwise. A pixel that cannot win, !(covered &&
// z > depth), keeps the framebuffer's colour and depth; the other planes
// and the texture are read only for the 4 pixels of a thread that hold a
// winner. With no framebuffer (a fresh frame) the kernel writes its clear
// values itself (colour 0, DEPTH_CLEAR) and reads none. PHONG and TEX are
// the object's config, so each form holds only the planes and the sampler
// it uses.

#include "shade.cuh"

namespace tr {

// The texture modes of ObjectConfig: none, then (uv_mode, filter_mode).
enum TexMode {
  kNoTex = 0,
  kScalarNearest = 1,
  kScalarBilinear = 2,
  kAvxNearest = 3,
  kAvxBilinear = 4,
};

constexpr int kShadeThreads = 256;
constexpr int kQuad = 4;  // pixels a thread

// Row y, column x of an (H, W) input lies at y * its row stride + x (a crop
// of a padded plane will do); the outputs are (H, W), rows contiguous.
struct ShadeArgs {
  const unsigned char* covered;  // (H, W) bool
  long long cov_row;
  const float* gbuf;  // plane c, row y, col x at c * plane + y * row + x
  long long plane, row;
  const unsigned* fb_color;  // (H, W), or null: a fresh frame
  long long color_row;
  const float* fb_depth;
  long long depth_row;
  const unsigned* tex;  // (th, tw) ARGB, or null
  int th, tw;
  const float* params;  // shade_params' vector (Phong only)
  int n_lights;
  int height, width, row0, col0;
  bool vec;  // 16-byte loads and stores
  unsigned* color_out;
  float* depth_out;
};

__device__ __forceinline__ void load4(const float* p, bool vec, int n,
                                      float* v) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) v[i] = i < n ? __ldg(p + i) : 0.0f;
  }
}

__device__ __forceinline__ void load4(const unsigned* p, bool vec, int n,
                                      unsigned* v) {
  if (vec) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) v[i] = i < n ? __ldg(p + i) : 0u;
  }
}

__device__ __forceinline__ void load4(const unsigned char* p, bool vec, int n,
                                      bool* v) {
  if (vec) {
    const uchar4 t = __ldg(reinterpret_cast<const uchar4*>(p));
    v[0] = t.x != 0;
    v[1] = t.y != 0;
    v[2] = t.z != 0;
    v[3] = t.w != 0;
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) v[i] = i < n && __ldg(p + i) != 0;
  }
}

template <int TEX>
__device__ __forceinline__ bool in_unit_square(float u, float v) {
  if constexpr (TEX == kAvxNearest || TEX == kAvxBilinear)
    return u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f;
  return true;
}

// sample_texture (ops/shading.py) of one pixel: 'scalar' nearest and
// bilinear, and 'avx' bilinear, are K5's fetch on the whole texture; 'avx'
// nearest truncates u * tw, clipped.
template <int TEX>
__device__ __forceinline__ void sample(const ShadeArgs& a, float u, float v,
                                       float* out) {
  if constexpr (TEX == kAvxNearest) {
    const int tx = clamp_i(to_i32(truncf(u * static_cast<float>(a.tw))), 0,
                           a.tw - 1);
    const int ty = clamp_i(to_i32(truncf(v * static_cast<float>(a.th))), 0,
                           a.th - 1);
    texel_rgba(a.tex, a.tw, ty, tx, out);
  } else {
    sample_texture(a.tex, a.tw, u, v, 0, a.th, a.tw,
                   TEX == kScalarBilinear || TEX == kAvxBilinear, out);
  }
}

template <bool PHONG, int TEX>
__global__ void __launch_bounds__(kShadeThreads)
    deferred_shade_kernel(const ShadeArgs a) {
  const long long quads = (a.width + kQuad - 1) / kQuad;
  const long long q = (long long)blockIdx.x * kShadeThreads + threadIdx.x;
  if (q >= quads * a.height) return;
  const int y = static_cast<int>(q / quads);
  const int x0 = static_cast<int>(q - y * quads) * kQuad;
  const int n = min(kQuad, a.width - x0);
  const size_t o = (size_t)y * a.width + x0;
  const float* g0 = a.gbuf + (size_t)y * a.row + x0;  // plane 0 at (y, x0)

  bool win[kQuad];
  float z[kQuad], depth[kQuad];
  unsigned color[kQuad];
  load4(a.covered + (size_t)y * a.cov_row + x0, a.vec, n, win);
  load4(g0, a.vec, n, z);
  if (a.fb_depth != nullptr) {
    load4(a.fb_depth + (size_t)y * a.depth_row + x0, a.vec, n, depth);
    load4(a.fb_color + (size_t)y * a.color_row + x0, a.vec, n, color);
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      depth[i] = kDepthClear;
      color[i] = 0u;
    }
  }
  bool any = false;
#pragma unroll
  for (int i = 0; i < kQuad; ++i) {
    win[i] = win[i] && z[i] > depth[i];
    any = any || win[i];
  }

  if (any) {
    float col[4][kQuad];  // [channel][pixel]
    if constexpr (TEX == kNoTex) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        load4(g0 + (c + 1) * a.plane, a.vec, n, col[c]);
    } else {
      float uoz[kQuad], voz[kQuad], oz[kQuad];
      load4(g0 + 8 * a.plane, a.vec, n, uoz);
      load4(g0 + 9 * a.plane, a.vec, n, voz);
      load4(g0 + 10 * a.plane, a.vec, n, oz);
#pragma unroll
      for (int i = 0; i < kQuad; ++i) {
        if (!win[i]) continue;
        const float inv_oz = 1.0f / oz[i];
        const float u = inv_oz * uoz[i], v = inv_oz * voz[i];
        float texel[4];
        sample<TEX>(a, u, v, texel);
#pragma unroll
        for (int c = 0; c < 4; ++c) col[c][i] = texel[c];
        win[i] = in_unit_square<TEX>(u, v);
      }
    }
    float nrm[3][kQuad];
    if constexpr (PHONG) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        load4(g0 + (c + 5) * a.plane, a.vec, n, nrm[c]);
    }
    const float py = static_cast<float>(y) + static_cast<float>(a.row0);
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (!win[i]) continue;
      float rgba[4];
      if constexpr (PHONG) {
        const float c4[4] = {col[0][i], col[1][i], col[2][i], col[3][i]};
        const float n3[3] = {nrm[0][i], nrm[1][i], nrm[2][i]};
        const float pxf =
            static_cast<float>(x0 + i) + static_cast<float>(a.col0);
        shade_phong(z[i], c4, n3, pxf, py, a.params, a.n_lights, rgba);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) rgba[c] = col[c][i];
      }
      color[i] = pack_argb(rgba);
      depth[i] = z[i];
    }
  }

  if (a.vec) {
    *reinterpret_cast<uint4*>(a.color_out + o) =
        make_uint4(color[0], color[1], color[2], color[3]);
    *reinterpret_cast<float4*>(a.depth_out + o) =
        make_float4(depth[0], depth[1], depth[2], depth[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kQuad; ++i) {
      if (i < n) {
        a.color_out[o + i] = color[i];
        a.depth_out[o + i] = depth[i];
      }
    }
  }
}

template <bool PHONG>
int launch_shade(int tex_mode, unsigned blocks, cudaStream_t stream,
                 const ShadeArgs& a) {
  switch (tex_mode) {
    case kNoTex:
      deferred_shade_kernel<PHONG, kNoTex>
          <<<blocks, kShadeThreads, 0, stream>>>(a);
      break;
    case kScalarNearest:
      deferred_shade_kernel<PHONG, kScalarNearest>
          <<<blocks, kShadeThreads, 0, stream>>>(a);
      break;
    case kScalarBilinear:
      deferred_shade_kernel<PHONG, kScalarBilinear>
          <<<blocks, kShadeThreads, 0, stream>>>(a);
      break;
    case kAvxNearest:
      deferred_shade_kernel<PHONG, kAvxNearest>
          <<<blocks, kShadeThreads, 0, stream>>>(a);
      break;
    case kAvxBilinear:
      deferred_shade_kernel<PHONG, kAvxBilinear>
          <<<blocks, kShadeThreads, 0, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace tr

// The deferred shade of the local (height, width) rect at (row0, col0) of
// the frame: covered (H, W) bool, gbuf's planes, fb_color / fb_depth the
// framebuffer or null for a fresh frame, each at the given strides (in
// elements; each row contiguous), tex the (th, tw) texture or null, params
// shade_params' vector or null (Gouraud). Writes color_out / depth_out (H,
// W); vec: every pointer 16-byte aligned (covered 4-byte), the width and
// every stride multiples of 4.
extern "C" int tr_deferred_shade(
    const unsigned char* covered, long long cov_row, const float* gbuf,
    long long plane, long long row, const unsigned* fb_color,
    long long color_row, const float* fb_depth, long long depth_row,
    const unsigned* tex, int th, int tw, const float* params, int n_lights,
    int phong, int tex_mode, int height, int width, int row0, int col0,
    int vec, unsigned* color_out, float* depth_out, cudaStream_t stream) {
  const tr::ShadeArgs a{covered,   cov_row,   gbuf,     plane,  row,
                        fb_color,  color_row, fb_depth, depth_row,
                        tex,       th,        tw,       params, n_lights,
                        height,    width,     row0,     col0,   vec != 0,
                        color_out, depth_out};
  const long long quads =
      (long long)((width + tr::kQuad - 1) / tr::kQuad) * height;
  const long long blocks = (quads + tr::kShadeThreads - 1) / tr::kShadeThreads;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return phong ? tr::launch_shade<true>(tex_mode, (unsigned)blocks, stream, a)
               : tr::launch_shade<false>(tex_mode, (unsigned)blocks, stream,
                                         a);
}
