// The per-pixel shading math of the port's kernels, one copy for the two
// that shade: the fused finalize (raster.cu, split_finalize_kernel and
// mask_kernel) and the deferred shade (shade.cu). Blinn-Phong, ARGB packing
// and K5, the texel fetch, in the f32 op order of ops/shading.py.
#pragma once

#include "common.cuh"

namespace tr {

// shade_planes' Phong branch for one pixel (ops/shading.py): unproject,
// per-light Blinn-Phong, clamp. prm = [dat, fl, m2p, cx, cy, ambient rgba,
// (light_p xyz, light_I rgba) per light].
__device__ __forceinline__ void shade_phong(float z, const float* col,
                                            const float* nrm, float px,
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
  norm3(nrm[0], nrm[1], nrm[2], n0, n1, n2);  // divergence #3
  norm3(-pos0, -pos1, -pos2, v0, v1, v2);
  float fin[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < n_lights; ++k) {
    const float* l = prm + 9 + 7 * k;
    if (k == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) fin[c] = col[c] * prm[5 + c];
    }
    float t0, t1, t2, h0, h1, h2;
    norm3(l[0] - pos0, l[1] - pos1, l[2] - pos2, t0, t1, t2);
    const float cosi = clamp01(inner3(n0, n1, n2, t0, t1, t2));
    norm3(t0 + v0, t1 + v1, t2 + v2, h0, h1, h2);
    const float spec = pow16(clamp01(inner3(n0, n1, n2, h0, h1, h2)));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      fin[c] = fin[c] + cosi * (col[c] * l[3 + c]) + spec * (1.0f * l[3 + c]);
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

// ---------------------------------------------------------------------------
// K5: one texel fetch per pixel from the scene's atlas (row-major u32 ARGB,
// aw texels per row; the object's texture is rows [v_off, v_off + th),
// columns [0, tw)). Replaces the TPU's one-hot MXU contractions
// (_row_texels :788, _col_pick :848): the H100 gathers texels directly,
// through L1 (the largest fused atlas, 128 x 128 texels, is 64 KB).
// ---------------------------------------------------------------------------

__device__ __forceinline__ int clamp_i(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// unpack_argb: each 8-bit channel as f32 times the f32 1/255.
__device__ __forceinline__ void texel_rgba(const unsigned* __restrict__ atlas,
                                           int aw, int row, int col,
                                           float* c) {
  const unsigned t = __ldg(atlas + (size_t)row * aw + col);
  constexpr float inv255 = 1.0f / 255.0f;
  c[0] = static_cast<float>((t >> 16) & 0xFFu) * inv255;
  c[1] = static_cast<float>((t >> 8) & 0xFFu) * inv255;
  c[2] = static_cast<float>(t & 0xFFu) * inv255;
  c[3] = static_cast<float>((t >> 24) & 0xFFu) * inv255;
}

// sample_texture's 'scalar' addressing (projekt.cpp:429-445) in the TPU
// finalize's op order (raster_pallas.py:1662-1689): nearest rounds
// u * (tw - 1) half away from zero; bilinear takes the fraction from the
// unclipped floor, clips the indices after, the second index min(i + 1,
// t - 1), then lerps top, bottom, out. A nearest object in a scene that
// also holds bilinear ones rides the TPU's bilinear sampler as a zero-t
// lerp, which returns c00 exactly, so it takes the nearest fetch here.
__device__ __forceinline__ void sample_texture(
    const unsigned* __restrict__ atlas, int aw, float u, float v, int v_off,
    int th, int tw, bool bilinear, float* out) {
  if (bilinear) {
    const float tu = u * static_cast<float>(tw - 1);
    const float tv = v * static_cast<float>(th - 1);
    const float x0 = floorf(tu), y0 = floorf(tv);
    const float fx = tu - x0, fy = tv - y0;
    const int xi = clamp_i(to_i32(x0), 0, tw - 1);
    const int yi = clamp_i(to_i32(y0), 0, th - 1);
    const int xi1 = min(xi + 1, tw - 1), yi1 = min(yi + 1, th - 1);
    float c00[4], c10[4], c01[4], c11[4];
    texel_rgba(atlas, aw, yi + v_off, xi, c00);
    texel_rgba(atlas, aw, yi + v_off, xi1, c10);
    texel_rgba(atlas, aw, yi1 + v_off, xi, c01);
    texel_rgba(atlas, aw, yi1 + v_off, xi1, c11);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float top = c00[c] + fx * (c10[c] - c00[c]);
      const float bot = c01[c] + fx * (c11[c] - c01[c]);
      out[c] = top + fy * (bot - top);
    }
  } else {
    const int tx = clamp_i(
        to_i32(round_half_away(u * static_cast<float>(tw - 1))), 0, tw - 1);
    const int ty = clamp_i(
        to_i32(round_half_away(v * static_cast<float>(th - 1))), 0, th - 1);
    texel_rgba(atlas, aw, ty + v_off, tx, out);
  }
}

}  // namespace tr
