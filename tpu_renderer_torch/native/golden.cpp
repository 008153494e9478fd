// Native CPU golden renderer + work-queue runtime.
//
// Faithful reimplementation of the reference renderer's semantics
// (FillEdgeTable projekt.cpp:3882-4121 + scalar DrawModel projekt.cpp:162-601)
// including the *sequential* attribute stepping (attr += gradient per
// row/pixel) and the per-step normal renormalization (projekt.cpp:504,
// 551-552) that the TPU path replaces with closed forms — making this the
// ground-truth CPU baseline for both behavior and performance.
//
// The reference's platform work queue (SURVEY.md L3/L7: Platform.AddEntry +
// worker threads + ZMask spinlock, projekt.cpp:1378-1409, 3609, 3809) is
// realized here as a std::thread pool with deterministic row-interleaved
// ownership (thread t fills rows where row % nthreads == t): each row has
// exactly one writer, so the spinlock is unnecessary and the output is
// bit-reproducible regardless of thread count — a deliberate improvement
// over the reference's racy-but-convergent locking, documented as such.
//
// Exposed via a C ABI consumed through ctypes (tpu_renderer_torch/golden/
// native.py). This file is the same source as tpu_renderer/native/golden.cpp;
// the two libraries agree bit for bit (tests/test_torch_golden.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libgolden.so golden.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#define TR_HAVE_AVX2 1
#else
#define TR_HAVE_AVX2 0
#endif

namespace {

constexpr float kNearClip = 0.2f;
constexpr float kDepthClear = -3.4028235e38f;

struct Transform {
  float dat, focal, m2p, cx, cy;
};

struct V3 { float x, y, z; };
struct V4 { float r, g, b, a; };

inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 mul(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline float inner(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 normalize(V3 v) {
  float inv = 1.0f / std::sqrt(inner(v, v));
  return mul(inv, v);
}
inline V4 add4(V4 a, V4 b) {
  return {a.r + b.r, a.g + b.g, a.b + b.b, a.a + b.a};
}
inline V4 mul4(float s, V4 a) { return {s * a.r, s * a.g, s * a.b, s * a.a}; }
inline V4 had4(V4 a, V4 b) {
  return {a.r * b.r, a.g * b.g, a.b * b.b, a.a * b.a};
}
inline float clamp01(float x) { return x < 0.f ? 0.f : (x > 1.f ? 1.f : x); }
inline V4 clamp01_4(V4 c) {
  return {clamp01(c.r), clamp01(c.g), clamp01(c.b), clamp01(c.a)};
}
inline float pow16(float x) {  // 4 squarings (projekt.cpp:1261-1266)
  float x2 = x * x, x4 = x2 * x2, x8 = x4 * x4;
  return x8 * x8;
}
inline int round_s32(float x) { return (int)roundf(x); }
inline uint32_t round_u32(float x) { return (uint32_t)roundf(x); }

// ProjectVertex (projekt.cpp:74-93): z holds DistanceToPZ.
inline V3 project_vertex(V3 cam, const Transform& t) {
  float dz = t.dat - cam.z;
  if (dz > kNearClip) {
    float s = (1.0f / dz) * t.focal;
    return {t.cx + t.m2p * (s * cam.x), t.cy + t.m2p * (s * cam.y), dz};
  }
  return {0.f, 0.f, 0.f};
}

// UnprojectVertex (projekt.cpp:147-160): takes camera z.
inline V3 unproject_vertex(float px, float py, float z, const Transform& t) {
  float dz = t.dat - z;
  float inv = 1.0f / t.m2p;
  float s = dz / t.focal;
  return {s * ((px - t.cx) * inv), s * ((py - t.cy) * inv), z};
}

struct Light { V3 p; V4 intensity; };

struct LightData {
  V4 ambient;
  const Light* lights;
  int count;
};

// edge_info (projekt.h:17-37) minus linked-list plumbing.
struct Edge {
  int ymin, ymax;
  float x, z, oz, u, v;       // stepped current values
  float xg, zg, ozg, ug, vg;  // per-row gradients
  V4 col, colg;
  V3 n, ng;
  float left;
  bool valid;
};

struct ObjectData {
  const float* verts;    // (V,3)
  const float* colors;   // (V,4)
  const float* normals;  // (V,3)
  const float* uvs;      // (V,2)
  int vertex_count;
  V3 p;
  const uint32_t* texture;
  int tex_h, tex_w;
  bool phong;
  bool use_avx;
  bool bilinear;  // 4-texel lerp (BASELINE config 3's sampling contract)
};

// Gouraud per-vertex lighting (projekt.cpp:4022-4063).
V4 gouraud_color(V4 base, V3 normal, V3 cam, const LightData& L,
                 bool textured) {
  V4 white{1.f, 1.f, 1.f, 1.f};
  V4 b = textured ? white : base;
  if (L.count == 0) return b;  // divergence #6 (golden spec)
  V4 out = had4(b, L.ambient);
  for (int k = 0; k < L.count; ++k) {
    V3 to_light = normalize(sub(L.lights[k].p, cam));
    float d = clamp01(inner(to_light, normal));
    out = clamp01_4(add4(out, mul4(d, had4(b, L.lights[k].intensity))));
  }
  return out;
}

// FillEdgeTable for one triangle (projekt.cpp:3882-4121).
int setup_triangle(const ObjectData& obj, const Transform& tr,
                   const LightData& L, int tri, Edge out[3]) {
  V3 cam[3], proj[3];
  V4 col[3];
  V3 nrm[3];
  float uv[3][2];
  for (int i = 0; i < 3; ++i) {
    int vi = 3 * tri + i;
    cam[i] = add({obj.verts[3 * vi], obj.verts[3 * vi + 1],
                  obj.verts[3 * vi + 2]}, obj.p);
    proj[i] = project_vertex(cam[i], tr);
    col[i] = {obj.colors[4 * vi], obj.colors[4 * vi + 1],
              obj.colors[4 * vi + 2], obj.colors[4 * vi + 3]};
    nrm[i] = {obj.normals[3 * vi], obj.normals[3 * vi + 1],
              obj.normals[3 * vi + 2]};
    uv[i][0] = obj.uvs[2 * vi];
    uv[i][1] = obj.uvs[2 * vi + 1];
  }
  // Backface cull (projekt.cpp:3926-3943).
  V3 e1 = normalize(sub(proj[1], proj[0]));
  V3 e2 = normalize(sub(proj[2], proj[0]));
  if (!(-(e1.x * e2.y - e1.y * e2.x) > 0.0f)) return 0;

  bool textured = obj.texture != nullptr;
  V4 gcol[3];
  if (!obj.phong)
    for (int i = 0; i < 3; ++i)
      gcol[i] = gouraud_color(col[i], nrm[i], cam[i], L, textured);

  static const int idx[3][2] = {{0, 1}, {1, 2}, {2, 0}};
  int count = 0;
  for (int e = 0; e < 3; ++e) {
    int mn = idx[e][0], mx = idx[e][1];
    if (proj[mn].y > proj[mx].y) std::swap(mn, mx);
    V3 minv = proj[mn], maxv = proj[mx];
    if (!(maxv.y > 0.0f)) continue;                  // cpp:3968
    if (minv.y - maxv.y == 0.0f) continue;           // cpp:4066

    Edge& E = out[count];
    E.ymax = round_s32(maxv.y);
    float clipped_y = 0.f, t = 0.f;
    if (minv.y < 0.0f) {
      clipped_y = -minv.y;
      t = (-minv.y) / (maxv.y - minv.y);
    }
    E.ymin = (int)std::max(0.0f, (float)round_s32(minv.y));
    float ydiff = (float)E.ymax - (float)E.ymin;

    E.xg = (maxv.x - minv.x) / (maxv.y - minv.y);
    E.zg = (cam[mx].z - cam[mn].z) / ydiff;
    E.x = minv.x + clipped_y * E.xg;
    E.z = cam[mn].z + clipped_y * E.zg;
    E.oz = 1.0f / minv.z;
    E.u = uv[mn][0] / minv.z;
    E.v = uv[mn][1] / minv.z;
    if (textured) {
      float u1 = uv[mx][0] * (1.0f / maxv.z);
      float v1 = uv[mx][1] * (1.0f / maxv.z);
      E.ug = (u1 - E.u) / ydiff;
      E.vg = (v1 - E.v) / ydiff;
      E.ozg = ((1.0f / maxv.z) - E.oz) / ydiff;
      E.u += clipped_y * E.ug;
      E.v += clipped_y * E.vg;
      E.oz += clipped_y * E.ozg;
    } else {
      E.ug = E.vg = E.ozg = 0.f;
    }

    V4 cmin, cmax;
    V3 nmin{0, 0, 0}, nmax{0, 0, 0};
    if (obj.phong) {
      cmin = col[mn]; cmax = col[mx];
      nmin = nrm[mn]; nmax = nrm[mx];
    } else {
      cmin = gcol[mn]; cmax = gcol[mx];
    }
    E.col = add4(mul4(1.0f - t, cmin), mul4(t, cmax));  // cpp:4091
    E.colg = mul4(1.0f / ydiff, add4(cmax, mul4(-1.f, E.col)));
    E.n = nmin;
    E.ng = obj.phong ? mul(1.0f / ydiff, sub(nmax, nmin)) : V3{0, 0, 0};
    E.left = (E.ymin == round_s32(proj[idx[e][0]].y)) ? 1.f : 0.f;
    E.valid = true;
    ++count;
  }
  return count;
}

inline void unpack_texel(uint32_t texel, V4* out) {
  const float inv = 1.0f / 255.0f;
  out->a = (float)((texel >> 24) & 0xFF) * inv;
  out->r = (float)((texel >> 16) & 0xFF) * inv;
  out->g = (float)((texel >> 8) & 0xFF) * inv;
  out->b = (float)(texel & 0xFF) * inv;
}

inline void sample_texture(const ObjectData& obj, float u, float v,
                           V4* out) {
  if (obj.bilinear) {
    // golden.cpu_reference.sample_texture's bilinear branch, identical
    // float order: frac from the UNCLIPPED floor, indices clipped after,
    // corners unpacked to [0,1] first, then c0 + t * (c1 - c0) lerps.
    float tu = u * (float)(obj.tex_w - 1);
    float tv = v * (float)(obj.tex_h - 1);
    float x0 = std::floor(tu), y0 = std::floor(tv);
    float fx = tu - x0, fy = tv - y0;
    int xi = (int)std::min(std::max(x0, 0.0f), (float)(obj.tex_w - 1));
    int yi = (int)std::min(std::max(y0, 0.0f), (float)(obj.tex_h - 1));
    int xi1 = std::min(xi + 1, obj.tex_w - 1);
    int yi1 = std::min(yi + 1, obj.tex_h - 1);
    V4 c00, c10, c01, c11;
    unpack_texel(obj.texture[yi * obj.tex_w + xi], &c00);
    unpack_texel(obj.texture[yi * obj.tex_w + xi1], &c10);
    unpack_texel(obj.texture[yi1 * obj.tex_w + xi], &c01);
    unpack_texel(obj.texture[yi1 * obj.tex_w + xi1], &c11);
    V4 top{c00.r + fx * (c10.r - c00.r), c00.g + fx * (c10.g - c00.g),
           c00.b + fx * (c10.b - c00.b), c00.a + fx * (c10.a - c00.a)};
    V4 bot{c01.r + fx * (c11.r - c01.r), c01.g + fx * (c11.g - c01.g),
           c01.b + fx * (c11.b - c01.b), c01.a + fx * (c11.a - c01.a)};
    out->r = top.r + fy * (bot.r - top.r);
    out->g = top.g + fy * (bot.g - top.g);
    out->b = top.b + fy * (bot.b - top.b);
    out->a = top.a + fy * (bot.a - top.a);
    return;
  }
  // scalar-path semantics: round, scale by dim-1, clamp (projekt.cpp:429-445)
  int tx = round_s32(u * (float)(obj.tex_w - 1));
  int ty = round_s32(v * (float)(obj.tex_h - 1));
  tx = std::min(std::max(tx, 0), obj.tex_w - 1);
  ty = std::min(std::max(ty, 0), obj.tex_h - 1);
  unpack_texel(obj.texture[ty * obj.tex_w + tx], out);
}

inline uint32_t pack_argb(V4 c) {  // projekt.cpp:490-493
  return (round_u32(c.a * 255.f) << 24) | (round_u32(c.r * 255.f) << 16) |
         (round_u32(c.g * 255.f) << 8) | round_u32(c.b * 255.f);
}

#if TR_HAVE_AVX2
// 8-wide AVX2 span fill — the analog of the reference's FillLineOptimized
// (projekt.cpp:1492-2320): closed-form per-lane attributes, per-lane texel
// gather, 8-wide Blinn-Phong, masked z-test stores. Unlike the reference's
// locked variant no spinlock is needed (rows are single-writer here).
static inline __m256 clamp01_8(__m256 x) {
  return _mm256_min_ps(_mm256_max_ps(x, _mm256_setzero_ps()),
                       _mm256_set1_ps(1.f));
}
static inline __m256 rsqrt_exact_8(__m256 d) {
  return _mm256_div_ps(_mm256_set1_ps(1.f), _mm256_sqrt_ps(d));
}

void fill_span_avx(const ObjectData& obj, const Transform& tr,
                   const LightData& L, const Edge& Le, const Edge& Re,
                   int row, uint32_t* color, float* depth, int W) {
  float xl = Le.x, xr = Re.x;
  float xd = roundf(xr - xl);
  float zinc = 0, ozinc = 0, uinc = 0, vinc = 0;
  V4 cinc{0, 0, 0, 0};
  V3 ninc{0, 0, 0};
  if (xd != 0.0f) {
    float inv = 1.0f / xd;
    zinc = (Re.z - Le.z) * inv;
    ozinc = (Re.oz - Le.oz) * inv;
    uinc = (Re.u - Le.u) * inv;
    vinc = (Re.v - Le.v) * inv;
    cinc = mul4(inv, add4(Re.col, mul4(-1.f, Le.col)));
    ninc = mul(inv, sub(Re.n, Le.n));
  }
  float xoff = xl < 0.f ? -xl : 0.f;
  float lx = xl < 0.f ? 0.f : (xl >= (float)W ? (float)W - 1.f : xl);
  float rx = xr < 0.f ? 0.f : (xr >= (float)W ? (float)W - 1.f : xr);
  int minx = std::min(round_s32(lx), W - 1);
  int maxx = std::min(round_s32(rx), W - 1);
  if (maxx < minx) return;

  const __m256 lane =
      _mm256_setr_ps(0.f, 1.f, 2.f, 3.f, 4.f, 5.f, 6.f, 7.f);
  bool textured = obj.texture != nullptr;
  uint32_t* px = color + (size_t)row * W;
  float* zb = depth + (size_t)row * W;

  for (int x = minx; x <= maxx; x += 8) {
    int n = std::min(8, maxx - x + 1);
    __m256 nmask =
        _mm256_cmp_ps(lane, _mm256_set1_ps((float)n), _CMP_LT_OQ);
    __m256 k = _mm256_add_ps(
        _mm256_set1_ps(xoff + (float)(x - minx)), lane);
    __m256 z = _mm256_add_ps(_mm256_set1_ps(Le.z),
                             _mm256_mul_ps(k, _mm256_set1_ps(zinc)));
    __m256 cr = _mm256_add_ps(_mm256_set1_ps(Le.col.r),
                              _mm256_mul_ps(k, _mm256_set1_ps(cinc.r)));
    __m256 cg = _mm256_add_ps(_mm256_set1_ps(Le.col.g),
                              _mm256_mul_ps(k, _mm256_set1_ps(cinc.g)));
    __m256 cb = _mm256_add_ps(_mm256_set1_ps(Le.col.b),
                              _mm256_mul_ps(k, _mm256_set1_ps(cinc.b)));
    __m256 ca = _mm256_add_ps(_mm256_set1_ps(Le.col.a),
                              _mm256_mul_ps(k, _mm256_set1_ps(cinc.a)));

    if (textured) {
      __m256 oz = _mm256_add_ps(_mm256_set1_ps(Le.oz),
                                _mm256_mul_ps(k, _mm256_set1_ps(ozinc)));
      __m256 uu = _mm256_add_ps(_mm256_set1_ps(Le.u),
                                _mm256_mul_ps(k, _mm256_set1_ps(uinc)));
      __m256 vv = _mm256_add_ps(_mm256_set1_ps(Le.v),
                                _mm256_mul_ps(k, _mm256_set1_ps(vinc)));
      __m256 inv_oz = _mm256_div_ps(_mm256_set1_ps(1.f), oz);
      alignas(32) float ua[8], va[8];
      _mm256_store_ps(ua, _mm256_mul_ps(inv_oz, uu));
      _mm256_store_ps(va, _mm256_mul_ps(inv_oz, vv));
      alignas(32) float ra[8], ga[8], ba[8], aa[8];
      for (int i = 0; i < n; ++i) {
        V4 texc;
        sample_texture(obj, ua[i], va[i], &texc);
        ra[i] = texc.r; ga[i] = texc.g; ba[i] = texc.b; aa[i] = texc.a;
      }
      for (int i = n; i < 8; ++i) { ra[i]=ga[i]=ba[i]=aa[i]=0.f; }
      cr = _mm256_load_ps(ra); cg = _mm256_load_ps(ga);
      cb = _mm256_load_ps(ba); ca = _mm256_load_ps(aa);
    }

    __m256 fr = cr, fg = cg, fb = cb, fa = ca;
    if (obj.phong) {
      // 8-wide unproject (UnprojectVertex_8x, projekt.cpp:102-145)
      __m256 dz = _mm256_sub_ps(_mm256_set1_ps(tr.dat), z);
      __m256 inv_m2p = _mm256_set1_ps(1.0f / tr.m2p);
      __m256 xs = _mm256_add_ps(_mm256_set1_ps((float)x), lane);
      __m256 ax = _mm256_mul_ps(
          _mm256_sub_ps(xs, _mm256_set1_ps(tr.cx)), inv_m2p);
      __m256 ay = _mm256_mul_ps(
          _mm256_sub_ps(_mm256_set1_ps((float)row),
                        _mm256_set1_ps(tr.cy)), inv_m2p);
      __m256 sscale = _mm256_div_ps(dz, _mm256_set1_ps(tr.focal));
      __m256 posx = _mm256_mul_ps(sscale, ax);
      __m256 posy = _mm256_mul_ps(sscale, ay);
      __m256 posz = z;
      // normal (group-stepped, renormalized per 8-px group like the
      // reference AVX path projekt.cpp:1432-1440)
      __m256 nx = _mm256_add_ps(_mm256_set1_ps(Le.n.x),
                                _mm256_mul_ps(k, _mm256_set1_ps(ninc.x)));
      __m256 ny = _mm256_add_ps(_mm256_set1_ps(Le.n.y),
                                _mm256_mul_ps(k, _mm256_set1_ps(ninc.y)));
      __m256 nz = _mm256_add_ps(_mm256_set1_ps(Le.n.z),
                                _mm256_mul_ps(k, _mm256_set1_ps(ninc.z)));
      __m256 nd = _mm256_add_ps(
          _mm256_add_ps(_mm256_mul_ps(nx, nx), _mm256_mul_ps(ny, ny)),
          _mm256_mul_ps(nz, nz));
      __m256 ninv = rsqrt_exact_8(nd);
      nx = _mm256_mul_ps(nx, ninv);
      ny = _mm256_mul_ps(ny, ninv);
      nz = _mm256_mul_ps(nz, ninv);
      // view = normalize(-pos)
      __m256 vd = _mm256_add_ps(
          _mm256_add_ps(_mm256_mul_ps(posx, posx),
                        _mm256_mul_ps(posy, posy)),
          _mm256_mul_ps(posz, posz));
      __m256 vinv = rsqrt_exact_8(vd);
      __m256 vx = _mm256_mul_ps(_mm256_sub_ps(_mm256_setzero_ps(), posx), vinv);
      __m256 vy = _mm256_mul_ps(_mm256_sub_ps(_mm256_setzero_ps(), posy), vinv);
      __m256 vz = _mm256_mul_ps(_mm256_sub_ps(_mm256_setzero_ps(), posz), vinv);

      fr = fg = fb = fa = _mm256_setzero_ps();
      for (int li = 0; li < L.count; ++li) {
        if (li == 0) {
          fr = _mm256_mul_ps(cr, _mm256_set1_ps(L.ambient.r));
          fg = _mm256_mul_ps(cg, _mm256_set1_ps(L.ambient.g));
          fb = _mm256_mul_ps(cb, _mm256_set1_ps(L.ambient.b));
          fa = _mm256_mul_ps(ca, _mm256_set1_ps(L.ambient.a));
        }
        const Light& lt = L.lights[li];
        __m256 lxv = _mm256_sub_ps(_mm256_set1_ps(lt.p.x), posx);
        __m256 lyv = _mm256_sub_ps(_mm256_set1_ps(lt.p.y), posy);
        __m256 lzv = _mm256_sub_ps(_mm256_set1_ps(lt.p.z), posz);
        __m256 ld = _mm256_add_ps(
            _mm256_add_ps(_mm256_mul_ps(lxv, lxv), _mm256_mul_ps(lyv, lyv)),
            _mm256_mul_ps(lzv, lzv));
        __m256 linv = rsqrt_exact_8(ld);
        lxv = _mm256_mul_ps(lxv, linv);
        lyv = _mm256_mul_ps(lyv, linv);
        lzv = _mm256_mul_ps(lzv, linv);
        __m256 cosi = clamp01_8(_mm256_add_ps(
            _mm256_add_ps(_mm256_mul_ps(nx, lxv), _mm256_mul_ps(ny, lyv)),
            _mm256_mul_ps(nz, lzv)));
        __m256 hx = _mm256_add_ps(lxv, vx);
        __m256 hy = _mm256_add_ps(lyv, vy);
        __m256 hz = _mm256_add_ps(lzv, vz);
        __m256 hd = _mm256_add_ps(
            _mm256_add_ps(_mm256_mul_ps(hx, hx), _mm256_mul_ps(hy, hy)),
            _mm256_mul_ps(hz, hz));
        __m256 hinv = rsqrt_exact_8(hd);
        hx = _mm256_mul_ps(hx, hinv);
        hy = _mm256_mul_ps(hy, hinv);
        hz = _mm256_mul_ps(hz, hinv);
        __m256 spec = clamp01_8(_mm256_add_ps(
            _mm256_add_ps(_mm256_mul_ps(nx, hx), _mm256_mul_ps(ny, hy)),
            _mm256_mul_ps(nz, hz)));
        spec = _mm256_mul_ps(spec, spec);  // ^2
        spec = _mm256_mul_ps(spec, spec);  // ^4
        spec = _mm256_mul_ps(spec, spec);  // ^8
        spec = _mm256_mul_ps(spec, spec);  // ^16 (projekt.cpp:1261-1266)
        __m256 Ir = _mm256_set1_ps(lt.intensity.r);
        __m256 Ig = _mm256_set1_ps(lt.intensity.g);
        __m256 Ib = _mm256_set1_ps(lt.intensity.b);
        __m256 Ia = _mm256_set1_ps(lt.intensity.a);
        fr = _mm256_add_ps(fr, _mm256_add_ps(
            _mm256_mul_ps(cosi, _mm256_mul_ps(cr, Ir)),
            _mm256_mul_ps(spec, Ir)));
        fg = _mm256_add_ps(fg, _mm256_add_ps(
            _mm256_mul_ps(cosi, _mm256_mul_ps(cg, Ig)),
            _mm256_mul_ps(spec, Ig)));
        fb = _mm256_add_ps(fb, _mm256_add_ps(
            _mm256_mul_ps(cosi, _mm256_mul_ps(cb, Ib)),
            _mm256_mul_ps(spec, Ib)));
        fa = _mm256_add_ps(fa, _mm256_add_ps(
            _mm256_mul_ps(cosi, _mm256_mul_ps(ca, Ia)),
            _mm256_mul_ps(spec, Ia)));
      }
      fr = clamp01_8(fr); fg = clamp01_8(fg);
      fb = clamp01_8(fb); fa = clamp01_8(fa);
    }

    // pack ARGB (projekt.cpp:490-493; cvtps rounds to nearest)
    __m256 s255 = _mm256_set1_ps(255.f);
    __m256i pa = _mm256_cvtps_epi32(_mm256_mul_ps(fa, s255));
    __m256i pr = _mm256_cvtps_epi32(_mm256_mul_ps(fr, s255));
    __m256i pg = _mm256_cvtps_epi32(_mm256_mul_ps(fg, s255));
    __m256i pb = _mm256_cvtps_epi32(_mm256_mul_ps(fb, s255));
    __m256i packed = _mm256_or_si256(
        _mm256_or_si256(_mm256_slli_epi32(pa, 24), _mm256_slli_epi32(pr, 16)),
        _mm256_or_si256(_mm256_slli_epi32(pg, 8), pb));

    // z-test + masked store (the reference's locked merge projekt.cpp:
    // 1372-1409 without the spinlock: rows are single-writer here)
    __m256 zold = _mm256_loadu_ps(zb + x);
    __m256 zmask = _mm256_and_ps(
        _mm256_cmp_ps(z, zold, _CMP_GT_OQ), nmask);
    __m256i zmask_i = _mm256_castps_si256(zmask);
    _mm256_maskstore_ps(zb + x, zmask_i, z);
    _mm256_maskstore_epi32((int*)(px + x), zmask_i, packed);
  }
}
#endif  // TR_HAVE_AVX2

// Span fill, scalar reference semantics (projekt.cpp:303-539): sequential
// attribute stepping, per-pixel normal renormalization in the Phong path.
void fill_span(const ObjectData& obj, const Transform& tr, const LightData& L,
               const Edge& Le, const Edge& Re, int row, uint32_t* color,
               float* depth, int W) {
  float xl = Le.x, xr = Re.x;
  float xd = roundf(xr - xl);
  float zinc = 0, ozinc = 0, uinc = 0, vinc = 0;
  V4 cinc{0, 0, 0, 0};
  V3 ninc{0, 0, 0};
  if (xd != 0.0f) {
    float inv = 1.0f / xd;
    zinc = (Re.z - Le.z) * inv;
    ozinc = (Re.oz - Le.oz) * inv;
    uinc = (Re.u - Le.u) * inv;
    vinc = (Re.v - Le.v) * inv;
    cinc = mul4(inv, add4(Re.col, mul4(-1.f, Le.col)));
    ninc = mul(inv, sub(Re.n, Le.n));
  }
  float xoff = xl < 0.f ? -xl : 0.f;
  float lx = xl < 0.f ? 0.f : (xl >= (float)W ? (float)W - 1.f : xl);
  float rx = xr < 0.f ? 0.f : (xr >= (float)W ? (float)W - 1.f : xr);
  int minx = std::min(round_s32(lx), W - 1);
  int maxx = std::min(round_s32(rx), W - 1);
  if (maxx < minx) return;

  float z = Le.z + xoff * zinc;
  float oz = Le.oz + xoff * ozinc;
  float u = Le.u + xoff * uinc;
  float v = Le.v + xoff * vinc;
  V4 col = add4(Le.col, mul4(xoff, cinc));
  V3 n = add(Le.n, mul(xoff, ninc));

  uint32_t* px = color + (size_t)row * W + minx;
  float* zb = depth + (size_t)row * W + minx;
  bool textured = obj.texture != nullptr;
  V4 white{1, 1, 1, 1};

  for (int x = minx; x <= maxx; ++x) {
    V4 cur = col;
    if (textured) {
      float inv_oz = 1.0f / oz;
      sample_texture(obj, inv_oz * u, inv_oz * v, &cur);
    }
    V4 final_color;
    if (obj.phong) {
      final_color = {0, 0, 0, 0};
      V3 pos = unproject_vertex((float)x, (float)row, z, tr);
      V3 view = normalize(mul(-1.f, pos));
      for (int k = 0; k < L.count; ++k) {
        if (k == 0) final_color = had4(cur, L.ambient);
        V3 to_light = normalize(sub(L.lights[k].p, pos));
        float cosi = clamp01(inner(n, to_light));
        V3 half = normalize(add(to_light, view));
        float spec = pow16(clamp01(inner(n, half)));
        final_color = add4(
            final_color,
            add4(mul4(cosi, had4(cur, L.lights[k].intensity)),
                 mul4(spec, had4(white, L.lights[k].intensity))));
      }
      final_color = clamp01_4(final_color);
    } else {
      final_color = cur;
    }
    uint32_t packed = pack_argb(final_color);
    if (z > *zb) {
      *zb = z;
      *px = packed;
    }
    ++px;
    ++zb;
    z += zinc;
    oz += ozinc;
    u += uinc;
    v += vinc;
    col = add4(col, cinc);
    if (obj.phong) n = normalize(add(n, ninc));  // projekt.cpp:504
  }
}

// Render all rows of one triangle owned by thread `tid` (row % nthreads).
// Faithful sequential edge walk: current edge values step by their gradients
// once per row (projekt.cpp:542-560), normals renormalized per row step.
void raster_triangle_rows(const ObjectData& obj, const Transform& tr,
                          const LightData& L, Edge edges[3], int n_edges,
                          uint32_t* color, float* depth, int H, int W,
                          int tid, int nthreads) {
  if (n_edges < 2) return;
  int row_lo = edges[0].ymin, row_hi = edges[0].ymax;
  for (int e = 1; e < n_edges; ++e) {
    row_lo = std::min(row_lo, edges[e].ymin);
    row_hi = std::max(row_hi, edges[e].ymax);
  }
  row_hi = std::min(row_hi, H);
  for (int row = row_lo; row < row_hi; ++row) {
    // active edges at this row, ordered by (x, gradient, left)
    int act[3], na = 0;
    for (int e = 0; e < n_edges; ++e)
      if (edges[e].ymin <= row && row < edges[e].ymax) act[na++] = e;
    if (na >= 2) {
      // insertion-sort the (at most 3) active edges
      for (int i = 1; i < na; ++i)
        for (int j = i; j > 0; --j) {
          const Edge& A = edges[act[j - 1]];
          const Edge& B = edges[act[j]];
          bool swap_it =
              (B.x < A.x) ||
              (B.x == A.x &&
               (B.xg < A.xg || (B.xg == A.xg && B.left < A.left)));
          if (swap_it) std::swap(act[j - 1], act[j]);
        }
      if (row % nthreads == tid && row >= 0) {
#if TR_HAVE_AVX2
        if (obj.use_avx)
          fill_span_avx(obj, tr, L, edges[act[0]], edges[act[1]], row,
                        color, depth, W);
        else
#endif
          fill_span(obj, tr, L, edges[act[0]], edges[act[1]], row, color,
                    depth, W);
      }
    }
    // step all active edges (projekt.cpp:542-560)
    for (int i = 0; i < na; ++i) {
      Edge& E = edges[act[i]];
      E.x += E.xg;
      E.z += E.zg;
      E.col = add4(E.col, E.colg);
      if (obj.phong) E.n = normalize(add(E.n, E.ng));  // cpp:551-552
      E.u += E.ug;
      E.v += E.vg;
      E.oz += E.ozg;
    }
  }
}

void render_object_thread(const ObjectData& obj, const Transform& tr,
                          const LightData& L, uint32_t* color, float* depth,
                          int H, int W, int tid, int nthreads) {
  int tri_count = obj.vertex_count / 3;
  Edge edges[3];
  for (int t = 0; t < tri_count; ++t) {
    int n = setup_triangle(obj, tr, L, t, edges);
    if (n >= 2)
      raster_triangle_rows(obj, tr, L, edges, n, color, depth, H, W, tid,
                           nthreads);
  }
}

}  // namespace

extern "C" {

int tr_native_version() { return 2; }  // v2: + filter_bilinear param

// Render one object over the shared color/depth buffers.
// transform5 = [distance_above_target, focal, meters_to_pixels, cx, cy]
// lights7 = light_count x [px, py, pz, Ir, Ig, Ib, Ia]
void tr_render_object(uint32_t* color, float* depth, int H, int W,
                      const float* verts, const float* colors,
                      const float* normals, const float* uvs,
                      int vertex_count, const float* obj_p,
                      const float* transform5, const float* ambient4,
                      int light_count, const float* lights7,
                      const uint32_t* texture, int tex_h, int tex_w,
                      int phong, int num_threads, int use_avx,
                      int filter_bilinear) {
  Transform tr{transform5[0], transform5[1], transform5[2], transform5[3],
               transform5[4]};
  std::vector<Light> lights(light_count);
  for (int k = 0; k < light_count; ++k) {
    lights[k].p = {lights7[7 * k], lights7[7 * k + 1], lights7[7 * k + 2]};
    lights[k].intensity = {lights7[7 * k + 3], lights7[7 * k + 4],
                           lights7[7 * k + 5], lights7[7 * k + 6]};
  }
  LightData L{{ambient4[0], ambient4[1], ambient4[2], ambient4[3]},
              lights.data(), light_count};
  bool avx = use_avx > 0;
#if !TR_HAVE_AVX2
  avx = false;
#endif
  if (use_avx < 0) avx = TR_HAVE_AVX2;  // auto
  ObjectData obj{verts,   colors, normals,
                 uvs,     vertex_count,
                 {obj_p[0], obj_p[1], obj_p[2]},
                 texture, tex_h,  tex_w,
                 phong != 0, avx, filter_bilinear != 0};

  int n = num_threads > 0
              ? num_threads
              : (int)std::max(1u, std::thread::hardware_concurrency());
  if (n == 1) {
    render_object_thread(obj, tr, L, color, depth, H, W, 0, 1);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n);
  for (int tid = 0; tid < n; ++tid)
    pool.emplace_back(render_object_thread, obj, tr, L, color, depth, H, W,
                      tid, n);
  for (auto& th : pool) th.join();
}

// Clear buffers to the renderer's conventions.
void tr_clear(uint32_t* color, float* depth, int H, int W,
              uint32_t clear_color) {
  for (size_t i = 0; i < (size_t)H * W; ++i) {
    color[i] = clear_color;
    depth[i] = kDepthClear;
  }
}

}  // extern "C"
