// Ground-tile shading for the blob render kernel (device side).
//
// The same math as dtown_torch/render/tile_shading.py (_tile_masks,
// _noise_h16f, _shade_pixels), which follows the Pallas helpers of
// dtown/render/pallas_raster.py. One float32 operation order on both
// sides; constants are double literals rounded once to float (DT_F).
// Marking terms are computed only for the pixel's own tile kind.
#pragma once

#include <cstdint>

#include "sincos.cuh"

namespace tile {

constexpr int STRAIGHT = 1, CURVE_LEFT = 2, CURVE_RIGHT = 3;
constexpr int WAY3_LEFT = 4, WAY3_RIGHT = 5, WAY4 = 6, ASPHALT_K = 7;
constexpr int GRASS_K = 8, FLOOR_K = 9;

// marking geometry (render/shading.py)
#define T_HALF_W DT_F(0.025 / 2)
#define T_LINE_W DT_F(0.025)
#define T_EDGE_OFF DT_F(0.5 - 0.035)

struct Marks {
  float yellow, white;  // coverages (AA) or 0/1 (no AA)
  float bu, bv;         // in-tile coordinates in base orientation
};

// One marking band |d| < hw: box-filter coverage with the upper 1-clamp
// deferred (AA), or the hard compare.
__device__ __forceinline__ float line(float d, float hw, float cap,
                                      float inv_fw, bool aa) {
  if (aa) return fmaxf(fminf((hw - fabsf(d)) * inv_fw + 0.5f, cap), 0.0f);
  return fabsf(d) < hw ? 1.0f : 0.0f;
}

__device__ __forceinline__ bool dashed(float p) {
  float r = fmodf(p / DT_F(0.125), 1.0f);  // remainder, sign of divisor
  if (r != 0.0f && r < 0.0f) r = r + 1.0f;
  return r < 0.5f;
}

// gate(cov, b) and bor(a, b) of the reference: products and sums of
// coverages under AA; and/or of 0/1 values otherwise.
__device__ __forceinline__ float gate(float cov, bool b, bool aa) {
  if (aa) return cov * (b ? 1.0f : 0.0f);
  return (cov != 0.0f) & b ? 1.0f : 0.0f;
}

__device__ __forceinline__ float bor(float a, float b, bool aa) {
  if (aa) return a + b;
  return (a != 0.0f) | (b != 0.0f) ? 1.0f : 0.0f;
}

__device__ __forceinline__ Marks tile_masks(int kind, int angle_idx, float u,
                                            float v, bool any_x, bool aa,
                                            float inv_fw) {
  const float c = angle_idx == 0 ? 1.0f : (angle_idx == 2 ? -1.0f : 0.0f);
  const float s = angle_idx == 1 ? 1.0f : (angle_idx == 3 ? -1.0f : 0.0f);
  const float du = u - 0.5f;
  const float dv = v - 0.5f;
  Marks m;
  m.bu = du * c - dv * s + 0.5f;
  m.bv = dv * c + du * s + 0.5f;
  const float bu = m.bu, bv = m.bv;
  const float cap_l = aa ? T_LINE_W * inv_fw : 0.0f;
  const float cap_s = aa ? DT_F(2.0 * 0.02) * inv_fw : 0.0f;
  auto ln = [&](float d) { return line(d, T_HALF_W, cap_l, inv_fw, aa); };
  auto ln_s = [&](float d) { return line(d, DT_F(0.02), cap_s, inv_fw, aa); };
  auto edge_pair = [&](float x) { return ln(fabsf(x - 0.5f) - T_EDGE_OFF); };
  float yellow = 0.0f, white = 0.0f;
  if (kind == STRAIGHT) {
    yellow = gate(ln(bu - 0.5f), dashed(bv), aa);
    white = edge_pair(bu);
  } else if (kind == CURVE_LEFT || kind == CURVE_RIGHT) {
    const float ddx = bu - (kind == CURVE_LEFT ? 1.0f : 0.0f);
    const float ddz = bv - 0.0f;
    const float r = sqrtf(ddx * ddx + ddz * ddz);
    yellow = gate(ln(r - 0.5f),
                  dashed((r + (fabsf(ddz) - fabsf(ddx)))
                         * DT_F(0.78539816)), aa);
    white = edge_pair(r);
  } else if (kind >= WAY3_LEFT && kind <= WAY4) {
    const float zm_m = gate(ln(bu - 0.5f), bv < 0.5f, aa);
    const float zp_m = gate(ln(bu - 0.5f), bv >= 0.5f, aa);
    const float xm_m = gate(ln(bv - 0.5f), bu < 0.5f, aa);
    const float xp_m = gate(ln(bv - 0.5f), bu >= 0.5f, aa);
    const float zm_s = gate(ln_s(bv - DT_F(0.08)),
                            (bu > 0.5f) & (bu < DT_F(0.8)), aa);
    const float zp_s = gate(ln_s(bv - DT_F(0.92)),
                            (bu > DT_F(0.2)) & (bu < 0.5f), aa);
    const float xm_s = gate(ln_s(bu - DT_F(0.08)),
                            (bv > DT_F(0.2)) & (bv < 0.5f), aa);
    const float xp_s = gate(ln_s(bu - DT_F(0.92)),
                            (bv > 0.5f) & (bv < DT_F(0.8)), aa);
    const bool dash_uv = dashed(bu + bv);
    const float zz_m = bor(zm_m, zp_m, aa);
    const float zz_s = bor(zm_s, zp_s, aa);
    if (kind == WAY3_LEFT) {
      yellow = gate(bor(zz_m, xp_m, aa), dash_uv, aa);
      white = bor(zz_s, xp_s, aa);
    } else if (kind == WAY3_RIGHT) {
      yellow = gate(bor(zz_m, xm_m, aa), dash_uv, aa);
      white = bor(zz_s, xm_s, aa);
    } else {
      yellow = gate(bor(zz_m, bor(xm_m, xp_m, aa), aa), dash_uv, aa);
      white = bor(zz_s, bor(xm_s, xp_s, aa), aa);
    }
  }
  if (aa) {
    white = fminf(white, 1.0f);
    yellow = fminf(yellow, 1.0f);
    if (any_x) yellow = yellow * (1.0f - white);
  }
  m.yellow = yellow;
  m.white = white;
  return m;
}

// low 16 bits of the texel hash as float32 in [0, 65536)
__device__ __forceinline__ float noise_h16f(float bu, float bv, int kind,
                                            int variant) {
  const int tx = min(static_cast<int>(bu * 128.0f), 127);
  const int ty = min(static_cast<int>(bv * 128.0f), 127);
  uint32_t h = static_cast<uint32_t>(
      tx | (ty << 7) | ((variant + ((kind << 3) - kind)) << 14));
  h = h + (h << 10);
  h = h ^ static_cast<uint32_t>(static_cast<int32_t>(h) >> 6);
  h = h + (h << 3);
  h = h ^ static_cast<uint32_t>(static_cast<int32_t>(h) >> 11);
  h = h + (h << 15);
  h = h ^ static_cast<uint32_t>(static_cast<int32_t>(h) >> 7);
  return static_cast<float>(h & 0xFFFFu);
}

// tile color: base, markings, hash noise; texture variant 0..3 (the
// packed tile byte's top bits) with brightness 0.94 + 0.04 * variant,
// which is exactly 0.94f for variant 0
__device__ __forceinline__ void shade_pixel(int kind, int angle_idx,
                                            int variant, float u, float v,
                                            bool any_x, bool aa, float inv_fw,
                                            float* r, float* g, float* b) {
  const Marks m = tile_masks(kind, angle_idx, u, v, any_x, aa, inv_fw);
  const bool is_road = kind >= STRAIGHT && kind <= ASPHALT_K;
  const bool is_grass = kind == GRASS_K;
  const bool is_floor = kind == FLOOR_K;
  // ASPHALT, GRASS, FLOOR, EMPTY, YELLOW, WHITE (render/shading.py)
  const double base_c[4][3] = {{0.155, 0.155, 0.16}, {0.22, 0.46, 0.18},
                               {0.62, 0.60, 0.58}, {0.13, 0.28, 0.11}};
  const double yel[3] = {0.82, 0.68, 0.10};
  const double wht[3] = {0.88, 0.88, 0.88};
  float ch[3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    // constant indices after unrolling: every color folds to a literal
    const float base = is_road ? DT_F(base_c[0][ci])
                       : is_grass ? DT_F(base_c[1][ci])
                       : is_floor ? DT_F(base_c[2][ci])
                                  : DT_F(base_c[3][ci]);
    if (aa) {
      ch[ci] = base + m.yellow * DT_F(yel[ci] - base_c[0][ci])
               + m.white * DT_F(wht[ci] - base_c[0][ci]);
    } else {
      const float o = m.yellow != 0.0f ? DT_F(yel[ci]) : base;
      ch[ci] = m.white != 0.0f ? DT_F(wht[ci]) : o;
    }
  }
  const float n = noise_h16f(m.bu, m.bv, kind, variant) / 32768.0f - 1.0f;
  const float amp = is_grass ? DT_F(0.03) : (is_road ? DT_F(0.012)
                                                     : DT_F(0.015));
  const float noise = amp * n;
  const float bright = DT_F(0.94) + DT_F(0.04) * static_cast<float>(variant);
  *r = ch[0] * bright + noise;
  *g = ch[1] * bright + noise;
  *b = ch[2] * bright + noise;
}

}  // namespace tile
