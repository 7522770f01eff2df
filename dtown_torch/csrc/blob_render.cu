// Blob-fed RGB render for Hopper (sm_90a): one thread per pixel.
//
// Replaces the Pallas TPU kernel dtown/render/blob_raster.py::
// _make_blob_kernel (launched by render_frames_from_blob) on its RGB,
// static-ray, no-randomization path. The plain version is
// dtown_torch/render/blob_raster.py::render_frames_reference; this file
// keeps its float32 operation order.
//
// What bounds it on the card: arithmetic. Each pixel runs the ground pass
// (ray-ground hit, tile lookup, analytic markings, hash noise) and, for
// the objects its env does not cull, a ray-primitive test per primitive;
// that is hundreds of float ops per pixel against 3 output bytes, far
// right of the H100's ~20 flop/byte ridge for float32 CUDA cores.
//
// Design:
//  * grid (B, ceil(H*W / 256)): a block belongs to one env, so the camera
//    basis, the per-object distance culls and the LOD gates are uniform
//    across the block and their branches never diverge. A culled object
//    is skipped whole; a culled primitive likewise. This replaces the TPU
//    kernel's pseudo-object lax.cond clusters and inf-folded masks with
//    plain branches that compute the same pixels.
//  * The static ray planes [5, H*W] (A, B, D, E, F) are inputs; per env a
//    ray is a yaw rotation of two planes. Reads are coalesced.
//  * The scene is not compiled into the kernel as on the TPU: the plan
//    arrives as flat float/int tables (objects, primitives) that every
//    thread walks in the same order, so one binary serves every map.
//  * The tile kind is one indexed word load instead of a select chain,
//    and tile ids use plain int multiplies.
//  * Ground color is computed in float32 and quantized once, like the
//    reference's float path. Output is u8 [B, 3, H*W], byte-identical to
//    the reference's [B, 3, S, 128] layout.
//  * Built with -fmad=false (see _build.py), so results match the plain
//    version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "sincos.cuh"
#include "tile_shading.cuh"

namespace {

constexpr int THREADS = 256;
// blob rows
constexpr int F_POS_X = 0, F_POS_Y = 1, F_POS_Z = 2, F_ANGLE = 3;
constexpr int F_STEP = 7;
// scene floats (blob_raster.py _SCENE_NAMES)
constexpr int S_CAMF = 0, S_CAMH = 1, S_TSINV = 2, S_KFW = 3, S_SHADE = 4;
constexpr int S_GR = 5, S_HR = 8, S_AMB = 11, S_KD = 12, S_LW = 13;
constexpr int S_DT = 16, S_INVTL = 17;
// object table (blob_raster.py O_*, OI_*)
constexpr int OBJ_F = 11, OBJ_I = 3;
constexpr int O_X = 0, O_Y = 1, O_Z = 2, O_SR = 3, O_CR = 4, O_INVS = 5;
constexpr int O_SC = 6, O_LMX = 7, O_LMY = 8, O_LMZ = 9, O_CULL2 = 10;
constexpr int OI_P0 = 0, OI_NP = 1, OI_BOX = 2;
// primitive table (P_*, PI_*)
constexpr int PRIM_F = 12, PRIM_I = 4;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_P0 = 3, P_P1 = 4, P_P2 = 5;
constexpr int P_CD2 = 6, P_CWX = 7, P_CWY = 8, P_CWZ = 9, P_RW2 = 10;
constexpr int P_NDV = 11;
constexpr int PI_BOX = 0, PI_LAMP = 1, PI_COLOR = 2, PI_OWN = 3;

struct Scene {
  const float* rays;   // [5, P]
  const int* words;
  const float* sc;     // scene floats
  const float* of;     // [n_objs, OBJ_F]
  const int* oi;       // [n_objs, OBJ_I]
  const float* pf;     // [n_prims, PRIM_F]
  const int* pi;       // [n_prims, PRIM_I]
  int P, n_words, Hg, Wg, n_objs;
  int aa, any_x, no_clamp, lamp_green, lamp_red;
};

__device__ __forceinline__ float safe_inv(float dm) {
  const float d = fabsf(dm) < 1e-9f ? (dm >= 0.0f ? 1e-9f : -1e-9f) : dm;
  return 1.0f / d;
}

__device__ __forceinline__ unsigned char to_u8(float x, bool no_clamp) {
  if (!no_clamp) x = fminf(fmaxf(x, 0.0f), 1.0f);
  return static_cast<unsigned char>(static_cast<int>(x * 255.0f + 0.5f));
}

__global__ void __launch_bounds__(THREADS)
blob_render_kernel(const float* __restrict__ blob, int B, Scene s,
                   unsigned char* __restrict__ out) {
  const int e = blockIdx.x;
  const int p = blockIdx.y * THREADS + threadIdx.x;
  if (p >= s.P) return;
  const float* sc = s.sc;
  auto SC = [&](int i) { return __ldg(sc + i); };

  // ---- per-env camera (uniform across the block) ------------------------
  const float px_s = __ldg(blob + F_POS_X * B + e);
  const float py_s = __ldg(blob + F_POS_Y * B + e);
  const float pz_s = __ldg(blob + F_POS_Z * B + e);
  const float ang_s = __ldg(blob + F_ANGLE * B + e);
  const float step_s = __ldg(blob + F_STEP * B + e);
  float s_a, c_a;
  dt_sincos(ang_s, &s_a, &c_a);
  const float camf = SC(S_CAMF);
  const float eye0 = px_s + camf * c_a;
  const float eye1 = py_s + SC(S_CAMH);
  const float eye2 = pz_s + camf * (-s_a);

  // ---- ray and ground hit --------------------------------------------------
  const float A = __ldg(s.rays + p);
  const float Bp = __ldg(s.rays + s.P + p);
  const float D = __ldg(s.rays + 2 * s.P + p);
  const float E = __ldg(s.rays + 3 * s.P + p);
  const float F = __ldg(s.rays + 4 * s.P + p);
  const bool gmask = D < -1e-6f;
  const float dx = c_a * A + s_a * Bp;
  const float dy = D;
  const float dz = c_a * Bp - s_a * A;
  const float t_g = eye1 * E;
  const bool aa = s.aa != 0;
  float inv_fw = 0.0f;
  if (aa) {
    const float k_fw = SC(S_KFW) / eye1;
    inv_fw = dy * dy * k_fw;
  }
  const float ts_inv = SC(S_TSINV);
  const float fx = (eye0 + t_g * dx) * ts_inv;
  const float fz = (eye2 + t_g * dz) * ts_inv;
  const float ti = floorf(fx);
  const float tj = floorf(fz);
  const bool in_grid = (ti >= 0.0f) & (ti < static_cast<float>(s.Wg))
                       & (tj >= 0.0f) & (tj < static_cast<float>(s.Hg))
                       & gmask;
  const int tid = static_cast<int>(tj) * s.Wg + static_cast<int>(ti);
  const int widx = tid >> 2;
  const int word = (widx >= 0 && widx < s.n_words) ? __ldg(s.words + widx)
                                                    : __ldg(s.words);
  const int byte = (word >> ((tid & 3) << 3)) & 0xFF;
  const int kind = byte & 0xF;
  const int angle_idx = (byte >> 4) & 0x3;
  float r, g, b;
  tile::shade_pixel(kind, angle_idx, 0, fx - ti, fz - tj, s.any_x != 0, aa,
                    inv_fw, &r, &g, &b);
  const float shade = SC(S_SHADE);
  r = (in_grid ? r : SC(S_GR)) * shade;
  g = (in_grid ? g : SC(S_GR + 1)) * shade;
  b = (in_grid ? b : SC(S_GR + 2)) * shade;
  const float skyf = 1.0f - 0.35f * fmaxf(D, 0.0f);
  if (!gmask) {
    r = SC(S_HR) * skyf;
    g = SC(S_HR + 1) * skyf;
    b = SC(S_HR + 2) * skyf;
  }

  // ---- object pass -----------------------------------------------------------
  if (s.n_objs > 0) {
    float t_best = gmask ? t_g : 1e30f;
    int pk = -1;
    float dv_best = 0.0f;
    const float t_env = step_s * SC(S_DT);
    const bool green = (static_cast<int>(floorf(t_env * SC(S_INVTL))) % 2)
                       > 0;
    const int lamp_pk = green ? s.lamp_green : s.lamp_red;
    const float lwx = SC(S_LW), lwy = SC(S_LW + 1), lwz = SC(S_LW + 2);
    const float dlw = dx * lwx + dy * lwy + dz * lwz;
    for (int o = 0; o < s.n_objs; ++o) {
      const float* ov = s.of + o * OBJ_F;
      const int* oiv = s.oi + o * OBJ_I;
      const float ox = __ldg(ov + O_X), oy = __ldg(ov + O_Y);
      const float oz = __ldg(ov + O_Z);
      const float dxo = ox - eye0;
      const float dzo = oz - eye2;
      const float dist2 = dxo * dxo + dzo * dzo;
      if (!(dist2 < __ldg(ov + O_CULL2))) continue;  // uniform: whole object
      const int p0 = __ldg(oiv + OI_P0);
      const int np = __ldg(oiv + OI_NP);
      float ey = 0.f, emx = 0.f, emz = 0.f, inv_dmx = 0.f, inv_dmz = 0.f;
      float wx = 0.f, wy = 0.f, wz = 0.f, osc = 0.f;
      if (__ldg(oiv + OI_BOX)) {
        const float inv_s = __ldg(ov + O_INVS);
        const float s_r = __ldg(ov + O_SR), c_r = __ldg(ov + O_CR);
        const float ex = (eye0 - ox) * inv_s;
        ey = (eye1 - oy) * inv_s;
        const float ez = (eye2 - oz) * inv_s;
        emx = ex * c_r + ez * s_r;
        emz = ez * c_r - ex * s_r;
        const float dmx = dx * c_r + dz * s_r;
        const float dmz = dz * c_r - dx * s_r;
        inv_dmx = safe_inv(dmx);
        inv_dmz = safe_inv(dmz);
        const float lmx = __ldg(ov + O_LMX), lmy = __ldg(ov + O_LMY);
        const float lmz = __ldg(ov + O_LMZ);
        wx = dmx >= 0.0f ? lmx : -lmx;
        wy = dy >= 0.0f ? lmy : -lmy;
        wz = dmz >= 0.0f ? lmz : -lmz;
        osc = __ldg(ov + O_SC);
      }
      for (int j = p0; j < p0 + np; ++j) {
        const float* pv = s.pf + j * PRIM_F;
        const int* piv = s.pi + j * PRIM_I;
        if (__ldg(piv + PI_OWN) && !(dist2 < __ldg(pv + P_CD2)))
          continue;  // LOD cull of this primitive (uniform)
        float t_w, dv;
        bool ok_p;
        if (__ldg(piv + PI_BOX)) {
          const float ocx = emx - __ldg(pv + P_CX);
          const float ocy = ey - __ldg(pv + P_CY);
          const float ocz = emz - __ldg(pv + P_CZ);
          const float q0 = __ldg(pv + P_P0), q1 = __ldg(pv + P_P1);
          const float q2 = __ldg(pv + P_P2);
          float t1 = (-q0 - ocx) * inv_dmx, t2 = (q0 - ocx) * inv_dmx;
          const float n1 = fminf(t1, t2), x1 = fmaxf(t1, t2);
          t1 = (-q1 - ocy) * F;
          t2 = (q1 - ocy) * F;
          const float n2 = fminf(t1, t2), x2 = fmaxf(t1, t2);
          t1 = (-q2 - ocz) * inv_dmz;
          t2 = (q2 - ocz) * inv_dmz;
          const float n3 = fminf(t1, t2), x3 = fmaxf(t1, t2);
          const float tmin = fmaxf(fmaxf(n1, n2), n3);
          const float tmax = fminf(fminf(x1, x2), x3);
          const float t_m = tmin > 1e-4f ? tmin : tmax;
          ok_p = (tmax >= tmin) & (tmax > 1e-4f);
          t_w = t_m * osc;
          const bool xb = (n1 >= n2) & (n1 >= n3);
          const bool yb = (n2 >= n3) & !xb;
          dv = xb ? wx : (yb ? wy : wz);
        } else {
          const float ocx = eye0 - __ldg(pv + P_CWX);
          const float ocy = eye1 - __ldg(pv + P_CWY);
          const float ocz = eye2 - __ldg(pv + P_CWZ);
          const float bq = ocx * dx + ocy * dy + ocz * dz;
          const float cq = ocx * ocx + ocy * ocy + ocz * ocz
                           - __ldg(pv + P_RW2);
          const float disc = bq * bq - cq;
          const float t_m = -bq - sqrtf(disc);  // NaN on a miss
          ok_p = t_m > 1e-4f;
          t_w = t_m;
          const float k1 = ocx * lwx + ocy * lwy + ocz * lwz;
          dv = (k1 + t_m * dlw) * __ldg(pv + P_NDV);
        }
        if (ok_p && t_w < t_best) {
          pk = __ldg(piv + PI_LAMP) ? lamp_pk : __ldg(piv + PI_COLOR);
          dv_best = dv;
          t_best = t_w;
        }
      }
    }
    if (pk >= 0) {
      const float shn = (SC(S_AMB) + SC(S_KD) * fmaxf(dv_best, 0.0f))
                        * DT_F(1.0 / 255.0);
      r = static_cast<float>((pk >> 16) & 255) * shn;
      g = static_cast<float>((pk >> 8) & 255) * shn;
      b = static_cast<float>(pk & 255) * shn;
    }
  }

  const bool no_clamp = s.no_clamp != 0;
  unsigned char* o = out + static_cast<size_t>(e) * 3 * s.P + p;
  o[0] = to_u8(r, no_clamp);
  o[s.P] = to_u8(g, no_clamp);
  o[2 * s.P] = to_u8(b, no_clamp);
}

}  // namespace

extern "C" int dtown_blob_render(const float* blob, const float* rays,
                                 const int* words, const float* scene,
                                 const float* of, const int* oi,
                                 const float* pf, const int* pi,
                                 unsigned char* out, int B, int P,
                                 int n_words, int Hg, int Wg, int n_objs,
                                 int aa, int any_x, int no_clamp,
                                 int lamp_green, int lamp_red,
                                 void* stream) {
  Scene s{rays, words, scene, of, oi, pf, pi, P, n_words, Hg, Wg, n_objs,
          aa, any_x, no_clamp, lamp_green, lamp_red};
  const dim3 grid(B, (P + THREADS - 1) / THREADS);
  blob_render_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(blob, B, s, out);
  return static_cast<int>(cudaGetLastError());
}
