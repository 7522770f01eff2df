// Blob-fed render for Hopper (sm_90a): one thread per pixel.
//
// Replaces the Pallas TPU kernel dtown/render/blob_raster.py::
// _make_blob_kernel (launched by render_frames_from_blob): RGB or one luma
// plane, static rays or (domain randomization) per-env rays, fisheye
// through the ray tables, static objects of spheres, boxes and (OBJ kinds
// at triangle fidelity) triangles, moving NPCs posed from the blob rows,
// optional objects gated by the env's visibility bits; one map or a stack
// of maps; any frame size with H*W % 128 == 0. The plain version is
// dtown_torch/render/blob_raster.py::render_frames_reference; this file
// keeps its float32 operation order.
//
// What bounds it on the card: arithmetic. Each pixel runs the ground pass
// (ray-ground hit, tile lookup, analytic markings, hash noise; under
// domain randomization also the ray's basis, normalization and divide and
// the texture-variant hash) and, for the objects its env does not cull, a
// ray-primitive test per primitive; that is hundreds of float ops per
// pixel against 1-3 output bytes, far right of the H100's ~20 flop/byte
// ridge for float32 CUDA cores.
//
// Design:
//  * grid (B, ceil(H*W / 256)): a block belongs to one env, so the camera
//    basis, the DR scalars, the per-object distance culls, the optional
//    bits, the NPC poses and the LOD gates are uniform across the block
//    and their branches never diverge. A culled object is skipped whole; a
//    culled primitive likewise. This replaces the TPU kernel's
//    pseudo-object lax.cond clusters and inf-folded masks with plain
//    branches that compute the same pixels; the moving NPCs keep the TPU
//    kernel's view half-plane cull.
//  * Without domain randomization the static ray planes [5, H*W] (A, B, D,
//    E, F; a sixth, the sky luma, under grayscale) are inputs; per env a
//    ray is a yaw rotation of two planes. Reads are coalesced. Under
//    domain randomization the input is the NDC table [2, H*W] that the
//    env's tan(fov/2) scales: the linear ramps (baked on the host in the
//    kernel's float32 operation order) or the fisheye lens table, so
//    fisheye needs no kernel of its own. The TPU kernel tiles frames of
//    more than 256 sublane rows (640x480) over a second grid axis to
//    bound its VMEM; here blockIdx.y already walks the pixel blocks.
//  * The scene is not compiled into the kernel as on the TPU: the plan
//    arrives as flat float/int tables (objects, primitives) that every
//    thread walks in the same order, so one binary serves every map.
//  * The mode flags (domain randomization, grayscale, moving NPCs, a stack
//    of maps, triangle primitives) are template parameters, so each path
//    keeps only its own registers (the static RGB path compiles as it did
//    before the other paths joined): 32 kernels.
//  * A triangle is a third primitive type beside box and sphere:
//    Moeller-Trumbore in the object's model space against the baked
//    v0/e1/e2, with the reference's operation order and its determinant
//    guard, and flat two-sided shading (the sign of n . d picks n . l).
//  * A stack of maps: each block reads its env's map row once, offsets its
//    word index by mid * npw (the stacked words are the members' segments)
//    and skips every object of another member with a block-uniform branch.
//    A skipped object never competes for the nearest hit; the TPU kernel
//    gates it by folding t * inf, whose finite predecessor let another
//    map's tall objects bleed into the sky. The stack is a fourth template
//    flag (sixteen kernels): as runtime arguments it raised the static RGB
//    kernel's registers from 48 to 56 and its time on one map by 8.8% on
//    an H100, so a single map compiles without it.
//  * The tile kind is one indexed word load instead of a select chain.
//  * Ground color is computed in float32 and quantized once, like the
//    reference's float path. Output is u8 [B, C, H*W], byte-identical to
//    the reference's [B, C, S, 128] layout.
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
constexpr int F_STEP = 7, F_MAPID = 26, F_NPC_BASE = 27, NPC_ROWS = 5;
// DR rows, relative to dr_base
constexpr int DR_FOV = 0, DR_CAMH = 1, DR_CAMA = 2, DR_CAMF = 3, DR_LX = 4;
constexpr int DR_AMB = 7, DR_GR = 8, DR_HR = 11, DR_TEXSEED = 14;
constexpr int DR_OBJVIS = 15;
// scene floats (blob_raster.py _SCENE_NAMES)
constexpr int S_CAMF = 0, S_CAMH = 1, S_TSINV = 2, S_KFW = 3, S_SHADE = 4;
constexpr int S_GR = 5, S_HR = 8, S_AMB = 11, S_KD = 12, S_LW = 13;
constexpr int S_DT = 16, S_INVTL = 17, S_ASPECT = 18, S_DEG = 19;
constexpr int S_HALFH = 20, S_LEMPTY = 21, S_LROAD = 22, S_LGRASS = 23;
constexpr int S_LFLOOR = 24, S_LY = 25, S_LW_ = 26, S_AOTHER = 27;
constexpr int S_AGRASS = 28, S_AROAD = 29, S_LOUT = 30, S_LGREEN = 31;
constexpr int S_LRED = 32;
// object table (blob_raster.py O_*, OI_*)
constexpr int OBJ_F = 12, OBJ_I = 8;
constexpr int O_X = 0, O_Y = 1, O_Z = 2, O_SR = 3, O_CR = 4, O_INVS = 5;
constexpr int O_SC = 6, O_LMX = 7, O_LMY = 8, O_LMZ = 9, O_CULL2 = 10;
constexpr int O_RV = 11;
constexpr int OI_P0 = 0, OI_NP = 1, OI_MODEL = 2, OI_NPC = 3, OI_OPT = 4;
constexpr int OI_WIG = 5, OI_PRED = 6, OI_MAP = 7;
// primitive table (P_*, PI_*)
// (a triangle: v0 in P_C*, e1 in P_P*, e2 in P_E2*, normal in P_N*)
constexpr int PRIM_F = 20, PRIM_I = 4;
constexpr int P_CX = 0, P_CY = 1, P_CZ = 2, P_P0 = 3, P_P1 = 4, P_P2 = 5;
constexpr int P_CD2 = 6, P_CWX = 7, P_CWY = 8, P_CWZ = 9, P_RW2 = 10;
constexpr int P_NDV = 11, P_LUMA = 12, P_E2X = 13, P_NX = 16, P_NDL = 19;
constexpr int PI_TYPE = 0, PI_LAMP = 1, PI_COLOR = 2, PI_OWN = 3;
constexpr int BOX_T = 1, TRI_T = 2;  // PI_TYPE values (0: sphere)

struct Scene {
  const float* rays;   // static planes [5 or 6, P]; under DR the NDC [2, P]
  const int* words;
  const float* sc;     // scene floats
  const float* of;     // [n_objs, OBJ_F]
  const int* oi;       // [n_objs, OBJ_I]
  const float* pf;     // [n_prims, PRIM_F]
  const int* pi;       // [n_prims, PRIM_I]
  int P, n_words, Hg, Wg, n_objs;
  int aa, any_x, no_clamp, lamp_green, lamp_red, drb;
  int n_maps, npw;     // a stack's member count and word segment
};

__device__ __forceinline__ float safe_inv(float dm) {
  const float d = fabsf(dm) < 1e-9f ? (dm >= 0.0f ? 1e-9f : -1e-9f) : dm;
  return 1.0f / d;
}

__device__ __forceinline__ unsigned char to_u8(float x, bool no_clamp) {
  if (!no_clamp) x = fminf(fmaxf(x, 0.0f), 1.0f);
  return static_cast<unsigned char>(static_cast<int>(x * 255.0f + 0.5f));
}

__device__ __forceinline__ uint32_t asr(uint32_t h, int k) {
  return static_cast<uint32_t>(static_cast<int32_t>(h) >> k);
}

// randomization.variant_hash: the texture variant (0..3) of a tile under
// an env's seed; wrapping + and << on uint32, >> arithmetic on int32
__device__ __forceinline__ int variant_hash(uint32_t tile, uint32_t seed) {
  uint32_t h = (tile ^ (seed << 13)) + seed;
  h = h + (h << 10);
  h = h ^ asr(h, 6);
  h = h + (h << 3);
  h = h ^ asr(h, 11);
  h = h + (h << 15);
  h = h ^ asr(h, 7);
  return static_cast<int>(h & 3u);
}

// luma of a ground texel before noise: the kind's base luma, then the
// marking terms (AA coverage deltas, else the marking lumas over the base)
__device__ __forceinline__ float luma_ground(const tile::Marks& m, int kind,
                                             const float* sc, bool aa) {
  const bool is_road = kind >= tile::STRAIGHT && kind <= tile::ASPHALT_K;
  float l = is_road ? __ldg(sc + S_LROAD)
            : kind == tile::GRASS_K ? __ldg(sc + S_LGRASS)
            : kind == tile::FLOOR_K ? __ldg(sc + S_LFLOOR)
                                    : __ldg(sc + S_LEMPTY);
  if (aa) {
    l = l + m.yellow * __ldg(sc + S_LY) + m.white * __ldg(sc + S_LW_);
  } else {
    if (m.yellow != 0.0f) l = __ldg(sc + S_LY);
    if (m.white != 0.0f) l = __ldg(sc + S_LW_);
  }
  return l;
}

__device__ __forceinline__ float noise_amp(int kind, const float* sc) {
  return kind >= tile::STRAIGHT && kind <= tile::ASPHALT_K
             ? __ldg(sc + S_AROAD)
             : (kind == tile::GRASS_K ? __ldg(sc + S_AGRASS)
                                      : __ldg(sc + S_AOTHER));
}

// DR, GRAY, NPC (the plan has moving NPCs), MULTI (a stack) and TRI (the
// plan has triangles) are compile-time: each combination compiles to its
// own kernel, so the static RGB path carries no register cost of the
// others
template <bool DR, bool GRAY, bool NPC, bool MULTI, bool TRI>
__global__ void __launch_bounds__(THREADS)
blob_render_kernel(const float* __restrict__ blob, int B, Scene s,
                   unsigned char* __restrict__ out) {
  const int e = blockIdx.x;
  const int p = blockIdx.y * THREADS + threadIdx.x;
  if (p >= s.P) return;
  const float* sc = s.sc;
  auto SC = [&](int i) { return __ldg(sc + i); };
  auto ROW = [&](int f) { return __ldg(blob + f * B + e); };
  constexpr bool dr = DR, gray = GRAY;
  const bool aa = s.aa != 0;

  // ---- per-env camera (uniform across the block) ------------------------
  const float px_s = ROW(F_POS_X);
  const float py_s = ROW(F_POS_Y);
  const float pz_s = ROW(F_POS_Z);
  const float ang_s = ROW(F_ANGLE);
  const float step_s = ROW(F_STEP);
  // the env's member of a stack (0 on one map)
  const int mid = MULTI ? static_cast<int>(ROW(F_MAPID)) : 0;
  float s_a, c_a;
  dt_sincos(ang_s, &s_a, &c_a);
  float camh, camf, lwx, lwy, lwz, amb, kd, shade, gr, gg, gb, hr, hg, hb;
  float tany = 0.f, tanx = 0.f, sp = 0.f, cp = 0.f;
  int seed = 0, visbits = 0;
  if (dr) {
    // per-env randomization scalars from the DR rows
    auto D = [&](int k) { return ROW(s.drb + k); };
    float s_h, c_h;
    dt_sincos(0.5f * D(DR_FOV) * SC(S_DEG), &s_h, &c_h);
    tany = s_h / c_h;
    tanx = tany * SC(S_ASPECT);
    dt_sincos(D(DR_CAMA) * SC(S_DEG), &sp, &cp);
    camh = D(DR_CAMH);
    camf = D(DR_CAMF);
    lwx = D(DR_LX);
    lwy = D(DR_LX + 1);
    lwz = D(DR_LX + 2);
    amb = D(DR_AMB);
    kd = 1.0f - amb;
    shade = amb + kd * fmaxf(-lwy, 0.0f);
    gr = D(DR_GR);
    gg = D(DR_GR + 1);
    gb = D(DR_GR + 2);
    hr = D(DR_HR);
    hg = D(DR_HR + 1);
    hb = D(DR_HR + 2);
    seed = static_cast<int>(D(DR_TEXSEED));
    visbits = static_cast<int>(D(DR_OBJVIS));
  } else {
    camh = SC(S_CAMH);
    camf = SC(S_CAMF);
    lwx = SC(S_LW);
    lwy = SC(S_LW + 1);
    lwz = SC(S_LW + 2);
    amb = SC(S_AMB);
    kd = SC(S_KD);
    shade = SC(S_SHADE);
    gr = SC(S_GR);
    gg = SC(S_GR + 1);
    gb = SC(S_GR + 2);
    hr = SC(S_HR);
    hg = SC(S_HR + 1);
    hb = SC(S_HR + 2);
  }
  const float eye0 = px_s + camf * c_a;
  const float eye1 = py_s + camh;
  const float eye2 = pz_s + camf * (-s_a);

  // ---- ray and ground hit --------------------------------------------------
  float dx, dy, dz, t_g, skyf, inv_dy, inv_fw = 0.0f;
  bool gmask;
  if (dr) {
    // per-pixel camera basis from the NDC table, normalization and
    // ground divide
    const float xn = __ldg(s.rays + p) * tanx;
    const float yn = __ldg(s.rays + s.P + p) * tany;
    const float fwd_x = cp * c_a, fwd_y = -sp, fwd_z = -cp * s_a;
    const float up_x = sp * c_a, up_y = cp, up_z = -sp * s_a;
    dx = fwd_x + xn * s_a + yn * up_x;
    dy = fwd_y + yn * up_y;
    dz = fwd_z + xn * c_a + yn * up_z;
    const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
    dx = dx * inv_n;
    dy = dy * inv_n;
    dz = dz * inv_n;
    gmask = dy < -1e-6f;
    t_g = gmask ? (-eye1) / dy : 1e30f;
    skyf = 1.0f - 0.35f * fmaxf(dy, 0.0f);
    inv_dy = safe_inv(dy);
    if (aa) {
      const float k_fw = SC(S_HALFH) / tany / SC(S_TSINV) / eye1;
      inv_fw = dy * dy * k_fw;
    }
  } else {
    const float A = __ldg(s.rays + p);
    const float Bp = __ldg(s.rays + s.P + p);
    const float D = __ldg(s.rays + 2 * s.P + p);
    const float E = __ldg(s.rays + 3 * s.P + p);
    dx = c_a * A + s_a * Bp;
    dy = D;
    dz = c_a * Bp - s_a * A;
    gmask = D < -1e-6f;
    t_g = eye1 * E;
    skyf = 1.0f - 0.35f * fmaxf(D, 0.0f);
    inv_dy = __ldg(s.rays + 4 * s.P + p);
    if (aa) {
      const float k_fw = SC(S_KFW) / eye1;
      inv_fw = dy * dy * k_fw;
    }
  }
  const float ts_inv = SC(S_TSINV);
  const float fx = (eye0 + t_g * dx) * ts_inv;
  const float fz = (eye2 + t_g * dz) * ts_inv;
  const float ti = floorf(fx);
  const float tj = floorf(fz);
  const bool in_grid = (ti >= 0.0f) & (ti < static_cast<float>(s.Wg))
                       & (tj >= 0.0f) & (tj < static_cast<float>(s.Hg))
                       & gmask;
  // wrapping int math: off-grid rays may be far outside (masked below)
  const int tid = static_cast<int>(
      static_cast<uint32_t>(static_cast<int>(tj))
          * static_cast<uint32_t>(s.Wg)
      + static_cast<uint32_t>(static_cast<int>(ti)));
  const int widx = MULTI ? mid * s.npw + (tid >> 2) : tid >> 2;
  const int word = (widx >= 0 && widx < s.n_words) ? __ldg(s.words + widx)
                                                    : __ldg(s.words);
  const int byte = (word >> ((tid & 3) << 3)) & 0xFF;
  const int kind = byte & 0xF;
  const int angle_idx = (byte >> 4) & 0x3;
  const int variant = dr ? variant_hash(static_cast<uint32_t>(tid),
                                        static_cast<uint32_t>(seed))
                         : 0;
  float r = 0.f, g = 0.f, b = 0.f, l = 0.f;
  if (gray) {
    const tile::Marks m = tile::tile_masks(kind, angle_idx, fx - ti, fz - tj,
                                           s.any_x != 0, aa, inv_fw);
    l = luma_ground(m, kind, sc, aa);
    const float nrm = tile::noise_h16f(m.bu, m.bv, kind, variant)
                      * DT_F(1.0 / 32768.0) - 1.0f;
    const float ampv = noise_amp(kind, sc);
    if (dr) {
      // luma-direct DR ground: brightness per texel, shade per env
      const float bright = DT_F(0.94) + DT_F(0.04)
                           * static_cast<float>(variant);
      l = l * bright + nrm * ampv;
      const float lg = 0.299f * gr + 0.587f * gg + 0.114f * gb;
      l = (in_grid ? l : lg) * shade;
      if (!gmask) l = (0.299f * hr + 0.587f * hg + 0.114f * hb) * skyf;
    } else {
      l = l + nrm * ampv;
      l = in_grid ? l : SC(S_LOUT);
      if (!gmask) l = __ldg(s.rays + 5 * s.P + p);
    }
  } else {
    tile::shade_pixel(kind, angle_idx, variant, fx - ti, fz - tj,
                      s.any_x != 0, aa, inv_fw, &r, &g, &b);
    r = (in_grid ? r : gr) * shade;
    g = (in_grid ? g : gg) * shade;
    b = (in_grid ? b : gb) * shade;
    if (!gmask) {
      r = hr * skyf;
      g = hg * skyf;
      b = hb * skyf;
    }
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
    const float lamp_l = green ? SC(S_LGREEN) : SC(S_LRED);
    const float dlw = dx * lwx + dy * lwy + dz * lwz;
    for (int o = 0; o < s.n_objs; ++o) {
      const float* ov = s.of + o * OBJ_F;
      const int* oiv = s.oi + o * OBJ_I;
      // another member's object: skipped whole (uniform across the block)
      if (MULTI && __ldg(oiv + OI_MAP) != mid) continue;
      const int npc = NPC ? __ldg(oiv + OI_NPC) : -1;
      float ox, oz, s_r, c_r;
      if (npc >= 0) {
        // moving NPC: pose from the blob's NPC rows
        const int nbase = F_NPC_BASE + NPC_ROWS * npc;
        ox = ROW(nbase);
        oz = ROW(nbase + 1);
        float a_npc = ROW(nbase + 2);
        if (__ldg(oiv + OI_WIG)) {
          float s_w, c_w;
          dt_sincos(DT_F(48.0) * t_env, &s_w, &c_w);
          a_npc = a_npc + DT_F(0.25) * s_w;
        }
        dt_sincos(-a_npc, &s_r, &c_r);
      } else {
        ox = __ldg(ov + O_X);
        oz = __ldg(ov + O_Z);
        s_r = __ldg(ov + O_SR);
        c_r = __ldg(ov + O_CR);
      }
      const float oy = __ldg(ov + O_Y);
      const float dxo = ox - eye0;
      const float dzo = oz - eye2;
      const float dist2 = dxo * dxo + dzo * dzo;
      // uniform culls of the whole object: distance, optional bit, the
      // NPC's view half-plane
      if (!(dist2 < __ldg(ov + O_CULL2))) continue;
      if (DR) {
        const int opt = __ldg(oiv + OI_OPT);
        if (opt >= 0 && !(((visbits >> opt) & 1) > 0)) continue;
      }
      if (NPC && __ldg(oiv + OI_PRED)
          && !(dxo * c_a - dzo * s_a > -__ldg(ov + O_RV)))
        continue;
      float lmx, lmy, lmz;
      if (npc >= 0 || dr) {
        // the per-env light in the object's model space
        lmx = lwx * c_r + lwz * s_r;
        lmy = lwy;
        lmz = lwz * c_r - lwx * s_r;
      } else {
        lmx = __ldg(ov + O_LMX);
        lmy = __ldg(ov + O_LMY);
        lmz = __ldg(ov + O_LMZ);
      }
      const int p0 = __ldg(oiv + OI_P0);
      const int np = __ldg(oiv + OI_NP);
      float ey = 0.f, emx = 0.f, emz = 0.f, inv_dmx = 0.f, inv_dmz = 0.f;
      float wx = 0.f, wy = 0.f, wz = 0.f, dmx = 0.f, dmz = 0.f;
      const float osc = __ldg(ov + O_SC);
      if (__ldg(oiv + OI_MODEL)) {
        // a box or triangle object: the rays in model space
        const float inv_s = __ldg(ov + O_INVS);
        const float ex = (eye0 - ox) * inv_s;
        ey = (eye1 - oy) * inv_s;
        const float ez = (eye2 - oz) * inv_s;
        emx = ex * c_r + ez * s_r;
        emz = ez * c_r - ex * s_r;
        dmx = dx * c_r + dz * s_r;
        dmz = dz * c_r - dx * s_r;
        inv_dmx = safe_inv(dmx);
        inv_dmz = safe_inv(dmz);
        wx = dmx >= 0.0f ? lmx : -lmx;
        wy = dy >= 0.0f ? lmy : -lmy;
        wz = dmz >= 0.0f ? lmz : -lmz;
      }
      for (int j = p0; j < p0 + np; ++j) {
        const float* pv = s.pf + j * PRIM_F;
        const int* piv = s.pi + j * PRIM_I;
        if (__ldg(piv + PI_OWN) && !(dist2 < __ldg(pv + P_CD2)))
          continue;  // LOD cull of this primitive (uniform)
        float t_w, dv;
        bool ok_p;
        const int ptype = __ldg(piv + PI_TYPE);
        if (TRI && ptype == TRI_T) {
          // Moeller-Trumbore in model space: the per-env tvec and qvec
          // against the baked v0, e1, e2
          const float e1x = __ldg(pv + P_P0), e1y = __ldg(pv + P_P1);
          const float e1z = __ldg(pv + P_P2);
          const float e2x = __ldg(pv + P_E2X), e2y = __ldg(pv + P_E2X + 1);
          const float e2z = __ldg(pv + P_E2X + 2);
          const float pvx = dy * e2z - dmz * e2y;
          const float pvy = dmz * e2x - dmx * e2z;
          const float pvz = dmx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          const bool ok_det = fabsf(det) > 1e-12f;
          const float inv_det = (ok_det ? 1.0f : 0.0f)
                                / (ok_det ? det : 1.0f);
          const float tvx = emx - __ldg(pv + P_CX);
          const float tvy = ey - __ldg(pv + P_CY);
          const float tvz = emz - __ldg(pv + P_CZ);
          const float u_b = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float v_b = (dmx * qvx + dy * qvy + dmz * qvz) * inv_det;
          const float t_m = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
          ok_p = (u_b >= 0.0f) & (v_b >= 0.0f) & (u_b + v_b <= 1.0f)
                 & (t_m > 1e-4f);
          t_w = t_m * osc;
          // flat two-sided shading
          const float nx = __ldg(pv + P_NX), ny = __ldg(pv + P_NX + 1);
          const float nz = __ldg(pv + P_NX + 2);
          const float ndl = dr ? nx * lmx + ny * lmy + nz * lmz
                               : __ldg(pv + P_NDL);
          const float nd = nx * dmx + ny * dy + nz * dmz;
          dv = nd > 0.0f ? ndl : -ndl;
        } else if (ptype == BOX_T) {
          const float ocx = emx - __ldg(pv + P_CX);
          const float ocy = ey - __ldg(pv + P_CY);
          const float ocz = emz - __ldg(pv + P_CZ);
          const float q0 = __ldg(pv + P_P0), q1 = __ldg(pv + P_P1);
          const float q2 = __ldg(pv + P_P2);
          float t1 = (-q0 - ocx) * inv_dmx, t2 = (q0 - ocx) * inv_dmx;
          const float n1 = fminf(t1, t2), x1 = fmaxf(t1, t2);
          t1 = (-q1 - ocy) * inv_dy;
          t2 = (q1 - ocy) * inv_dy;
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
          float cwx, cwz;
          if (npc >= 0) {
            // world centre of an NPC's sphere, in float32
            const float cx = __ldg(pv + P_CX), cz = __ldg(pv + P_CZ);
            cwx = ox + osc * (cx * c_r - cz * s_r);
            cwz = oz + osc * (cx * s_r + cz * c_r);
          } else {
            cwx = __ldg(pv + P_CWX);
            cwz = __ldg(pv + P_CWZ);
          }
          const float ocx = eye0 - cwx;
          const float ocy = eye1 - __ldg(pv + P_CWY);
          const float ocz = eye2 - cwz;
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
          if (gray) {
            const float sh = amb + kd * fmaxf(dv, 0.0f);
            l = (__ldg(piv + PI_LAMP) ? lamp_l : __ldg(pv + P_LUMA)) * sh;
          } else {
            pk = __ldg(piv + PI_LAMP) ? lamp_pk : __ldg(piv + PI_COLOR);
            dv_best = dv;
          }
          t_best = t_w;
        }
      }
    }
    if (pk >= 0) {
      const float shn = (amb + kd * fmaxf(dv_best, 0.0f))
                        * DT_F(1.0 / 255.0);
      r = static_cast<float>((pk >> 16) & 255) * shn;
      g = static_cast<float>((pk >> 8) & 255) * shn;
      b = static_cast<float>(pk & 255) * shn;
    }
  }

  const bool no_clamp = s.no_clamp != 0;
  if (gray) {
    out[static_cast<size_t>(e) * s.P + p] = to_u8(l, no_clamp);
  } else {
    unsigned char* o = out + static_cast<size_t>(e) * 3 * s.P + p;
    o[0] = to_u8(r, no_clamp);
    o[s.P] = to_u8(g, no_clamp);
    o[2 * s.P] = to_u8(b, no_clamp);
  }
}

// Launch the specialisation of the mode flags flags[0..4] (DR, GRAY, NPC,
// MULTI, TRI), picking one template argument at a time.
template <bool... F>
void launch(const bool* flags, dim3 grid, cudaStream_t st, const float* blob,
            int B, const Scene& s, unsigned char* out) {
  if constexpr (sizeof...(F) == 5) {
    blob_render_kernel<F...><<<grid, THREADS, 0, st>>>(blob, B, s, out);
  } else if (flags[sizeof...(F)]) {
    launch<F..., true>(flags, grid, st, blob, B, s, out);
  } else {
    launch<F..., false>(flags, grid, st, blob, B, s, out);
  }
}

}  // namespace

extern "C" int dtown_blob_render(const float* blob, const float* rays,
                                 const int* words, const float* scene,
                                 const float* of, const int* oi,
                                 const float* pf, const int* pi,
                                 unsigned char* out, int B, int H, int W,
                                 int n_words, int Hg, int Wg, int n_objs,
                                 int aa, int any_x, int no_clamp,
                                 int lamp_green, int lamp_red, int dr,
                                 int gray, int npc, int drb, int n_maps,
                                 int npw, int tri, void* stream) {
  const int P = H * W;
  Scene s{rays, words, scene, of, oi, pf, pi, P, n_words, Hg, Wg,
          n_objs, aa, any_x, no_clamp, lamp_green, lamp_red, drb, n_maps,
          npw};
  // grid.y = 1200 at 640x480, far below its limit of 65535
  const dim3 grid(B, (P + THREADS - 1) / THREADS);
  // dr, gray, npc (the plan has moving NPCs), a stack and triangles pick
  // the specialisation
  const bool flags[5] = {dr != 0, gray != 0, npc != 0, n_maps > 1, tri != 0};
  launch<>(flags, grid, static_cast<cudaStream_t>(stream), blob, B, s, out);
  return static_cast<int>(cudaGetLastError());
}
