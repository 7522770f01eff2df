// Blob-fed render for Hopper (sm_90a): a block per env and pixel chunk, a
// per-block scene prologue in shared memory, a bounding-sphere test per
// pixel and object, four pixels a thread.
//
// Replaces the Pallas TPU kernel dtown/render/blob_raster.py::
// _make_blob_kernel (defined at :574, launched by render_frames_from_blob
// at :1728): RGB or one luma plane, static rays or (domain randomization)
// per-env rays, fisheye through the ray tables, static objects of spheres,
// boxes and (OBJ kinds at triangle fidelity) triangles, moving NPCs posed
// from the blob rows, optional objects gated by the env's visibility bits;
// one map or a stack of maps; any frame size with H*W % 128 == 0. The
// plain version is dtown_torch/render/blob_raster.py::
// render_frames_reference; this file keeps its float32 operation order.
//
// What bounds it on the card: issued instructions, not bytes. Each pixel
// runs the ground pass (ray-ground hit, tile lookup, analytic markings,
// hash noise; under domain randomization also the ray's basis,
// normalization and divide and the texture-variant hash) and a ray test
// per primitive its env keeps: hundreds to thousands of scalar float32,
// integer and select instructions per pixel against 1-3 output bytes. There
// is no matrix product (no tensor cores, no wgmma) and the bytes are
// negligible (64x64 RGB at 4096 envs writes 50 MB), so the design removes
// instructions:
//
//  * A per-block prologue. Warp 0 evaluates every object's per-env culls
//    once (stack member, distance, optional bit, the NPC view half-plane
//    and the view cull below) and each primitive's LOD cull, and compacts
//    the kept objects and primitives in plan order (warp ballot and prefix
//    sum; the nearest-hit test t_w < t_best is strict, so the order decides
//    ties) into shared memory as float4 records with the per-env values
//    folded: a box's six slab offsets (-q - oc, q - oc), a sphere's centre
//    offset, c - b^2 term and light term, a triangle's tvec, qvec and t
//    numerator, an NPC's pose, wiggle and light rotation, the lamp colour
//    of the traffic-light phase, the object's bounding sphere. Each value
//    is computed by one thread with the same float32 operations in the same
//    order as the per-pixel code had (-fmad=false), so the bits are
//    unchanged. The env's tile words (its member's segment on a stack) and
//    the scene floats are staged beside them. One __syncthreads, then the
//    pixel loop walks the compacted list with no cull branch and no table
//    load.
//  * A bounding-sphere test per pixel and kept object: a ray that misses
//    the sphere around the object's position (its bounding radius and
//    VIEW_PAD, O_RB) from outside cannot hit any of its primitives, so the
//    object's model-space ray and primitive tests are skipped: most rays
//    miss most of the env's kept objects.
//  * A block renders a chunk of one env's frame: the whole 64x64 frame, or
//    up to 4096 pixels of a larger one, so the prologue is paid once per
//    thousands of pixels; frames are split into smaller chunks while the
//    grid would hold fewer than about four waves of blocks on 132 SMs.
//  * Four consecutive pixels a thread, one after another, each output
//    plane written as one 32-bit word of four packed bytes. The ray planes
//    are read with scalar loads (the thread's later pixels hit in L1): as
//    float4 they held 20 registers across the object loop and were no
//    faster on an H100.
//  * A conservative view cull of every object (pack_plan's ``view_cull``
//    flag, the TPU kernel's behind-the-camera cluster skip in this form): an
//    object whose bounding circle lies wholly behind the camera's flat
//    forward half-plane is skipped. pack_plan turns it on only when every
//    ray of the frame (every DR draw included) has a positive horizontal
//    forward component; then a hit at t > 1e-4 lies in front of that plane
//    and the object cannot be hit, so no pixel changes.
//  * The mode flags (domain randomization, grayscale, moving NPCs, a stack
//    of maps, triangle primitives) are template parameters: each path
//    keeps only its own registers; 32 kernels.
//  * The camera is recomputed by every thread (per-env uniform work, once
//    per 4-16 pixels); the scene floats arrive as a device table (the
//    entry point's interface), read once a block into shared memory.
//  * Ground color is computed in float32 and quantized once, like the
//    reference's float path. Output is u8 [B, C, H*W], byte-identical to
//    the reference's [B, C, S, 128] layout. Built with -fmad=false (see
//    _build.py), so results match the plain version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "sincos.cuh"
#include "tile_shading.cuh"

namespace {

constexpr int THREADS = 128;          // four warps
constexpr int PIX = 4;                // consecutive pixels a thread
constexpr int PASS = THREADS * PIX;   // pixels a block renders a pass
constexpr int MAX_CHUNK = 4096;       // pixels a block renders at most
constexpr int MIN_BLOCKS = 8 * 4 * 132;  // ~8 waves of ~4 blocks an SM
constexpr int MAX_STAGED_WORDS = 2048;   // tile words staged (8 KB)
constexpr unsigned FULL = 0xffffffffu;
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
constexpr int S_LRED = 32, S_VIEW = 33, N_SCENE = 34, SCENE_PAD = 36;
// object table (blob_raster.py O_*, OI_*)
constexpr int OBJ_F = 13, OBJ_I = 8;
constexpr int O_X = 0, O_Y = 1, O_Z = 2, O_SR = 3, O_CR = 4, O_INVS = 5;
constexpr int O_SC = 6, O_LMX = 7, O_LMY = 8, O_LMZ = 9, O_CULL2 = 10;
constexpr int O_RV = 11, O_RB = 12;
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
// primitives an object holds at most (blob_raster.py MAX_OBJ_PRIMS,
// KERNEL_TRI_BUDGET): the capacity of the compacted list
constexpr int OBJ_PRIMS = 4, TRI_PRIMS = 8;

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
  int chunk;           // pixels a block renders
  int n_staged;        // tile words staged in shared memory (0: none)
};

// Shared-memory layout of the prologue's output (dynamic shared memory):
// objects [cap_o] x 3 float4, primitives [cap_p] x NQ float4 (NQ = 2, or 5
// with triangles), the scene floats, the staged tile words.
//   object:    a = (c_r, s_r, osc, model),  b = (lmx, lmy, lmz, prim end),
//              c = (centre - eye, |centre - eye|^2 - r^2)
//   box:       q0 = (lo_x, hi_x, lo_y, type), q1 = (hi_y, lo_z, hi_z, col)
//   sphere:    q0 = (ocx, ocy, ocz, type),    q1 = (cq, k1, ndv, col)
//   triangle:  q0 = (e1, type), q1 = (e2, col), q2 = (tvec, n . l),
//              q3 = (qvec, e2 . qvec), q4 = (n, 0)
// col is the packed RGB colour (int bits) or, in grayscale, the luma.
__host__ __device__ constexpr int n_q(bool tri) { return tri ? 5 : 2; }
__host__ __device__ inline int prim_cap(int n_objs, bool tri) {
  return n_objs * (tri ? TRI_PRIMS : OBJ_PRIMS);
}
__host__ inline size_t smem_bytes(int n_objs, bool tri, int n_staged) {
  return sizeof(float4) * (3 * static_cast<size_t>(n_objs)
                           + n_q(tri) * static_cast<size_t>(
                               prim_cap(n_objs, tri)))
         + sizeof(float) * SCENE_PAD + sizeof(int) * n_staged;
}

__device__ __forceinline__ float safe_inv(float dm) {
  const float d = fabsf(dm) < 1e-9f ? (dm >= 0.0f ? 1e-9f : -1e-9f) : dm;
  return 1.0f / d;
}

__device__ __forceinline__ uint32_t to_u8(float x, bool no_clamp) {
  if (!no_clamp) x = fminf(fmaxf(x, 0.0f), 1.0f);
  return static_cast<uint32_t>(static_cast<int>(x * 255.0f + 0.5f)) & 0xFFu;
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
  float l = is_road ? sc[S_LROAD]
            : kind == tile::GRASS_K ? sc[S_LGRASS]
            : kind == tile::FLOOR_K ? sc[S_LFLOOR]
                                    : sc[S_LEMPTY];
  if (aa) {
    l = l + m.yellow * sc[S_LY] + m.white * sc[S_LW_];
  } else {
    if (m.yellow != 0.0f) l = sc[S_LY];
    if (m.white != 0.0f) l = sc[S_LW_];
  }
  return l;
}

__device__ __forceinline__ float noise_amp(int kind, const float* sc) {
  return kind >= tile::STRAIGHT && kind <= tile::ASPHALT_K
             ? sc[S_AROAD]
             : (kind == tile::GRASS_K ? sc[S_AGRASS] : sc[S_AOTHER]);
}

// Resident blocks an SM is asked to hold (__launch_bounds__): 6 caps a
// thread at 85 registers, which every specialisation fits without spill
// but RGB under domain randomization with triangles, which gets 5 (102).
// Without a minimum, ptxas kept fewer registers and spilled in most of
// the 32 specialisations; the minimum costs a little speed on an H100 and
// is kept so that none spills.
__host__ __device__ constexpr int min_blocks(bool dr, bool gray, bool tri) {
  return dr && !gray && tri ? 5 : 6;
}

// DR, GRAY, NPC (the plan has moving NPCs), MULTI (a stack) and TRI (the
// plan has triangles) are compile-time: each combination compiles to its
// own kernel, so the static RGB path carries no register cost of the
// others
template <bool DR, bool GRAY, bool NPC, bool MULTI, bool TRI>
__global__ void __launch_bounds__(THREADS, min_blocks(DR, GRAY, TRI))
blob_render_kernel(const float* __restrict__ blob, int B, Scene s,
                   unsigned char* __restrict__ out) {
  extern __shared__ float4 smem[];
  __shared__ int s_kept;   // the compacted objects' count
  const int e = blockIdx.x;
  const int tx = threadIdx.x;
  const int cap_o = s.n_objs;
  const int cap_p = prim_cap(s.n_objs, TRI);
  float4* s_oa = smem;
  float4* s_ob = s_oa + cap_o;
  float4* s_oc = s_ob + cap_o;
  float4* s_q = s_oc + cap_o;           // [n_q(TRI)][cap_p]
  float* s_sc = reinterpret_cast<float*>(s_q + n_q(TRI) * cap_p);
  int* s_words = reinterpret_cast<int*>(s_sc + SCENE_PAD);
  auto ROW = [&](int f) { return __ldg(blob + f * B + e); };
  auto SC = [&](int i) { return __ldg(s.sc + i); };
  constexpr bool dr = DR, gray = GRAY;
  const bool aa = s.aa != 0;

  // ---- per-env camera (uniform across the block) ------------------------
  const float px_s = ROW(F_POS_X);
  const float py_s = ROW(F_POS_Y);
  const float pz_s = ROW(F_POS_Z);
  const float ang_s = ROW(F_ANGLE);
  // the env's member of a stack (0 on one map)
  const int mid = MULTI ? static_cast<int>(ROW(F_MAPID)) : 0;
  if (tx < N_SCENE) s_sc[tx] = SC(tx);
  for (int i = tx; i < s.n_staged; i += THREADS)
    s_words[i] = __ldg(s.words + (MULTI ? mid * s.npw : 0) + i);
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

  // ---- prologue: the env's kept objects and primitives, compacted ------
  if (tx < 32) {
    const int lane = tx;
    const bool view = SC(S_VIEW) != 0.0f;
    const float t_env = ROW(F_STEP) * SC(S_DT);
    const bool green = (static_cast<int>(floorf(t_env * SC(S_INVTL))) % 2)
                       > 0;
    const int lamp_pk = green ? s.lamp_green : s.lamp_red;
    const float lamp_l = green ? SC(S_LGREEN) : SC(S_LRED);
    int n_kept = 0, n_prim = 0;  // running totals (uniform in the warp)
    for (int o0 = 0; o0 < s.n_objs; o0 += 32) {
      const int o = o0 + lane;
      const float* ov = s.of + o * OBJ_F;
      const int* oiv = s.oi + o * OBJ_I;
      bool keep = o < s.n_objs;
      // another member's object is skipped whole
      if (MULTI && keep) keep = __ldg(oiv + OI_MAP) == mid;
      const int npc = NPC && keep ? __ldg(oiv + OI_NPC) : -1;
      float ox = 0.f, oz = 0.f, s_r = 0.f, c_r = 0.f, dist2 = 0.f;
      int p0 = 0, np = 0, np_keep = 0;
      if (keep) {
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
        const float dxo = ox - eye0;
        const float dzo = oz - eye2;
        dist2 = dxo * dxo + dzo * dzo;
        // the object's culls: distance, optional bit, the NPC's view
        // half-plane, and (view) the view cull of every object
        keep = dist2 < __ldg(ov + O_CULL2);
        if (DR) {
          const int opt = __ldg(oiv + OI_OPT);
          if (opt >= 0 && !(((visbits >> opt) & 1) > 0)) keep = false;
        }
        const float fwd = dxo * c_a - dzo * s_a;
        if (NPC && __ldg(oiv + OI_PRED) && !(fwd > -__ldg(ov + O_RV)))
          keep = false;
        if (view && !(fwd > -__ldg(ov + O_RB))) keep = false;
        p0 = __ldg(oiv + OI_P0);
        np = __ldg(oiv + OI_NP);
        // LOD cull of each primitive; an object left without one goes
        for (int j = p0; keep && j < p0 + np; ++j)
          np_keep += !(__ldg(s.pi + j * PRIM_I + PI_OWN)
                       && !(dist2 < __ldg(s.pf + j * PRIM_F + P_CD2)));
        keep = keep && np_keep > 0;
      }
      if (!keep) np_keep = 0;
      // compaction in plan order: the object's rank among the kept ones,
      // its primitives' offset (inclusive prefix sum over the lanes)
      const unsigned ball = __ballot_sync(FULL, keep);
      const int rank = __popc(ball & ((1u << lane) - 1u));
      int incl = np_keep;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      if (keep) {
        const int ko = n_kept + rank;
        int k = n_prim + incl - np_keep;
        const float oy = __ldg(ov + O_Y);
        const float osc = __ldg(ov + O_SC);
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
        const int model = __ldg(oiv + OI_MODEL);
        float ey = 0.f, emx = 0.f, emz = 0.f;
        if (model) {
          // a box or triangle object: the eye in model space
          const float inv_s = __ldg(ov + O_INVS);
          const float ex = (eye0 - ox) * inv_s;
          ey = (eye1 - oy) * inv_s;
          const float ez = (eye2 - oz) * inv_s;
          emx = ex * c_r + ez * s_r;
          emz = ez * c_r - ex * s_r;
        }
        s_oa[ko] = make_float4(c_r, s_r, osc, __int_as_float(model));
        s_ob[ko] = make_float4(lmx, lmy, lmz, __int_as_float(k + np_keep));
        // the bounding sphere's centre from the eye and |oc|^2 - r^2
        const float bx = ox - eye0, by = oy - eye1, bz = oz - eye2;
        const float rb = __ldg(ov + O_RB);
        s_oc[ko] = make_float4(bx, by, bz,
                               bx * bx + by * by + bz * bz - rb * rb);
        for (int j = p0; j < p0 + np; ++j) {
          const float* pv = s.pf + j * PRIM_F;
          const int* piv = s.pi + j * PRIM_I;
          if (__ldg(piv + PI_OWN) && !(dist2 < __ldg(pv + P_CD2)))
            continue;  // LOD cull of this primitive
          const int ptype = __ldg(piv + PI_TYPE);
          const float col =
              gray ? (__ldg(piv + PI_LAMP) ? lamp_l : __ldg(pv + P_LUMA))
                   : __int_as_float(__ldg(piv + PI_LAMP)
                                        ? lamp_pk : __ldg(piv + PI_COLOR));
          const float tyf = __int_as_float(ptype);
          float4* q = s_q + k;
          if (TRI && ptype == TRI_T) {
            // Moeller-Trumbore's per-env half: tvec, qvec, e2 . qvec
            const float e1x = __ldg(pv + P_P0), e1y = __ldg(pv + P_P1);
            const float e1z = __ldg(pv + P_P2);
            const float e2x = __ldg(pv + P_E2X), e2y = __ldg(pv + P_E2X + 1);
            const float e2z = __ldg(pv + P_E2X + 2);
            const float tvx = emx - __ldg(pv + P_CX);
            const float tvy = ey - __ldg(pv + P_CY);
            const float tvz = emz - __ldg(pv + P_CZ);
            const float qvx = tvy * e1z - tvz * e1y;
            const float qvy = tvz * e1x - tvx * e1z;
            const float qvz = tvx * e1y - tvy * e1x;
            const float tnum = e2x * qvx + e2y * qvy + e2z * qvz;
            const float nx = __ldg(pv + P_NX), ny = __ldg(pv + P_NX + 1);
            const float nz = __ldg(pv + P_NX + 2);
            const float ndl = dr ? nx * lmx + ny * lmy + nz * lmz
                                 : __ldg(pv + P_NDL);
            q[0] = make_float4(e1x, e1y, e1z, tyf);
            q[cap_p] = make_float4(e2x, e2y, e2z, col);
            q[2 * cap_p] = make_float4(tvx, tvy, tvz, ndl);
            q[3 * cap_p] = make_float4(qvx, qvy, qvz, tnum);
            q[4 * cap_p] = make_float4(nx, ny, nz, 0.0f);
          } else if (ptype == BOX_T) {
            // the slab offsets -q - oc and q - oc of each axis
            const float ocx = emx - __ldg(pv + P_CX);
            const float ocy = ey - __ldg(pv + P_CY);
            const float ocz = emz - __ldg(pv + P_CZ);
            const float q0 = __ldg(pv + P_P0), q1 = __ldg(pv + P_P1);
            const float q2 = __ldg(pv + P_P2);
            q[0] = make_float4(-q0 - ocx, q0 - ocx, -q1 - ocy, tyf);
            q[cap_p] = make_float4(q1 - ocy, -q2 - ocz, q2 - ocz, col);
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
            const float cq = ocx * ocx + ocy * ocy + ocz * ocz
                             - __ldg(pv + P_RW2);
            const float k1 = ocx * lwx + ocy * lwy + ocz * lwz;
            q[0] = make_float4(ocx, ocy, ocz, tyf);
            q[cap_p] = make_float4(cq, k1, __ldg(pv + P_NDV), col);
          }
          ++k;
        }
      }
      n_kept += __popc(ball);
      n_prim += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) s_kept = n_kept;
  }
  __syncthreads();
  const int n_kept = s_kept;

  // ---- per-env terms of the pixel pass ----------------------------------
  const float ts_inv = s_sc[S_TSINV];
  float k_fw = 0.0f;
  if (aa) k_fw = dr ? s_sc[S_HALFH] / tany / ts_inv / eye1
                    : s_sc[S_KFW] / eye1;
  const bool no_clamp = s.no_clamp != 0;
  const int P = s.P;
  const int cy = static_cast<int>(blockIdx.y);
  const int c1 = min((cy + 1) * s.chunk, P);
  unsigned char* out_e = out + static_cast<size_t>(e) * (gray ? 1 : 3) * P;

  for (int p = cy * s.chunk + tx * PIX; p < c1; p += PASS) {
    uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
#pragma unroll 1
    for (int k = 0; k < PIX; ++k) {
      // ---- ray and ground hit ---------------------------------------------
      // (scalar loads: the thread's later pixels hit in L1)
      const float* ray = s.rays + p + k;
      float dx, dy, dz, t_g, skyf, inv_dy, inv_fw = 0.0f;
      bool gmask;
      if (dr) {
        // per-pixel camera basis from the NDC table, normalization and
        // ground divide
        const float xn = __ldg(ray) * tanx;
        const float yn = __ldg(ray + P) * tany;
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
      } else {
        const float A = __ldg(ray), Bp = __ldg(ray + P);
        const float D = __ldg(ray + 2 * P);
        dx = c_a * A + s_a * Bp;
        dy = D;
        dz = c_a * Bp - s_a * A;
        gmask = D < -1e-6f;
        t_g = eye1 * __ldg(ray + 3 * P);
        skyf = 1.0f - 0.35f * fmaxf(D, 0.0f);
        inv_dy = __ldg(ray + 4 * P);
      }
      if (aa) inv_fw = dy * dy * k_fw;
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
      // an in-grid tile's word lies in the env's segment; an off-grid
      // pixel's word is masked below
      int word;
      if (s.n_staged) {
        const int widx = tid >> 2;
        word = s_words[(widx >= 0 && widx < s.n_staged) ? widx : 0];
      } else {
        const int widx = MULTI ? mid * s.npw + (tid >> 2) : tid >> 2;
        word = (widx >= 0 && widx < s.n_words) ? __ldg(s.words + widx)
                                               : __ldg(s.words);
      }
      const int byte = (word >> ((tid & 3) << 3)) & 0xFF;
      const int kind = byte & 0xF;
      const int angle_idx = (byte >> 4) & 0x3;
      const int variant = dr ? variant_hash(static_cast<uint32_t>(tid),
                                            static_cast<uint32_t>(seed))
                             : 0;
      float r = 0.f, g = 0.f, b = 0.f, l = 0.f;
      if (gray) {
        const tile::Marks m = tile::tile_masks(kind, angle_idx, fx - ti,
                                               fz - tj, s.any_x != 0, aa,
                                               inv_fw);
        l = luma_ground(m, kind, s_sc, aa);
        const float nrm = tile::noise_h16f(m.bu, m.bv, kind, variant)
                          * DT_F(1.0 / 32768.0) - 1.0f;
        const float ampv = noise_amp(kind, s_sc);
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
          l = in_grid ? l : s_sc[S_LOUT];
          if (!gmask) l = __ldg(ray + 5 * P);
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

      // ---- object pass over the compacted list -----------------------------
      if (n_kept > 0) {
        float t_best = gmask ? t_g : 1e30f;
        int pk = -1;
        float dv_best = 0.0f;
        const float dlw = dx * lwx + dy * lwy + dz * lwz;
        int j = 0;
        for (int o = 0; o < n_kept; ++o) {
          const float4 oa = s_oa[o];
          const float4 ob = s_ob[o];
          const int j_end = __float_as_int(ob.w);
          // the ray misses the object's bounding sphere (from outside):
          // none of its primitives can be hit
          const float4 oc = s_oc[o];
          const float bq = oc.x * dx + oc.y * dy + oc.z * dz;
          if (oc.w > 0.0f && (bq < 0.0f || bq * bq < oc.w)) {
            j = j_end;
            continue;
          }
          float inv_dmx = 0.f, inv_dmz = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
          float dmx = 0.f, dmz = 0.f;
          if (__float_as_int(oa.w)) {
            // a box or triangle object: the ray in model space
            const float c_r = oa.x, s_r = oa.y;
            dmx = dx * c_r + dz * s_r;
            dmz = dz * c_r - dx * s_r;
            inv_dmx = safe_inv(dmx);
            inv_dmz = safe_inv(dmz);
            wx = dmx >= 0.0f ? ob.x : -ob.x;
            wy = dy >= 0.0f ? ob.y : -ob.y;
            wz = dmz >= 0.0f ? ob.z : -ob.z;
          }
          for (; j < j_end; ++j) {
            const float4 q0 = s_q[j];
            const float4 q1 = s_q[cap_p + j];
            const int ptype = __float_as_int(q0.w);
            float t_w, dv;
            bool ok_p;
            if (TRI && ptype == TRI_T) {
              // Moeller-Trumbore in model space against the kept
              // triangle's e1, e2 and its per-env tvec and qvec
              const float4 q2 = s_q[2 * cap_p + j];
              const float4 q3 = s_q[3 * cap_p + j];
              const float4 q4 = s_q[4 * cap_p + j];
              const float pvx = dy * q1.z - dmz * q1.y;
              const float pvy = dmz * q1.x - dmx * q1.z;
              const float pvz = dmx * q1.y - dy * q1.x;
              const float det = q0.x * pvx + q0.y * pvy + q0.z * pvz;
              const bool ok_det = fabsf(det) > 1e-12f;
              const float inv_det = (ok_det ? 1.0f : 0.0f)
                                    / (ok_det ? det : 1.0f);
              const float u_b = (q2.x * pvx + q2.y * pvy + q2.z * pvz)
                                * inv_det;
              const float v_b = (dmx * q3.x + dy * q3.y + dmz * q3.z)
                                * inv_det;
              const float t_m = q3.w * inv_det;
              ok_p = (u_b >= 0.0f) & (v_b >= 0.0f) & (u_b + v_b <= 1.0f)
                     & (t_m > 1e-4f);
              t_w = t_m * oa.z;
              // flat two-sided shading
              const float nd = q4.x * dmx + q4.y * dy + q4.z * dmz;
              dv = nd > 0.0f ? q2.w : -q2.w;
            } else if (ptype == BOX_T) {
              float t1 = q0.x * inv_dmx, t2 = q0.y * inv_dmx;
              const float n1 = fminf(t1, t2), x1 = fmaxf(t1, t2);
              t1 = q0.z * inv_dy;
              t2 = q1.x * inv_dy;
              const float n2 = fminf(t1, t2), x2 = fmaxf(t1, t2);
              t1 = q1.y * inv_dmz;
              t2 = q1.z * inv_dmz;
              const float n3 = fminf(t1, t2), x3 = fmaxf(t1, t2);
              const float tmin = fmaxf(fmaxf(n1, n2), n3);
              const float tmax = fminf(fminf(x1, x2), x3);
              const float t_m = tmin > 1e-4f ? tmin : tmax;
              ok_p = (tmax >= tmin) & (tmax > 1e-4f);
              t_w = t_m * oa.z;
              const bool xb = (n1 >= n2) & (n1 >= n3);
              const bool yb = (n2 >= n3) & !xb;
              dv = xb ? wx : (yb ? wy : wz);
            } else {
              const float bq = q0.x * dx + q0.y * dy + q0.z * dz;
              const float disc = bq * bq - q1.x;
              const float t_m = -bq - sqrtf(disc);  // NaN on a miss
              ok_p = t_m > 1e-4f;
              t_w = t_m;
              dv = (q1.y + t_m * dlw) * q1.z;
            }
            if (ok_p && t_w < t_best) {
              if (gray) {
                const float sh = amb + kd * fmaxf(dv, 0.0f);
                l = q1.w * sh;
              } else {
                pk = __float_as_int(q1.w);
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

      const int sh8 = 8 * k;
      if (gray) {
        w0 |= to_u8(l, no_clamp) << sh8;
      } else {
        w0 |= to_u8(r, no_clamp) << sh8;
        w1 |= to_u8(g, no_clamp) << sh8;
        w2 |= to_u8(b, no_clamp) << sh8;
      }

    }
    // one 32-bit word of four bytes per plane
    *reinterpret_cast<uint32_t*>(out_e + p) = w0;
    if (!gray) {
      *reinterpret_cast<uint32_t*>(out_e + P + p) = w1;
      *reinterpret_cast<uint32_t*>(out_e + 2 * P + p) = w2;
    }
  }
}

// Launch the specialisation of the mode flags flags[0..4] (DR, GRAY, NPC,
// MULTI, TRI), picking one template argument at a time.
template <bool... F>
cudaError_t launch(const bool* flags, dim3 grid, size_t smem,
                   cudaStream_t st, const float* blob, int B, const Scene& s,
                   unsigned char* out) {
  if constexpr (sizeof...(F) == 5) {
    auto kern = blob_render_kernel<F...>;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kern<<<grid, THREADS, smem, st>>>(blob, B, s, out);
    return cudaGetLastError();
  } else if (flags[sizeof...(F)]) {
    return launch<F..., true>(flags, grid, smem, st, blob, B, s, out);
  } else {
    return launch<F..., false>(flags, grid, smem, st, blob, B, s, out);
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
  if (P % PIX != 0 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the env's tile words (its member's segment on a stack), staged when
  // they fit
  const int seg = n_maps > 1 ? npw : n_words;
  const int n_staged = seg <= MAX_STAGED_WORDS ? seg : 0;
  // chunks of at most MAX_CHUNK pixels, a multiple of PASS, split further
  // while the grid holds fewer than MIN_BLOCKS blocks
  int n_chunks = (P + MAX_CHUNK - 1) / MAX_CHUNK;
  auto chunk_of = [&](int n) {
    return ((P + n - 1) / n + PASS - 1) / PASS * PASS;
  };
  int chunk = chunk_of(n_chunks);
  while (chunk > PASS
         && static_cast<long long>(B) * n_chunks < MIN_BLOCKS) {
    n_chunks *= 2;
    chunk = chunk_of(n_chunks);
  }
  n_chunks = (P + chunk - 1) / chunk;
  Scene s{rays, words, scene, of, oi, pf, pi, P, n_words, Hg, Wg,
          n_objs, aa, any_x, no_clamp, lamp_green, lamp_red, drb, n_maps,
          npw, chunk, n_staged};
  const dim3 grid(B, n_chunks);
  // dr, gray, npc (the plan has moving NPCs), a stack and triangles pick
  // the specialisation
  const bool flags[5] = {dr != 0, gray != 0, npc != 0, n_maps > 1, tri != 0};
  const size_t smem = smem_bytes(n_objs, tri != 0, n_staged);
  return static_cast<int>(launch<>(flags, grid, smem,
                                   static_cast<cudaStream_t>(stream), blob,
                                   B, s, out));
}
