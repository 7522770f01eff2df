// Fused state step for Hopper (sm_90a): a group of G lanes per env.
//
// Replaces the Pallas TPU kernel dtown/ops/state_kernel.py::
// make_state_kernel (launched by state_step_pallas): the agent, the moving
// NPCs (walking duckies, pure-pursuit duckiebots), collision against live
// NPC footprints and the optional objects of a domain-randomized env, the
// auto-reset with NPC re-placement and the DR redraw, stacked multimaps
// (every lookup offset by the env's map index) and the Nav task (goal
// check, optional distance shaping, goal redraw at reset). The plain version
// is dtown_torch/ops/state_kernel.py::state_step_reference; this file keeps
// its float32 operation order for every quantity.
//
// What bounds it on the card: latency. Per env the step reads and writes
// one blob column (32-64 floats, more with NPCs) plus two actions, and does
// a few thousand scalar operations, most of them behind dependent table
// loads (a lane query: tile word, 12 chord dots, the winner's 8 control
// points, a bisection). At 4096 envs that is 1-2 MB of traffic and a few
// million operations: microseconds at the card's rates. One thread per
// env walked the whole chain alone, NPC after NPC and object after object,
// so the time was one env's serial chain. A GPU runs a thread's
// instructions in order, so a loop whose body loads and then uses a value
// pays a full memory round trip an iteration: every load below is started
// in a batch before its first use.
//
// Design: G lanes (one group, inside one warp) step one env, E = 128 / G
// envs a block, so 4096 envs fill 256 blocks on the 132 SMs.
//  * The block stages in shared memory, with coalesced asynchronous copies
//    (cp.async, all in flight at once), the scalar parameters, the DR
//    ranges and, where they fit, the tile words, the object table, the
//    column map and the NPC table; then its E columns of the blob [nf, B]
//    and the actions. It writes the columns back
//    coalesced at the end (zero rows included). The staged NPC rows are the
//    NPCs' state: the state machines read and write them in place, so any
//    NPC count runs (the launch lowers E until the block fits, and leaves
//    the tables in global memory where they would not fit beside one env;
//    Python computes the launch shape, state_kernel.py::launch_shape).
//  * Phase A: lane 0 runs the agent's wheel model and drive substeps; NPC i
//    runs its whole frame_skip loop on lane 1 + i mod (G - 1) at the same
//    time (no NPC's update reads another's). A duckiebot's two lane queries
//    stay on its lane, each loading the 12 chords at once and the winner's
//    control points once.
//  * Phase B: the agent's 12 chord dots (with each curve's control points,
//    so the winner's are in shared memory) and its 5 drivability probes,
//    spread over the lanes, into shared memory.
//    At its end every lane starts the loads a reset would need (its spawn
//    bank row, the Nav goal), so that phase D only stores them.
//  * Phase C: every lane selects the curve in order c = 0..11 (first
//    strictly greater dot) and runs the bisection (the same instructions on
//    every lane cost the warp nothing more than on one; the kept end's
//    distance is carried, not evaluated again). Then the SAT test of the
//    object columns (column m on lane m mod G; the agent's own two axes
//    projected once, and a column's remaining axes skipped once one
//    separates: `separated` is an OR).
//  * Phase C', lane 0: the folds of the probes, of `collided`, of
//    prox_static (a chain of fminf) and of prox_dyn (an ordered sum) in
//    column order; reward, done and Nav. Every float reduction runs on one
//    lane in the plain version's order over values other lanes computed,
//    so the blob comes out the same bits.
//  * Phase D, the reset, spread: the spawn bank's 8 rows from lanes 0-7, each
//    NPC's re-placement and fresh walk speed on its own lane, the DR
//    redraw's 16 hashed uniforms (13 ranged rows, the light's x and z, the
//    texture seed) one per lane, then the light's normalization and the
//    optional-object bits in order on lane 0, the goal on lane G - 1.
//  * The TPU kernel's `table_T @ onehot_T` matmul gathers are indexed loads:
//    from shared memory for the staged tables, through the read-only path
//    (__ldg) for the curve table (transposed, so that a tile's chords and a
//    curve's control points are 16-byte loads) and the spawn bank. A stack
//    of maps arrives as its members' tables concatenated, offset by the
//    env's map row; another map's object column is skipped in the fold.
//  * Nav and multimap are template parameters (four kernels).
//  * The DR redraw's multiply-adds are fmaf: the reference, as XLA builds
//    it, contracts them (the plain version emulates the FMA in float64).
//  * The integer hash computes +, << and ^ in uint32_t (defined
//    wraparound) and each >> as an arithmetic shift of the int32 value,
//    which is the reference's int32 semantics.
//  * Built with -fmad=false and without fast math (_build.py): each op rounds
//    once, as in the plain version.
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "sincos.cuh"

namespace {

// blob rows (dtown_torch/ops/state_kernel.py F_*)
constexpr int F_POS_X = 0, F_POS_Y = 1, F_POS_Z = 2, F_ANGLE = 3;
constexpr int F_SPEED = 4, F_WVL = 5, F_WVR = 6, F_STEP = 7, F_RNG = 8;
constexpr int F_ROBOT_SPEED = 9, F_WHEEL_DIST = 10, F_ACT0 = 11;
constexpr int F_ACT1 = 12, F_REWARD = 13, F_DONE = 14, F_LDIST = 15;
constexpr int F_LDOT = 16, F_LDEG = 17, F_INLANE = 18, F_COLL = 19;
constexpr int F_TIME = 20, F_ENVID = 21, F_OLDIST = 22, F_OLDOT = 23;
constexpr int F_OLDEG = 24, F_OINLANE = 25, F_MAPID = 26;
constexpr int F_NPC_BASE = 27, NPC_ROWS = 5;
// DR rows, relative to dr_base
constexpr int DR_FOV = 0, DR_LX = 4, DR_LY = 5, DR_LZ = 6, DR_AMB = 7;
constexpr int DR_GR = 8, DR_TEXSEED = 14, DR_OBJVIS = 15, DR_ROWS = 16;
// NPC table rows (state_kernel.py NPC_*)
constexpr int NPC_KIND = 0, NPC_X0 = 1, NPC_Z0 = 2, NPC_A0 = 3, NPC_HW = 4;
constexpr int NPC_HL = 5, NPC_RAD = 6, NPC_WALK = 7, NPC_DUCKIE = 0;

// curve table fields of a tile (state_kernel.py CT_*; the kernel's copy is
// transposed, [n_tiles, CT_F], so a tile's fields are contiguous and each
// group of four is 16-byte aligned)
constexpr int N_CURVES = 12, CT_CPS = 0, CT_CHX = 144, CT_CHZ = 156;
constexpr int CT_VALID = 168, CT_F = 184;
// object table rows
constexpr int OT_CX = 0, OT_NX = 8, OT_PX = 12, OT_PZ = 13, OT_RAD = 14;
constexpr int OT_ACT = 15, OT_DYN = 16;
// spawn bank rows, in the order of the blob rows they land in
constexpr int BANK_K = 512;
__constant__ int BANK_DEST[8] = {F_POS_X, F_POS_Y,  F_POS_Z,  F_ANGLE,
                                 F_OLDIST, F_OLDOT, F_OLDEG, F_OINLANE};
// scalar parameters (state_kernel.py _PARAM_NAMES)
constexpr int P_DT = 0, P_INV_DT = 1, P_KR = 2, P_KL = 3, P_RADIUS = 4;
constexpr int P_LIMIT = 5, P_MAX_STEPS = 6, P_CAM_BACK = 7, P_HW = 8;
constexpr int P_HL = 9, P_TS_INV = 10, P_AGENT_RAD = 11, P_NAV_COEF = 12;

constexpr int BEZIER_ITERS = 8;
constexpr int SALT_SPAWN = 0x20000000, SALT_GOAL = 0x40000000;
constexpr float NAV_GOAL_REWARD = 500.0f;
constexpr int SALT_U01 = 0x10000000, TAG_STEP = 0x3779B9;
constexpr int SALT_DUCKIE = 0x30000000, NPC_STEP = 0x611C9;

// The launch shape (state_kernel.py K1_GROUP, K1_THREADS, launch_shape).
constexpr int G = 8;          // lanes per env
constexpr int THREADS = 128;  // threads a block at the full E = THREADS / G
static_assert(32 % G == 0 && G >= 8, "a group sits in one warp, >= 8 lanes");
// per-env shared words besides the blob column and 2M SAT words: actions,
// the agent record, the chord dots, the curves' control points, the
// probes, the done flag
constexpr int AG_X = 0, AG_Z = 1, AG_ANG = 2, AG_SA = 3, AG_CA = 4;
constexpr int AG_CX = 5, AG_CZ = 6, AG_SPEED = 7, AG_VL = 8, AG_VR = 9;
constexpr int AG_N = 10, N_PROBES = 5, N_CPS = 8;
constexpr int ENV_WORDS = 2 + AG_N + N_CURVES + N_CPS * N_CURVES + N_PROBES
                          + 1;
// per-block shared words: the scalar parameters and the DR (lo, span)
// pairs, then, staged where they fit, the tile words, per object column
// its table rows OT_CX..OT_DYN and column map, and per NPC its table column
constexpr int PRM_WORDS = 16, DRP_WORDS = 26;
constexpr int TABLE_WORDS = PRM_WORDS + DRP_WORDS;
constexpr int OT_ROWS = OT_DYN + 1, COLUMN_WORDS = OT_ROWS + 3, NPC_F = 8;
// the DR redraw's jobs, one hashed uniform each: the 13 ranged rows
// (state_kernel.py DR_TAGS order, the last six the clipped colours), the
// light's x and z, the texture seed; and the row each writes (relative to
// dr_base; -1 and -2: the robot speed and wheel base rows)
constexpr int N_RANGED = 13, N_DR_JOBS = 16, FIRST_COLOUR = 7;
constexpr int J_LIGHT = N_RANGED, J_SEED = N_RANGED + 2;
__constant__ int DR_TAG[N_DR_JOBS] = {1,  2,  3,  4,  5,  6, 9, 10,
                                      11, 12, 13, 14, 15, 7, 8, 16};
__constant__ int DR_ROW[N_DR_JOBS] = {-1, -2, 0,  1,  2,  3, 7, 8,
                                      9,  10, 11, 12, 13, 4, 6, 14};

// words, ot, npc, colmap, drp and prm point into shared memory once staged
struct Tables {
  const int* words;
  const float* ct;     // [n_tiles, CT_F]
  const float* ot;
  const float* bank;
  const float* npc;    // [8, n_npc]
  const int* colmap;   // [3, M]: NPC index, optional bit (-1: none), map
  const float* drp;    // DR (lo, span) pairs
  const float* prm;    // scalar parameters (P_*)
  const int* n_ok_v;   // [n_maps] accepted-bank count of each member
  const int* n_driv;   // [n_maps] drivable-tile count of each member (Nav)
  const float* goal;   // [8, n_maps * goal_k] drivable tiles (Nav)
  int n_tiles;         // the curve table's width (n_maps * t_pad)
  int Hg, Wg, M, n_npc, dr, n_opt, n_maps, t_pad, npw, goal_k;
};

__device__ __forceinline__ int32_t asr(uint32_t h, int k) {
  return static_cast<int32_t>(h) >> k;  // arithmetic shift of the int32
}

__device__ __forceinline__ int32_t hash_u32(int32_t a, int32_t b,
                                            int32_t salt) {
  uint32_t h = (static_cast<uint32_t>(a) ^ (static_cast<uint32_t>(b) << 13))
               + static_cast<uint32_t>(b) + static_cast<uint32_t>(salt);
  h = h + (h << 10);
  h = h ^ static_cast<uint32_t>(asr(h, 6));
  h = h + (h << 3);
  h = h ^ static_cast<uint32_t>(asr(h, 11));
  h = h + (h << 15);
  h = h ^ static_cast<uint32_t>(asr(h, 7));
  return static_cast<int32_t>(h & 0x7FFFFFFFu);
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// x / 65536 as a product: the divisor is a power of two, so the two agree
// to the bit (an integer below 2^16 times 2^-16 is exact)
constexpr float kInv65536 = 1.0f / 65536.0f;

// per-(env, episode, tag) uniform in [0, 1) from the integer hash
__device__ __forceinline__ float u01(int32_t rng, int32_t env, int tag) {
  const int32_t hv = hash_u32(rng, env, SALT_U01 + tag * TAG_STEP);
  return static_cast<float>(hv & 0xFFFF) * kInv65536;
}

// n words from global src to shared dst by the block's nth threads, as
// asynchronous copies (cp.async): a thread starts all of its copies without
// waiting on any; __pipeline_wait_prior(0) then waits once for them all
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int nth) {
  for (int i = threadIdx.x; i < n; i += nth)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(T));
}

// one differential-drive substep (simulator.py::_update_pos)
__device__ __forceinline__ void drive(float* x, float* z, float* a,
                                      float s_a, float c_a, float vl,
                                      float vr, float wheel_dist, float dt) {
  const float dir_x = c_a, dir_z = -s_a;
  const bool straight = vl == vr;
  const float npx_s = *x + dt * vl * dir_x;
  const float npz_s = *z + dt * vl * dir_z;
  const float denom = straight ? 1.0f : vl - vr;
  const float w = (vr - vl) / wheel_dist;
  const float r_icc = wheel_dist * (vl + vr) / (2.0f * denom);
  const float rot = w * dt;
  const float cx = *x + r_icc * s_a;
  const float cz = *z + r_icc * c_a;
  float s_r, c_r;
  dt_sincos(rot, &s_r, &c_r);
  const float dx = *x - cx;
  const float dz = *z - cz;
  const float npx_a = cx + dx * c_r + dz * s_r;
  const float npz_a = cz + dz * c_r - dx * s_r;
  *x = straight ? npx_s : npx_a;
  *z = straight ? npz_s : npz_a;
  *a = *a + (straight ? 0.0f : rot);
}

// The clipped tile id under (px, pz); *ing: whether the point is on the
// grid.
__device__ __forceinline__ int tile_of(const Tables& t, float ts_inv,
                                       float px, float pz, bool* ing) {
  const float fi = floorf(px * ts_inv);
  const float fj = floorf(pz * ts_inv);
  *ing = (fi >= 0.0f) & (fi < static_cast<float>(t.Wg)) & (fj >= 0.0f)
         & (fj < static_cast<float>(t.Hg));
  const int ii = min(max(static_cast<int>(fi), 0), t.Wg - 1);
  const int jj = min(max(static_cast<int>(fj), 0), t.Hg - 1);
  return jj * t.Wg + ii;
}

// Drivability of the tile under (px, pz); also returns the clipped tile id.
// woff is the env's word segment (mi * npw on a stack, else 0).
__device__ __forceinline__ bool drivable_at(const Tables& t, float ts_inv,
                                            float px, float pz, int woff,
                                            int* tid_out) {
  bool ing;
  const int tid = tile_of(t, ts_inv, px, pz, &ing);
  const int word = t.words[woff + (tid >> 2)];
  const int kind = (word >> ((tid & 3) * 8)) & 0xF;
  *tid_out = tid;
  return ing & (kind >= 1) & (kind <= 6);  // TILE_STRAIGHT..TILE_4WAY
}

// curve c's chord dot with the query direction from its loaded chord and
// valid flag (-1e30 for an invalid curve)
__device__ __forceinline__ float chord_dot(float chx, float chz, float valid,
                                           float qdx, float qdz) {
  const float dot = chx * qdx + chz * qdz;
  return valid > 0.5f ? dot : -1e30f;
}

struct Bez {
  float x0, z0, x1, z1, x2, z2, x3, z3;
  __device__ __forceinline__ void point(float t, float* x, float* z) const {
    const float u = 1.0f - t;
    const float w0 = u * u * u;
    const float w1 = 3.0f * t * u * u;
    const float w2 = 3.0f * t * t * u;
    const float w3 = t * t * t;
    *x = w0 * x0 + w1 * x1 + w2 * x2 + w3 * x3;
    *z = w0 * z0 + w1 * z1 + w2 * z2 + w3 * z3;
  }
};

// the control points of curve c of a tile's fields p4 (two 16-byte loads)
__device__ __forceinline__ Bez curve_of(const float4* p4, int c) {
  const float4 a = __ldg(p4 + (CT_CPS + c * 12) / 4);
  const float4 b = __ldg(p4 + (CT_CPS + c * 12) / 4 + 1);
  return Bez{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
}

// The agent's lane query spreads the 12 curves of a tile over the lanes:
// lane l takes curves l and l + G. Loads their chords, valid flags and
// control points from the tile's fields cc.
constexpr int NQ = (N_CURVES + G - 1) / G;
struct Curves {
  float ch[NQ][3];
  Bez cp[NQ];
};

__device__ __forceinline__ Curves load_curves(const float* cc, int lane) {
  Curves v;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int c = lane + q * G;
    if (c < N_CURVES) {
      v.ch[q][0] = __ldg(cc + CT_CHX + c);
      v.ch[q][1] = __ldg(cc + CT_CHZ + c);
      v.ch[q][2] = __ldg(cc + CT_VALID + c);
      v.cp[q] = curve_of(reinterpret_cast<const float4*>(cc), c);
    }
  }
  return v;
}

// closest_curve_point's squared distance from (qx, qz) to curve b at t
__device__ __forceinline__ float dist2(const Bez& b, float t, float qx,
                                       float qz) {
  float x, z;
  b.point(t, &x, &z);
  const float ex = x - qx, ez = z - qz;
  return ex * ex + ez * ez;
}

// closest_curve_point's fixed-depth bisection on one lane: each halving
// keeps the end nearer (qx, qz). An end's distance is a function of its t
// alone, so the kept end's is carried rather than evaluated again: the same
// bits, one curve point a halving. Returns the final interval's middle.
__device__ float halve(const Bez& b, float qx, float qz) {
  float t_bot = 0.0f, t_top = 1.0f;
  float d_bot = dist2(b, t_bot, qx, qz), d_top = dist2(b, t_top, qx, qz);
  for (int it = 0; it < BEZIER_ITERS; ++it) {
    const float mid = 0.5f * (t_bot + t_top);
    const float d_mid = dist2(b, mid, qx, qz);
    if (d_bot < d_top) {
      t_top = mid;
      d_top = d_mid;
    } else {
      t_bot = mid;
      d_bot = d_mid;
    }
  }
  return 0.5f * (t_bot + t_top);
}

// closest_curve_point's point and unit tangent of curve b at ts
__device__ void curve_at(const Bez& b, float ts, float* px_c, float* pz_c,
                         float* tanx_o, float* tanz_o) {
  b.point(ts, px_c, pz_c);
  const float u = 1.0f - ts;
  const float tanx = 3.0f * u * u * (b.x1 - b.x0)
                     + 6.0f * u * ts * (b.x2 - b.x1)
                     + 3.0f * ts * ts * (b.x3 - b.x2);
  const float tanz = 3.0f * u * u * (b.z1 - b.z0)
                     + 6.0f * u * ts * (b.z2 - b.z1)
                     + 3.0f * ts * ts * (b.z3 - b.z2);
  const float tinv = 1.0f / sqrtf(fmaxf(tanx * tanx + tanz * tanz, 1e-24f));
  *tanx_o = tanx * tinv;
  *tanz_o = tanz * tinv;
}

// A lane query on one lane (a duckiebot's): the 12 chords loaded at once,
// the select in curve order (first strictly greater dot), the winner's
// control points once (none: 0, as the plain version's select leaves
// them), the bisection; returns the best chord dot.
__device__ float lane_query(const Tables& t, int tid, float qx, float qz,
                            float qdx, float qdz, float* px_c, float* pz_c,
                            float* tanx_o, float* tanz_o) {
  const float4* p4 = reinterpret_cast<const float4*>(t.ct + tid * CT_F);
  float ch[3][N_CURVES];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < N_CURVES / 4; ++q) {
      const float4 v = __ldg(p4 + (CT_CHX + r * N_CURVES) / 4 + q);
      ch[r][4 * q] = v.x;
      ch[r][4 * q + 1] = v.y;
      ch[r][4 * q + 2] = v.z;
      ch[r][4 * q + 3] = v.w;
    }
  }
  float best_dot = -1e30f;
  int best = -1;
#pragma unroll
  for (int c = 0; c < N_CURVES; ++c) {
    const float dot = chord_dot(ch[0][c], ch[1][c], ch[2][c], qdx, qdz);
    if (dot > best_dot) {
      best_dot = dot;
      best = c;
    }
  }
  Bez b{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (best >= 0) b = curve_of(p4, best);
  curve_at(b, halve(b, qx, qz), px_c, pz_c, tanx_o, tanz_o);
  return best_dot;
}

// NPC i's whole frame_skip loop (objects.py semantics) on its rows of the
// staged blob column (row r at r * E).
__device__ void npc_step(const Tables& t, float* nrow, int E, int i,
                         int frame_skip, float dt, float ts_inv, int woff,
                         int toff) {
  auto N = [&](int r) { return t.npc[r * t.n_npc + i]; };
  const bool duckie = static_cast<int>(N(NPC_KIND)) == NPC_DUCKIE;
  const float walk = N(NPC_WALK);
  float nx = nrow[0], nz = nrow[E], na = nrow[2 * E], nw = nrow[3 * E];
  const float nv = nrow[4 * E];
  for (int fs = 0; fs < frame_skip; ++fs) {
    float s_n, c_n;
    dt_sincos(na, &s_n, &c_n);
    if (duckie) {
      // walk along the heading, reverse after walk_dist
      const float step_len = nv * dt;
      nx = nx + step_len * c_n;
      nz = nz - step_len * s_n;
      nw = nw + step_len;
      const bool rev = nw > walk;
      na = rev ? na + DT_F(3.14159265358979323846) : na;
      nw = rev ? 0.0f : nw;
    } else {
      // scripted duckiebot: pure pursuit on two chained lane queries
      const float bdx = c_n, bdz = -s_n;
      int tq;
      const bool drv1 = drivable_at(t, ts_inv, nx, nz, woff, &tq);
      float cpx, cpz, ctx, ctz;
      const float bd1 = lane_query(t, toff + tq, nx, nz, bdx, bdz, &cpx,
                                   &cpz, &ctx, &ctz);
      const float fpx = cpx + DT_F(0.30) * ctx;
      const float fpz = cpz + DT_F(0.30) * ctz;
      const bool drv2 = drivable_at(t, ts_inv, fpx, fpz, woff, &tq);
      float gpx, gpz, gtx, gtz;
      const float bd2 = lane_query(t, toff + tq, fpx, fpz, bdx, bdz, &gpx,
                                   &gpz, &gtx, &gtz);
      const float pvx = gpx - nx;
      const float pvz = gpz - nz;
      const float pinv = 1.0f / sqrtf(fmaxf(pvx * pvx + pvz * pvz, 1e-18f));
      const float dotr = (s_n * pvx + c_n * pvz) * pinv;
      float steering = DT_F(0.15) * (-dotr);
      const bool ok = drv1 & (bd1 > 0.0f) & drv2 & (bd2 > 0.0f);
      if (!ok) steering = 0.0f;
      drive(&nx, &nz, &na, s_n, c_n, nv - steering, nv + steering,
            DT_F(0.102), dt);
    }
  }
  nrow[0] = nx;
  nrow[E] = nz;
  nrow[2 * E] = na;
  nrow[3 * E] = nw;
}

// The agent's box for the SAT test: corners, axes (dir, right), centre,
// and the corners' extent on its own two axes (the same for every column).
struct Box {
  float gx[4], gz[4], ax[2], az[2], lo[2], hi[2], cx, cz, rad;
};

// The agent's extent on axis (ax, az), in the plain version's corner order.
__device__ __forceinline__ void extent(const Box& a, float ax, float az,
                                       float* lo, float* hi) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float p = a.gx[i] * ax + a.gz[i] * az;
    *lo = i == 0 ? p : fminf(*lo, p);
    *hi = i == 0 ? p : fmaxf(*hi, p);
  }
}

// SAT collision and proximity score of object column m against the agent's
// box. Returns the score and sets *flags: bit 0 a hit of an active object,
// bit 1 an active static object (prox_static), bit 2 an active dynamic one
// (prox_dyn). col is the env's staged blob column (the live NPC rows).
__device__ float sat_column(const Tables& t, const float* col, int E, int m,
                            int objvis, const Box& a, int* flags) {
  auto O = [&](int r) { return t.ot[r * t.M + m]; };
  const int ni = t.colmap[m];
  const int kbit = t.colmap[t.M + m];
  float ocx[4], ocz[4], axs[4], azs[4], o_px, o_pz, o_rad;
  bool o_act, o_dyn;
  axs[0] = a.ax[0];
  azs[0] = a.az[0];
  axs[1] = a.ax[1];
  azs[1] = a.az[1];
  if (ni >= 0) {
    // live NPC footprint (objects.py::dynamic_corners)
    const float* nrow = col + (F_NPC_BASE + NPC_ROWS * ni) * E;
    const float nx = nrow[0], nz = nrow[E];
    float s_n, c_n;
    dt_sincos(nrow[2 * E], &s_n, &c_n);
    const float fx_n = c_n, fz_n = -s_n, rx_n = s_n, rz_n = c_n;
    const float hw_n = t.npc[NPC_HW * t.n_npc + ni];
    const float hl_n = t.npc[NPC_HL * t.n_npc + ni];
    ocx[0] = nx - hl_n * fx_n - hw_n * rx_n;
    ocx[1] = nx + hl_n * fx_n - hw_n * rx_n;
    ocx[2] = nx + hl_n * fx_n + hw_n * rx_n;
    ocx[3] = nx - hl_n * fx_n + hw_n * rx_n;
    ocz[0] = nz - hl_n * fz_n - hw_n * rz_n;
    ocz[1] = nz + hl_n * fz_n - hw_n * rz_n;
    ocz[2] = nz + hl_n * fz_n + hw_n * rz_n;
    ocz[3] = nz - hl_n * fz_n + hw_n * rz_n;
    axs[2] = rx_n;
    azs[2] = rz_n;
    axs[3] = fx_n;
    azs[3] = fz_n;
    o_px = nx;
    o_pz = nz;
    o_rad = t.npc[NPC_RAD * t.n_npc + ni];
    o_act = true;
    o_dyn = true;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ocx[i] = O(OT_CX + 2 * i);
      ocz[i] = O(OT_CX + 2 * i + 1);
    }
    axs[2] = O(OT_NX + 0);
    azs[2] = O(OT_NX + 1);
    axs[3] = O(OT_NX + 2);
    azs[3] = O(OT_NX + 3);
    o_px = O(OT_PX);
    o_pz = O(OT_PZ);
    o_rad = O(OT_RAD);
    o_act = O(OT_ACT) > 0.5f;
    o_dyn = O(OT_DYN) > 0.5f;
    // optional-object visibility bit of this env (domain rand only)
    if (kbit >= 0) o_act = o_act & (((objvis >> kbit) & 1) > 0);
  }
  // the 4 axes in the plain version's order; once one separates, the OR
  // is decided and the rest are skipped
  bool separated = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (separated) break;
    const float ax = axs[k], az = azs[k];
    float amin, amax, bmin = 0.f, bmax = 0.f;
    if (k < 2) {
      amin = a.lo[k];
      amax = a.hi[k];
    } else {
      extent(a, ax, az, &amin, &amax);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pb = ocx[i] * ax + ocz[i] * az;
      bmin = i == 0 ? pb : fminf(bmin, pb);
      bmax = i == 0 ? pb : fmaxf(bmax, pb);
    }
    separated = separated | (amax < bmin) | (bmax < amin);
  }
  const float dxo = o_px - a.cx;
  const float dzo = o_pz - a.cz;
  const float dist_o = sqrtf(dxo * dxo + dzo * dzo);
  *flags = (!separated & o_act ? 1 : 0) | (o_act & !o_dyn ? 2 : 0)
           | (o_act & o_dyn ? 4 : 0);
  return dist_o - a.rad - o_rad;
}

// The block's shared words for E envs, the tables staged or not
// (state_kernel.py launch_shape).
int shared_words(int nf, int M, int n_npc, int n_words, int E,
                 bool staged) {
  return TABLE_WORDS + (staged ? n_words + COLUMN_WORDS * M + NPC_F * n_npc
                               : 0)
         + E * (nf + ENV_WORDS + 2 * M);
}

template <bool NAV, bool MULTI>
__global__ void __launch_bounds__(THREADS, 4)
state_step_kernel(const float* __restrict__ blob,
                  const float* __restrict__ act, float* __restrict__ out,
                  Tables t, int B, int nf, int E, int n_words, int staged,
                  int frame_skip, int use_wm, int auto_reset) {
  extern __shared__ float sm[];
  const int nth = E * G;
  const int e0 = blockIdx.x * E;
  const int ne = min(E, B - e0);  // envs of this block
  const int M = t.M;
  const int n_npc = t.n_npc;
  // shared layout (state_kernel.py launch_shape): per block the scalar
  // parameters, the DR pairs and, staged, the tile words, the object table
  // rows, the column map and the NPC table; then the blob columns [nf][E];
  // then per env the actions [2], the agent record [AG_N], the chord dots
  // [12], the curves' control points [12][8], the probes [5], the done
  // flag, the SAT scores and flags [M] each
  float* s_prm = sm;
  float* s_drp = s_prm + PRM_WORDS;
  int* s_words = reinterpret_cast<int*>(s_drp + DRP_WORDS);
  float* s_ot = reinterpret_cast<float*>(s_words + (staged ? n_words : 0));
  int* s_col = reinterpret_cast<int*>(s_ot + (staged ? OT_ROWS * M : 0));
  float* s_npc = reinterpret_cast<float*>(s_col + (staged ? 3 * M : 0));
  float* slab = s_npc + (staged ? NPC_F * n_npc : 0);
  float* s_act = slab + nf * E;
  float* s_ag = s_act + 2 * E;
  float* s_dot = s_ag + AG_N * E;
  float* s_cps = s_dot + N_CURVES * E;
  int* s_prb = reinterpret_cast<int*>(s_cps + N_CPS * N_CURVES * E);
  int* s_done = s_prb + N_PROBES * E;
  float* s_score = reinterpret_cast<float*>(s_done + E);
  int* s_flag = reinterpret_cast<int*>(s_score + M * E);

  // ---- stage: the tables, the blob columns and the actions ------------
  stage(s_prm, t.prm, P_NAV_COEF + 1, nth);
  stage(s_drp, t.drp, DRP_WORDS, nth);
  if (staged) {
    stage(s_words, t.words, n_words, nth);
    stage(s_ot, t.ot, OT_ROWS * M, nth);
    stage(s_col, t.colmap, 3 * M, nth);
    stage(s_npc, t.npc, NPC_F * n_npc, nth);
    t.words = s_words;
    t.ot = s_ot;
    t.colmap = s_col;
    t.npc = s_npc;
  }
  t.prm = s_prm;
  t.drp = s_drp;
  // thread x moves env column x % E, rows x / E + k * G (coalesced runs of
  // the block's envs)
  const int j_io = threadIdx.x % E;
  const int f_io = threadIdx.x / E;
  if (j_io < ne)
    for (int f = f_io; f < nf; f += G)
      __pipeline_memcpy_async(slab + f * E + j_io, blob + f * B + e0 + j_io,
                              sizeof(float));
  stage(s_act, act + 2 * e0, 2 * ne, nth);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const int s = threadIdx.x / G, lane = threadIdx.x % G;
  const int drb = F_NPC_BASE + NPC_ROWS * n_npc;
  const int navb = drb + (t.dr ? DR_ROWS : 0);
  const int f_end = NAV ? navb + 2 : navb;
  if (s < ne) {
    // the group's lanes of its warp
    const unsigned gmask = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
    float* col = slab + s;
    auto R = [&](int f) -> float& { return col[f * E]; };
    const float* prm = s_prm;
    float* ag = s_ag + s * AG_N;
    const float ts_inv = prm[P_TS_INV];
    const float dt = prm[P_DT];
    const float map_row = R(F_MAPID);
    const int32_t rng_i = static_cast<int32_t>(R(F_RNG));
    const int32_t env_i = static_cast<int32_t>(R(F_ENVID));
    // the env's member of a stack and its table segments
    const int mi = MULTI ? static_cast<int>(map_row) : 0;
    const int woff = MULTI ? mi * t.npw : 0;
    const int toff = MULTI ? mi * t.t_pad : 0;
    // the reset's counts, loaded now so that phase A's end does not wait
    const int n_ok = __ldg(t.n_ok_v + mi);
    const int n_driv = NAV ? __ldg(t.n_driv + mi) : 0;

    // ---- phase A: the agent's drive on lane 0, the NPCs on the others ----
    if (lane == 0) {
      float pos_x = R(F_POS_X), pos_z = R(F_POS_Z), angle = R(F_ANGLE);
      const float act0 = s_act[2 * s], act1 = s_act[2 * s + 1];
      const float robot_speed = R(F_ROBOT_SPEED);
      const float wheel_dist = R(F_WHEEL_DIST);
      float u_l, u_r;
      if (use_wm) {
        const float radius = prm[P_RADIUS];
        const float limit = prm[P_LIMIT];
        const float omega_r = (act0 + 0.5f * act1 * wheel_dist) / radius;
        const float omega_l = (act0 - 0.5f * act1 * wheel_dist) / radius;
        u_r = clampf(omega_r * prm[P_KR], -limit, limit);
        u_l = clampf(omega_l * prm[P_KL], -limit, limit);
      } else {
        u_l = act0;
        u_r = act1;
      }
      u_l = clampf(u_l, -1.0f, 1.0f);
      u_r = clampf(u_r, -1.0f, 1.0f);
      const float vl = u_l * robot_speed;
      const float vr = u_r * robot_speed;
      float speed = 0.0f;
      for (int fs = 0; fs < frame_skip; ++fs) {
        float s_a, c_a;
        dt_sincos(angle, &s_a, &c_a);
        float new_x = pos_x, new_z = pos_z, new_angle = angle;
        drive(&new_x, &new_z, &new_angle, s_a, c_a, vl, vr, wheel_dist, dt);
        const float ddx = new_x - pos_x;
        const float ddz = new_z - pos_z;
        speed = sqrtf(ddx * ddx + ddz * ddz) * prm[P_INV_DT];
        pos_x = new_x;
        pos_z = new_z;
        angle = new_angle;
      }
      float s_a, c_a;
      dt_sincos(angle, &s_a, &c_a);
      const float cam_back = prm[P_CAM_BACK];
      ag[AG_X] = pos_x;
      ag[AG_Z] = pos_z;
      ag[AG_ANG] = angle;
      ag[AG_SA] = s_a;
      ag[AG_CA] = c_a;
      ag[AG_CX] = pos_x + cam_back * c_a;
      ag[AG_CZ] = pos_z + cam_back * -s_a;
      ag[AG_SPEED] = speed;
      ag[AG_VL] = vl;
      ag[AG_VR] = vr;
    } else {
      for (int i = lane - 1; i < n_npc; i += G - 1)
        npc_step(t, col + (F_NPC_BASE + NPC_ROWS * i) * E, E, i, frame_skip,
                 dt, ts_inv, woff, toff);
    }
    // the spawn (one bank row a lane, within the env's member segment) and
    // the goal that a reset would take, loaded now so that phase D only
    // stores them
    const int32_t h = hash_u32(rng_i, env_i, SALT_SPAWN);
    const int sidx = mi * BANK_K + h % max(n_ok, 1);
    const float spawn =
        lane < 8 ? __ldg(t.bank + lane * (t.n_maps * BANK_K) + sidx) : 0.0f;
    float goal_i = 0.0f, goal_j = 0.0f;
    if (NAV && lane == G - 1) {
      const int32_t hg = hash_u32(rng_i, env_i, SALT_GOAL);
      const int gidx = mi * t.goal_k + hg % max(n_driv, 1);
      goal_i = __ldg(t.goal + gidx);
      goal_j = __ldg(t.goal + t.n_maps * t.goal_k + gidx);
    }
    __syncwarp(gmask);

    const float pos_x = ag[AG_X], pos_z = ag[AG_Z];
    const float s_a = ag[AG_SA], c_a = ag[AG_CA];
    const float acx = ag[AG_CX], acz = ag[AG_CZ];
    const float dir_x = c_a, dir_z = -s_a;
    const float right_x = s_a, right_z = c_a;
    const float hw = prm[P_HW], hl = prm[P_HL];

    // ---- phase B: chord dots and control points, probes, over the lanes --
    {
      // curves lane and lane + G of the tile under the agent
      bool ing;
      const int tid = tile_of(t, ts_inv, pos_x, pos_z, &ing);
      const Curves cv = load_curves(t.ct + (toff + tid) * CT_F, lane);
      int probe = 0;
      if (lane < N_PROBES) {
        float qx = pos_x, qz = pos_z;
        if (lane == 1) {
          qx = acx;
          qz = acz;
        } else if (lane == 2) {
          qx = acx - hw * right_x;
          qz = acz - hw * right_z;
        } else if (lane == 3) {
          qx = acx + hw * right_x;
          qz = acz + hw * right_z;
        } else if (lane == 4) {
          qx = acx + hl * dir_x;
          qz = acz + hl * dir_z;
        }
        int tq;
        probe = drivable_at(t, ts_inv, qx, qz, woff, &tq) ? 1 : 0;
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = lane + q * G;
        if (c < N_CURVES) {
          s_dot[s * N_CURVES + c] =
              chord_dot(cv.ch[q][0], cv.ch[q][1], cv.ch[q][2], dir_x, dir_z);
          reinterpret_cast<Bez*>(s_cps)[s * N_CURVES + c] = cv.cp[q];
        }
      }
      if (lane < N_PROBES) s_prb[s * N_PROBES + lane] = probe;
    }
    __syncwarp(gmask);

    // ---- phase C: the curve select and bisection on every lane, then SAT --
    // the curve select in curve order: first strictly greater dot (every
    // lane reads the same dots and picks the same curve)
    float best_dot = -1e30f;
    int best = -1;
#pragma unroll
    for (int c = 0; c < N_CURVES; ++c) {
      const float d = s_dot[s * N_CURVES + c];
      if (d > best_dot) {
        best_dot = d;
        best = c;
      }
    }
    Bez b{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (best >= 0)
      b = reinterpret_cast<const Bez*>(s_cps)[s * N_CURVES + best];
    float px_c, pz_c, tanx, tanz;
    curve_at(b, halve(b, pos_x, pos_z), &px_c, &pz_c, &tanx, &tanz);
    if (lane < M) {
      Box a;
      const float sfs[4] = {-hl, hl, hl, -hl};
      const float srs[4] = {hw, hw, -hw, -hw};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a.gx[i] = acx + sfs[i] * dir_x + srs[i] * right_x;
        a.gz[i] = acz + sfs[i] * dir_z + srs[i] * right_z;
      }
      a.ax[0] = dir_x;
      a.az[0] = dir_z;
      a.ax[1] = right_x;
      a.az[1] = right_z;
      extent(a, dir_x, dir_z, &a.lo[0], &a.hi[0]);
      extent(a, right_x, right_z, &a.lo[1], &a.hi[1]);
      a.cx = acx;
      a.cz = acz;
      a.rad = prm[P_AGENT_RAD];
      const int objvis = t.dr ? static_cast<int>(R(drb + DR_OBJVIS)) : 0;
      for (int m = lane; m < M; m += G) {
        int flags = 0;
        float score = 0.0f;
        // a stack's object exists on its own member map only
        if (!MULTI || t.colmap[2 * M + m] == mi)
          score = sat_column(t, col, E, m, objvis, a, &flags);
        s_score[s * M + m] = score;
        s_flag[s * M + m] = flags;
      }
    }
    __syncwarp(gmask);

    // ---- phase C': lane 0 folds in order; reward, done, Nav ---------------
    if (lane == 0) {
      const float speed = ag[AG_SPEED];
      const float step_cnt = R(F_STEP) + static_cast<float>(frame_skip);
      const int* prb = s_prb + s * N_PROBES;
      const bool d_c = prb[0] != 0;
      const bool all_driv = (prb[1] != 0) & (prb[2] != 0) & (prb[3] != 0)
                            & (prb[4] != 0);
      bool collided = false;
      float prox_static = 1e30f;
      float prox_dyn = 0.0f;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const int fl = s_flag[s * M + m];
        const float score = s_score[s * M + m];
        collided = collided | ((fl & 1) != 0);
        if (fl & 2) prox_static = fminf(prox_static, score);
        if (fl & 4) prox_dyn = prox_dyn + fminf(score, 0.0f);
      }
      const float col_penalty = fminf(prox_static, 0.0f) + prox_dyn;
      const bool valid = all_driv & !collided;

      // lane position
      const float dot_dir = clampf(dir_x * tanx + dir_z * tanz, -1.0f, 1.0f);
      const float rox = -tanz;
      const float roz = tanx;
      const float signed_dist = (pos_x - px_c) * rox + (pos_z - pz_c) * roz;
      float ang_rad = dt_acos(dot_dir);
      if (dir_x * rox + dir_z * roz < 0.0f) ang_rad = -ang_rad;
      const bool in_lane = d_c & (best_dot > 0.0f);

      // reward / done
      const float reward_full = 1.0f * speed * dot_dir
                                + -10.0f * fabsf(signed_dist)
                                + 40.0f * col_penalty;
      const float reward_alive = in_lane ? reward_full : 40.0f * col_penalty;
      const bool crashed = !valid;
      const bool truncated = step_cnt >= prm[P_MAX_STEPS];
      bool done = crashed | truncated;
      float reward = crashed ? -1000.0f : reward_alive;
      if (NAV) {
        // goal check on the post-step tile of a live episode
        const float goal_i = R(navb), goal_j = R(navb + 1);
        const bool reached = (floorf(pos_x * ts_inv) == goal_i)
                             & (floorf(pos_z * ts_inv) == goal_j) & !done;
        if (reached) reward = reward + NAV_GOAL_REWARD;
        const float coef = prm[P_NAV_COEF];
        if (coef != 0.0f) {
          // potential-based goal-distance shaping
          const float ts_k = 1.0f / ts_inv;
          const float gx = (goal_i + 0.5f) * ts_k;
          const float gz = (goal_j + 0.5f) * ts_k;
          float ex = gx - R(F_POS_X), ez = gz - R(F_POS_Z);
          const float d_prev = sqrtf(ex * ex + ez * ez);
          ex = gx - pos_x;
          ez = gz - pos_z;
          const float d_next = sqrtf(ex * ex + ez * ez);
          reward = reward + coef * (d_prev - d_next);
        }
        done = done | reached;
      }

      // this step's rows; a reset's pose and lane rows come from the bank
      // lanes in phase D
      const bool reset = auto_reset && done;
      const float lane_deg = ang_rad * DT_F(180.0 / 3.14159265358979323846);
      const float in_lane_f = in_lane ? 1.0f : 0.0f;
      if (!reset) {
        R(F_POS_X) = pos_x;
        R(F_POS_Z) = pos_z;
        R(F_ANGLE) = ag[AG_ANG];
        R(F_OLDIST) = signed_dist;
        R(F_OLDOT) = dot_dir;
        R(F_OLDEG) = lane_deg;
        R(F_OINLANE) = in_lane_f;
      }
      const float step_out = reset ? 0.0f : step_cnt;
      R(F_SPEED) = reset ? 0.0f : speed;
      R(F_WVL) = reset ? 0.0f : ag[AG_VL];
      R(F_WVR) = reset ? 0.0f : ag[AG_VR];
      R(F_STEP) = step_out;
      R(F_RNG) = R(F_RNG) + 1.0f;
      R(F_ACT0) = s_act[2 * s];
      R(F_ACT1) = s_act[2 * s + 1];
      R(F_REWARD) = reward;
      R(F_DONE) = done ? 1.0f : 0.0f;
      R(F_LDIST) = signed_dist;
      R(F_LDOT) = dot_dir;
      R(F_LDEG) = lane_deg;
      R(F_INLANE) = in_lane_f;
      R(F_COLL) = collided ? 1.0f : 0.0f;
      R(F_TIME) = step_out * dt;
      s_done[s] = reset ? 1 : 0;
    }
    __syncwarp(gmask);

    // ---- phase D: the reset (spawn, NPCs, goal) and the DR rows, spread ---
    const bool reset = s_done[s] != 0;
    if (reset) {
      if (lane < 8) R(BANK_DEST[lane]) = spawn;
      // NPCs re-place at their initial poses; a duckie's walk speed is
      // redrawn ~N(0.02, 0.005) (Irwin-Hall sum of 4 hashed uniforms)
      for (int i = lane - 1; lane > 0 && i < n_npc; i += G - 1) {
        auto N = [&](int r) { return t.npc[r * n_npc + i]; };
        float* nrow = col + (F_NPC_BASE + NPC_ROWS * i) * E;
        nrow[0] = N(NPC_X0);
        nrow[E] = N(NPC_Z0);
        nrow[2 * E] = N(NPC_A0);
        nrow[3 * E] = 0.0f;
        if (static_cast<int>(N(NPC_KIND)) == NPC_DUCKIE) {
          float usum = 0.0f;
          for (int j = 0; j < 4; ++j) {
            const int32_t hv = hash_u32(
                rng_i, env_i, SALT_DUCKIE + j * TAG_STEP + i * NPC_STEP);
            usum = usum + static_cast<float>(hv & 0xFFFF) * kInv65536;
          }
          const float ih_scale = static_cast<float>(1.7320508f * 0.005f);
          nrow[4 * E] = fmaxf(fmaf(usum - 2.0f, ih_scale, DT_F(0.02)),
                              0.001f);
        }
      }
      if (NAV && lane == G - 1) {
        // a fresh goal: a uniform drivable tile of the env's map
        R(navb) = goal_i;
        R(navb + 1) = goal_j;
      }
    }
    if (auto_reset && t.dr) {
      // the DR redraw of a fresh episode, one job a lane, the same code on
      // every lane; the reference clips the colour rows of every env, reset
      // or not. The light's normalization and the optional objects' bits
      // (summed in bit order) follow on lane 0.
      for (int j = lane; j < N_DR_JOBS; j += G) {
        const int row = DR_ROW[j] == -1   ? F_ROBOT_SPEED
                        : DR_ROW[j] == -2 ? F_WHEEL_DIST
                                          : drb + DR_ROW[j];
        const bool stored = j < J_LIGHT || j == J_SEED;
        float v = stored ? R(row) : 0.0f;
        if (reset) {
          const float u = u01(rng_i, env_i, DR_TAG[j]);
          v = j < N_RANGED  ? fmaf(u, t.drp[2 * j + 1], t.drp[2 * j])
              : j < J_SEED ? fmaf(u, DT_F(0.8), -1.0f)
                           : floorf(u * 8388608.0f);
        }
        if (j >= FIRST_COLOUR && j < N_RANGED) v = clampf(v, 0.0f, 1.0f);
        if (stored) {
          R(row) = v;
        } else if (reset) {
          s_dot[s * N_CURVES + j - J_LIGHT] = v;  // phase C is done with it
        }
      }
      __syncwarp(gmask);
      if (reset && lane == 0) {
        const float lx_n = s_dot[s * N_CURVES], lz_n = s_dot[s * N_CURVES + 1];
        const float linv = 1.0f / sqrtf(lx_n * lx_n + 1.0f + lz_n * lz_n);
        R(drb + DR_LX) = lx_n * linv;
        R(drb + DR_LY) = -linv;
        R(drb + DR_LZ) = lz_n * linv;
        float vis = 0.0f;
        for (int k = 0; k < t.n_opt; ++k)
          vis = vis + (u01(rng_i, env_i, 17 + k) < 0.5f
                           ? static_cast<float>(1 << k) : 0.0f);
        R(drb + DR_OBJVIS) = vis;
      }
    }
  }
  __syncthreads();
  if (j_io < ne) {
#pragma unroll 4
    for (int f = f_io; f < nf; f += G)
      out[f * B + e0 + j_io] = f < f_end ? slab[f * E + j_io] : 0.0f;
  }
}

}  // namespace

extern "C" int dtown_state_step(const float* blob, const float* act,
                                float* out, const int* words,
                                const float* ct, const float* ot,
                                const float* bank, const float* prm,
                                const float* npc, const int* colmap,
                                const float* drp, const int* n_ok_v,
                                const int* n_driv, const float* goal, int B,
                                int nf, int n_tiles, int Hg, int Wg, int M,
                                int frame_skip, int use_wm,
                                int auto_reset, int n_npc, int dr, int n_opt,
                                int n_maps, int t_pad, int npw,
                                int nav, int goal_k, int group, int E,
                                int smem, void* stream) {
  // the launch shape from Python must be this build's; the shared bytes
  // say whether the tables are staged
  const int n_words = n_maps > 1 ? n_maps * npw : (Hg * Wg + 3) / 4;
  const int staged =
      smem == 4 * shared_words(nf, M, n_npc, n_words, E, true);
  if (group != G || E < 1 || E * G > THREADS || n_maps < 1
      || (!staged
          && smem != 4 * shared_words(nf, M, n_npc, n_words, E, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  t.words = words;
  t.ct = ct;
  t.ot = ot;
  t.bank = bank;
  t.npc = npc;
  t.colmap = colmap;
  t.drp = drp;
  t.prm = prm;
  t.n_tiles = n_tiles;
  t.Hg = Hg;
  t.Wg = Wg;
  t.M = M;
  t.n_npc = n_npc;
  t.dr = dr;
  t.n_opt = n_opt;
  t.n_ok_v = n_ok_v;
  t.n_driv = n_driv;
  t.goal = goal;
  t.n_maps = n_maps;
  t.t_pad = t_pad;
  t.npw = npw;
  t.goal_k = goal_k;
  const int blocks = (B + E - 1) / E;
  auto st = static_cast<cudaStream_t>(stream);
  // Nav and a stack of more than one map pick the specialisation
  switch ((nav ? 2 : 0) | (n_maps > 1 ? 1 : 0)) {
#define DT_LAUNCH(k, N, M_)                                                \
  case k: {                                                                \
    auto kern = state_step_kernel<N, M_>;                                  \
    if (smem > 48 * 1024) {                                                \
      const cudaError_t err = cudaFuncSetAttribute(                        \
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);        \
      if (err != cudaSuccess) return static_cast<int>(err);               \
    }                                                                      \
    kern<<<blocks, E * G, smem, st>>>(blob, act, out, t, B, nf, E,         \
                                      n_words, staged, frame_skip, use_wm, \
                                      auto_reset);                         \
    break;                                                                 \
  }
    DT_LAUNCH(0, false, false)
    DT_LAUNCH(1, false, true)
    DT_LAUNCH(2, true, false)
    DT_LAUNCH(3, true, true)
#undef DT_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
