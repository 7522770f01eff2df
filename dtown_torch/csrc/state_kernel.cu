// Fused state step for Hopper (sm_90a): one thread per env.
//
// Replaces the Pallas TPU kernel dtown/ops/state_kernel.py::
// make_state_kernel (launched by state_step_pallas): the agent, the moving
// NPCs (walking duckies, pure-pursuit duckiebots), collision against live
// NPC footprints and the optional objects of a domain-randomized env, the
// auto-reset with NPC re-placement and the DR redraw, stacked multimaps
// (every lookup offset by the env's map index) and the Nav task (goal
// check, optional distance shaping, goal redraw at reset). The plain version
// is dtown_torch/ops/state_kernel.py::state_step_reference; this file keeps
// its float32 operation order step for step.
//
// What bounds it on the card: latency, then operations. Per env the step
// reads and writes one blob column (32-64 floats each way) plus two
// actions; a static map costs a few thousand scalar operations an env, and
// each duckiebot adds two more lane queries per substep. At 4096 envs that
// is ~1-2 MB of traffic and a few million operations, so launch latency
// and the dependent table loads dominate.
//
// Design:
//  * The field-major blob [NF, B] is kept: thread e reads blob[f*B + e],
//    so a warp's loads and stores of one field are coalesced.
//  * The TPU kernel's `table_T @ onehot_T` matmul gathers become indexed
//    loads through the read-only path (__ldg): the curve table of the tile
//    under the query point (184 x T floats), the object table (24 x M),
//    the spawn bank (8 x 512) and the packed tile words. They are small
//    (18 KB for loop_obstacles' curve table) and stay in L1/L2.
//  * 128 threads a block, so 4096 envs fill 32 blocks (the TPU kernel's
//    512-env programs would leave most of the 132 SMs idle).
//  * NPC state lives in small per-thread arrays for up to MAX_NPC = 8
//    NPCs. Past that (a stack concatenates its members' NPCs, so any count
//    can occur) the state machines read and write the NPC rows of the
//    output blob in place instead, with the same reads and writes in the
//    same order, so the rows come out the same bits; a third template flag
//    (MANY) keeps the register path's code as it was. The NPC descriptors
//    come from a float table [8, n_npc] and each object column carries
//    its NPC index and optional-object bit (colmap), so one binary serves
//    every map. The agent and the duckiebots share one lane_query.
//  * A stack of maps arrives as its members' tables concatenated: the
//    word index gains mi * npw, the curve column mi * t_pad, the spawn pick
//    mi * BANK_K and the goal pick mi * goal_k, where mi is the env's map
//    row; each object column carries its member map (colmap row 2) and
//    another map's column is skipped. Envs of one warp sit on different
//    maps (round-robin assignment), so that skip diverges; it is exact.
//  * Nav, multimap and MANY are template parameters (eight kernels): the
//    single map static path compiles without their registers, as before.
//  * The DR redraw's multiply-adds are fmaf: the reference, as XLA builds
//    it, contracts them (the plain version emulates the FMA in float64).
//  * The integer hash computes +, << and ^ in uint32_t (defined
//    wraparound) and each >> as an arithmetic shift of the int32 value,
//    which is the reference's int32 semantics.
//  * Built with -fmad=false and without fast math (_build.py): each op rounds
//    once, as in the plain version, so the discrete rows (done, collision,
//    in-lane, step, rng) agree exactly and the pose rows to the bit.
#include <cstdint>
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
constexpr int F_OLDEG = 24, F_OINLANE = 25, F_MAPID = 26, N_OUT = 27;
constexpr int F_NPC_BASE = 27, NPC_ROWS = 5;
// DR rows, relative to dr_base
constexpr int DR_FOV = 0, DR_CAMH = 1, DR_CAMA = 2, DR_CAMF = 3, DR_LX = 4;
constexpr int DR_LY = 5, DR_LZ = 6, DR_AMB = 7, DR_GR = 8, DR_HR = 11;
constexpr int DR_TEXSEED = 14, DR_OBJVIS = 15, DR_ROWS = 16;
// (lo, span) pairs of the DR redraw (state_kernel.py DR_TAGS order)
constexpr int D_RS = 0, D_WD = 1, D_FOV = 2, D_CAMH = 3, D_CAMA = 4;
constexpr int D_CAMF = 5, D_AMB = 6, D_G = 7, D_H = 10;
// NPC table rows (state_kernel.py NPC_*)
constexpr int NPC_KIND = 0, NPC_X0 = 1, NPC_Z0 = 2, NPC_A0 = 3, NPC_HW = 4;
constexpr int NPC_HL = 5, NPC_RAD = 6, NPC_WALK = 7, NPC_DUCKIE = 0;
constexpr int MAX_NPC = 8;

// curve table rows
constexpr int N_CURVES = 12, CT_CPS = 0, CT_CHX = 144, CT_CHZ = 156;
constexpr int CT_VALID = 168;
// object table rows
constexpr int OT_CX = 0, OT_NX = 8, OT_PX = 12, OT_PZ = 13, OT_RAD = 14;
constexpr int OT_ACT = 15, OT_DYN = 16;
// spawn bank rows
constexpr int BK_X = 0, BK_Y = 1, BK_Z = 2, BK_ANG = 3, BK_LDIST = 4;
constexpr int BK_LDOT = 5, BK_LDEG = 6, BK_INLANE = 7, BANK_K = 512;
// scalar parameters (state_kernel.py _PARAM_NAMES)
constexpr int P_DT = 0, P_INV_DT = 1, P_KR = 2, P_KL = 3, P_RADIUS = 4;
constexpr int P_LIMIT = 5, P_MAX_STEPS = 6, P_CAM_BACK = 7, P_HW = 8;
constexpr int P_HL = 9, P_TS_INV = 10, P_AGENT_RAD = 11, P_NAV_COEF = 12;

constexpr int BEZIER_ITERS = 8;
constexpr int THREADS = 128;
constexpr int SALT_SPAWN = 0x20000000, SALT_GOAL = 0x40000000;
constexpr float NAV_GOAL_REWARD = 500.0f;
constexpr int SALT_U01 = 0x10000000, TAG_STEP = 0x3779B9;
constexpr int SALT_DUCKIE = 0x30000000, NPC_STEP = 0x611C9;

struct Tables {
  const int* words;
  const float* ct;
  const float* ot;
  const float* bank;
  const float* npc;    // [8, n_npc]
  const int* colmap;   // [3, M]: NPC index, optional bit (-1: none), map
  const float* drp;    // DR (lo, span) pairs
  const int* n_ok_v;   // [n_maps] accepted-bank count of each member
  const int* n_driv;   // [n_maps] drivable-tile count of each member (Nav)
  const float* goal;   // [8, n_maps * goal_k] drivable tiles (Nav)
  int n_tiles;         // the curve table's width (n_maps * t_pad)
  int Hg, Wg, M, n_npc, dr, n_opt, n_maps, t_pad, npw, goal_k;
  float ts_inv;
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

// per-(env, episode, tag) uniform in [0, 1) from the integer hash
__device__ __forceinline__ float u01(int32_t rng, int32_t env, int tag) {
  const int32_t hv = hash_u32(rng, env, SALT_U01 + tag * TAG_STEP);
  return static_cast<float>(hv & 0xFFFF) / 65536.0f;
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

// Drivability of the tile under (px, pz); also returns the clipped tile id.
// woff is the env's word segment (mi * npw on a stack, else 0).
__device__ __forceinline__ bool drivable_at(const Tables& t, float px,
                                            float pz, int woff,
                                            int* tid_out) {
  const float fi = floorf(px * t.ts_inv);
  const float fj = floorf(pz * t.ts_inv);
  const bool ing = (fi >= 0.0f) & (fi < static_cast<float>(t.Wg))
                   & (fj >= 0.0f) & (fj < static_cast<float>(t.Hg));
  const int ii = min(max(static_cast<int>(fi), 0), t.Wg - 1);
  const int jj = min(max(static_cast<int>(fj), 0), t.Hg - 1);
  const int tid = jj * t.Wg + ii;
  const int word = __ldg(t.words + woff + (tid >> 2));
  const int kind = (word >> ((tid & 3) * 8)) & 0xF;
  *tid_out = tid;
  return ing & (kind >= 1) & (kind <= 6);  // TILE_STRAIGHT..TILE_4WAY
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

// closest_curve_point on the tile's curve package: chord-dot curve select,
// fixed-depth bisection; returns point, unit tangent, best chord dot.
__device__ void lane_query(const Tables& t, int tid, float qx, float qz,
                           float qdx, float qdz, float* px_c, float* pz_c,
                           float* tanx_o, float* tanz_o, float* best_o) {
  const float* col = t.ct + tid;
  const int T = t.n_tiles;
  float best_dot = -1e30f;
  float cps[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < N_CURVES; ++c) {
    float dot = __ldg(col + (CT_CHX + c) * T) * qdx
                + __ldg(col + (CT_CHZ + c) * T) * qdz;
    if (!(__ldg(col + (CT_VALID + c) * T) > 0.5f)) dot = -1e30f;
    if (dot > best_dot) {
      best_dot = dot;
      for (int k = 0; k < 8; ++k)
        cps[k] = __ldg(col + (CT_CPS + c * 12 + k) * T);
    }
  }
  const Bez b{cps[0], cps[1], cps[2], cps[3], cps[4], cps[5], cps[6],
              cps[7]};
  float t_bot = 0.0f, t_top = 1.0f;
  for (int it = 0; it < BEZIER_ITERS; ++it) {
    const float mid = 0.5f * (t_bot + t_top);
    float bx, bz, tx, tz;
    b.point(t_bot, &bx, &bz);
    b.point(t_top, &tx, &tz);
    const float ebx = bx - qx, ebz = bz - qz;
    const float etx = tx - qx, etz = tz - qz;
    const bool keep_bot = (ebx * ebx + ebz * ebz) < (etx * etx + etz * etz);
    const float nb = keep_bot ? t_bot : mid;
    const float nt = keep_bot ? mid : t_top;
    t_bot = nb;
    t_top = nt;
  }
  const float ts = 0.5f * (t_bot + t_top);
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
  *best_o = best_dot;
}

template <bool NAV, bool MULTI, bool MANY>
__global__ void __launch_bounds__(THREADS)
state_step_kernel(const float* __restrict__ blob,
                  const float* __restrict__ act, float* __restrict__ out,
                  Tables t, const float* __restrict__ prm, int B, int nf,
                  int frame_skip, int use_wm, int auto_reset) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B) return;
  t.ts_inv = __ldg(prm + P_TS_INV);
  const float dt = __ldg(prm + P_DT);
  const float hw = __ldg(prm + P_HW);
  const float hl = __ldg(prm + P_HL);
  auto row = [&](int f) { return blob[f * B + e]; };
  const int n_npc = t.n_npc;
  const int drb = F_NPC_BASE + NPC_ROWS * n_npc;

  float pos_x = row(F_POS_X), pos_y = row(F_POS_Y), pos_z = row(F_POS_Z);
  float angle = row(F_ANGLE);
  const float act0 = act[2 * e], act1 = act[2 * e + 1];
  float robot_speed = row(F_ROBOT_SPEED);
  float wheel_dist = row(F_WHEEL_DIST);
  float step_cnt = row(F_STEP);
  const float rng_ctr = row(F_RNG);
  const float env_id = row(F_ENVID);
  const float map_row = row(F_MAPID);
  const int32_t rng_i = static_cast<int32_t>(rng_ctr);
  const int32_t env_i = static_cast<int32_t>(env_id);
  const int objvis = t.dr ? static_cast<int>(row(drb + DR_OBJVIS)) : 0;
  // the env's member of a stack and its table segments
  const int mi = MULTI ? static_cast<int>(map_row) : 0;
  const int woff = MULTI ? mi * t.npw : 0;
  const int toff = MULTI ? mi * t.t_pad : 0;
  const int navb = drb + (t.dr ? DR_ROWS : 0);
  float goal_i = 0.0f, goal_j = 0.0f;
  if (NAV) {
    goal_i = row(navb);
    goal_j = row(navb + 1);
  }
  const float pos_x_pre = pos_x, pos_z_pre = pos_z;

  // ---- wheel model ----------------------------------------------------
  float u_l, u_r;
  if (use_wm) {
    const float radius = __ldg(prm + P_RADIUS);
    const float limit = __ldg(prm + P_LIMIT);
    const float omega_r = (act0 + 0.5f * act1 * wheel_dist) / radius;
    const float omega_l = (act0 - 0.5f * act1 * wheel_dist) / radius;
    u_r = clampf(omega_r * __ldg(prm + P_KR), -limit, limit);
    u_l = clampf(omega_l * __ldg(prm + P_KL), -limit, limit);
  } else {
    u_l = act0;
    u_r = act1;
  }
  u_l = clampf(u_l, -1.0f, 1.0f);
  u_r = clampf(u_r, -1.0f, 1.0f);
  float vl = u_l * robot_speed;
  float vr = u_r * robot_speed;

  // ---- differential-drive integration ----------------------------------
  float speed = 0.0f;
  for (int fs = 0; fs < frame_skip; ++fs) {
    float s_a, c_a;
    dt_sincos(angle, &s_a, &c_a);
    float new_x = pos_x, new_z = pos_z, new_angle = angle;
    drive(&new_x, &new_z, &new_angle, s_a, c_a, vl, vr, wheel_dist, dt);
    const float ddx = new_x - pos_x;
    const float ddz = new_z - pos_z;
    speed = sqrtf(ddx * ddx + ddz * ddz) * __ldg(prm + P_INV_DT);
    pos_x = new_x;
    pos_z = new_z;
    angle = new_angle;
  }
  step_cnt = step_cnt + static_cast<float>(frame_skip);

  float s_a, c_a;
  dt_sincos(angle, &s_a, &c_a);
  const float dir_x = c_a, dir_z = -s_a;
  const float right_x = s_a, right_z = c_a;

  // ---- drivability ------------------------------------------------------
  const float cam_back = __ldg(prm + P_CAM_BACK);
  const float acx = pos_x + cam_back * dir_x;
  const float acz = pos_z + cam_back * dir_z;
  int tid_pos, tid_tmp;
  const bool d_c = drivable_at(t, pos_x, pos_z, woff, &tid_pos);
  const bool d_c2 = drivable_at(t, acx, acz, woff, &tid_tmp);
  const bool d_l = drivable_at(t, acx - hw * right_x, acz - hw * right_z,
                               woff, &tid_tmp);
  const bool d_r = drivable_at(t, acx + hw * right_x, acz + hw * right_z,
                               woff, &tid_tmp);
  const bool d_f = drivable_at(t, acx + hl * dir_x, acz + hl * dir_z, woff,
                               &tid_tmp);
  const bool all_driv = d_c2 & d_l & d_r & d_f;

  // ---- moving-NPC state machines (objects.py semantics) -----------------
  // NPC i's state: registers up to MAX_NPC NPCs, else (MANY) its rows of
  // the output blob, read and written in place (row f of env e at f*B + e:
  // a warp's accesses of one row are coalesced)
  float npc_x[MAX_NPC], npc_z[MAX_NPC], npc_a[MAX_NPC], npc_w[MAX_NPC];
  float npc_v[MAX_NPC];
  auto NS = [&](float* reg, int r, int i) -> float& {
    if constexpr (MANY) {
      return out[(F_NPC_BASE + NPC_ROWS * i + r) * B + e];
    } else {
      return reg[i];
    }
  };
  auto N = [&](int r, int i) { return __ldg(t.npc + r * n_npc + i); };
  for (int i = 0; i < n_npc; ++i) {
    const int base = F_NPC_BASE + NPC_ROWS * i;
    NS(npc_x, 0, i) = row(base + 0);
    NS(npc_z, 1, i) = row(base + 1);
    NS(npc_a, 2, i) = row(base + 2);
    NS(npc_w, 3, i) = row(base + 3);
    NS(npc_v, 4, i) = row(base + 4);
  }
  for (int fs = 0; fs < (n_npc > 0 ? frame_skip : 0); ++fs) {
    for (int i = 0; i < n_npc; ++i) {
      float nx = NS(npc_x, 0, i), nz = NS(npc_z, 1, i);
      float na = NS(npc_a, 2, i), nw = NS(npc_w, 3, i);
      const float nv = NS(npc_v, 4, i);
      float s_n, c_n;
      dt_sincos(na, &s_n, &c_n);
      if (static_cast<int>(N(NPC_KIND, i)) == NPC_DUCKIE) {
        // walk along the heading, reverse after walk_dist
        const float step_len = nv * dt;
        nx = nx + step_len * c_n;
        nz = nz - step_len * s_n;
        nw = nw + step_len;
        const bool rev = nw > N(NPC_WALK, i);
        na = rev ? na + DT_F(3.14159265358979323846) : na;
        nw = rev ? 0.0f : nw;
      } else {
        // scripted duckiebot: pure pursuit on two chained lane queries
        const float bdx = c_n, bdz = -s_n;
        int tq;
        const bool drv1 = drivable_at(t, nx, nz, woff, &tq);
        float cpx, cpz, ctx, ctz, bd1;
        lane_query(t, toff + tq, nx, nz, bdx, bdz, &cpx, &cpz, &ctx, &ctz,
                   &bd1);
        const float fpx = cpx + DT_F(0.30) * ctx;
        const float fpz = cpz + DT_F(0.30) * ctz;
        const bool drv2 = drivable_at(t, fpx, fpz, woff, &tq);
        float gpx, gpz, gtx, gtz, bd2;
        lane_query(t, toff + tq, fpx, fpz, bdx, bdz, &gpx, &gpz, &gtx, &gtz,
                   &bd2);
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
      NS(npc_x, 0, i) = nx;
      NS(npc_z, 1, i) = nz;
      NS(npc_a, 2, i) = na;
      NS(npc_w, 3, i) = nw;
    }
  }

  // ---- SAT collision + proximity ----------------------------------------
  bool collided = false;
  float prox_static = 1e30f;
  float prox_dyn = 0.0f;
  if (t.M > 0) {
    float agx[4], agz[4];
    const float sfs[4] = {-hl, hl, hl, -hl};
    const float srs[4] = {hw, hw, -hw, -hw};
    for (int i = 0; i < 4; ++i) {
      agx[i] = acx + sfs[i] * dir_x + srs[i] * right_x;
      agz[i] = acz + sfs[i] * dir_z + srs[i] * right_z;
    }
    const float agent_rad = __ldg(prm + P_AGENT_RAD);
    for (int m = 0; m < t.M; ++m) {
      // a stack's object exists on its own member map only
      if (MULTI && __ldg(t.colmap + 2 * t.M + m) != mi) continue;
      auto O = [&](int r) { return __ldg(t.ot + r * t.M + m); };
      const int ni = __ldg(t.colmap + m);
      const int kbit = __ldg(t.colmap + t.M + m);
      float ocx[4], ocz[4], axs[4], azs[4], o_px, o_pz, o_rad;
      bool o_act, o_dyn;
      axs[0] = dir_x;
      azs[0] = dir_z;
      axs[1] = right_x;
      azs[1] = right_z;
      if (ni >= 0) {
        // live NPC footprint (objects.py::dynamic_corners)
        const float nx = NS(npc_x, 0, ni), nz = NS(npc_z, 1, ni);
        float s_n, c_n;
        dt_sincos(NS(npc_a, 2, ni), &s_n, &c_n);
        const float fx_n = c_n, fz_n = -s_n, rx_n = s_n, rz_n = c_n;
        const float hw_n = N(NPC_HW, ni), hl_n = N(NPC_HL, ni);
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
        o_rad = N(NPC_RAD, ni);
        o_act = true;
        o_dyn = true;
      } else {
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
      bool separated = false;
      for (int a = 0; a < 4; ++a) {
        const float ax = axs[a], az = azs[a];
        float amin = 0.f, amax = 0.f, bmin = 0.f, bmax = 0.f;
        for (int i = 0; i < 4; ++i) {
          const float pa = agx[i] * ax + agz[i] * az;
          amin = i == 0 ? pa : fminf(amin, pa);
          amax = i == 0 ? pa : fmaxf(amax, pa);
          const float pb = ocx[i] * ax + ocz[i] * az;
          bmin = i == 0 ? pb : fminf(bmin, pb);
          bmax = i == 0 ? pb : fmaxf(bmax, pb);
        }
        separated = separated | (amax < bmin) | (bmax < amin);
      }
      collided = collided | (!separated & o_act);
      const float dxo = o_px - acx;
      const float dzo = o_pz - acz;
      const float dist_o = sqrtf(dxo * dxo + dzo * dzo);
      const float score = dist_o - agent_rad - o_rad;
      if (o_act & !o_dyn) prox_static = fminf(prox_static, score);
      if (o_act & o_dyn) prox_dyn = prox_dyn + fminf(score, 0.0f);
    }
  }
  const float col_penalty = fminf(prox_static, 0.0f) + prox_dyn;
  const bool valid = all_driv & !collided;

  // ---- lane position ------------------------------------------------------
  float px_c, pz_c, tanx, tanz, best_dot;
  lane_query(t, toff + tid_pos, pos_x, pos_z, dir_x, dir_z, &px_c, &pz_c,
             &tanx, &tanz, &best_dot);
  const float dot_dir = clampf(dir_x * tanx + dir_z * tanz, -1.0f, 1.0f);
  const float rox = -tanz;
  const float roz = tanx;
  const float signed_dist = (pos_x - px_c) * rox + (pos_z - pz_c) * roz;
  float ang_rad = dt_acos(dot_dir);
  if (dir_x * rox + dir_z * roz < 0.0f) ang_rad = -ang_rad;
  const bool in_lane = d_c & (best_dot > 0.0f);

  // ---- reward / done ------------------------------------------------------
  const float reward_full = 1.0f * speed * dot_dir
                            + -10.0f * fabsf(signed_dist)
                            + 40.0f * col_penalty;
  const float reward_alive = in_lane ? reward_full : 40.0f * col_penalty;
  const bool crashed = !valid;
  const bool truncated = step_cnt >= __ldg(prm + P_MAX_STEPS);
  bool done = crashed | truncated;
  float reward = crashed ? -1000.0f : reward_alive;
  if (NAV) {
    // goal check on the post-step tile of a live episode
    const bool reached = (floorf(pos_x * t.ts_inv) == goal_i)
                         & (floorf(pos_z * t.ts_inv) == goal_j) & !done;
    if (reached) reward = reward + NAV_GOAL_REWARD;
    const float coef = __ldg(prm + P_NAV_COEF);
    if (coef != 0.0f) {
      // potential-based goal-distance shaping
      const float ts_k = 1.0f / t.ts_inv;
      const float gx = (goal_i + 0.5f) * ts_k;
      const float gz = (goal_j + 0.5f) * ts_k;
      float ex = gx - pos_x_pre, ez = gz - pos_z_pre;
      const float d_prev = sqrtf(ex * ex + ez * ez);
      ex = gx - pos_x;
      ez = gz - pos_z;
      const float d_next = sqrtf(ex * ex + ez * ez);
      reward = reward + coef * (d_prev - d_next);
    }
    done = done | reached;
  }

  // ---- auto-reset from the spawn bank --------------------------------------
  const float lane_deg = ang_rad * DT_F(180.0 / 3.14159265358979323846);
  const float in_lane_f = in_lane ? 1.0f : 0.0f;
  float o_ldist = signed_dist, o_ldot = dot_dir, o_ldeg = lane_deg;
  float o_inlane = in_lane_f;
  float drr[DR_ROWS];
  if (t.dr)
    for (int k = 0; k < DR_ROWS; ++k) drr[k] = row(drb + k);
  if (auto_reset && done) {
    const int32_t h = hash_u32(rng_i, env_i, SALT_SPAWN);
    // within the env's member segment of the bank (mi = 0 on one map)
    const int sidx = mi * BANK_K + h % max(__ldg(t.n_ok_v + mi), 1);
    const int bank_w = t.n_maps * BANK_K;
    auto S = [&](int r) { return __ldg(t.bank + r * bank_w + sidx); };
    pos_x = S(BK_X);
    pos_y = S(BK_Y);
    pos_z = S(BK_Z);
    angle = S(BK_ANG);
    speed = 0.0f;
    vl = 0.0f;
    vr = 0.0f;
    step_cnt = 0.0f;
    o_ldist = S(BK_LDIST);
    o_ldot = S(BK_LDOT);
    o_ldeg = S(BK_LDEG);
    o_inlane = S(BK_INLANE);
    if (NAV) {
      // a fresh goal: a uniform drivable tile of the env's map
      const int32_t hg = hash_u32(rng_i, env_i, SALT_GOAL);
      const int gidx = mi * t.goal_k + hg % max(__ldg(t.n_driv + mi), 1);
      goal_i = __ldg(t.goal + gidx);
      goal_j = __ldg(t.goal + t.n_maps * t.goal_k + gidx);
    }
    // NPCs re-place at their initial poses; a duckie's walk speed is
    // redrawn ~N(0.02, 0.005) (Irwin-Hall sum of 4 hashed uniforms)
    for (int i = 0; i < n_npc; ++i) {
      NS(npc_x, 0, i) = N(NPC_X0, i);
      NS(npc_z, 1, i) = N(NPC_Z0, i);
      NS(npc_a, 2, i) = N(NPC_A0, i);
      NS(npc_w, 3, i) = 0.0f;
      if (static_cast<int>(N(NPC_KIND, i)) == NPC_DUCKIE) {
        float usum = 0.0f;
        for (int j = 0; j < 4; ++j) {
          const int32_t hv = hash_u32(
              rng_i, env_i, SALT_DUCKIE + j * TAG_STEP + i * NPC_STEP);
          usum = usum + static_cast<float>(hv & 0xFFFF) / 65536.0f;
        }
        const float ih_scale = static_cast<float>(1.7320508f * 0.005f);
        NS(npc_v, 4, i) = fmaxf(fmaf(usum - 2.0f, ih_scale, DT_F(0.02)),
                                0.001f);
      }
    }
    if (t.dr) {
      // redraw every randomization row of a fresh episode
      auto rdw = [&](int d, int tag) {
        return fmaf(u01(rng_i, env_i, tag), __ldg(t.drp + 2 * d + 1),
                    __ldg(t.drp + 2 * d));
      };
      robot_speed = rdw(D_RS, 1);
      wheel_dist = rdw(D_WD, 2);
      drr[DR_FOV] = rdw(D_FOV, 3);
      drr[DR_CAMH] = rdw(D_CAMH, 4);
      drr[DR_CAMA] = rdw(D_CAMA, 5);
      drr[DR_CAMF] = rdw(D_CAMF, 6);
      const float lx_n = fmaf(u01(rng_i, env_i, 7), DT_F(0.8), -1.0f);
      const float lz_n = fmaf(u01(rng_i, env_i, 8), DT_F(0.8), -1.0f);
      const float linv = 1.0f / sqrtf(lx_n * lx_n + 1.0f + lz_n * lz_n);
      drr[DR_LX] = lx_n * linv;
      drr[DR_LY] = -linv;
      drr[DR_LZ] = lz_n * linv;
      drr[DR_AMB] = rdw(D_AMB, 9);
      for (int c = 0; c < 3; ++c) {
        drr[DR_GR + c] = rdw(D_G + c, 10 + c);
        drr[DR_HR + c] = rdw(D_H + c, 13 + c);
      }
      drr[DR_TEXSEED] = floorf(u01(rng_i, env_i, 16) * 8388608.0f);
      float vis = 0.0f;
      for (int k = 0; k < t.n_opt; ++k)
        vis = vis + (u01(rng_i, env_i, 17 + k) < 0.5f
                         ? static_cast<float>(1 << k) : 0.0f);
      drr[DR_OBJVIS] = vis;
    }
  }
  if (auto_reset && t.dr) {
    // the reference clips the colour rows of every env, reset or not
    for (int c = 0; c < 3; ++c) {
      drr[DR_GR + c] = clampf(drr[DR_GR + c], 0.0f, 1.0f);
      drr[DR_HR + c] = clampf(drr[DR_HR + c], 0.0f, 1.0f);
    }
  }

  const float rows[N_OUT] = {
      pos_x, pos_y, pos_z, angle, speed, vl, vr, step_cnt, rng_ctr + 1.0f,
      robot_speed, wheel_dist, act0, act1, reward, done ? 1.0f : 0.0f,
      signed_dist, dot_dir, lane_deg, in_lane_f, collided ? 1.0f : 0.0f,
      step_cnt * dt, env_id, o_ldist, o_ldot, o_ldeg, o_inlane, map_row};
#pragma unroll
  for (int f = 0; f < N_OUT; ++f) out[f * B + e] = rows[f];
  for (int i = 0; i < (MANY ? 0 : n_npc); ++i) {
    // (MANY: the rows are in place already)
    const int base = F_NPC_BASE + NPC_ROWS * i;
    out[(base + 0) * B + e] = npc_x[i];
    out[(base + 1) * B + e] = npc_z[i];
    out[(base + 2) * B + e] = npc_a[i];
    out[(base + 3) * B + e] = npc_w[i];
    out[(base + 4) * B + e] = npc_v[i];
  }
  int f_end = drb;
  if (t.dr) {
    for (int k = 0; k < DR_ROWS; ++k) out[(drb + k) * B + e] = drr[k];
    f_end = drb + DR_ROWS;
  }
  if (NAV) {
    out[navb * B + e] = goal_i;
    out[(navb + 1) * B + e] = goal_j;
    f_end = navb + 2;
  }
  for (int f = f_end; f < nf; ++f) out[f * B + e] = 0.0f;
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
                                int nav, int goal_k, int npc_rows,
                                void* stream) {
  // more than MAX_NPC NPCs need their state in the blob rows (npc_rows)
  if ((n_npc > MAX_NPC && !npc_rows) || n_maps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Tables t;
  t.words = words;
  t.ct = ct;
  t.ot = ot;
  t.bank = bank;
  t.npc = npc;
  t.colmap = colmap;
  t.drp = drp;
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
  t.ts_inv = 0.0f;  // read from prm inside the kernel
  const int blocks = (B + THREADS - 1) / THREADS;
  auto st = static_cast<cudaStream_t>(stream);
  // nav, a stack of more than one map and NPC state in the blob rows pick
  // the specialisation
  switch ((npc_rows ? 4 : 0) | (nav ? 2 : 0) | (n_maps > 1 ? 1 : 0)) {
#define DT_LAUNCH(k, N, M_, R)                                           \
  case k:                                                                \
    state_step_kernel<N, M_, R><<<blocks, THREADS, 0, st>>>(             \
        blob, act, out, t, prm, B, nf, frame_skip, use_wm, auto_reset);  \
    break;
    DT_LAUNCH(0, false, false, false)
    DT_LAUNCH(1, false, true, false)
    DT_LAUNCH(2, true, false, false)
    DT_LAUNCH(3, true, true, false)
    DT_LAUNCH(4, false, false, true)
    DT_LAUNCH(5, false, true, true)
    DT_LAUNCH(6, true, false, true)
    DT_LAUNCH(7, true, true, true)
#undef DT_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
