// Row-fed RGB render for Hopper (sm_90a): a block per env and pixel chunk,
// a per-block prologue in shared memory, a bounding-sphere test per pixel
// and object, deferred shading, four pixels a thread.
//
// Replaces the two Pallas TPU kernels of dtown/render/pallas_raster.py
// that render_frames_pallas launches:
//  * row_render_static_kernel <- _make_kernel_static (K3, defined at :861,
//    launched at :755; the static scene baked into the TPU kernel);
//  * row_render_kernel        <- _make_kernel (K4, defined at :326,
//    launched at :773; per-env rows of the Kvis nearest objects and their
//    primitives).
// The plain versions are dtown_torch/render/row_raster.py::
// render_frames_static_reference and render_frames_rows_reference; this
// file keeps their float32 operation order.
//
// What bounds it on the card: issued instructions, not bytes. Each pixel
// normalizes its ray, hits the ground, shades the tile (analytic markings
// with AA, hash noise) and tests the primitives of the objects its env
// keeps: hundreds of scalar float32, integer and select instructions per
// pixel against 3 output bytes and a few hundred bytes of per-env rows.
// There is no matrix product (no tensor cores, no wgmma, no TMA), so the
// design removes instructions:
//
//  * A per-block prologue. Warp 0 evaluates each object once per env: its
//    keep flag (K3: the cull flag of the env's flag row; K4: the row's
//    active flag), the lamp colour of its phase (K3), the eye in model
//    space, each primitive's folded terms (a box's six slab offsets -q - oc
//    and q - oc, a sphere's oc and |oc|^2 - r^2) and the world bounding
//    sphere below. It compacts the kept objects in row order (warp ballot,
//    prefix sum of the primitive counts): the nearest-hit test
//    t_w < t_best is strict, so order decides ties. Each folded value is
//    computed by one thread with the same float32 operations in the same
//    order as the per-pixel code had (-fmad=false), so the bits do not
//    change. K4's padded slots (zero extents: a zero-radius sphere at the
//    model origin, which in float32 can still report a hit) stay in the
//    list, folded like any sphere. One __syncthreads, then the pixel loop
//    walks only the compacted list.
//  * A bounding-sphere test per pixel and kept object, in world space: a
//    sphere around the object's position whose radius is the reach of its
//    farthest primitive (|c| + r for a sphere, |c| + |(p0, p1, p2)| for a
//    box) times the scale, plus VIEW_PAD (1 cm) for float32 rounding. It
//    always contains the model origin, so it covers the padded slots. A
//    ray that misses it from outside cannot hit any of the object's
//    primitives at t > 1e-4, so the object's model ray and primitive tests
//    are skipped; an eye inside the sphere always tests. K4 computes the
//    radius in the prologue from the env's primitive rows; K3's scene
//    table carries it (SO_RB, baked on the host).
//  * Deferred shading. The primitive loop keeps only t_best, the winner's
//    index and its t_m under the same strict test in the same order; the
//    hit point, normal (K4's three divides included) and Lambert term are
//    computed once, for the winner. The shade is a pure function of the
//    winner's inputs and t_m, so the bytes are those of shading every hit.
//    1/dy is computed once a pixel, 1/dmx and 1/dmz only for objects that
//    hold a box.
//  * A block renders a chunk of one env's frame: the whole 64x64 frame, or
//    up to 4096 pixels of a larger one, so the prologue and the staging of
//    the camera row, the rows and the env's tile words in shared memory are
//    paid once per thousands of pixels; frames are split into smaller
//    chunks while the grid would hold fewer than about four waves of
//    blocks on 132 SMs (the blob render's rule).
//  * Four consecutive pixels a thread, one after another, each output
//    plane written as one 32-bit word of four packed bytes (P % 128 == 0
//    keeps the words aligned).
//  * __launch_bounds__(128, 8): at most 64 registers a thread, which both
//    kernels fit without spill (chip_smoke.py prints the ptxas report and
//    fails on a spill); more resident warps hide the latency of the
//    divergent object pass.
//  * The TPU kernels build the pixel ray from iota ramps, or under fisheye
//    from the inverted lens model's NDC table (_ndc_planes); here both
//    kernels read an NDC table [2, H*W] always: the linear ramps baked on
//    the host with the kernels' float ops, or the fisheye table. K3's
//    scene arrives as small tables (row_raster.pack_static_scene), so one
//    binary serves every map; the constants the reference folds in Python
//    doubles arrive folded in float64 and rounded once to float32, while K4
//    computes the same quantities in float32, as its TPU kernel does.
//  * Ground and sky come from tile_shading.cuh (shared with the blob
//    render). The reference's rsqrt is 1.0f / sqrtf here and in the plain
//    version; built with -fmad=false (see _build.py), so results match the
//    plain version bit for bit.
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
// resident blocks an SM is asked to hold (at most 64 registers a thread)
constexpr int RESIDENT = 8;
constexpr unsigned FULL = 0xffffffffu;
// camera row (row_raster.py C_*)
constexpr int CAM_F = 32;
constexpr int C_EYE = 0, C_FWD = 3, C_RIGHT = 6, C_UP = 9, C_TANX = 12;
constexpr int C_TANY = 13, C_SHADE = 14, C_GND = 15, C_HOR = 18;
constexpr int C_TSINV = 21, C_LIGHT = 22, C_AMB = 25;
// K4 rows: object pos(3) sin cos inv_scale scale active; primitive type
// cx cy cz p0 p1 p2 r g b
constexpr int OBJ_F = 8, PRIM_F = 10, P_MAX = 4;
constexpr int OB_ACTIVE = 7;
// K3 scene tables (row_raster.py SO_*, SOI_*, SP_*, SPI_*)
constexpr int SO_F = 8, SO_I = 2, SP_F = 13, SP_I = 2;
constexpr int SO_X = 0, SO_Y = 1, SO_Z = 2, SO_SR = 3, SO_CR = 4;
constexpr int SO_INVS = 5, SO_SC = 6, SO_RB = 7;
constexpr int SP_CX = 0, SP_CY = 1, SP_CZ = 2, SP_P0 = 3, SP_P1 = 4;
constexpr int SP_P2 = 5, SP_R = 6, SP_P0SQ = 9, SP_IP0 = 10;
constexpr int MAX_STATIC = 16;
#define VIEW_PAD DT_F(0.01)

struct Dims {
  int P, H, n_words, Hg, Wg, aa, any_x;
  int chunk;      // pixels a block renders
  int n_staged;   // tile words staged in shared memory (0: none)
};

// The object inputs of either kernel (the other kernel's pointers null).
struct Objs {
  // K3: per-env (cull, phase) flags and the shared scene tables
  const float* flags;
  const float* sof;
  const int* soi;
  const float* spf;
  const int* spi;
  // K4: per-env object and primitive rows
  const float* obj;
  const float* prim;
  int n;          // K3: scene objects; K4: Kvis row slots
};

// Shared-memory layout (dynamic shared memory), n = Objs::n object slots:
//   object:    oa = (c_r, s_r, osc, has a box),
//              ob = (emx, ey, emz, first prim | end prim << 16),
//              oc = (centre - eye, |centre - eye|^2 - radius^2),
//              od = (lamp colour (K3), 0)
//   box:       q0 = (-p0 - ocx, p0 - ocx, -p1 - ocy, tag),
//              q1 = (p1 - ocy, -p2 - ocz, p2 - ocz, 0)
//   sphere:    q0 = (ocx, ocy, ocz, tag), q1 = (|oc|^2 - r^2, 0, 0, 0)
// tag = the primitive's row (K4: slot * P_MAX + q; K3: its table row) << 1
// | is_box. Then the camera row, K4's object and primitive rows, and the
// staged tile words.
__host__ __device__ inline int raw_floats(bool stat, int n) {
  return stat ? 0 : n * (OBJ_F + P_MAX * PRIM_F);
}
__host__ inline size_t smem_bytes(bool stat, int n, int n_staged) {
  return sizeof(float4) * (4 + 2 * P_MAX) * static_cast<size_t>(n)
         + sizeof(float) * (CAM_F + raw_floats(stat, n))
         + sizeof(int) * static_cast<size_t>(n_staged);
}

__device__ __forceinline__ float safe_inv(float dm) {
  const float eps = DT_F(1e-9);
  const float d = fabsf(dm) < eps ? (dm >= 0.0f ? eps : -eps) : dm;
  return 1.0f / d;
}

__device__ __forceinline__ uint32_t to_u8(float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  return static_cast<uint32_t>(static_cast<int>(x * 255.0f + 0.5f)) & 0xFFu;
}

__device__ __forceinline__ float sgn(float q) {
  return q >= 0.0f ? 1.0f : -1.0f;
}

// A pixel after the ground pass: world ray, nearest hit so far, color.
struct Px {
  float dx, dy, dz, t_best, r, g, b;
};

// Ray setup, ground hit, tile shading and sky (row_raster._ground). k_fw
// is the env's AA footprint factor (0 without AA); words is the env's tile
// words (staged or global).
__device__ __forceinline__ Px ground_pass(const float* cam, const int* words,
                                          const float* __restrict__ ndc,
                                          int p, const Dims& d, float k_fw) {
  const float xn = __ldg(ndc + p) * cam[C_TANX];
  const float yn = __ldg(ndc + d.P + p) * cam[C_TANY];
  float dx = cam[C_FWD] + xn * cam[C_RIGHT] + yn * cam[C_UP];
  float dy = cam[C_FWD + 1] + xn * cam[C_RIGHT + 1] + yn * cam[C_UP + 1];
  float dz = cam[C_FWD + 2] + xn * cam[C_RIGHT + 2] + yn * cam[C_UP + 2];
  const float inv_n = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);
  dx = dx * inv_n;
  dy = dy * inv_n;
  dz = dz * inv_n;

  const float eye0 = cam[C_EYE], eye1 = cam[C_EYE + 1];
  const float eye2 = cam[C_EYE + 2];
  const bool hg = dy < -DT_F(1e-6);
  const float t_g = hg ? -eye1 / dy : DT_F(1e30);
  const float ts_inv = cam[C_TSINV];
  const float fx = (eye0 + t_g * dx) * ts_inv;
  const float fz = (eye2 + t_g * dz) * ts_inv;
  const float ti = floorf(fx);
  const float tj = floorf(fz);
  const bool in_grid = (ti >= 0.0f) & (ti < static_cast<float>(d.Wg))
                       & (tj >= 0.0f) & (tj < static_cast<float>(d.Hg)) & hg;
  // float -> int saturates on the device; the clamp keeps the id in range
  const int ii = min(max(static_cast<int>(ti), 0), d.Wg - 1);
  const int jj = min(max(static_cast<int>(tj), 0), d.Hg - 1);
  const int tid = jj * d.Wg + ii;
  const int word = words[tid >> 2];
  const int byte = (word >> ((tid & 3) * 8)) & 0xFF;
  const bool aa = d.aa != 0;
  const float inv_fw = aa ? dy * dy * k_fw : 0.0f;
  Px o;
  tile::shade_pixel(byte & 0xF, (byte >> 4) & 0x3, (byte >> 6) & 0x3,
                    fx - ti, fz - tj, d.any_x != 0, aa, inv_fw, &o.r, &o.g,
                    &o.b);
  const float shade = cam[C_SHADE];
  o.r = (in_grid ? o.r : cam[C_GND]) * shade;
  o.g = (in_grid ? o.g : cam[C_GND + 1]) * shade;
  o.b = (in_grid ? o.b : cam[C_GND + 2]) * shade;
  const float sky_f = 1.0f - DT_F(0.35) * fmaxf(dy, 0.0f);
  if (!hg) {
    o.r = cam[C_HOR] * sky_f;
    o.g = cam[C_HOR + 1] * sky_f;
    o.b = cam[C_HOR + 2] * sky_f;
  }
  o.dx = dx;
  o.dy = dy;
  o.dz = dz;
  o.t_best = hg ? t_g : DT_F(1e30);
  return o;
}

// The prologue (warp 0): the env's kept objects and their primitives,
// folded and compacted in row order into shared memory. Returns the kept
// objects' count (lane 0's value is used).
template <bool STATIC>
__device__ __forceinline__ int prologue(const Objs& s, int e,
                                        const float* cam, const float* s_obj,
                                        const float* s_prim, float4* s_oa,
                                        float4* s_ob, float4* s_oc,
                                        float4* s_od, float4* s_q0,
                                        float4* s_q1) {
  const int lane = threadIdx.x;
  const float eye0 = cam[C_EYE], eye1 = cam[C_EYE + 1];
  const float eye2 = cam[C_EYE + 2];
  const int n_flags = 2 * (s.n > 0 ? s.n : 1);
  int n_kept = 0, n_prim = 0;  // running totals (uniform in the warp)
  for (int o0 = 0; o0 < s.n; o0 += 32) {
    const int o = o0 + lane;
    bool keep = false;
    int j0 = 0, np = 0;
    if (o < s.n) {
      if (STATIC) {
        keep = __ldg(s.flags + static_cast<size_t>(e) * n_flags + 2 * o)
               > 0.5f;
        j0 = __ldg(s.soi + o * SO_I);
        np = __ldg(s.soi + o * SO_I + 1);
      } else {
        keep = s_obj[o * OBJ_F + OB_ACTIVE] > 0.5f;
        j0 = o * P_MAX;
        np = P_MAX;   // padded slots included
      }
    }
    const int np_keep = keep ? np : 0;
    // compaction in row order: the object's rank among the kept ones, its
    // primitives' offset (inclusive prefix sum over the lanes)
    const unsigned ball = __ballot_sync(FULL, keep);
    const int rank = __popc(ball & ((1u << lane) - 1u));
    int incl = np_keep;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, dd);
      if (lane >= dd) incl += v;
    }
    if (keep) {
      const int ko = n_kept + rank;
      const int k0 = n_prim + incl - np_keep;
      float ox, oy, oz, s_r, c_r, inv_s, osc, rb;
      float lr = 0.f, lg = 0.f, lb = 0.f;
      if (STATIC) {
        const float* ov = s.sof + o * SO_F;
        ox = __ldg(ov + SO_X);
        oy = __ldg(ov + SO_Y);
        oz = __ldg(ov + SO_Z);
        s_r = __ldg(ov + SO_SR);
        c_r = __ldg(ov + SO_CR);
        inv_s = __ldg(ov + SO_INVS);
        osc = __ldg(ov + SO_SC);
        rb = __ldg(ov + SO_RB);
        // the lamp colour of the env's phase
        const bool green =
            __ldg(s.flags + static_cast<size_t>(e) * n_flags + 2 * o + 1)
            > 0.5f;
        lr = green ? DT_F(0.1) : DT_F(0.9);
        lg = green ? DT_F(0.85) : DT_F(0.1);
        lb = green ? DT_F(0.15) : DT_F(0.1);
      } else {
        const float* ov = s_obj + o * OBJ_F;
        ox = ov[0];
        oy = ov[1];
        oz = ov[2];
        s_r = ov[3];
        c_r = ov[4];
        inv_s = ov[5];
        osc = ov[6];
        // the bounding radius from the env's primitive rows
        float r = 0.0f;
        for (int q = 0; q < P_MAX; ++q) {
          const float* pv = s_prim + (j0 + q) * PRIM_F;
          const float cl = sqrtf(pv[1] * pv[1] + pv[2] * pv[2]
                                 + pv[3] * pv[3]);
          const float reach =
              pv[0] > 0.5f ? sqrtf(pv[4] * pv[4] + pv[5] * pv[5]
                                   + pv[6] * pv[6])
                           : pv[4];
          r = fmaxf(r, cl + reach);
        }
        rb = r * osc + VIEW_PAD;
      }
      // the eye in model space (the per-pixel code's model_ray)
      const float ex = (eye0 - ox) * inv_s;
      const float ey = (eye1 - oy) * inv_s;
      const float ez = (eye2 - oz) * inv_s;
      const float emx = ex * c_r + ez * s_r;
      const float emz = ez * c_r - ex * s_r;
      bool has_box = false;
      for (int q = 0; q < np; ++q) {
        const int g = j0 + q;
        float cx, cy, cz, p0, p1, p2, r2;
        bool box;
        if (STATIC) {
          const float* pv = s.spf + g * SP_F;
          box = __ldg(s.spi + g * SP_I) != 0;
          cx = __ldg(pv + SP_CX);
          cy = __ldg(pv + SP_CY);
          cz = __ldg(pv + SP_CZ);
          p0 = __ldg(pv + SP_P0);
          p1 = __ldg(pv + SP_P1);
          p2 = __ldg(pv + SP_P2);
          r2 = __ldg(pv + SP_P0SQ);
        } else {
          const float* pv = s_prim + g * PRIM_F;
          box = pv[0] > 0.5f;
          cx = pv[1];
          cy = pv[2];
          cz = pv[3];
          p0 = pv[4];
          p1 = pv[5];
          p2 = pv[6];
          r2 = p0 * p0;
        }
        const float ocx = emx - cx, ocy = ey - cy, ocz = emz - cz;
        const float tag = __int_as_float((g << 1) | (box ? 1 : 0));
        const int k = k0 + q;
        if (box) {
          s_q0[k] = make_float4(-p0 - ocx, p0 - ocx, -p1 - ocy, tag);
          s_q1[k] = make_float4(p1 - ocy, -p2 - ocz, p2 - ocz, 0.0f);
        } else {
          const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
          s_q0[k] = make_float4(ocx, ocy, ocz, tag);
          s_q1[k] = make_float4(cq, 0.0f, 0.0f, 0.0f);
        }
        has_box = has_box || box;
      }
      s_oa[ko] = make_float4(c_r, s_r, osc, __int_as_float(has_box ? 1 : 0));
      s_ob[ko] = make_float4(emx, ey, emz,
                             __int_as_float(k0 | ((k0 + np) << 16)));
      // the bounding sphere's centre from the eye and |b|^2 - r^2
      const float bx = ox - eye0, by = oy - eye1, bz = oz - eye2;
      s_oc[ko] = make_float4(bx, by, bz,
                             bx * bx + by * by + bz * bz - rb * rb);
      s_od[ko] = make_float4(lr, lg, lb, 0.0f);
    }
    n_kept += __popc(ball);
    n_prim += __shfl_sync(FULL, incl, 31);
  }
  return n_kept;
}

// The winner's shade (the per-pixel code's hit point, normal and Lambert
// term, once): K4 divides by the extents in float32, K3 multiplies by the
// host-folded reciprocals, as the two TPU kernels do.
template <bool STATIC>
__device__ __forceinline__ void shade_winner(const Objs& s, const float* cam,
                                             const float* s_prim,
                                             const float4& oa,
                                             const float4& ob,
                                             const float4& od, int tag,
                                             float t_m, Px* px) {
  const float c_r = oa.x, s_r = oa.y;
  const float dmx = px->dx * c_r + px->dz * s_r;
  const float dmz = px->dz * c_r - px->dx * s_r;
  const int g = tag >> 1;
  const bool box = (tag & 1) != 0;
  float cx, cy, cz, cr, cg, cb;
  const float* pv = STATIC ? s.spf + g * SP_F : s_prim + g * PRIM_F;
  if (STATIC) {
    cx = __ldg(pv + SP_CX);
    cy = __ldg(pv + SP_CY);
    cz = __ldg(pv + SP_CZ);
    if (__ldg(s.spi + g * SP_I + 1)) {   // a lamp: the env's phase colour
      cr = od.x;
      cg = od.y;
      cb = od.z;
    } else {
      cr = __ldg(pv + SP_R);
      cg = __ldg(pv + SP_R + 1);
      cb = __ldg(pv + SP_R + 2);
    }
  } else {
    cx = pv[1];
    cy = pv[2];
    cz = pv[3];
    cr = pv[7];
    cg = pv[8];
    cb = pv[9];
  }
  const float hx = ob.x + t_m * dmx - cx;
  const float hy = ob.y + t_m * px->dy - cy;
  const float hz = ob.z + t_m * dmz - cz;
  float nmx, nmy, nmz;
  if (box) {
    float ax, ay, az;
    if (STATIC) {
      ax = fabsf(hx) * __ldg(pv + SP_IP0);
      ay = fabsf(hy) * __ldg(pv + SP_IP0 + 1);
      az = fabsf(hz) * __ldg(pv + SP_IP0 + 2);
    } else {
      ax = fabsf(hx) / fmaxf(pv[4], DT_F(1e-9));
      ay = fabsf(hy) / fmaxf(pv[5], DT_F(1e-9));
      az = fabsf(hz) / fmaxf(pv[6], DT_F(1e-9));
    }
    const bool xb = (ax >= ay) & (ax >= az);
    const bool yb = !xb & (ay >= az);
    nmx = xb ? sgn(hx) : 0.0f;
    nmy = yb ? sgn(hy) : 0.0f;
    nmz = (xb | yb) ? 0.0f : sgn(hz);
  } else {
    const float rinv = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz,
                                          DT_F(1e-12)));
    nmx = hx * rinv;
    nmy = hy * rinv;
    nmz = hz * rinv;
  }
  const float nwx = nmx * c_r - nmz * s_r;
  const float nwz = nmz * c_r + nmx * s_r;
  const float diff = fmaxf(-(nwx * cam[C_LIGHT] + nmy * cam[C_LIGHT + 1]
                             + nwz * cam[C_LIGHT + 2]), 0.0f);
  const float amb = cam[C_AMB];
  const float sh = amb + (1.0f - amb) * diff;
  px->r = cr * sh;
  px->g = cg * sh;
  px->b = cb * sh;
}

// The body both kernels share; STATIC picks K3's inputs or K4's.
template <bool STATIC>
__device__ __forceinline__ void render(const float* __restrict__ cam,
                                       const int* __restrict__ words,
                                       const float* __restrict__ ndc,
                                       const Objs& s,
                                       unsigned char* __restrict__ out,
                                       const Dims& d) {
  extern __shared__ float4 smem[];
  __shared__ int s_kept;   // the compacted objects' count
  const int e = blockIdx.x;
  const int tx = threadIdx.x;
  const int n = s.n;
  float4* s_oa = smem;
  float4* s_ob = s_oa + n;
  float4* s_oc = s_ob + n;
  float4* s_od = s_oc + n;
  float4* s_q0 = s_od + n;               // [n * P_MAX]
  float4* s_q1 = s_q0 + n * P_MAX;
  float* s_cam = reinterpret_cast<float*>(s_q1 + n * P_MAX);
  float* s_obj = s_cam + CAM_F;          // K4's rows
  float* s_prim = s_obj + (STATIC ? 0 : n * OBJ_F);
  int* s_words = reinterpret_cast<int*>(s_cam + CAM_F
                                        + raw_floats(STATIC, n));

  // ---- staging: the camera row, K4's rows, the env's tile words --------
  if (tx < CAM_F) s_cam[tx] = __ldg(cam + static_cast<size_t>(e) * CAM_F + tx);
  if (!STATIC) {
    for (int i = tx; i < n * OBJ_F; i += THREADS)
      s_obj[i] = __ldg(s.obj + static_cast<size_t>(e) * n * OBJ_F + i);
    for (int i = tx; i < n * P_MAX * PRIM_F; i += THREADS)
      s_prim[i] = __ldg(s.prim + static_cast<size_t>(e) * n * P_MAX * PRIM_F
                        + i);
  }
  const int* words_e = words + static_cast<size_t>(e) * d.n_words;
  for (int i = tx; i < d.n_staged; i += THREADS) s_words[i] = __ldg(words_e + i);
  __syncthreads();

  // ---- prologue: the env's kept objects and primitives, compacted -------
  if (tx < 32) {
    const int n_kept = prologue<STATIC>(s, e, s_cam, s_obj, s_prim, s_oa,
                                        s_ob, s_oc, s_od, s_q0, s_q1);
    if (tx == 0) s_kept = n_kept;
  }
  __syncthreads();
  const int n_kept = s_kept;

  // ---- per-env terms of the pixel pass ------------------------------------
  float k_fw = 0.0f;
  if (d.aa) k_fw = static_cast<float>(d.H) / (2.0f * s_cam[C_TANY])
                   / s_cam[C_TSINV] / s_cam[C_EYE + 1];
  const int* wsrc = d.n_staged ? s_words : words_e;
  const int P = d.P;
  const int cy = static_cast<int>(blockIdx.y);
  const int c1 = min((cy + 1) * d.chunk, P);
  unsigned char* out_e = out + static_cast<size_t>(e) * 3 * P;

  for (int p = cy * d.chunk + tx * PIX; p < c1; p += PASS) {
    uint32_t w0 = 0u, w1 = 0u, w2 = 0u;
#pragma unroll 1
    for (int k = 0; k < PIX; ++k) {
      Px px = ground_pass(s_cam, wsrc, ndc, p + k, d, k_fw);

      // ---- object pass over the compacted list ---------------------------
      if (n_kept > 0) {
        const float inv_y = safe_inv(px.dy);
        int win = -1, win_o = 0;
        float win_t = 0.0f;
        for (int o = 0; o < n_kept; ++o) {
          // the ray misses the object's bounding sphere (from outside):
          // none of its primitives can be hit
          const float4 oc = s_oc[o];
          const float bq = oc.x * px.dx + oc.y * px.dy + oc.z * px.dz;
          if (oc.w > 0.0f && (bq < 0.0f || bq * bq < oc.w)) continue;
          const float4 oa = s_oa[o];
          const int range = __float_as_int(s_ob[o].w);
          const float c_r = oa.x, s_r = oa.y;
          // the ray in the object's model space
          const float dmx = px.dx * c_r + px.dz * s_r;
          const float dmz = px.dz * c_r - px.dx * s_r;
          float inv_x = 0.0f, inv_z = 0.0f;
          if (__float_as_int(oa.w)) {
            inv_x = safe_inv(dmx);
            inv_z = safe_inv(dmz);
          }
          const int j_end = range >> 16;
          for (int j = range & 0xFFFF; j < j_end; ++j) {
            const float4 q0 = s_q0[j];
            const float4 q1 = s_q1[j];
            float t_m;
            bool hit;
            if (__float_as_int(q0.w) & 1) {
              float t1 = q0.x * inv_x, t2 = q0.y * inv_x;
              const float n1 = fminf(t1, t2), x1 = fmaxf(t1, t2);
              t1 = q0.z * inv_y;
              t2 = q1.x * inv_y;
              const float n2 = fminf(t1, t2), x2 = fmaxf(t1, t2);
              t1 = q1.y * inv_z;
              t2 = q1.z * inv_z;
              const float n3 = fminf(t1, t2), x3 = fmaxf(t1, t2);
              const float tmin = fmaxf(fmaxf(n1, n2), n3);
              const float tmax = fminf(fminf(x1, x2), x3);
              t_m = tmin > DT_F(1e-4) ? tmin : tmax;
              hit = (tmax >= fmaxf(tmin, DT_F(1e-4))) & (t_m > DT_F(1e-4));
            } else {
              const float bs = q0.x * dmx + q0.y * px.dy + q0.z * dmz;
              const float disc = bs * bs - q1.x;
              t_m = -bs - sqrtf(fmaxf(disc, 0.0f));
              hit = (disc > 0.0f) & (t_m > DT_F(1e-4));
            }
            const float t_w = t_m * oa.z;
            if (hit && t_w < px.t_best) {
              px.t_best = t_w;
              win = j;
              win_o = o;
              win_t = t_m;
            }
          }
        }
        if (win >= 0)
          shade_winner<STATIC>(s, s_cam, s_prim, s_oa[win_o], s_ob[win_o],
                               s_od[win_o], __float_as_int(s_q0[win].w),
                               win_t, &px);
      }

      const int sh8 = 8 * k;
      w0 |= to_u8(px.r) << sh8;
      w1 |= to_u8(px.g) << sh8;
      w2 |= to_u8(px.b) << sh8;
    }
    // one 32-bit word of four bytes per plane
    *reinterpret_cast<uint32_t*>(out_e + p) = w0;
    *reinterpret_cast<uint32_t*>(out_e + P + p) = w1;
    *reinterpret_cast<uint32_t*>(out_e + 2 * P + p) = w2;
  }
}

__global__ void __launch_bounds__(THREADS, RESIDENT)
row_render_static_kernel(const float* __restrict__ cam,
                         const int* __restrict__ words,
                         const float* __restrict__ ndc, Objs s,
                         unsigned char* __restrict__ out, Dims d) {
  render<true>(cam, words, ndc, s, out, d);
}

__global__ void __launch_bounds__(THREADS, RESIDENT)
row_render_kernel(const float* __restrict__ cam,
                  const int* __restrict__ words,
                  const float* __restrict__ ndc, Objs s,
                  unsigned char* __restrict__ out, Dims d) {
  render<false>(cam, words, ndc, s, out, d);
}

// Frame and grid sizes, the chunk a block renders (at most MAX_CHUNK
// pixels, a multiple of PASS, split further while the grid holds fewer
// than MIN_BLOCKS blocks) and the grid.
bool dims(int B, int H, int W, int n_words, int Hg, int Wg, int aa,
          int any_x, Dims* d, dim3* grid) {
  const int P = H * W;
  if (P % PIX != 0 || B < 1) return false;
  int n_chunks = (P + MAX_CHUNK - 1) / MAX_CHUNK;
  auto chunk_of = [&](int nc) {
    return ((P + nc - 1) / nc + PASS - 1) / PASS * PASS;
  };
  int chunk = chunk_of(n_chunks);
  while (chunk > PASS
         && static_cast<long long>(B) * n_chunks < MIN_BLOCKS) {
    n_chunks *= 2;
    chunk = chunk_of(n_chunks);
  }
  n_chunks = (P + chunk - 1) / chunk;
  const int n_staged = n_words <= MAX_STAGED_WORDS ? n_words : 0;
  *d = Dims{P, H, n_words, Hg, Wg, aa, any_x, chunk, n_staged};
  *grid = dim3(B, n_chunks);
  return true;
}

}  // namespace

extern "C" int dtown_row_render_static(
    const float* cam, const int* words, const float* ndc, const float* flags,
    const float* sof, const int* soi, const float* spf, const int* spi,
    unsigned char* out, int B, int H, int W, int n_words, int Hg, int Wg,
    int n_objs, int aa, int any_x, void* stream) {
  Dims d;
  dim3 grid;
  if (n_objs > MAX_STATIC
      || !dims(B, H, W, n_words, Hg, Wg, aa, any_x, &d, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const Objs s{flags, sof, soi, spf, spi, nullptr, nullptr, n_objs};
  const size_t smem = smem_bytes(true, n_objs, d.n_staged);
  row_render_static_kernel<<<grid, THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      cam, words, ndc, s, out, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtown_row_render(const float* cam, const int* words,
                                const float* ndc, const float* obj,
                                const float* prim, unsigned char* out, int B,
                                int H, int W, int n_words, int Hg, int Wg,
                                int kvis, int aa, int any_x, void* stream) {
  Dims d;
  dim3 grid;
  if (!dims(B, H, W, n_words, Hg, Wg, aa, any_x, &d, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(false, kvis, d.n_staged);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Objs s{nullptr, nullptr, nullptr, nullptr, nullptr, obj, prim, kvis};
  row_render_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cam, words, ndc, s, out, d);
  return static_cast<int>(cudaGetLastError());
}
