// Row-fed RGB render for Hopper (sm_90a): one thread per pixel.
//
// Replaces the two Pallas TPU kernels of dtown/render/pallas_raster.py
// that render_frames_pallas launches:
//  * row_render_static_kernel <- _make_kernel_static (K3, the static scene
//    baked into the TPU kernel);
//  * row_render_kernel        <- _make_kernel (K4, per-env rows of the
//    Kvis nearest objects and their primitives).
// The plain versions are dtown_torch/render/row_raster.py::
// render_frames_static_reference and render_frames_rows_reference; this
// file keeps their float32 operation order.
//
// What bounds it on the card: arithmetic. Each pixel normalizes its ray,
// hits the ground, shades the tile (analytic markings with AA, hash
// noise) and tests every primitive of the objects its env does not cull;
// that is hundreds of float ops against 3 output bytes and a few hundred
// bytes of per-env rows.
//
// Design:
//  * grid (B, ceil(H*W / 256)): a block belongs to one env, so the camera
//    row, the object rows and the cull flags are block-uniform. They are
//    loaded once per block into shared memory, and an object whose cull
//    flag is off is skipped by the whole block without divergence.
//  * The TPU kernels build the pixel ray from iota ramps, or under fisheye
//    from the inverted lens model's NDC table (_ndc_planes); here both
//    kernels read an NDC table [2, H*W] always: the linear ramps baked on
//    the host with the kernels' float ops (a division by W and by H), or
//    the fisheye table. The pixel's ray is then the table entry times the
//    env's tan(fov/2), as in the TPU kernels.
//  * K3's scene is not compiled into the kernel: it arrives as small
//    object/primitive tables (row_raster.pack_static_scene) that every
//    thread walks in order, so one binary serves every map. The constants
//    the reference folds in Python doubles arrive folded in float64 and
//    rounded once to float32; K4 computes the same quantities in float32
//    (sincos(-angle), divides), as its TPU kernel does.
//  * The packed-word select chain is one indexed load; tile ids use int
//    multiplies.
//  * Ground and sky come from tile_shading.cuh (shared with the blob
//    render); the primitive test is one __device__ function both kernels
//    call.
//  * The reference's rsqrt is 1.0f / sqrtf here and in the plain version;
//    built with -fmad=false (see _build.py), so results match the plain
//    version bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "sincos.cuh"
#include "tile_shading.cuh"

namespace {

constexpr int THREADS = 256;
// camera row (row_raster.py C_*)
constexpr int CAM_F = 32;
constexpr int C_EYE = 0, C_FWD = 3, C_RIGHT = 6, C_UP = 9, C_TANX = 12;
constexpr int C_TANY = 13, C_SHADE = 14, C_GND = 15, C_HOR = 18;
constexpr int C_TSINV = 21, C_LIGHT = 22, C_AMB = 25;
// K4 rows
constexpr int OBJ_F = 8, PRIM_F = 10, P_MAX = 4;
// K3 scene tables (row_raster.py SO_*, SOI_*, SP_*, SPI_*)
constexpr int SO_F = 7, SO_I = 2, SP_F = 13, SP_I = 2;
constexpr int SO_X = 0, SO_Y = 1, SO_Z = 2, SO_SR = 3, SO_CR = 4;
constexpr int SO_INVS = 5, SO_SC = 6;
constexpr int SP_CX = 0, SP_CY = 1, SP_CZ = 2, SP_P0 = 3, SP_P1 = 4;
constexpr int SP_P2 = 5, SP_R = 6, SP_P0SQ = 9, SP_IP0 = 10;
constexpr int MAX_STATIC = 16;

struct Dims {
  int P, H, n_words, Hg, Wg, aa, any_x;
};

// A pixel after the ground pass: world ray, nearest hit so far, color.
struct Px {
  float dx, dy, dz, t_best, r, g, b;
};

// The env's ray in one object's model space, and its slab reciprocals.
struct ModelRay {
  float emx, ey, emz, dmx, dmz, inv_x, inv_y, inv_z;
};

__device__ __forceinline__ float safe_inv(float dm) {
  const float eps = DT_F(1e-9);
  const float d = fabsf(dm) < eps ? (dm >= 0.0f ? eps : -eps) : dm;
  return 1.0f / d;
}

__device__ __forceinline__ unsigned char to_u8(float x) {
  x = fminf(fmaxf(x, 0.0f), 1.0f);
  return static_cast<unsigned char>(static_cast<int>(x * 255.0f + 0.5f));
}

// Ray setup, ground hit, tile shading and sky (row_raster._ground).
__device__ __forceinline__ Px ground_pass(const float* cam,
                                          const int* __restrict__ words,
                                          const float* __restrict__ ndc,
                                          int p, const Dims& d) {
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
  const int word = __ldg(words + (tid >> 2));
  const int byte = (word >> ((tid & 3) * 8)) & 0xFF;
  const bool aa = d.aa != 0;
  float inv_fw = 0.0f;
  if (aa) {
    const float k_fw = static_cast<float>(d.H) / (2.0f * cam[C_TANY])
                       / ts_inv / eye1;
    inv_fw = dy * dy * k_fw;
  }
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

__device__ __forceinline__ ModelRay model_ray(const float* cam, const Px& px,
                                              float ox, float oy, float oz,
                                              float s_r, float c_r,
                                              float inv_s) {
  const float ex = (cam[C_EYE] - ox) * inv_s;
  const float ey = (cam[C_EYE + 1] - oy) * inv_s;
  const float ez = (cam[C_EYE + 2] - oz) * inv_s;
  ModelRay m;
  m.emx = ex * c_r + ez * s_r;
  m.ey = ey;
  m.emz = ez * c_r - ex * s_r;
  m.dmx = px.dx * c_r + px.dz * s_r;
  m.dmz = px.dz * c_r - px.dx * s_r;
  m.inv_x = safe_inv(m.dmx);
  m.inv_y = safe_inv(px.dy);
  m.inv_z = safe_inv(m.dmz);
  return m;
}

__device__ __forceinline__ float sgn(float q) {
  return q >= 0.0f ? 1.0f : -1.0f;
}

// One primitive against the pixel's ray: sphere (radius^2 = r2) or box
// (half extents p0..p2), then the Lambert shade of the hit point's normal.
// K3 passes the host-folded reciprocals i0..i2 of the half extents
// (DIVIDE false); K4 divides by the extents in float32 (DIVIDE true), as
// the two TPU kernels do. Returns whether the primitive is hit in front;
// *t_m is the model-space distance, *sh the shade.
template <bool DIVIDE>
__device__ __forceinline__ bool prim_test(bool is_box, const ModelRay& m,
                                          float dy, const float* cam,
                                          float s_r, float c_r, float cx,
                                          float cy, float cz, float p0,
                                          float p1, float p2, float r2,
                                          float i0, float i1, float i2,
                                          float* t_out, float* sh_out) {
  const float ocx = m.emx - cx, ocy = m.ey - cy, ocz = m.emz - cz;
  float t_m;
  bool hit;
  if (is_box) {
    float t1 = (-p0 - ocx) * m.inv_x, t2 = (p0 - ocx) * m.inv_x;
    const float n1 = fminf(t1, t2), x1 = fmaxf(t1, t2);
    t1 = (-p1 - ocy) * m.inv_y;
    t2 = (p1 - ocy) * m.inv_y;
    const float n2 = fminf(t1, t2), x2 = fmaxf(t1, t2);
    t1 = (-p2 - ocz) * m.inv_z;
    t2 = (p2 - ocz) * m.inv_z;
    const float n3 = fminf(t1, t2), x3 = fmaxf(t1, t2);
    const float tmin = fmaxf(fmaxf(n1, n2), n3);
    const float tmax = fminf(fminf(x1, x2), x3);
    t_m = tmin > DT_F(1e-4) ? tmin : tmax;
    hit = (tmax >= fmaxf(tmin, DT_F(1e-4))) & (t_m > DT_F(1e-4));
  } else {
    const float bq = ocx * m.dmx + ocy * dy + ocz * m.dmz;
    const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r2;
    const float disc = bq * bq - cq;
    t_m = -bq - sqrtf(fmaxf(disc, 0.0f));
    hit = (disc > 0.0f) & (t_m > DT_F(1e-4));
  }
  const float hx = m.emx + t_m * m.dmx - cx;
  const float hy = m.ey + t_m * dy - cy;
  const float hz = m.emz + t_m * m.dmz - cz;
  float nmx, nmy, nmz;
  if (is_box) {
    float ax, ay, az;
    if (DIVIDE) {
      ax = fabsf(hx) / fmaxf(p0, DT_F(1e-9));
      ay = fabsf(hy) / fmaxf(p1, DT_F(1e-9));
      az = fabsf(hz) / fmaxf(p2, DT_F(1e-9));
    } else {
      ax = fabsf(hx) * i0;
      ay = fabsf(hy) * i1;
      az = fabsf(hz) * i2;
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
  *sh_out = amb + (1.0f - amb) * diff;
  *t_out = t_m;
  return hit;
}

__device__ __forceinline__ void store(unsigned char* __restrict__ out,
                                      int e, int p, const Dims& d,
                                      const Px& px) {
  unsigned char* o = out + static_cast<size_t>(e) * 3 * d.P + p;
  o[0] = to_u8(px.r);
  o[d.P] = to_u8(px.g);
  o[2 * d.P] = to_u8(px.b);
}

__global__ void __launch_bounds__(THREADS)
row_render_static_kernel(const float* __restrict__ cam,
                         const int* __restrict__ words,
                         const float* __restrict__ ndc,
                         const float* __restrict__ flags,
                         const float* __restrict__ sof,
                         const int* __restrict__ soi,
                         const float* __restrict__ spf,
                         const int* __restrict__ spi,
                         unsigned char* __restrict__ out, Dims d,
                         int n_objs) {
  __shared__ float s_cam[CAM_F];
  __shared__ float s_flags[2 * MAX_STATIC];
  const int e = blockIdx.x;
  for (int i = threadIdx.x; i < CAM_F; i += THREADS)
    s_cam[i] = cam[static_cast<size_t>(e) * CAM_F + i];
  const int n_flags = 2 * (n_objs > 0 ? n_objs : 1);
  for (int i = threadIdx.x; i < 2 * n_objs; i += THREADS)
    s_flags[i] = flags[static_cast<size_t>(e) * n_flags + i];
  __syncthreads();
  const int p = blockIdx.y * THREADS + threadIdx.x;
  if (p >= d.P) return;

  Px px = ground_pass(s_cam, words + static_cast<size_t>(e) * d.n_words, ndc,
                      p, d);
  for (int o = 0; o < n_objs; ++o) {
    if (!(s_flags[2 * o] > 0.5f)) continue;  // culled: uniform per block
    const bool green = s_flags[2 * o + 1] > 0.5f;
    const float* ov = sof + o * SO_F;
    const float s_r = __ldg(ov + SO_SR), c_r = __ldg(ov + SO_CR);
    const float osc = __ldg(ov + SO_SC);
    const ModelRay m = model_ray(s_cam, px, __ldg(ov + SO_X),
                                 __ldg(ov + SO_Y), __ldg(ov + SO_Z), s_r,
                                 c_r, __ldg(ov + SO_INVS));
    const int j0 = __ldg(soi + o * SO_I), np = __ldg(soi + o * SO_I + 1);
    for (int j = j0; j < j0 + np; ++j) {
      const float* pv = spf + j * SP_F;
      const bool is_box = __ldg(spi + j * SP_I) != 0;
      const bool lamp = __ldg(spi + j * SP_I + 1) != 0;
      float t_m, sh;
      const bool hit = prim_test<false>(
          is_box, m, px.dy, s_cam, s_r, c_r, __ldg(pv + SP_CX),
          __ldg(pv + SP_CY), __ldg(pv + SP_CZ), __ldg(pv + SP_P0),
          __ldg(pv + SP_P1), __ldg(pv + SP_P2), __ldg(pv + SP_P0SQ),
          __ldg(pv + SP_IP0), __ldg(pv + SP_IP0 + 1), __ldg(pv + SP_IP0 + 2),
          &t_m, &sh);
      const float t_w = t_m * osc;
      if (hit && t_w < px.t_best) {
        float cr, cg, cb;
        if (lamp) {
          cr = green ? DT_F(0.1) : DT_F(0.9);
          cg = green ? DT_F(0.85) : DT_F(0.1);
          cb = green ? DT_F(0.15) : DT_F(0.1);
        } else {
          cr = __ldg(pv + SP_R);
          cg = __ldg(pv + SP_R + 1);
          cb = __ldg(pv + SP_R + 2);
        }
        px.r = cr * sh;
        px.g = cg * sh;
        px.b = cb * sh;
        px.t_best = t_w;
      }
    }
  }
  store(out, e, p, d, px);
}

__global__ void __launch_bounds__(THREADS)
row_render_kernel(const float* __restrict__ cam,
                  const int* __restrict__ words,
                  const float* __restrict__ ndc,
                  const float* __restrict__ obj,
                  const float* __restrict__ prim,
                  unsigned char* __restrict__ out, Dims d, int kvis) {
  extern __shared__ float smem[];
  float* s_cam = smem;
  float* s_obj = s_cam + CAM_F;
  float* s_prim = s_obj + kvis * OBJ_F;
  const int e = blockIdx.x;
  for (int i = threadIdx.x; i < CAM_F; i += THREADS)
    s_cam[i] = cam[static_cast<size_t>(e) * CAM_F + i];
  for (int i = threadIdx.x; i < kvis * OBJ_F; i += THREADS)
    s_obj[i] = obj[static_cast<size_t>(e) * kvis * OBJ_F + i];
  for (int i = threadIdx.x; i < kvis * P_MAX * PRIM_F; i += THREADS)
    s_prim[i] = prim[static_cast<size_t>(e) * kvis * P_MAX * PRIM_F + i];
  __syncthreads();
  const int p = blockIdx.y * THREADS + threadIdx.x;
  if (p >= d.P) return;

  Px px = ground_pass(s_cam, words + static_cast<size_t>(e) * d.n_words, ndc,
                      p, d);
  for (int k = 0; k < kvis; ++k) {
    const float* ov = s_obj + k * OBJ_F;
    if (!(ov[7] > 0.5f)) continue;  // inactive slot: uniform per block
    const float s_r = ov[3], c_r = ov[4], osc = ov[6];
    const ModelRay m = model_ray(s_cam, px, ov[0], ov[1], ov[2], s_r, c_r,
                                 ov[5]);
    for (int q = 0; q < P_MAX; ++q) {
      const float* pv = s_prim + (k * P_MAX + q) * PRIM_F;
      const float p0 = pv[4];
      float t_m, sh;
      const bool hit = prim_test<true>(
          pv[0] > 0.5f, m, px.dy, s_cam, s_r, c_r, pv[1], pv[2], pv[3], p0,
          pv[5], pv[6], p0 * p0, 0.0f, 0.0f, 0.0f, &t_m, &sh);
      const float t_w = t_m * osc;
      if (hit && t_w < px.t_best) {
        px.r = pv[7] * sh;
        px.g = pv[8] * sh;
        px.b = pv[9] * sh;
        px.t_best = t_w;
      }
    }
  }
  store(out, e, p, d, px);
}

}  // namespace

extern "C" int dtown_row_render_static(
    const float* cam, const int* words, const float* ndc, const float* flags,
    const float* sof, const int* soi, const float* spf, const int* spi,
    unsigned char* out, int B, int H, int W, int n_words, int Hg, int Wg,
    int n_objs, int aa, int any_x, void* stream) {
  if (n_objs > MAX_STATIC) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{H * W, H, n_words, Hg, Wg, aa, any_x};
  const dim3 grid(B, (d.P + THREADS - 1) / THREADS);
  row_render_static_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      cam, words, ndc, flags, sof, soi, spf, spi, out, d, n_objs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtown_row_render(const float* cam, const int* words,
                                const float* ndc, const float* obj,
                                const float* prim, unsigned char* out, int B,
                                int H, int W, int n_words, int Hg, int Wg,
                                int kvis, int aa, int any_x, void* stream) {
  const Dims d{H * W, H, n_words, Hg, Wg, aa, any_x};
  const size_t smem = sizeof(float) * (CAM_F + kvis * OBJ_F
                                       + kvis * P_MAX * PRIM_F);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, (d.P + THREADS - 1) / THREADS);
  row_render_kernel<<<grid, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      cam, words, ndc, obj, prim, out, d, kvis);
  return static_cast<int>(cudaGetLastError());
}
