// Polynomial sincos and arccos shared by the kernels of dtown_torch.
//
// Same float32 operation order as dtown_torch/geometry.py::sincos and
// ops/state_kernel.py::_acos (which follow the JAX package): Cody-Waite
// 3-part pi/2 reduction + the fdlibm kernel polynomials. Every constant is
// a double literal rounded once to float, which is what jnp does with a
// Python float next to a float32 array. rintf rounds half to even like
// jnp.round / torch.round.
#pragma once

#define DT_F(x) (static_cast<float>(x))

__device__ __forceinline__ void dt_sincos(float x, float* s_out,
                                          float* c_out) {
  const float k = rintf(x * DT_F(0.636619772367581343076));
  const float r = ((x - k * DT_F(1.57079632673412561417e+00))
                   - k * DT_F(6.07710050650619224932e-11))
                  - k * DT_F(2.02226624879595063154e-21);
  const float z = r * r;
  float ps = DT_F(1.58969099521155010221e-10);
  ps = ps * z + DT_F(-2.50507602534068634195e-08);
  ps = ps * z + DT_F(2.75573137070700676789e-06);
  ps = ps * z + DT_F(-1.98412698298579493134e-04);
  ps = ps * z + DT_F(8.33333333332248946124e-03);
  ps = ps * z + DT_F(-1.66666666666666324348e-01);
  const float s = r + (r * z) * ps;
  float pc = DT_F(-1.13596475577881948265e-11);
  pc = pc * z + DT_F(2.08757232129817482790e-09);
  pc = pc * z + DT_F(-2.75573143513906633035e-07);
  pc = pc * z + DT_F(2.48015872894767294178e-05);
  pc = pc * z + DT_F(-1.38888888888741095749e-03);
  pc = pc * z + DT_F(4.16666666666666019037e-02);
  const float c = (1.0f - 0.5f * z) + (z * z) * pc;
  const int n = static_cast<int>(k) & 3;
  *s_out = n == 0 ? s : (n == 1 ? c : (n == 2 ? -s : -c));
  *c_out = n == 0 ? c : (n == 1 ? -s : (n == 2 ? -c : s));
}

// Abramowitz-Stegun 4.4.45 arccos (~7e-5 rad).
__device__ __forceinline__ float dt_acos(float x) {
  const float ax = fabsf(x);
  float p = DT_F(-0.0187293) * ax + DT_F(0.0742610);
  p = p * ax + DT_F(-0.2121144);
  p = p * ax + DT_F(1.5707288);
  const float r = p * sqrtf(fmaxf(1.0f - ax, 0.0f));
  return x < 0.0f ? DT_F(3.14159265358979323846) - r : r;
}
