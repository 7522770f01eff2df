"""Backend-independent polynomial sincos (torch).

Counterpart of dtown/geometry.py::sincos: Cody-Waite 3-part pi/2 argument
reduction + the fdlibm kernel polynomials, evaluated in float32 with the
same operation order, so the plain versions and the CUDA kernels
(csrc/sincos.cuh) reproduce the reference's bits. ``torch.round`` rounds
half to even like ``jnp.round`` (``rintf`` on the device side).
"""
import torch

_PIO2_HI = 1.57079632673412561417e+00
_PIO2_MID = 6.07710050650619224932e-11
_PIO2_LO = 2.02226624879595063154e-21
_TWO_OVER_PI = 0.636619772367581343076

_S = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
      -1.98412698298579493134e-04, 2.75573137070700676789e-06,
      -2.50507602534068634195e-08, 1.58969099521155010221e-10)
_C = (4.16666666666666019037e-02, -1.38888888888741095749e-03,
      2.48015872894767294178e-05, -2.75573143513906633035e-07,
      2.08757232129817482790e-09, -1.13596475577881948265e-11)


def _kernel_sin(r, z):
    p = torch.full_like(z, _S[5])
    for s in (_S[4], _S[3], _S[2], _S[1], _S[0]):
        p = p * z + s
    return r + r * z * p


def _kernel_cos(z):
    p = torch.full_like(z, _C[5])
    for c in (_C[4], _C[3], _C[2], _C[1], _C[0]):
        p = p * z + c
    return 1.0 - 0.5 * z + z * z * p


def sincos(x: torch.Tensor):
    """(sin x, cos x) of a float32 tensor, ~1 ulp."""
    k = torch.round(x * _TWO_OVER_PI)
    r = ((x - k * _PIO2_HI) - k * _PIO2_MID) - k * _PIO2_LO
    z = r * r
    s = _kernel_sin(r, z)
    c = _kernel_cos(z)
    n = k.to(torch.int32) & 3
    sin_x = torch.where(
        n == 0, s, torch.where(n == 1, c, torch.where(n == 2, -s, -c)))
    cos_x = torch.where(
        n == 0, c, torch.where(n == 1, -s, torch.where(n == 2, -c, s)))
    return sin_x, cos_x
