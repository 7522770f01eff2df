// Elementwise multiply-add chain for Hopper (sm_90a): the f32-vs-bf16
// throughput probe.
//
// Replaces the Pallas TPU kernel of scripts/bf16_probe.py::make_kernel:
// every element runs `ops` chained steps a = a * v + 1e-3 (a starts at v)
// in float32 or in bfloat16, and is written back as float32. The plain
// version is dtown_torch/probes.py::fma_chain_reference.
//
// What bounds it on the card: arithmetic. Each element is read and
// written once (8 bytes) against 2 * ops dependent operations.
//
// Design:
//  * Each step rounds as the reference's `a * v + c`: a multiply and an
//    add of their own (__fmul_rn / __fadd_rn, and the _rn bf16x2
//    intrinsics, which the compiler never contracts into an FMA), so the
//    kernel matches the plain version bit for bit. A fused-FMA variant is
//    a speed question for later.
//  * Two elements a thread: one float2 load and store; in bf16 one
//    __nv_bfloat162 register, so each multiply or add instruction works on
//    both elements (the packed rate the probe asks about).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
fma_chain_f32_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                     long long n2, int ops) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (i >= n2) return;
  const float2 v = x[i];
  const float c = 1e-3f;
  float2 a = v;
#pragma unroll 8
  for (int k = 0; k < ops; ++k) {
    a.x = __fadd_rn(__fmul_rn(a.x, v.x), c);
    a.y = __fadd_rn(__fmul_rn(a.y, v.y), c);
  }
  out[i] = a;
}

__global__ void __launch_bounds__(THREADS)
fma_chain_bf16_kernel(const float2* __restrict__ x, float2* __restrict__ out,
                      long long n2, int ops) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS
                      + threadIdx.x;
  if (i >= n2) return;
  const float2 xv = x[i];
  const __nv_bfloat162 v = __floats2bfloat162_rn(xv.x, xv.y);
  const __nv_bfloat162 c = __float2bfloat162_rn(1e-3f);
  __nv_bfloat162 a = v;
#pragma unroll 8
  for (int k = 0; k < ops; ++k) a = __hadd2_rn(__hmul2_rn(a, v), c);
  out[i] = __bfloat1622float2(a);
}

}  // namespace

// x, out: float32 [n] with n even; bf16 != 0 runs the bfloat16 chain.
extern "C" int dtown_fma_chain(const float* x, float* out, long long n,
                               int ops, int bf16, void* stream) {
  const long long n2 = n / 2;
  const long long blocks = (n2 + THREADS - 1) / THREADS;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xi = reinterpret_cast<const float2*>(x);
  auto* o = reinterpret_cast<float2*>(out);
  if (bf16) {
    fma_chain_bf16_kernel<<<blocks, THREADS, 0, st>>>(xi, o, n2, ops);
  } else {
    fma_chain_f32_kernel<<<blocks, THREADS, 0, st>>>(xi, o, n2, ops);
  }
  return static_cast<int>(cudaGetLastError());
}
