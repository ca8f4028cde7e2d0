// P2, the attainable-rate probe for Hopper (sm_90a).
//
// Replaces: the Pallas kernel of scripts/vpu_peak.py:47-63 (launch :68),
// which measured the attainable f32 VPU rate under the scan's roofline.
// It computes, for each element x of a (B, T, D) float32 array,
//
//   mode 0 (dependent):     acc = x;  K times acc = acc * x + 0.5
//   mode 1 (independent-4): acc_j = x (1 + 0.125 j), j < 4;  K / 4 times
//                           acc_j = acc_j * x + (0.25 + 0.125 j);
//                           out = ((acc_0 + acc_1) + acc_2) + acc_3
//   mode 2 (exp2 chain):    acc = x;  K times acc = exp2(acc * x) * 0.5
//
// The multiplier x is data, so the compiler cannot fold the chain (a
// constant-coefficient chain is linear in x and folds, as the script's
// comment warns). For x in (0, 1) every chain is contracting and stays
// bounded: the FMA chains near 0.5 / (1 - x), the exp2 chain in (0.5, 1).
//
// Mode 0 and 1 measure the FP32 FMA pipes (2 FLOP per FMA): each SM
// sub-partition issues one warp FFMA per clock. With one element per
// thread and the card full of warps the dependent chain was expected to
// reach the pipe as the independent ones do; on an H100 it reached about
// half of the published rate and the four independent chains ~84 %
// (PERF.md).
// Mode 2 measures the special-function unit through ex2.approx.ftz, the
// instruction K1 (selective_scan_fwd.cuh:ex2) computes each state's decay
// with: one MUFU.EX2 and two FMULs per step, so it is bound by the SFU's
// 16 results per clock per SM. The kernel's time is
// bytes (x read, out written) plus K steps; the caller differences two K
// so that the launch and the memory cancel.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
peak_probe_kernel(const float* __restrict__ x, float* __restrict__ out,
                  size_t n, int k) {
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float xv = x[i];
    float acc;
    if constexpr (MODE == 0) {
      acc = xv;
#pragma unroll 16
      for (int s = 0; s < k; ++s) acc = fmaf(acc, xv, 0.5f);
    } else if constexpr (MODE == 1) {
      float a0 = xv, a1 = xv * 1.125f, a2 = xv * 1.25f, a3 = xv * 1.375f;
#pragma unroll 4
      for (int s = 0; s < k / 4; ++s) {
        a0 = fmaf(a0, xv, 0.25f);
        a1 = fmaf(a1, xv, 0.375f);
        a2 = fmaf(a2, xv, 0.5f);
        a3 = fmaf(a3, xv, 0.625f);
      }
      acc = ((a0 + a1) + a2) + a3;
    } else {
      acc = xv;
#pragma unroll 16
      for (int s = 0; s < k; ++s) acc = ex2(acc * xv) * 0.5f;
    }
    out[i] = acc;
  }
}

template <int MODE>
int launch(const float* x, float* out, size_t n, int k, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // Enough blocks to fill every SM with resident warps; a grid-stride loop
  // covers the rest.
  const size_t want = (n + kThreads - 1) / kThreads;
  const size_t cap = static_cast<size_t>(sms) * 64;
  const unsigned blocks = static_cast<unsigned>(want < cap ? want : cap);
  peak_probe_kernel<MODE><<<blocks, kThreads, 0, stream>>>(x, out, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry, bound with ctypes: out = the chain of `mode` (0, 1, 2) of
// length k on each of the n float32 elements of x. Returns the CUDA error
// of the launch (0 on success); asynchronous on `stream`.
extern "C" int mamba_peak_probe(const void* x, void* out, long long n, int k,
                                int mode, void* stream) {
  if (n <= 0 || k < 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t count = static_cast<size_t>(n);
  if (mode == 0) return launch<0>(xp, op, count, k, s);
  if (mode == 1) return launch<1>(xp, op, count, k, s);
  return launch<2>(xp, op, count, k, s);
}
