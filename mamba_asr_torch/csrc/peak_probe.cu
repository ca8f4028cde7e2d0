// P2, the attainable-rate probe for Hopper (sm_90a).
//
// Replaces: the Pallas kernel of scripts/vpu_peak.py:47-63 (launch :68),
// which measured the attainable f32 VPU rate under the scan's roofline.
// It computes, for each element x of a float32 array,
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
// Mode 0 and 1 measure the FP32 FMA pipes (2 FLOP per FMA, 128 lanes per
// SM): mode 0 the latency-limited reading (one chain at a time per
// thread), mode 1 the throughput reading (four chains per element). Mode 2
// measures the special-function unit through ex2.approx.ftz, the
// instruction K1 (selective_scan_fwd.cuh:ex2) computes each state's decay
// with: one MUFU.EX2 and two FMULs per step, bound by the SFU's 16 results
// per clock per SM. A launch moves 8 bytes per element and runs K steps on
// it; the caller differences two K so that the launch and the memory
// cancel.
//
// Design. The first port ran one element per thread through a grid-stride
// loop: a 4-byte load, the whole chain, a 4-byte store, so that a thread
// had nothing in flight while it ran its chain (8 KB per SM between
// chains) and a k-64 launch cost the memory time plus the chain time.
// Here the stream overlaps the chains:
// - a persistent grid, kGeometry[mode] blocks of 1,024 threads per SM,
//   each block owning a contiguous range of x's 16-byte-aligned body, the
//   ranges equal to within one float4;
// - each thread walks its block's range a float4 at a time (16-byte
//   loads, neighbouring threads on neighbouring float4s) and keeps the
//   next float4's load in flight in registers while it runs the current
//   four elements' chains one after another: 32 KB in flight per SM at two
//   blocks, against the ~18 KB that 3.35 TB/s over 132 SMs at ~0.7 us of
//   latency asks;
// - results go out as one 16-byte store where out is 16-byte aligned at
//   that element (else four 4-byte stores);
// - block 0 runs the ragged ends with plain loads: up to 3 elements before
//   x's first 16-byte boundary (a view with a storage offset) and up to 3
//   after its last whole float4;
// - each chain runs in compile-time blocks of kBlockSteps steps inside a
//   runtime count of blocks, then the remainder, so the loop's own
//   instructions take 3 of every 131 issue slots (the compiler unrolls the
//   block twice); the floating-point operations and their order per
//   element are the first port's.
// A ring of shared-memory tiles filled by 1-D bulk asynchronous copies
// (cp.async.bulk completing on mbarriers, a producer warp, consumer warps
// releasing a stage as soon as they had read it) was built and timed
// against this design in one call on an NVIDIA H100 80GB HBM3 at 700 W:
// 0.0324 ms against 0.0242 (dependent, k 64, B32 x 751 x 288), 0.0299 with
// its consumer warps in four groups taking alternate tiles (PERF.md).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBlockSteps = 64;  // chain steps per unrolled block

// Blocks per SM and warps per block of each mode's launch: two blocks
// were faster for the FMA modes, one for exp2 (PERF.md). The wrapper keeps
// a copy (kernels/peak_probe.py:GEOMETRY).
struct Geometry {
  int blocks_per_sm;
  int warps;
};
constexpr Geometry kGeometry[3] = {{2, 32}, {2, 32}, {1, 32}};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ long long global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// One element's chain of k steps (see the modes above).
template <int MODE>
__device__ __forceinline__ float chain(float xv, int k) {
  if constexpr (MODE == 0) {
    float acc = xv;
    int s = k;
    for (; s >= kBlockSteps; s -= kBlockSteps) {
#pragma unroll
      for (int j = 0; j < kBlockSteps; ++j) acc = fmaf(acc, xv, 0.5f);
    }
#pragma unroll 1
    for (; s > 0; --s) acc = fmaf(acc, xv, 0.5f);
    return acc;
  } else if constexpr (MODE == 1) {
    float a0 = xv, a1 = xv * 1.125f, a2 = xv * 1.25f, a3 = xv * 1.375f;
    int s = k / 4;
    for (; s >= kBlockSteps / 4; s -= kBlockSteps / 4) {
#pragma unroll
      for (int j = 0; j < kBlockSteps / 4; ++j) {
        a0 = fmaf(a0, xv, 0.25f);
        a1 = fmaf(a1, xv, 0.375f);
        a2 = fmaf(a2, xv, 0.5f);
        a3 = fmaf(a3, xv, 0.625f);
      }
    }
#pragma unroll 1
    for (; s > 0; --s) {
      a0 = fmaf(a0, xv, 0.25f);
      a1 = fmaf(a1, xv, 0.375f);
      a2 = fmaf(a2, xv, 0.5f);
      a3 = fmaf(a3, xv, 0.625f);
    }
    return ((a0 + a1) + a2) + a3;
  } else {
    float acc = xv;
    int s = k;
    for (; s >= kBlockSteps; s -= kBlockSteps) {
#pragma unroll
      for (int j = 0; j < kBlockSteps; ++j) acc = ex2(acc * xv) * 0.5f;
    }
#pragma unroll 1
    for (; s > 0; --s) acc = ex2(acc * xv) * 0.5f;
    return acc;
  }
}

// x[0, head) and x[head + 4 * body4, n) are the ragged ends; the body in
// between is body4 float4s starting at a 16-byte boundary of x.
//
// TIMED (the measurement tool's instantiation) has block 0's thread 0
// write its SM cycles and global-timer nanoseconds from start to end to
// clock_out[0] and [1]: their ratio is the SM clock the card held.
template <int MODE, bool TIMED>
__global__ void __launch_bounds__(kMaxThreads, 2)
peak_probe_kernel(const float* __restrict__ x, float* __restrict__ out, long long n, int k,
                  int head, long long body4, long long* __restrict__ clock_out) {
  const long long lo = body4 * blockIdx.x / gridDim.x;
  const long long hi = body4 * (blockIdx.x + 1) / gridDim.x;
  const int step = blockDim.x;
  const bool lead = TIMED && blockIdx.x == 0 && threadIdx.x == 0;
  long long c0 = 0, g0 = 0;
  if (lead) {
    c0 = clock64();
    g0 = global_ns();
  }
  if (blockIdx.x == 0) {
    const long long tail = n - head - 4 * body4;
    if (threadIdx.x < head + tail) {
      const long long e =
          threadIdx.x < head ? threadIdx.x : head + 4 * body4 + (threadIdx.x - head);
      out[e] = chain<MODE>(x[e], k);
    }
  }
  const float4* body = reinterpret_cast<const float4*>(x + head);
  float* body_out = out + head;
  const bool vec_out = (reinterpret_cast<uintptr_t>(body_out) & 15) == 0;
  long long i = lo + threadIdx.x;
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < hi) next = __ldg(body + i);
  for (; i < hi; i += step) {
    const float4 v = next;
    if (i + step < hi) next = __ldg(body + i + step);  // in flight during the chains
    float4 r;
    r.x = chain<MODE>(v.x, k);
    r.y = chain<MODE>(v.y, k);
    r.z = chain<MODE>(v.z, k);
    r.w = chain<MODE>(v.w, k);
    float* o = body_out + 4 * i;
    if (vec_out) {
      *reinterpret_cast<float4*>(o) = r;
    } else {
      o[0] = r.x;
      o[1] = r.y;
      o[2] = r.z;
      o[3] = r.w;
    }
  }
  if (lead) {
    clock_out[0] = clock64() - c0;
    clock_out[1] = global_ns() - g0;
  }
}

// exact: fail (cudaErrorInvalidConfiguration) unless blocks_per_sm blocks
// fit on an SM; else run as many as fit, up to blocks_per_sm.
template <int MODE, bool TIMED>
int launch(const float* x, float* out, long long n, int k, Geometry g, long long* clock_out,
           cudaStream_t stream, bool exact) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 32 * g.warps;
  int fit = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &fit, peak_probe_kernel<MODE, TIMED>, threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit < 1 || (exact && fit < g.blocks_per_sm)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long per_sm = g.blocks_per_sm < fit ? g.blocks_per_sm : fit;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  const long long to_boundary = static_cast<long long>((16 - (addr & 15)) & 15) / 4;
  const int head = static_cast<int>(to_boundary < n ? to_boundary : n);
  const long long body4 = (n - head) / 4;
  long long grid = per_sm * sms;
  if (grid > body4) grid = body4 > 0 ? body4 : 1;
  peak_probe_kernel<MODE, TIMED><<<static_cast<unsigned>(grid), threads, 0, stream>>>(
      x, out, n, k, head, body4, clock_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool TIMED>
int dispatch(const void* x, void* out, long long n, int k, int mode, Geometry g,
             long long* clock_out, void* stream, bool exact) {
  if (n <= 0 || k < 0 || mode < 0 || mode > 2 || g.blocks_per_sm < 1 || g.warps < 1 ||
      32 * g.warps > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 3) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0) return launch<0, TIMED>(xp, op, n, k, g, clock_out, s, exact);
  if (mode == 1) return launch<1, TIMED>(xp, op, n, k, g, clock_out, s, exact);
  return launch<2, TIMED>(xp, op, n, k, g, clock_out, s, exact);
}

}  // namespace

// Plain C entry, bound with ctypes: out = the chain of `mode` (0, 1, 2) of
// length k on each of the n float32 elements of x, at the mode's geometry.
// Returns the CUDA error of the launch (0 on success); asynchronous on
// `stream`.
extern "C" int mamba_peak_probe(const void* x, void* out, long long n, int k, int mode,
                                void* stream) {
  if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false>(x, out, n, k, mode, kGeometry[mode], nullptr, stream, false);
}

// The same chains at a chosen geometry: blocks_per_sm blocks (all resident,
// else cudaErrorInvalidConfiguration) of `warps` warps (1 to 32) on every
// SM. With clock_out, a device array of 2 int64, the timed instantiation
// runs and writes block 0's cycles and nanoseconds there (see the kernel).
extern "C" int mamba_peak_probe_at(const void* x, void* out, long long n, int k, int mode,
                                   int blocks_per_sm, int warps, void* clock_out,
                                   void* stream) {
  const Geometry g{blocks_per_sm, warps};
  long long* clock = static_cast<long long*>(clock_out);
  if (clock != nullptr) return dispatch<true>(x, out, n, k, mode, g, clock, stream, true);
  return dispatch<false>(x, out, n, k, mode, g, nullptr, stream, true);
}
