// CTC prefix-score frame recurrences for Hopper (sm_90a).
//
// Replaces: mamba_asr_tpu/ops/pallas/log_scan.py:_ctc_dp_kernel (launched
// by ctc_dp_pallas), both log-semiring recurrences of
// CTCPrefixScorer.select in one launch:
//
//   r_nb(t) = logaddexp(r_nb(t-1) + a_nb(t), grow(t))
//   r_b(t)  = logaddexp(r_b(t-1) + lpb(t), valid(t) ? r_nb(t-1) + lpb(t) : NEG)
//
// with r(-1) = NEG = -1e30, the scorer's finite stand-in for -inf (so
// r_nb(0) = grow(0)). Layout (T, N) float32, all six planes contiguous:
// frame-major, so neighbouring hypotheses sit at neighbouring addresses.
//
// Bound. Four planes in and two out, 24 * T * N bytes: at T 751 and N 528,
// 9.5 MB, ~2.8 us at 3.35 TB/s. What bounds a design is the chain of
// dependent logaddexps (an exp and a log on the special-function unit,
// ~60 to 80 cycles each): walked frame by frame it is 751 steps per
// recurrence, ~190 us whatever N is.
//
// Design. A two-level scan, as the TPU kernel's _linlog_2level. The step
// x -> logaddexp(x + a, b) is a map (a, b); two compose as
// (a1, b1) then (a2, b2) = (a1 + a2, logaddexp(b1 + a2, b2)), with
// (0, NEG) the identity. A block takes kHB neighbouring hypotheses x kC
// chunks of frames, a thread each: the threads of a warp run over
// hypotheses, so each frame row loads coalesced. Each thread loads its
// chunk's frames into registers and composes their maps; one warp per
// hypothesis scans the kC chunk maps by shuffles (each lane kC / 32 chunks)
// and hands each chunk its incoming state through shared memory; each
// thread then walks its chunk again from that state, writing r_nb. r_b
// follows in the same launch from r_b's inputs, valid ? r_nb(t-1) + lpb :
// NEG, where the chunk's first frame takes r_nb(t-1) from the scan's
// carry. The dependent chain per recurrence drops from T steps to about
// 2 * T / kC + kC / 32 + 5 + 1 (at T 751: ~24). T beyond kC * kLmax
// frames runs in segments, the state carried from one to the next.
// logaddexp uses ex2.approx / lg2.approx (log1p(e) = log2(1 + e) * ln 2,
// e in [0, 1]): absolute error ~1e-7, well inside the 1e-4 + 1e-5 * |x|
// the kernel is held to. The block is 8 hypotheses x 128 chunks of at
// most 6 frames: of the shapes timed on an H100 SXM (700 W), the shortest
// chunks, and so the shortest chain, were the fastest (PERF.md). There a
// 768-frame segment takes ~6.7 us and a launch at T 1 ~5 us, so at T
// 751 the launch and one round trip of loads, not the chain or the
// bytes, are most of the time.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kHB = 8;     // hypotheses per block
constexpr int kC = 128;    // chunks of frames per hypothesis, a thread each
constexpr int kLmax = 6;   // frames per chunk at most: a segment is kC * kLmax

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float r = fmaf(kLn2, lg2(1.f + ex2((fminf(a, b) - m) * kLog2e)), m);
  return m == -INFINITY ? m : r;  // both -inf (never at the scorer's NEG)
}

// The state entering chunk c of hypothesis hb, from each thread's chunk map
// (A, B) and the segment's entering state seg[hb], which becomes the
// segment's leaving state. One warp per hypothesis scans its kC chunk maps.
__device__ float carry_in(float A, float B, float* mA, float* mB, float* carry,
                          float* seg, int hb, int c) {
  constexpr int P = kC + 1;  // pitch: the threads' writes fall in distinct banks
  constexpr int R = kC / 32;
  mA[hb * P + c] = A;
  mB[hb * P + c] = B;
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (w < kHB) {
    float a[R], b[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      a[r] = mA[w * P + lane * R + r];
      b[r] = mB[w * P + lane * R + r];
    }
    float ta = a[0], tb = b[0];
#pragma unroll
    for (int r = 1; r < R; ++r) {
      tb = logaddexp(tb + a[r], b[r]);
      ta += a[r];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float pa = __shfl_up_sync(0xffffffffu, ta, o);
      const float pb = __shfl_up_sync(0xffffffffu, tb, o);
      if (lane >= o) {
        tb = logaddexp(pb + ta, tb);
        ta += pa;
      }
    }
    float ea = __shfl_up_sync(0xffffffffu, ta, 1);
    float eb = __shfl_up_sync(0xffffffffu, tb, 1);
    if (lane == 0) {
      ea = 0.f;
      eb = kNeg;
    }
    const float x0 = seg[w];
    __syncwarp();
    float x = logaddexp(x0 + ea, eb);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      carry[w * P + lane * R + r] = x;
      x = logaddexp(x + a[r], b[r]);
    }
    if (lane == 31) seg[w] = x;
  }
  __syncthreads();
  return carry[hb * P + c];
}

__global__ void __launch_bounds__(kHB * kC)
ctc_dp_kernel(const float* __restrict__ a_nb, const float* __restrict__ grow,
              const float* __restrict__ lpb, const float* __restrict__ valid,
              float* __restrict__ r_nb, float* __restrict__ r_b, int T, int N) {
  static_assert(kC % 32 == 0 && kHB * kC <= 1024, "kC / 32 warps per hypothesis scan");
  static_assert(kLmax <= 32, "one bit of `ok` per frame");
  __shared__ float mA[kHB * (kC + 1)], mB[kHB * (kC + 1)], carry[kHB * (kC + 1)];
  __shared__ float seg_nb[kHB], seg_b[kHB];
  const int hb = threadIdx.x % kHB;
  const int c = threadIdx.x / kHB;
  const int n = blockIdx.x * kHB + hb;
  if (threadIdx.x < kHB) {
    seg_nb[threadIdx.x] = kNeg;
    seg_b[threadIdx.x] = kNeg;
  }
  for (int s0 = 0; s0 < T; s0 += kC * kLmax) {
    const int seg = min(kC * kLmax, T - s0);
    const int len = (seg + kC - 1) / kC;  // frames per chunk; the last is ragged
    const int f0 = s0 + c * len;
    const int cl = n < N ? max(0, min(len, s0 + seg - f0)) : 0;
    float x1[kLmax], x2[kLmax], x3[kLmax];
    unsigned ok = 0;
#pragma unroll
    for (int k = 0; k < kLmax; ++k) {
      if (k < cl) {
        const size_t i = static_cast<size_t>(f0 + k) * N + n;
        x1[k] = a_nb[i];
        x2[k] = grow[i];
        x3[k] = lpb[i];
        ok |= (valid[i] > 0.f ? 1u : 0u) << k;
      }
    }
    // r_nb: compose, scan, walk.
    float A = 0.f, B = kNeg;
#pragma unroll
    for (int k = 0; k < kLmax; ++k) {
      if (k < cl) {
        B = logaddexp(B + x1[k], x2[k]);
        A += x1[k];
      }
    }
    const float nb_in = carry_in(A, B, mA, mB, carry, seg_nb, hb, c);
    float x = nb_in;
#pragma unroll
    for (int k = 0; k < kLmax; ++k) {
      if (k < cl) {
        x = logaddexp(x + x1[k], x2[k]);
        x2[k] = x;
        r_nb[static_cast<size_t>(f0 + k) * N + n] = x;
      }
    }
    // r_b's inputs, from the top so that x2[k - 1] is still r_nb.
#pragma unroll
    for (int k = kLmax - 1; k >= 0; --k) {
      if (k < cl) x2[k] = (ok >> k) & 1u ? (k ? x2[k - 1] : nb_in) + x3[k] : kNeg;
    }
    A = 0.f;
    B = kNeg;
#pragma unroll
    for (int k = 0; k < kLmax; ++k) {
      if (k < cl) {
        B = logaddexp(B + x3[k], x2[k]);
        A += x3[k];
      }
    }
    float y = carry_in(A, B, mA, mB, carry, seg_b, hb, c);
#pragma unroll
    for (int k = 0; k < kLmax; ++k) {
      if (k < cl) {
        y = logaddexp(y + x3[k], x2[k]);
        r_b[static_cast<size_t>(f0 + k) * N + n] = y;
      }
    }
  }
}

}  // namespace

// Plain C entry, bound with ctypes: six (T, N) float32 planes. Returns the
// CUDA error of the launch (0 on success); the launch is asynchronous on
// `stream`.
extern "C" int mamba_ctc_dp(const void* a_nb, const void* grow, const void* lpb,
                            const void* valid, void* r_nb, void* r_b, int T,
                            int N, void* stream) {
  if (T <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ctc_dp_kernel<<<(N + kHB - 1) / kHB, kHB * kC, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_nb), static_cast<const float*>(grow),
      static_cast<const float*>(lpb), static_cast<const float*>(valid),
      static_cast<float*>(r_nb), static_cast<float*>(r_b), T, N);
  return static_cast<int>(cudaGetLastError());
}
