// CTC prefix-score frame recurrences for Hopper (sm_90a).
//
// Replaces: mamba_asr_tpu/ops/pallas/log_scan.py:_ctc_dp_kernel (launched
// by ctc_dp_pallas), both log-semiring recurrences of
// CTCPrefixScorer.select in one launch:
//
//   r_nb(t) = logaddexp(r_nb(t-1) + a_nb(t), grow(t))
//   r_b(t)  = logaddexp(r_b(t-1) + lpb(t), valid(t) ? r_nb(t-1) + lpb(t) : NEG)
//
// with r(-1) = -inf (so r_nb(0) = grow(0)) and NEG = -1e30, the scorer's
// finite stand-in for -inf. logaddexp(a, b) = max + log1p(exp(-|a - b|)),
// which stays finite at the sentinels, as torch.logaddexp does.
// Layout (T, N) float32, all six planes contiguous: frame-major, so the
// threads of a warp, one per hypothesis, read neighbouring addresses.
//
// Design. One thread per hypothesis walks t = 0..T-1 and fuses the two
// recurrences: r_b(t) needs r_nb(t-1), which the same thread has just
// computed, so each step is a chain of two logaddexps. The frames' inputs
// do not depend on the recurrence: the thread loads a tile of kTile
// frames into registers at once, so their memory latencies overlap, then
// walks the tile. Rows of hypotheses that chose eos are computed like the
// others (the caller discards them). On the TPU the kernel solves each
// recurrence with a two-level affine-map scan over the whole (T, N)
// block in VMEM (log-depth, stage-count bound there); here it is a plain
// sequential walk.
//
// Bound. Four planes in and two out, 24 * T * N bytes: at T 751 and
// N 528, 9.5 MB, ~2.8 us at 3.35 TB/s; four special-function results per
// (t, n). This design is latency-bound instead: T dependent steps of two
// logaddexps each (~100 cycles), tens of microseconds whatever N is, with
// only ceil(N / 64) blocks. The TPU kernel's two-level scan (chunks of
// frames solved in parallel, then a carry across chunks) is the redesign.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 64;  // hypotheses per block
constexpr int kTile = 16;     // frames loaded ahead per thread
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  if (a == b && fabsf(a) == INFINITY) return a;  // both -inf (or +inf)
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void __launch_bounds__(kThreads)
ctc_dp_kernel(const float* __restrict__ a_nb, const float* __restrict__ grow,
              const float* __restrict__ lpb, const float* __restrict__ valid,
              float* __restrict__ r_nb, float* __restrict__ r_b, int T, int N) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  float nb = grow[n];
  float b = valid[n] > 0.f ? kNeg + lpb[n] : kNeg;
  r_nb[n] = nb;
  r_b[n] = b;
  for (int t0 = 1; t0 < T; t0 += kTile) {
    float a[kTile], g[kTile], l[kTile], v[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const size_t i = static_cast<size_t>(t0 + k) * N + n;
      const bool in = t0 + k < T;
      a[k] = in ? a_nb[i] : 0.f;
      g[k] = in ? grow[i] : kNeg;
      l[k] = in ? lpb[i] : 0.f;
      v[k] = in ? valid[i] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      if (t0 + k >= T) break;
      const size_t i = static_cast<size_t>(t0 + k) * N + n;
      const float from_nb = v[k] > 0.f ? nb + l[k] : kNeg;  // r_nb(t-1)
      nb = logaddexp(nb + a[k], g[k]);
      b = logaddexp(b + l[k], from_nb);
      r_nb[i] = nb;
      r_b[i] = b;
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
  const int blocks = (N + kThreads - 1) / kThreads;
  ctc_dp_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a_nb), static_cast<const float*>(grow),
      static_cast<const float*>(lpb), static_cast<const float*>(valid),
      static_cast<float*>(r_nb), static_cast<float*>(r_b), T, N);
  return static_cast<int>(cudaGetLastError());
}
