// Selective-scan (Mamba S6) adjoint for Hopper (sm_90a): the kernel body,
// templated on a variant tag. selective_scan_bwd.cu instantiates kBase
// (K2); scan_variants.cu instantiates every tag (P1's adjoint ablations).
//
// Replaces: mamba_asr_tpu/ops/pallas/scan.py:_scan_bwd_kernel (launched by
// selective_scan_bwd_pallas), and the variants of
// scripts/exp_scan_variants.py:make_bwd_kernel. Given the forward's
// inputs, its per-chunk boundary states (selective_scan_fwd.cuh, training
// form) and the cotangents dout (B, L, D) and d(h_last) (B, D, N), it
// returns
//
//   du, ddelta (through the softplus), dz      (B, L, D) in u's dtype
//   dB, dC partial sums, one per channel tile  (tiles, B, L, N) fp32
//   dA partial sums over time                  (B, D, N) fp32
//   dD, ddelta_bias partial sums over time     (B, D) fp32
//   dh0                                        (B, D, N) fp32
//
// The caller sums the partials over tiles / rows in torch. Math (fp32):
//
//   dt_t  = softplus(delta_t + dt_bias)            (or without softplus)
//   a_t   = exp(dt_t * A),  h_t = a_t h_{t-1} + dt_t u_t B_t
//   dy_t  = dout_t * silu(z_t)
//   g_t   = dy_t C_t + a_{t+1} g_{t+1},  g_{L-1} += d(h_last)
//   du_t  = dt_t <g_t, B_t> + D dy_t
//   ddt_t = u_t <g_t, B_t> + <g_t a_t h_{t-1}, A>,  ddelta = ddt * sigmoid(raw)
//   dB_t  = sum_d g_t dt_t u_t,  dC_t = sum_d h_t dy_t
//   dA    = sum_{b,t} g_t a_t h_{t-1} dt_t,  dD = sum_{b,t} dy_t u_t
//   dz_t  = dout_t (<h_t, C_t> + D u_t) silu'(z_t),  dh0 = a_0 g_0
//
// Layout is time-major, as in the JAX package, all tensors contiguous.
//
// Design. The reverse walk needs h_{t-1} at every step. Recovering it as
// (h_t - dbu_t) / a_t blows up where a_t = exp(dt A) underflows, so each
// chunk of kChunk = 32 steps is recomputed forward from the boundary
// state the forward kernel wrote, then walked backward, as the TPU kernel
// does per cell (scan.py:470-475). One thread owns one state element
// (row, channel, n): the NP lanes of a channel (NP = N rounded up to 8,
// 16 or 32) hold its N states, so the chunk's 32 states of each element
// stay in registers (an unrolled loop indexes them at compile time), and
// the sums over N (du, ddt, the pre-gate y) are warp shuffles. The
// per-channel special functions of a chunk (softplus, sigmoid, silu) are
// spread over the channel's lanes, each lane taking steps q, q + NP, ...,
// and broadcast by shuffle where a step needs them. Blocks hold 256 /
// NP channels (128 / 32 at NP 32) of one row and walk the row's chunks
// from last to first; g is carried in registers across chunks.
//
// Reductions. dB and dC sum over all channels: the channels of a warp
// by shuffle, the warps of a block in shared memory, and the blocks
// (channel tiles) as partials that the wrapper sums. dA, dD and
// ddelta_bias sum over time in registers and over rows in the wrapper.
// No atomics: the result is deterministic. Steps past L are identity
// (dt = 0, dy = 0) and store nothing, so the ragged end needs no padding.
//
// Bound. Inputs read once and outputs written once: u, delta, z, dout,
// B, C and the boundary states in; du, ddelta, dz and the dB/dC partials
// out (at B32 L626 D288 N16 bf16 about 95 MB, ~29 us at 3.35 TB/s); the
// exp2 of each state element plus ~5 special functions per channel step
// on the SFUs (~1.2e8, ~29 us); ~15 FP32 FLOP per state element. The
// redundant work of this simple design (the forward recompute, the
// per-step shuffles, dB/dC partials of 18 channel tiles) puts it well
// above that; making it fast is later work.
//
// Variants (P1; each the TPU script's function, numerically wrong on
// purpose except nloop; scripts/exp_scan_variants.py:383-563):
//   kNLoop      exact: the three sums over n taken in order n = 0 .. NP-1,
//               each lane's term broadcast in turn by shuffle (a
//               sequential accumulator, as the TPU's nloop), not the tree
//   kNoExp      a_t = 1 + dt_t A log2e   (no MUFU.EX2, in both walks)
//   kNoSoftplus dt = delta + dt_bias, d(softplus) = 1
//   kNoFwdScan  the recomputed states are h_t = dt_t u_t B_t (no forward
//               recurrence)
//   kNoRevScan  g_t = dy_t C_t, plus the carry at the chunk's last step;
//               the carry out of a chunk is a_{t0} g_{t0} (no reverse
//               recurrence)
//   kNoReduceN  each sum over n replaced by lane n = 0's term: <g, B> ->
//               g_0, <g a h, A> -> (g a h)_0 ln 2, <h, C> -> h_0
//   kNoReduceD  the dB, dC partials of each channel tile are B and C
//               themselves (no sums over channels)
//   kNoGh       g a h_{t-1} replaced by g

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace scan_bwd {

// Order of kernels/scan_variants.py:BWD_VARIANTS.
enum Variant : int {
  kBase = 0,
  kNLoop,
  kNoExp,
  kNoSoftplus,
  kNoFwdScan,
  kNoRevScan,
  kNoReduceN,
  kNoReduceD,
  kNoGh,
  kNumVariants
};

constexpr int kChunk = 32;  // must equal selective_scan_fwd.cuh's kTileT
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// jax.nn.softplus: logaddexp(x, 0), as in selective_scan_fwd.cuh.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <int NP>
struct Shape {
  static constexpr int kThreads = NP == 32 ? 128 : 256;
  static constexpr int kChannels = kThreads / NP;  // channels per block
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kPer = kChunk / NP;         // steps owned per lane
};

// Sum over the NP lanes of one channel group.
template <int NP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = NP / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The same sum taken in lane order 0 .. NP-1 (kNLoop).
template <int NP>
__device__ __forceinline__ float group_sum_in_order(float v, int group_base) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NP; ++j) s += __shfl_sync(kFull, v, group_base + j);
  return s;
}

// Sum over the channel groups of one warp (lanes with the same n).
template <int NP>
__device__ __forceinline__ float across_groups(float v) {
#pragma unroll
  for (int off = NP; off < 32; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <int V, int NP>
__device__ __forceinline__ float n_sum(float v, int group_base) {
  if constexpr (V == kNLoop) {
    return group_sum_in_order<NP>(v, group_base);
  } else {
    return group_sum<NP>(v);
  }
}

template <int V, int NP, typename T>
__global__ void __launch_bounds__(Shape<NP>::kThreads)
bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ delta,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const T* __restrict__ z, const T* __restrict__ dout,
    const float* __restrict__ A, const float* __restrict__ dt_bias,
    const float* __restrict__ d_skip, const float* __restrict__ h0,
    const float* __restrict__ dh_last, const float* __restrict__ h_chunks,
    T* __restrict__ du, T* __restrict__ ddelta, T* __restrict__ dz,
    float* __restrict__ dB_part, float* __restrict__ dC_part,
    float* __restrict__ dA_part, float* __restrict__ dD_part,
    float* __restrict__ ddb_part, float* __restrict__ dh0, int batch, int L,
    int D, int N, int softplus_on) {
  using S = Shape<NP>;
  __shared__ float sB[kChunk][NP];
  __shared__ float sC[kChunk][NP];
  __shared__ float sdB[S::kWarps][kChunk][NP];
  __shared__ float sdC[S::kWarps][kChunk][NP];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane & (NP - 1);  // state index n, and owner slot
  const int group_base = lane & ~(NP - 1);
  const int b = blockIdx.y;
  const int d = blockIdx.x * S::kChannels + threadIdx.x / NP;
  const bool active = d < D;
  const bool holds_state = active && q < N;
  const size_t state = (static_cast<size_t>(b) * D + d) * N + q;
  const bool sp_on = softplus_on != 0 && V != kNoSoftplus;

  const float a = holds_state ? A[static_cast<size_t>(d) * N + q] : 0.f;
  const float a2 = a * kLog2e;
  const float bias = (active && dt_bias != nullptr) ? dt_bias[d] : 0.f;
  const float dsk = (active && d_skip != nullptr) ? d_skip[d] : 0.f;
  float g = (holds_state && dh_last != nullptr) ? dh_last[state] : 0.f;
  float dA_acc = 0.f, dD_acc = 0.f, ddb_acc = 0.f;

  auto discretize = [&](float dt) {
    if constexpr (V == kNoExp) {
      return 1.f + dt * a2;
    } else {
      return exp2f(dt * a2);
    }
  };

  const size_t row = static_cast<size_t>(b) * L;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk's shared memory is read
    for (int i = threadIdx.x; i < kChunk * NP; i += S::kThreads) {
      const int tt = i / NP;
      const int n = i - tt * NP;
      const bool ok = t0 + tt < L && n < N;
      const size_t off = (row + t0 + tt) * N + n;
      sB[tt][n] = ok ? to_f32(Bm[off]) : 0.f;
      sC[tt][n] = ok ? to_f32(Cm[off]) : 0.f;
    }

    // Per-channel values of the steps this lane owns: q, q + NP, ...
    float pu[S::kPer], pdt[S::kPer], pdsp[S::kPer], pdy[S::kPer];
    float pdzf[S::kPer], pyp[S::kPer];
#pragma unroll
    for (int s = 0; s < S::kPer; ++s) {
      const int t = t0 + s * NP + q;
      pu[s] = pdt[s] = pdsp[s] = pdy[s] = pdzf[s] = pyp[s] = 0.f;
      if (active && t < L) {
        const size_t idx = (row + t) * D + d;
        const float raw = to_f32(delta[idx]) + bias;
        const float zv = to_f32(z[idx]);
        const float go = to_f32(dout[idx]);
        const float sig = sigmoid(zv);
        pu[s] = to_f32(u[idx]);
        pdt[s] = sp_on ? softplus(raw) : raw;
        pdsp[s] = sp_on ? sigmoid(raw) : 1.f;
        pdy[s] = go * zv * sig;
        pdzf[s] = go * sig * (1.f + zv * (1.f - sig));
      }
    }
    float h_start = 0.f;
    if (holds_state) {
      if (c > 0) {
        h_start = h_chunks[((static_cast<size_t>(b) * n_chunks + c - 1) * D + d) * N + q];
      } else if (h0 != nullptr) {
        h_start = h0[state];
      }
    }
    __syncthreads();  // sB, sC staged

    // Forward recompute of the chunk's states (same arithmetic as the
    // forward kernel) and of the pre-gate y's contraction.
    float hist[kChunk];
    float h = h_start;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int src = group_base + i % NP;
      const float dt = __shfl_sync(kFull, pdt[i / NP], src);
      const float uv = __shfl_sync(kFull, pu[i / NP], src);
      const float dbu = (dt * uv) * sB[i][q];
      if constexpr (V == kNoFwdScan) {
        h = dbu;
      } else {
        h = discretize(dt) * h + dbu;
      }
      hist[i] = h;
      float yp;
      if constexpr (V == kNoReduceN) {
        yp = __shfl_sync(kFull, h, group_base);
      } else {
        yp = n_sum<V, NP>(h * sC[i][q], group_base);
      }
      if (q == i % NP) pyp[i / NP] = yp;
    }

    // Reverse walk.
    const float g_carry = g;
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      const int src = group_base + i % NP;
      const float dt = __shfl_sync(kFull, pdt[i / NP], src);
      const float uv = __shfl_sync(kFull, pu[i / NP], src);
      const float dy = __shfl_sync(kFull, pdy[i / NP], src);
      const float h_prev = i > 0 ? hist[i > 0 ? i - 1 : 0] : h_start;
      const float da = discretize(dt);
      if constexpr (V == kNoRevScan) {
        g = dy * sC[i][q] + (i == kChunk - 1 ? g_carry : 0.f);
      } else {
        g += dy * sC[i][q];
      }
      const float gdh = V == kNoGh ? g : g * da * h_prev;
      dA_acc += gdh * dt;
      float s1, s2;
      if constexpr (V == kNoReduceN) {
        s1 = __shfl_sync(kFull, g, group_base);
        s2 = __shfl_sync(kFull, gdh, group_base) * kLn2;
      } else {
        s1 = n_sum<V, NP>(g * sB[i][q], group_base);
        s2 = n_sum<V, NP>(gdh * a, group_base);
      }
      if constexpr (V != kNoReduceD) {
        const float pB = across_groups<NP>(g * (dt * uv));
        const float pC = across_groups<NP>(hist[i] * dy);
        if (lane < NP) {
          sdB[warp][i][q] = pB;
          sdC[warp][i][q] = pC;
        }
      }
      if (q == i % NP && active && t0 + i < L) {
        const int s = i / NP;
        const size_t idx = (row + t0 + i) * D + d;
        const float dd = (s1 * pu[s] + s2) * pdsp[s];
        store(du + idx, s1 * pdt[s] + pdy[s] * dsk);
        store(ddelta + idx, dd);
        store(dz + idx, pdzf[s] * (pyp[s] + dsk * pu[s]));
        dD_acc += pdy[s] * pu[s];
        ddb_acc += dd;
      }
      if constexpr (V == kNoRevScan) {
        if (i == 0) g *= da;
      } else {
        g *= da;
      }
    }
    __syncthreads();  // sdB, sdC complete

    for (int j = threadIdx.x; j < kChunk * NP; j += S::kThreads) {
      const int tt = j / NP;
      const int n = j - tt * NP;
      if (t0 + tt < L && n < N) {
        float sb = 0.f, sc = 0.f;
        if constexpr (V == kNoReduceD) {
          sb = sB[tt][n];
          sc = sC[tt][n];
        } else {
#pragma unroll
          for (int w = 0; w < S::kWarps; ++w) {
            sb += sdB[w][tt][n];
            sc += sdC[w][tt][n];
          }
        }
        const size_t off =
            ((static_cast<size_t>(blockIdx.x) * batch + b) * L + t0 + tt) * N + n;
        dB_part[off] = sb;
        dC_part[off] = sc;
      }
    }
  }

  if (holds_state) {
    dA_part[state] = dA_acc;
    if (dh0 != nullptr) dh0[state] = g;
  }
  dD_acc = group_sum<NP>(dD_acc);
  ddb_acc = group_sum<NP>(ddb_acc);
  if (active && q == 0) {
    dD_part[static_cast<size_t>(b) * D + d] = dD_acc;
    ddb_part[static_cast<size_t>(b) * D + d] = ddb_acc;
  }
}

template <int V, int NP, typename T>
int launch_np(const void* const* in, void* const* out, int batch, int L, int D,
              int N, int softplus_on, cudaStream_t stream) {
  using S = Shape<NP>;
  const dim3 grid((D + S::kChannels - 1) / S::kChannels, batch);
  bwd_kernel<V, NP, T><<<grid, S::kThreads, 0, stream>>>(
      static_cast<const T*>(in[0]), static_cast<const T*>(in[1]),
      static_cast<const T*>(in[2]), static_cast<const T*>(in[3]),
      static_cast<const T*>(in[4]), static_cast<const T*>(in[5]),
      static_cast<const float*>(in[6]), static_cast<const float*>(in[7]),
      static_cast<const float*>(in[8]), static_cast<const float*>(in[9]),
      static_cast<const float*>(in[10]), static_cast<const float*>(in[11]),
      static_cast<T*>(out[0]), static_cast<T*>(out[1]), static_cast<T*>(out[2]),
      static_cast<float*>(out[3]), static_cast<float*>(out[4]),
      static_cast<float*>(out[5]), static_cast<float*>(out[6]),
      static_cast<float*>(out[7]), static_cast<float*>(out[8]), batch, L, D,
      N, softplus_on);
  return static_cast<int>(cudaGetLastError());
}

template <int V, typename T>
int launch_t(const void* const* in, void* const* out, int batch, int L, int D,
             int N, int softplus_on, cudaStream_t stream) {
  if (N <= 8) return launch_np<V, 8, T>(in, out, batch, L, D, N, softplus_on, stream);
  if (N <= 16) return launch_np<V, 16, T>(in, out, batch, L, D, N, softplus_on, stream);
  return launch_np<V, 32, T>(in, out, batch, L, D, N, softplus_on, stream);
}

// Channels per block for d_state N: the dB/dC partials have
// ceil(D / this) channel tiles.
inline int channels_per_block(int N) {
  if (N <= 8) return Shape<8>::kChannels;
  if (N <= 16) return Shape<16>::kChannels;
  return Shape<32>::kChannels;
}

// Variant V. in = {u, delta, B, C, z, dout, A, dt_bias, d_skip, h0,
// dh_last, h_chunks}; out = {du, ddelta, dz, dB_part, dC_part, dA_part,
// dD_part, ddb_part, dh0}. Returns the CUDA error of the launch.
template <int V>
int launch(const void* const* in, void* const* out, int batch, int L, int D,
           int N, int is_bf16, int softplus_on, cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || D <= 0 || N <= 0 || N > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return is_bf16
             ? launch_t<V, __nv_bfloat16>(in, out, batch, L, D, N, softplus_on, stream)
             : launch_t<V, float>(in, out, batch, L, D, N, softplus_on, stream);
}

}  // namespace scan_bwd
