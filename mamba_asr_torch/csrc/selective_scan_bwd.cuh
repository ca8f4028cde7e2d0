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
// does per cell (scan.py:470-475). The first version of this kernel gave
// each lane one state element (16 lanes per channel at N 16): every sum
// over n was a 4-level shuffle tree per step, the per-channel values were
// broadcast by shuffle, the loads and stores were scattered, and it ran at
// 26x its bound (0.747 ms at B32 L626 D288 N16 bf16 on an NVIDIA H100
// 80GB HBM3 at 700 W, PERF.md), its time following its instruction count;
// this one runs at 0.248 ms there (8.5x). Here, as in the forward kernel
// (selective_scan_fwd.cuh), 8 lanes share a channel and each lane holds NS
// of its states (1, 2 or 4: N rounded up to 8, 16 or 32; lane q holds n =
// q + 8 j). A block of 128 threads holds one batch row and 16 channels,
// so the main path runs 576 blocks, all resident at once (five per SM at
// 96 registers, with ~130 bytes of spills per thread). On the card two
// waves, from 4 blocks per SM at 128 registers or from 256-thread blocks
// of 32 channels, were clearly slower although they spilled less. Per chunk:
//   - staging: each thread turns 4 (channel, step) pairs, loaded
//     coalesced (16 channels of a step are 32 bytes, one sector), into
//     dt, dt u, dy = dout silu(z), u, softplus' and the dz factor in shared
//     memory, once per (row, channel, step), read by the lanes as
//     broadcasts, four steps at a time (float4); B and C likewise. The
//     previous chunk's rows are prefetched into L2 meanwhile.
//   - forward: each lane walks the 32 steps from the boundary state with
//     its NS states in registers (one MUFU.EX2 and two FMAs per state and
//     step), keeping the state before each sub-tile of kSub = 4 steps and
//     the last sub-tile's a_t and a_t h_{t-1}. The sum <h, C> of 8
//     consecutive steps is a reduce-scatter across the channel's 8 lanes
//     (7 shuffles per 8 steps, not 3 per step), which leaves lane q step
//     q's sum; it goes to shared memory.
//   - reverse: sub-tile by sub-tile from the last, the sub-tile's a_t
//     and a_t h_{t-1} are recomputed from its kept start state into
//     registers (the last one's come from the forward), then the lanes
//     walk it backward, carrying g in registers across sub-tiles and
//     chunks. <g, B> and <g a h, A> of 4 consecutive steps are one
//     reduce-scatter of 8 values.
//   - sums over channels (dB, dC): a lane's values of kCStep steps (4
//     values) are reduce-scattered across the warp's 4 channels (3
//     shuffles), the 4 warps' sums added in shared memory at the chunk's
//     end, in a fixed order, and each block writes one partial per
//     channel tile of 16.
//   - epilogue: the staging threads form du, ddelta and dz from the sums
//     and store them coalesced, and keep dD and ddelta_bias per channel.
// No atomics: the result is deterministic. Steps past L are identity
// (dt = 0, dy = 0) and store nothing, so the ragged end needs no padding.
//
// Bound. Inputs read once and outputs written once: u, delta, z, dout,
// B, C and the boundary states in; du, ddelta, dz and the dB/dC partials
// out (at B32 L626 D288 N16 bf16 about 95 MB, ~29 us at 3.35 TB/s); the
// exp2 of each state element plus ~5 special functions per channel step
// on the SFUs (~1.2e8, ~29 us); ~15 FP32 FLOP per state element. This
// design computes the exp2 twice per state element (forward, and the
// sub-tile recompute for all but the last sub-tile).
//
// Variants (P1; each the TPU script's function, numerically wrong on
// purpose except nloop; scripts/exp_scan_variants.py:383-563):
//   kNLoop      exact: the three sums over n taken in order n = 0 .. N-1,
//               each lane's term broadcast in turn by shuffle (a
//               sequential accumulator, as the TPU's nloop), not the
//               reduce-scatter
//   kNoExp      a_t = 1 + dt_t A log2e   (no MUFU.EX2, in both walks)
//   kNoSoftplus dt = delta + dt_bias, d(softplus) = 1
//   kNoFwdScan  the recomputed states are h_t = dt_t u_t B_t (no forward
//               recurrence)
//   kNoRevScan  g_t = dy_t C_t, plus the carry at the chunk's last step;
//               the carry out of a chunk is a_{t0} g_{t0} (no reverse
//               recurrence)
//   kNoReduceN  each sum over n replaced by the n = 0 term: <g, B> -> g_0,
//               <g a h, A> -> (g a h)_0 ln 2, <h, C> -> h_0; lane 0 of
//               the channel writes them (no reduce-scatter)
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
constexpr int kThreads = 128;
constexpr int kLanes = 8;                   // lanes per channel
constexpr int kCh = kThreads / kLanes;      // channels per block (one channel tile)
constexpr int kWarps = kThreads / 32;
constexpr int kChPerWarp = 32 / kLanes;     // channels per warp
constexpr int kRow = kChunk + 4;            // padded row of the [channel or n][step] tiles
constexpr int kPair = kCh * kChunk / kThreads;  // staged (channel, step) pairs per thread
constexpr int kPairStride = kThreads / kCh;     // step stride of a thread's pairs
// Steps of a reverse sub-tile: its a_t and a_t h_{t-1} are kept in
// registers, and its <g, B> and <g a h, A> (2 x 4 values) are one
// reduce-scatter across the channel's 8 lanes. 8-step sub-tiles (two
// reduce-scatters each) timed no faster on the card and spilled more.
constexpr int kSub = 4;
constexpr int kSubs = kChunk / kSub;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kChPerWarp == 4, "the channel reduce-scatter spans 4 channels");
static_assert(2 * kThreads <= kWarps * kChunk * kLanes, "sRedB holds the dD and ddb sums");

template <int NS>
struct Shape {
  static constexpr int kN = kLanes * NS;         // padded states
  static constexpr int kCStep = 4 / NS;          // steps per channel reduce-scatter
  static constexpr int kBC = kN * kChunk / kThreads;  // staged B, C per thread
  static constexpr int kMinBlocks = NS == 4 ? 3 : 5;
  // Shared memory in floats: sB, sC [kN][kRow]; nine [kCh][kRow] tiles;
  // the dB, dC sums of each warp [2][kWarps][kChunk][kN].
  static constexpr int kSmemFloats =
      2 * kN * kRow + 9 * kCh * kRow + 2 * kWarps * kChunk * kN;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// 2^x on the SFU: one MUFU.EX2, denormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(p)));
}

template <int V>
__device__ __forceinline__ float discretize(float x) {  // x = dt A log2e
  if constexpr (V == kNoExp) {
    return 1.f + x;
  } else {
    return ex2(x);
  }
}

// kLanes values in each lane of a kLanes-lane group -> lane q returns the
// sum over the group of v[q]. kLanes - 1 shuffles (selective_scan_fwd.cuh).
__device__ __forceinline__ float reduce_scatter(float (&v)[kLanes], int q) {
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off >>= 1) {
    const bool upper = (q & off) != 0;
#pragma unroll
    for (int j = 0; j < off; ++j) {
      const float send = upper ? v[j] : v[j + off];
      const float keep = upper ? v[j + off] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, off);
    }
  }
  return v[0];
}

// 4 values in each of the warp's 4 lanes that hold the same states (one
// per channel, lanes q, q + 8, q + 16, q + 24) -> the lane of channel cw
// returns the sum over the 4 channels of v[cw], as (v_cw + v_cw^2) +
// (v_cw^1 + v_cw^3). 3 shuffles.
__device__ __forceinline__ float channel_reduce_scatter(float (&v)[4], int cw) {
  const bool hi = (cw & 2) != 0;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = hi ? v[j] : v[j + 2];
    const float keep = hi ? v[j + 2] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, 16);
  }
  const bool odd = (cw & 1) != 0;
  const float send = odd ? v[0] : v[1];
  const float keep = odd ? v[1] : v[0];
  return keep + __shfl_xor_sync(kFull, send, 8);
}

template <int V, int NS, typename T>
__global__ void __launch_bounds__(kThreads, Shape<NS>::kMinBlocks)
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
  using S = Shape<NS>;
  constexpr int kN = S::kN;
  constexpr int kCStep = S::kCStep;

  extern __shared__ __align__(16) float smem[];
  float (*sB)[kRow] = reinterpret_cast<float (*)[kRow]>(smem);
  float (*sC)[kRow] = sB + kN;
  float (*sDt)[kRow] = sC + kN;     // dt (0 past L)
  float (*sDtu)[kRow] = sDt + kCh;  // dt u
  float (*sDy)[kRow] = sDtu + kCh;  // dy = dout silu(z)
  float (*sU)[kRow] = sDy + kCh;    // u
  float (*sDsp)[kRow] = sU + kCh;   // d softplus = sigmoid(raw)
  float (*sDzf)[kRow] = sDsp + kCh; // dout silu'(z)
  float (*sYp)[kRow] = sDzf + kCh;  // <h, C>
  float (*sS1)[kRow] = sYp + kCh;   // <g, B>
  float (*sS2)[kRow] = sS1 + kCh;   // <g a h, A log2e>
  float (*sRedB)[kChunk][kN] = reinterpret_cast<float (*)[kChunk][kN]>(sS2 + kCh);
  float (*sRedC)[kChunk][kN] = sRedB + kWarps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = tid & (kLanes - 1);
  const int cl = tid / kLanes;  // channel of this lane within the block
  const int cw = lane / kLanes; // channel of this lane within the warp
  const int group_base = lane & ~(kLanes - 1);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + cl;
  const size_t row = static_cast<size_t>(b) * L;
  const size_t state0 = (static_cast<size_t>(b) * D + d) * N;

  // a2 = A log2e; g and the dA sums of this lane's states.
  float a2[NS], g[NS], dA[NS];
  bool holds[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = q + j * kLanes;
    holds[j] = d < D && n < N;
    a2[j] = holds[j] ? A[static_cast<size_t>(d) * N + n] * kLog2e : 0.f;
    g[j] = (holds[j] && dh_last != nullptr) ? dh_last[state0 + n] : 0.f;
    dA[j] = 0.f;
  }

  // Staging roles: this thread's pairs are channel sc, steps st0 + k * kPairStride.
  const int sc = tid % kCh;
  const int st0 = tid / kCh;
  const int sd = d0 + sc;
  const bool s_ok = sd < D;
  const float bias = (s_ok && dt_bias != nullptr) ? dt_bias[sd] : 0.f;
  const float dsk = (s_ok && d_skip != nullptr) ? d_skip[sd] : 0.f;
  const bool sp_on = softplus_on != 0 && V != kNoSoftplus;
  float dD_acc = 0.f, ddb_acc = 0.f;

  const int n_chunks = (L + kChunk - 1) / kChunk;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncthreads();  // the previous chunk's tiles are read
    {
      float pu[kPair], pd[kPair], pz[kPair], po[kPair], pb[S::kBC], pc[S::kBC];
#pragma unroll
      for (int k = 0; k < kPair; ++k) {
        const int t = t0 + st0 + k * kPairStride;
        const bool ok = s_ok && t < L;
        const size_t idx = (row + t) * D + sd;
        pu[k] = ok ? to_f32(u[idx]) : 0.f;
        pd[k] = ok ? to_f32(delta[idx]) : 0.f;
        pz[k] = ok ? to_f32(z[idx]) : 0.f;
        po[k] = ok ? to_f32(dout[idx]) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < S::kBC; ++k) {
        const int i = tid + k * kThreads;
        const int tt = i / kN;
        const int n = i % kN;
        const bool ok = n < N && t0 + tt < L;
        const size_t off = (row + t0 + tt) * N + n;
        pb[k] = ok ? to_f32(Bm[off]) : 0.f;
        pc[k] = ok ? to_f32(Cm[off]) : 0.f;
      }
      if (c > 0) {  // the previous chunk (whole: only the last is ragged) into L2
        const size_t tp = row + t0 - kChunk + lane;
        const T* arr = warp == 0 ? u : warp == 1 ? delta : warp == 2 ? z : dout;
        prefetch_l2(arr + tp * D + d0);
        constexpr int kPerLine = 128 / static_cast<int>(sizeof(T));
        if (tid < (kChunk * N + kPerLine - 1) / kPerLine) {
          const size_t off = (row + t0 - kChunk) * N + static_cast<size_t>(tid) * kPerLine;
          prefetch_l2(Bm + off);
          prefetch_l2(Cm + off);
        }
      }
#pragma unroll
      for (int k = 0; k < kPair; ++k) {
        const int st = st0 + k * kPairStride;
        const float raw = pd[k] + bias;
        float dt = raw, dsp = 1.f;
        if (sp_on) {  // jax.nn.softplus and its derivative, sigmoid(raw)
          const float e = __expf(-fabsf(raw));
          dt = fmaxf(raw, 0.f) + log1pf(e);
          const float r = __frcp_rn(1.f + e);
          dsp = raw >= 0.f ? r : e * r;
        }
        const float zv = pz[k];
        const float sig = __frcp_rn(1.f + __expf(-zv));
        const float go = po[k];
        // Steps past L and channels past D: dt = 0, dy = 0 (identity).
        const bool ok = s_ok && t0 + st < L;
        sDt[sc][st] = ok ? dt : 0.f;
        sDtu[sc][st] = ok ? dt * pu[k] : 0.f;
        sDy[sc][st] = go * zv * sig;
        sU[sc][st] = pu[k];
        sDsp[sc][st] = dsp;
        sDzf[sc][st] = go * sig * (1.f + zv * (1.f - sig));
      }
#pragma unroll
      for (int k = 0; k < S::kBC; ++k) {
        const int i = tid + k * kThreads;
        sB[i % kN][i / kN] = pb[k];
        sC[i % kN][i / kN] = pc[k];
      }
    }
    float h[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = q + j * kLanes;
      h[j] = 0.f;
      if (holds[j]) {
        if (c > 0) {
          h[j] = h_chunks[((static_cast<size_t>(b) * n_chunks + c - 1) * D + d) * N + n];
        } else if (h0 != nullptr) {
          h[j] = h0[state0 + n];
        }
      }
    }
    __syncthreads();  // the chunk is staged

    // Forward: the chunk's states from the boundary state; <h, C> and the
    // dC sums per step; the state before each sub-tile, and the last
    // sub-tile's a_t and a_t h_{t-1}.
    float hck[kSubs][NS];
    float a_last[kSub][NS], ah_last[kSub][NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) hck[0][j] = h[j];
#pragma unroll
    for (int s8 = 0; s8 < kChunk / kLanes; ++s8) {
      float v[kLanes];
#pragma unroll
      for (int e4 = 0; e4 < kLanes; e4 += 4) {
        const int i4 = s8 * kLanes + e4;
        const float4 dt4 = *reinterpret_cast<const float4*>(&sDt[cl][i4]);
        const float4 du4 = *reinterpret_cast<const float4*>(&sDtu[cl][i4]);
        const float4 dy4 = *reinterpret_cast<const float4*>(&sDy[cl][i4]);
        const float dts[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
        const float dus[4] = {du4.x, du4.y, du4.z, du4.w};
        const float dys[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
        float bs[NS][4], cs[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 b4 = *reinterpret_cast<const float4*>(&sB[q + j * kLanes][i4]);
          const float4 c4 = *reinterpret_cast<const float4*>(&sC[q + j * kLanes][i4]);
          bs[j][0] = b4.x; bs[j][1] = b4.y; bs[j][2] = b4.z; bs[j][3] = b4.w;
          cs[j][0] = c4.x; cs[j][1] = c4.y; cs[j][2] = c4.z; cs[j][3] = c4.w;
        }
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i4 + e;
          if (i % kSub == 0 && i > 0) {
#pragma unroll
            for (int j = 0; j < NS; ++j) hck[i / kSub][j] = h[j];
          }
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float a = discretize<V>(dts[e] * a2[j]);
            const float ah = a * h[j];
            if constexpr (V == kNoFwdScan) {
              h[j] = dus[e] * bs[j][e];
            } else {
              h[j] = fmaf(dus[e], bs[j][e], ah);
            }
            if (i >= kChunk - kSub) {
              a_last[i - (kChunk - kSub)][j] = a;
              ah_last[i - (kChunk - kSub)][j] = ah;
            }
            if constexpr (V == kNLoop) {
              // In order of n: all lanes' j = 0 terms, then j = 1, ...
              const float pj = h[j] * cs[j][e];
#pragma unroll
              for (int jj = 0; jj < kLanes; ++jj) p += __shfl_sync(kFull, pj, group_base + jj);
            } else if constexpr (V == kNoReduceN) {
              if (j == 0) p = h[0];
            } else {
              p = fmaf(h[j], cs[j][e], p);
            }
            w[(i % kCStep) * NS + j] = h[j] * dys[e];
          }
          v[e4 + e] = p;
          if constexpr (V != kNoReduceD) {
            if ((i + 1) % kCStep == 0) {
              const float r = channel_reduce_scatter(w, cw);
              sRedC[warp][i + 1 - kCStep + cw / NS][q + (cw % NS) * kLanes] = r;
            }
          }
        }
      }
      const int base = s8 * kLanes;
      if constexpr (V == kNoReduceN) {
        if (q == 0) {
#pragma unroll
          for (int e = 0; e < kLanes; ++e) sYp[cl][base + e] = v[e];
        }
      } else if constexpr (V == kNLoop) {
        float mine = v[0];
#pragma unroll
        for (int e = 1; e < kLanes; ++e) mine = q == e ? v[e] : mine;
        sYp[cl][base + q] = mine;
      } else {
        sYp[cl][base + q] = reduce_scatter(v, q);
      }
    }

    // Reverse: sub-tile by sub-tile from the last.
#pragma unroll
    for (int sub = kSubs - 1; sub >= 0; --sub) {
      const int i4 = sub * kSub;
      const float4 dt4 = *reinterpret_cast<const float4*>(&sDt[cl][i4]);
      const float4 du4 = *reinterpret_cast<const float4*>(&sDtu[cl][i4]);
      const float4 dy4 = *reinterpret_cast<const float4*>(&sDy[cl][i4]);
      const float dts[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
      const float dus[4] = {du4.x, du4.y, du4.z, du4.w};
      const float dys[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
      float bs[NS][4], cs[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float4 b4 = *reinterpret_cast<const float4*>(&sB[q + j * kLanes][i4]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sC[q + j * kLanes][i4]);
        bs[j][0] = b4.x; bs[j][1] = b4.y; bs[j][2] = b4.z; bs[j][3] = b4.w;
        cs[j][0] = c4.x; cs[j][1] = c4.y; cs[j][2] = c4.z; cs[j][3] = c4.w;
      }
      // a_t and a_t h_{t-1} of the sub-tile: the forward's for the last,
      // recomputed from the kept start state (same arithmetic) otherwise.
      float ha[kSub][NS], hah[kSub][NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float hr = hck[sub][j];
#pragma unroll
        for (int e = 0; e < kSub; ++e) {
          if (sub == kSubs - 1) {
            ha[e][j] = a_last[e][j];
            hah[e][j] = ah_last[e][j];
          } else {
            ha[e][j] = discretize<V>(dts[e] * a2[j]);
            hah[e][j] = ha[e][j] * hr;
            if constexpr (V == kNoFwdScan) {
              hr = dus[e] * bs[j][e];
            } else {
              hr = fmaf(dus[e], bs[j][e], hah[e][j]);
            }
          }
        }
      }
      float v[2 * kSub];  // <g, B> of the 4 steps, then <g a h, A log2e>
      float w[4];
#pragma unroll
      for (int e = kSub - 1; e >= 0; --e) {
        const int i = i4 + e;  // step within the chunk
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          if constexpr (V == kNoRevScan) {
            g[j] = i == kChunk - 1 ? fmaf(dys[e], cs[j][e], g[j]) : dys[e] * cs[j][e];
          } else {
            g[j] = fmaf(dys[e], cs[j][e], g[j]);
          }
          const float gdh = V == kNoGh ? g[j] : g[j] * hah[e][j];
          dA[j] = fmaf(gdh, dts[e], dA[j]);
          if constexpr (V == kNLoop) {
            const float t1 = g[j] * bs[j][e];
            const float t2 = gdh * a2[j];
#pragma unroll
            for (int jj = 0; jj < kLanes; ++jj) {
              s1 += __shfl_sync(kFull, t1, group_base + jj);
              s2 += __shfl_sync(kFull, t2, group_base + jj);
            }
          } else if constexpr (V == kNoReduceN) {
            if (j == 0) {  // the epilogue's ln 2 makes s2 (g a h)_0 ln 2
              s1 = g[0];
              s2 = gdh;
            }
          } else {
            s1 = fmaf(g[j], bs[j][e], s1);
            s2 = fmaf(gdh, a2[j], s2);
          }
          w[(i % kCStep) * NS + j] = g[j] * dus[e];
          if constexpr (V == kNoRevScan) {
            if (i == 0) g[j] *= ha[e][j];
          } else {
            g[j] *= ha[e][j];
          }
        }
        v[e] = s1;
        v[kSub + e] = s2;
        if constexpr (V != kNoReduceD) {
          if (i % kCStep == 0) {
            const float r = channel_reduce_scatter(w, cw);
            sRedB[warp][i + cw / NS][q + (cw % NS) * kLanes] = r;
          }
        }
      }
      if constexpr (V == kNoReduceN) {
        if (q == 0) {
#pragma unroll
          for (int e = 0; e < kSub; ++e) {
            sS1[cl][i4 + e] = v[e];
            sS2[cl][i4 + e] = v[kSub + e];
          }
        }
      } else {
        float r;
        if constexpr (V == kNLoop) {  // every lane holds every sum: lane q keeps v[q]
          r = v[0];
#pragma unroll
          for (int e = 1; e < 2 * kSub; ++e) r = q == e ? v[e] : r;
        } else {
          r = reduce_scatter(v, q);
        }
        if (q < kSub) {
          sS1[cl][i4 + q] = r;
        } else {
          sS2[cl][i4 + q - kSub] = r;
        }
      }
    }
    __syncthreads();  // the sums of the chunk are in shared memory

    // Epilogue: du, ddelta, dz of this thread's pairs, stored coalesced.
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      const int st = st0 + k * kPairStride;
      const int t = t0 + st;
      if (s_ok && t < L) {
        const float s1 = sS1[sc][st];
        const float s2 = sS2[sc][st] * kLn2;
        const float uv = sU[sc][st];
        const float dy = sDy[sc][st];
        const float dd = fmaf(s1, uv, s2) * sDsp[sc][st];
        const size_t idx = (row + t) * D + sd;
        store(du + idx, fmaf(s1, sDt[sc][st], dy * dsk));
        store(ddelta + idx, dd);
        store(dz + idx, sDzf[sc][st] * fmaf(dsk, uv, sYp[sc][st]));
        dD_acc = fmaf(dy, uv, dD_acc);
        ddb_acc += dd;
      }
    }
    // The chunk's dB, dC partials of this channel tile: the warps' sums
    // added in warp order.
    const size_t part = (static_cast<size_t>(blockIdx.x) * batch + b) * L + t0;
    for (int i = tid; i < kChunk * kN; i += kThreads) {
      const int tt = i / kN;
      const int n = i % kN;
      if (t0 + tt < L && n < N) {
        float sb, sc2;
        if constexpr (V == kNoReduceD) {
          sb = sB[n][tt];
          sc2 = sC[n][tt];
        } else {
          sb = sRedB[0][tt][n];
          sc2 = sRedC[0][tt][n];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) {
            sb += sRedB[w][tt][n];
            sc2 += sRedC[w][tt][n];
          }
        }
        dB_part[(part + tt) * N + n] = sb;
        dC_part[(part + tt) * N + n] = sc2;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (holds[j]) {
      const int n = q + j * kLanes;
      dA_part[state0 + n] = dA[j];
      if (dh0 != nullptr) dh0[state0 + n] = g[j];
    }
  }
  // dD and ddelta_bias of each channel: its kPairStride staging threads'
  // sums, added in the order of their first step.
  __syncthreads();  // the last chunk's partial sums are read
  float* red = &sRedB[0][0][0];  // [2][kThreads]
  red[tid] = dD_acc;
  red[kThreads + tid] = ddb_acc;
  __syncthreads();
  if (tid < kCh && d0 + tid < D) {
    float sd_ = red[tid], sb_ = red[kThreads + tid];
#pragma unroll
    for (int k = 1; k < kPairStride; ++k) {
      sd_ += red[k * kCh + tid];
      sb_ += red[kThreads + k * kCh + tid];
    }
    dD_part[static_cast<size_t>(b) * D + d0 + tid] = sd_;
    ddb_part[static_cast<size_t>(b) * D + d0 + tid] = sb_;
  }
}

template <int V, int NS, typename T>
int launch_ns(const void* const* in, void* const* out, int batch, int L, int D,
              int N, int softplus_on, cudaStream_t stream) {
  constexpr int kBytes = Shape<NS>::kSmemFloats * static_cast<int>(sizeof(float));
  const auto kernel = bwd_kernel<V, NS, T>;
  if (kBytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 grid((D + kCh - 1) / kCh, batch);
  kernel<<<grid, kThreads, kBytes, stream>>>(
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
  if (N <= kLanes) return launch_ns<V, 1, T>(in, out, batch, L, D, N, softplus_on, stream);
  if (N <= 2 * kLanes) return launch_ns<V, 2, T>(in, out, batch, L, D, N, softplus_on, stream);
  return launch_ns<V, 4, T>(in, out, batch, L, D, N, softplus_on, stream);
}

// Channels per block, whatever d_state N: the dB/dC partials have
// ceil(D / this) channel tiles.
inline int channels_per_block(int /*N*/) { return kCh; }

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
