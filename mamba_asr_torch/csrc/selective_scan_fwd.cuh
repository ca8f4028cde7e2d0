// Selective-scan (Mamba S6) forward for Hopper (sm_90a): the kernel body,
// templated on a variant tag. selective_scan_fwd.cu instantiates kBase
// (K1); scan_variants.cu instantiates every tag (P1's forward ablations).
//
// Replaces: mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel (K1) and the
// forward variants of scripts/exp_scan_variants.py:make_kernel (P1).
//
//   dt    = softplus(delta + dt_bias)                 (when softplus_on)
//   h_t   = exp(dt * A) * h_{t-1} + dt * u_t * B_t    (fp32, h_0 = h0 or 0)
//   y_t   = <h_t, C_t> + D * u_t
//   out_t = y_t * silu(z_t)                           (in u's dtype)
//
// Layout is time-major, as in the JAX package: u, delta, z, out (B, L, D);
// B, C (B, L, N); A (D, N) fp32; dt_bias, D (D,) fp32; h0, h_last (B, D, N)
// fp32; h_chunks (B, ceil(L / 32), D, N) fp32. All tensors contiguous.
//
// Training form (h_chunks not null): the state after every kTileT = 32
// steps (after step L for the ragged final chunk) is written out, the
// residual the adjoint (selective_scan_bwd.cuh) starts each chunk from.
// `out` is bit-identical between the two forms (the extra store changes
// no arithmetic).
//
// Design. The work is B * D * N independent recurrences (147,456 at the
// main path's B32 D288 N16); the first version of this kernel gave each
// thread a whole channel (9,216 threads, 96 blocks, ~half a warp per
// scheduler) and was latency-bound at 26x its bound. Here 8 lanes share a channel and each
// lane holds NS = ceil(N / 8) of its states (2 at N 16), as the adjoint
// spreads a channel over lanes. A block of 128 threads holds one batch
// row and 16 neighbouring channels (32 bytes per step of each bf16 (B, L,
// D) array, one sector), so the main path runs 576 blocks, all resident
// at once (five per SM; 256-thread blocks with one state per lane left 48
// blocks to a second wave). The block walks time in tiles of 32 steps:
//   - staging: each thread converts 4 (channel, step) pairs, loaded
//     during the previous tile (a register prefetch), into shared memory:
//     dt after the softplus, dt * u, D * u and silu(z), once per (row,
//     channel, step) and not once per lane; B and C likewise.
//   - recurrence: each lane walks the 32 steps with its NS states in
//     registers, reading the staged values four steps at a time (float4);
//     per state and step one MUFU.EX2 and three FMAs. Two states per lane
//     halve the shared-memory loads of dt and dt * u per state, and their
//     two products with C add in a register before any shuffle.
//   - y: the 8 lanes' partial sums for 8 consecutive steps are summed by
//     a reduce-scatter across the lanes (7 shuffles per 8 steps, not 3 per
//     step), which leaves lane q the sum of step q; it applies D * u and
//     the gate and puts out in shared memory, and the next tile's staging
//     pass stores out coalesced.
// Measured on an H100 (PERF.md) the first layout, 16 lanes of one
// state and 256-thread blocks, ran at 0.29 ms, and every block walked its
// steps at ~340 cycles each whatever the occupancy: the time followed the
// instruction count (the y reduction 40 %, the accurate softplus and silu
// of the staging ~18 %). No atomics: the result is deterministic.
//
// Bound. Each input is read once and out written once (at B32 L751 D288
// N16 bf16, ~57 MB, 17 us at 3.35 TB/s); the SFU computes one exp2 per
// state element plus ~4 special functions per channel step (softplus and
// silu), 1.38e8 results, 33 us at 16 per clock per SM: operations.
//
// Small batches. At B1 the rows and channel groups give 18 blocks, and
// each walks 751 steps in turn (0.051 ms, 50x its bound, on an H100 in the
// unsplit form). Where they give fewer than 2 blocks per SM the wrapper
// (kernels/selective_scan.py:time_segments) splits time into segments of
// whole tiles, to about 4 blocks per SM, and launches twice: a segment
// pass walks every segment but the last from a zero state and keeps its
// end state and its sum of dt, and the walk starts each segment from h0
// folded through the earlier segments, h = exp2(A log2e sum(dt)) h +
// h_end (the segment's product of decays is the exp2 of the summed
// exponent). The exp2 work doubles, the latency divides by the number of
// segments.
//
// Variants (P1; numerically wrong on purpose except nloop and fusedy,
// each the TPU script's function, scripts/exp_scan_variants.py:104-254):
//   kNoExp      da = 1 + dt * A                  (no MUFU.EX2 in the walk)
//   kNoSoftplus dt = delta + dt_bias
//   kNoScan     h_t = dt u_t B_t: the dependency on h_{t-1} goes; da is
//               still computed and consumed (fmaf(da, 0, dbu)), so the
//               delta to base is the recurrence's latency alone
//   kNoDbu      the input term is u_t, not dt u_t B_t
//   kNoY        y_t = u_t: no h * C products, no reduction over N
//   kFastExp    exp(x) as the script's 2^floor * cubic, on the FMA pipes
//   kBf16Scan   da, dt u B and h rounded to bf16, h updated by one bf16 FMA
//   kNLoop      exact: y summed over n in order n = 0 .. N-1, each lane's
//               term broadcast in turn by shuffle (a sequential accumulator
//               over n, as the TPU's nloop layout), not the reduce-scatter
//   kFusedY     exact: the TPU's fusedy folds the C contraction into the
//               scan combine so that hs (L, N, D) is never stored; here the
//               state never leaves a register and y is formed step by step
//               in every variant, so fusedy is base by construction:
//               scan_variants.cu launches kBase for it

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace scan_fwd {

// Order of kernels/scan_variants.py:FWD_VARIANTS.
enum Variant : int {
  kBase = 0,
  kNoExp,
  kNoSoftplus,
  kNoScan,
  kNoDbu,
  kNoY,
  kFastExp,
  kBf16Scan,
  kNLoop,
  kFusedY,
  kNumVariants
};

constexpr int kThreads = 128;
constexpr int kLanes = 8;          // lanes per channel; a lane holds NS states
constexpr int kCh = kThreads / kLanes;  // channels per block
constexpr int kTileT = 32;         // steps staged per pass; the training form's chunk
constexpr int kRow = kTileT + 4;   // padded row of the [channel or n][step] tiles
constexpr int kSub = kTileT / kLanes;   // kLanes-step sub-tiles of a tile
constexpr int kPair = kCh * kTileT / kThreads;  // staged (channel, step) pairs per thread
constexpr int kPairStride = kThreads / kCh;     // step stride of a thread's pairs
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// jax.nn.softplus: logaddexp(x, 0), stable for large |x|. log1pf stays
// accurate: at the Mamba init dt reaches 1e-3, where an absolute error of
// 4e-7 in dt would be a relative 4e-4 in the states it feeds.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(__expf(-fabsf(x)));
}

// silu(z) = z / (1 + exp(-z)); the fast divide returns 0 where exp(-z)
// overflows, as the true value (z e^z) is there.
__device__ __forceinline__ float silu(float z) { return __fdividef(z, 1.f + __expf(-z)); }

// 2^x on the SFU: one MUFU.EX2, denormal results flushed to 0 (below
// 2^-126 the state's decay term is zero to float32's resolution).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// scripts/exp_scan_variants.py:172-181: exp(x) = 2^floor(y) * cubic(frac),
// y = max(x log2e, -120).
__device__ __forceinline__ float fast_exp(float x) {
  const float y = fmaxf(x * kLog2e, -120.f);
  const float yi = floorf(y);
  const float yf = y - yi;
  const float p = 1.f + yf * (0.6931471f + yf * (0.2401597f + yf * 0.0558027f));
  return __int_as_float((static_cast<int>(yi) + 127) << 23) * p;
}

// kLanes values in each lane of a kLanes-lane group -> lane q returns the
// sum over the group of v[q]. kLanes - 1 shuffles.
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

// The launch's arguments (see the C entry in selective_scan_fwd.cu); the
// kernel takes them one by one, so that its pointers are __restrict__
// parameters (read through the read-only path: with the pointers in a
// struct the main path's launch took ~20 % longer on an H100).
// segments > 1 splits time into segments of seg_len steps (a multiple of
// kTileT): seg_h (B, segments - 1, D, N) and seg_dt (B, segments - 1, D)
// hold each segment's local end state and its sum of dt.
struct FwdArgs {
  const void* u;
  const void* delta;
  const void* Bm;
  const void* Cm;
  const void* z;
  const float* A;
  const float* dt_bias;
  const float* d_skip;
  const float* h0;
  void* out;
  float* h_last;
  float* h_chunks;
  float* seg_h;
  float* seg_dt;
  int batch, L, D, N, softplus_on, seg_len, segments;
};

// The three forms of the kernel: one block walks a row's whole length
// (kWhole); or time is split, and a block (channel group, row, segment
// blockIdx.z) either walks its segment from a zero state and writes only
// its end state and sum of dt (kSegmentPass), or starts its segment from
// h0 folded through the earlier segments' (sum of dt, end state) and
// walks it (kSegmentWalk). kWhole keeps its tile range at compile time:
// with the segment's range read at run time the main path's launch took
// ~20 % longer on an H100.
enum Form : int { kWhole = 0, kSegmentPass, kSegmentWalk };

// NS states per lane: lane q of a channel holds n = q + j * kLanes, j < NS.
template <int V, int NS, typename T, int FORM>
__global__ void __launch_bounds__(kThreads, 5)
fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
           const T* __restrict__ Bm, const T* __restrict__ Cm,
           const T* __restrict__ z, const float* __restrict__ A,
           const float* __restrict__ dt_bias, const float* __restrict__ d_skip,
           const float* __restrict__ h0, T* __restrict__ out,
           float* __restrict__ h_last, float* __restrict__ h_chunks,
           float* __restrict__ seg_h, float* __restrict__ seg_dt, int L, int D,
           int N, int softplus_on, int seg_len, int segments) {
  constexpr bool LOCAL = FORM == kSegmentPass;
  constexpr int kN = kLanes * NS;                            // padded states
  constexpr int kBC = (kN * kTileT + kThreads - 1) / kThreads;  // staged B, C per thread

  __shared__ __align__(16) float sB[kN][kRow];
  __shared__ __align__(16) float sC[kN][kRow];
  __shared__ __align__(16) float sDt[kCh][kRow];
  __shared__ __align__(16) float sDtu[kCh][kRow];
  __shared__ __align__(16) float sDu[kCh][kRow];
  __shared__ __align__(16) float sGate[kCh][kRow];
  __shared__ __align__(16) float sOut[kCh][kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = tid & (kLanes - 1);
  const int cl = tid / kLanes;        // channel of this lane within the block
  const int group_base = lane & ~(kLanes - 1);
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + cl;
  const size_t row = static_cast<size_t>(b) * L;
  const size_t state0 = (static_cast<size_t>(b) * D + d) * N;

  // a2 = A * log2e (A itself for the variants that take exp(x) of x = dt A).
  float a2[NS], h[NS];
  __nv_bfloat16 hb[NS];
  bool holds[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int n = q + j * kLanes;
    holds[j] = d < D && n < N;
    a2[j] = 0.f;
    h[j] = 0.f;
    if (holds[j]) {
      const float a = A[static_cast<size_t>(d) * N + n];
      a2[j] = (V == kNoExp || V == kFastExp) ? a : a * kLog2e;
      if (!LOCAL && h0 != nullptr) h[j] = h0[state0 + n];
    }
  }
  const int seg = FORM == kWhole ? 0 : blockIdx.z;
  if (FORM == kSegmentWalk && seg > 0 && d < D) {
    for (int sp = 0; sp < seg; ++sp) {
      const size_t at = (static_cast<size_t>(b) * (segments - 1) + sp) * D + d;
      const float dt_sum = seg_dt[at];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (holds[j]) h[j] = fmaf(ex2(a2[j] * dt_sum), h[j], seg_h[at * N + q + j * kLanes]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) hb[j] = __float2bfloat16(h[j]);

  // Staging roles: this thread's pairs are channel sc, steps st0 + k * kPairStride.
  const int sc = tid % kCh;
  const int st0 = tid / kCh;
  const int sd = d0 + sc;
  const bool s_ok = sd < D;
  const float bias = (s_ok && dt_bias != nullptr) ? dt_bias[sd] : 0.f;
  const float dsk = (s_ok && d_skip != nullptr) ? d_skip[sd] : 0.f;
  const bool sp_on = softplus_on != 0 && V != kNoSoftplus;

  float pu[kPair], pd[kPair], pz[kPair], pb[kBC], pc[kBC];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      const int t = t0 + st0 + k * kPairStride;
      const bool ok = s_ok && t < L;
      const size_t idx = (row + t) * D + sd;
      pu[k] = ok ? to_f32(u[idx]) : 0.f;
      pd[k] = ok ? to_f32(delta[idx]) : 0.f;
      pz[k] = ok ? to_f32(z[idx]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      const int tt = i / kN;
      const int n = i % kN;
      const bool ok = i < kN * kTileT && n < N && t0 + tt < L;
      const size_t off = (row + t0 + tt) * N + n;
      pb[k] = ok ? to_f32(Bm[off]) : 0.f;
      pc[k] = ok ? to_f32(Cm[off]) : 0.f;
    }
  };
  // out of the previous tile, staged in sOut, stored coalesced.
  auto store_out = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      const int st = st0 + k * kPairStride;
      if (s_ok && t0 + st < L) store(out + (row + t0 + st) * D + sd, sOut[sc][st]);
    }
  };

  const int n_chunks = (L + kTileT - 1) / kTileT;
  const int tile_begin = FORM == kWhole ? 0 : seg * (seg_len / kTileT);
  const int tile_end = FORM == kWhole ? n_chunks : min(n_chunks, tile_begin + seg_len / kTileT);
  float dt_sum = 0.f;  // LOCAL: the segment's sum of dt
  prefetch(tile_begin * kTileT);
  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int t0 = tile * kTileT;
    __syncthreads();  // the previous tile's staged values and sOut are read
    if (!LOCAL && tile > tile_begin) store_out(t0 - kTileT);
#pragma unroll
    for (int k = 0; k < kPair; ++k) {
      const int st = st0 + k * kPairStride;
      const bool ok = s_ok && t0 + st < L;
      float dt = pd[k] + bias;
      if (sp_on) dt = softplus(dt);
      const float uv = pu[k];
      // Steps past L and channels past D are identity steps (dt = 0).
      sDt[sc][st] = ok ? dt : 0.f;
      sDtu[sc][st] = ok ? (V == kNoDbu ? uv : dt * uv) : 0.f;
      if constexpr (!LOCAL) {
        sDu[sc][st] = V == kNoY ? uv + dsk * uv : dsk * uv;
        sGate[sc][st] = silu(pz[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kBC; ++k) {
      const int i = tid + k * kThreads;
      if (i < kN * kTileT) {
        sB[i % kN][i / kN] = pb[k];
        sC[i % kN][i / kN] = pc[k];
      }
    }
    if (tile + 1 < tile_end) prefetch(t0 + kTileT);  // in flight during the walk
    __syncthreads();

    const int tn = min(kTileT, L - t0);
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      float v[kLanes];
      float y_mine = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < kLanes; j4 += 4) {
        const int t4 = s * kLanes + j4;
        const float4 dt4 = *reinterpret_cast<const float4*>(&sDt[cl][t4]);
        const float4 du4 = *reinterpret_cast<const float4*>(&sDtu[cl][t4]);
        const float dts[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
        const float dus[4] = {du4.x, du4.y, du4.z, du4.w};
        float bs[NS][4], cs[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 b4 = *reinterpret_cast<const float4*>(&sB[q + j * kLanes][t4]);
          const float4 c4 = *reinterpret_cast<const float4*>(&sC[q + j * kLanes][t4]);
          bs[j][0] = b4.x; bs[j][1] = b4.y; bs[j][2] = b4.z; bs[j][3] = b4.w;
          cs[j][0] = c4.x; cs[j][1] = c4.y; cs[j][2] = c4.z; cs[j][3] = c4.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (LOCAL) dt_sum += dts[e];
          float p = 0.f;
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float x = dts[e] * a2[j];
            float da;
            if constexpr (V == kNoExp) {
              da = 1.f + x;
            } else if constexpr (V == kFastExp) {
              da = fast_exp(x);
            } else {
              da = ex2(x);
            }
            const float dbu = V == kNoDbu ? dus[e] : dus[e] * bs[j][e];
            if constexpr (V == kNoScan) {
              if (t4 + e < tn) h[j] = fmaf(da, 0.f, dbu);
            } else if constexpr (V == kBf16Scan) {
              hb[j] = __hfma(__float2bfloat16(da), hb[j], __float2bfloat16(dbu));
              h[j] = __bfloat162float(hb[j]);
            } else {
              h[j] = fmaf(da, h[j], dbu);
            }
            if constexpr (LOCAL) {
              // the segment pass needs the state alone
            } else if constexpr (V == kNLoop) {
              // In order of n: all lanes' j = 0 terms, then j = 1, ...
              const float pj = h[j] * cs[j][e];
#pragma unroll
              for (int jj = 0; jj < kLanes; ++jj) p += __shfl_sync(kFull, pj, group_base + jj);
            } else {
              p = fmaf(h[j], cs[j][e], p);
            }
          }
          if constexpr (V == kNLoop) {
            if (q == j4 + e) y_mine = p;
          } else if constexpr (!LOCAL) {
            v[j4 + e] = p;
          }
        }
      }
      if constexpr (!LOCAL) {
        if constexpr (V != kNoY && V != kNLoop) y_mine = reduce_scatter(v, q);
        const int t = s * kLanes + q;
        sOut[cl][t] = ((V == kNoY ? 0.f : y_mine) + sDu[cl][t]) * sGate[cl][t];
      }
    }
    if (!LOCAL && h_chunks != nullptr) {
      const size_t base = ((static_cast<size_t>(b) * n_chunks + tile) * D + d) * N;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (holds[j]) h_chunks[base + q + j * kLanes] = h[j];
      }
    }
  }
  if constexpr (LOCAL) {
    const size_t at = (static_cast<size_t>(b) * (segments - 1) + seg) * D + d;
    if (q == 0 && d < D) seg_dt[at] = dt_sum;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (holds[j]) seg_h[at * N + q + j * kLanes] = h[j];
    }
  } else {
    __syncthreads();
    store_out((tile_end - 1) * kTileT);
    if (h_last != nullptr && (FORM == kWhole || seg == segments - 1)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        if (holds[j]) h_last[state0 + q + j * kLanes] = h[j];
      }
    }
  }
}

#define KERNEL_ARGS(T)                                                            \
  static_cast<const T*>(args.u), static_cast<const T*>(args.delta),               \
      static_cast<const T*>(args.Bm), static_cast<const T*>(args.Cm),             \
      static_cast<const T*>(args.z), args.A, args.dt_bias, args.d_skip, args.h0,  \
      static_cast<T*>(args.out), args.h_last, args.h_chunks, args.seg_h,          \
      args.seg_dt, args.L, args.D, args.N, args.softplus_on, args.seg_len,        \
      args.segments

template <int V, int NS, typename T>
int launch_ns(const FwdArgs& args, cudaStream_t stream) {
  const unsigned groups = (args.D + kCh - 1) / kCh;
  if constexpr (V == kBase) {
    if (args.segments > 1) {
      fwd_kernel<V, NS, T, kSegmentPass><<<dim3(groups, args.batch, args.segments - 1),
                                           kThreads, 0, stream>>>(KERNEL_ARGS(T));
      const cudaError_t rc = cudaGetLastError();
      if (rc != cudaSuccess) return static_cast<int>(rc);
      fwd_kernel<V, NS, T, kSegmentWalk><<<dim3(groups, args.batch, args.segments),
                                           kThreads, 0, stream>>>(KERNEL_ARGS(T));
      return static_cast<int>(cudaGetLastError());
    }
  }
  fwd_kernel<V, NS, T, kWhole><<<dim3(groups, args.batch), kThreads, 0, stream>>>(
      KERNEL_ARGS(T));
  return static_cast<int>(cudaGetLastError());
}
#undef KERNEL_ARGS

template <int V, typename T>
int launch_t(const FwdArgs& args, cudaStream_t stream) {
  if (args.N <= kLanes) return launch_ns<V, 1, T>(args, stream);
  if (args.N <= 2 * kLanes) return launch_ns<V, 2, T>(args, stream);
  return launch_ns<V, 4, T>(args, stream);
}

// Variant V on u's dtype (is_bf16: bfloat16, else float32). Only the base
// splits time into args.segments. Returns the CUDA error of the launch (0 on
// success); asynchronous on `stream`.
template <int V>
int launch(const FwdArgs& args, int is_bf16, cudaStream_t stream) {
  const bool split_ok = args.segments == 1 ||
      (V == kBase && args.seg_h != nullptr && args.seg_dt != nullptr);
  if (args.batch <= 0 || args.batch > 65535 || args.L <= 0 || args.D <= 0 ||
      args.N <= 0 || args.N > 32 || args.segments < 1 || args.segments > 65535 ||
      args.seg_len <= 0 || args.seg_len % kTileT != 0 || !split_ok ||
      static_cast<long long>(args.seg_len) * (args.segments - 1) >= args.L ||
      static_cast<long long>(args.seg_len) * args.segments < args.L) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return is_bf16 ? launch_t<V, __nv_bfloat16>(args, stream)
                 : launch_t<V, float>(args, stream);
}

}  // namespace scan_fwd
