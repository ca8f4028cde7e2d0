// Selective-scan (Mamba S6) forward for Hopper (sm_90a).
//
// Replaces: mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel: the inference
// outputs (out, h_last) and, in its training form, the per-chunk boundary
// states that the adjoint (selective_scan_bwd.cu) starts each chunk from.
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
// steps (after the last step for the ragged final chunk) is written out,
// as hb_ref with want_bounds does on the TPU (scan.py:369-374). It is the
// only residual: the post-softplus dt and the pre-gate y that the TPU
// kernel also emits are recomputed by the adjoint, which spreads each
// channel's per-step special functions over 16 lanes, so they cost it SFU
// issue slots and no bytes. `out` is bit-identical between the two forms
// (the extra store changes no arithmetic).
//
// Design. One thread owns one (batch row, channel) pair and keeps its N
// states in registers; a block holds 128 consecutive channels of one row,
// so the grid is (ceil(D / 128), batch). Time is a sequential loop: each
// step reads u, delta and z at neighbouring addresses across the warp.
// B_t and C_t are shared by every channel of the row, so the block stages
// them in shared memory a tile of timesteps at a time. The softplus runs
// here, on delta as it arrives (bf16 at the model's compute dtype), and
// exp(dt*A) is exp2(dt * A*log2e) with A scaled once per thread. No
// atomics: the result is deterministic.
//
// Bound. Each input is read once and each output written once, so the
// bytes moved are those of u, delta, z, out, B and C; the (B, L, D, N)
// discretised terms never leave registers. The operations are B*L*D*N
// exp2 on the special-function units plus ~3 FMAs each. At the full-width
// shape (B32 L751 D288 N16, bf16) that is ~57 MB and ~1.1e8 exp2, about
// 30 us on an H100 SXM.
//
// Known limit of this simple design: only ceil(D/128) * B blocks (96 at
// the full-width shape, for 132 SMs), each walking L dependent steps, so
// the kernel is latency-bound far above its bound. Splitting time into
// chunks with a carried-state pass is the redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTileT = 32;     // timesteps of B and C staged per pass;
                               // also the chunk of the training form
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// jax.nn.softplus: logaddexp(x, 0), stable for large |x|.
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <int NMAX, typename T>
__global__ void __launch_bounds__(kThreads)
selective_scan_fwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                          const T* __restrict__ Bm, const T* __restrict__ Cm,
                          const T* __restrict__ z, const float* __restrict__ A,
                          const float* __restrict__ dt_bias,
                          const float* __restrict__ d_skip,
                          const float* __restrict__ h0, T* __restrict__ out,
                          float* __restrict__ h_last,
                          float* __restrict__ h_chunks, int L, int D, int N,
                          int softplus_on) {
  __shared__ float sB[kTileT][NMAX];
  __shared__ float sC[kTileT][NMAX];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < D;

  float a2[NMAX];
  float h[NMAX];
#pragma unroll
  for (int n = 0; n < NMAX; ++n) {
    a2[n] = 0.f;
    h[n] = 0.f;
  }
  float bias = 0.f;
  float dsk = 0.f;
  const size_t state = (static_cast<size_t>(b) * D + d) * N;
  if (active) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) {
        a2[n] = A[static_cast<size_t>(d) * N + n] * kLog2e;
        if (h0 != nullptr) h[n] = h0[state + n];
      }
    }
    if (dt_bias != nullptr) bias = dt_bias[d];
    if (d_skip != nullptr) dsk = d_skip[d];
  }

  const size_t row = static_cast<size_t>(b) * L;
  for (int t0 = 0; t0 < L; t0 += kTileT) {
    const int tn = min(kTileT, L - t0);
    __syncthreads();  // the previous tile is no longer read
    const T* b_tile = Bm + (row + t0) * N;
    const T* c_tile = Cm + (row + t0) * N;
    for (int i = threadIdx.x; i < tn * N; i += kThreads) {
      const int tt = i / N;
      const int n = i - tt * N;
      sB[tt][n] = to_f32(b_tile[i]);
      sC[tt][n] = to_f32(c_tile[i]);
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < tn; ++tt) {
      const size_t idx = (row + t0 + tt) * D + d;
      const float uv = to_f32(u[idx]);
      float dt = to_f32(delta[idx]) + bias;
      if (softplus_on) dt = softplus(dt);
      const float dtu = dt * uv;
      float y = 0.f;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) {
          h[n] = exp2f(dt * a2[n]) * h[n] + dtu * sB[tt][n];
          y += h[n] * sC[tt][n];
        }
      }
      y += dsk * uv;
      const float zv = to_f32(z[idx]);
      store(out + idx, y * (zv / (1.f + expf(-zv))));
    }
    if (h_chunks != nullptr) {
      const int n_chunks = (L + kTileT - 1) / kTileT;
      float* hc = h_chunks +
          ((static_cast<size_t>(b) * n_chunks + t0 / kTileT) * D + d) * N;
#pragma unroll
      for (int n = 0; n < NMAX; ++n) {
        if (n < N) hc[n] = h[n];
      }
    }
  }

  if (active && h_last != nullptr) {
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      if (n < N) h_last[state + n] = h[n];
    }
  }
}

template <int NMAX, typename T>
void launch(const void* u, const void* delta, const void* Bm, const void* Cm,
            const void* z, const void* A, const void* dt_bias,
            const void* d_skip, const void* h0, void* out, void* h_last,
            void* h_chunks, int batch, int L, int D, int N, int softplus_on,
            cudaStream_t stream) {
  const dim3 grid((D + kThreads - 1) / kThreads, batch);
  selective_scan_fwd_kernel<NMAX, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(delta),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(z), static_cast<const float*>(A),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), static_cast<T*>(out),
      static_cast<float*>(h_last), static_cast<float*>(h_chunks), L, D, N,
      softplus_on);
}

template <typename T>
void launch_n(const void* u, const void* delta, const void* Bm, const void* Cm,
              const void* z, const void* A, const void* dt_bias,
              const void* d_skip, const void* h0, void* out, void* h_last,
              void* h_chunks, int batch, int L, int D, int N, int softplus_on,
              cudaStream_t stream) {
  if (N <= 8) {
    launch<8, T>(u, delta, Bm, Cm, z, A, dt_bias, d_skip, h0, out, h_last,
                 h_chunks, batch, L, D, N, softplus_on, stream);
  } else if (N <= 16) {
    launch<16, T>(u, delta, Bm, Cm, z, A, dt_bias, d_skip, h0, out, h_last,
                  h_chunks, batch, L, D, N, softplus_on, stream);
  } else {
    launch<32, T>(u, delta, Bm, Cm, z, A, dt_bias, d_skip, h0, out, h_last,
                  h_chunks, batch, L, D, N, softplus_on, stream);
  }
}

}  // namespace

// Plain C entry, bound with ctypes. dt_bias, d_skip and h0 may be null
// (zeros); h_last and h_chunks may be null (not written). is_bf16 selects
// the dtype of u, delta, B, C, z and out (bfloat16 or float32). Returns
// the CUDA error of the launch (0 on success); the launch is asynchronous
// on `stream`.
extern "C" int mamba_selective_scan_fwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* z, const void* A, const void* dt_bias, const void* d_skip,
    const void* h0, void* out, void* h_last, void* h_chunks, int batch,
    int L, int D, int N, int is_bf16, int softplus_on, void* stream) {
  if (batch <= 0 || batch > 65535 || L <= 0 || D <= 0 || N <= 0 || N > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_n<__nv_bfloat16>(u, delta, Bm, Cm, z, A, dt_bias, d_skip, h0, out,
                            h_last, h_chunks, batch, L, D, N, softplus_on, s);
  } else {
    launch_n<float>(u, delta, Bm, Cm, z, A, dt_bias, d_skip, h0, out, h_last,
                    h_chunks, batch, L, D, N, softplus_on, s);
  }
  return static_cast<int>(cudaGetLastError());
}
