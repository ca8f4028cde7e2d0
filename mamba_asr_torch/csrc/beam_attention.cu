// Ancestor-masked single-query beam attention for Hopper (sm_90a).
//
// Replaces: mamba_asr_tpu/ops/pallas/beam_attention.py:_beam_attn_kernel
// (launched by beam_attention_pallas). For hypothesis n and head h:
//
//   s_j      = <q[n, h], k[h, j, anc[j, n]]> / sqrt(dh)      for j <= pos
//   out[n,h] = sum_j softmax(s)_j * v[h, j, anc[j, n]]      (fp32, out in q's dtype)
//
// Layouts as in the JAX package: q, out (N, H, dh); k, v (H, S, N, dh),
// append-only (row n writes position s at [:, s, n]); anc (S, N) int32,
// anc[j, n] = the row that holds position j of hypothesis n. q, k, v and
// out share one dtype (float32 or bfloat16). All contiguous.
//
// Design. One warp per (n, h), four warps per block. The warp stages q in
// shared memory as float. Pass 1: lanes over positions j = lane, lane+32,
// ..., each lane gathers its row anc[j, n] of k and computes the score in
// fp32, keeping score and row in shared memory; a warp max and a warp sum
// of exp(s - max) by shuffles. Pass 2: lanes over dh (up to 4 values per
// lane, so dh <= 128), a loop over j reads each position's v row, which
// the warp loads as one contiguous segment. Rows past pos are never read,
// so a never-written buffer tail cannot leak in. pos is a host int passed
// by value: no device read, no sync. On the TPU the kernel renders the
// (J, R, N) validity plane and sweeps all rows with an online softmax; a
// gather is what suits this card, and it serves every N (the TPU falls
// back to the XLA gather above ~N 400 for lack of VMEM).
//
// Bound. The bytes it must move are the k and v rows of positions <= pos,
// the anc column and q in, out written: at the S2S-Small decoder (H 4,
// dh 36, bf16), N 528 and pos 255, 2 * 4 * 256 * 528 * 72 B = 77.9 MB,
// ~23 us at 3.35 TB/s. The arithmetic (4 * H * N * (pos + 1) * dh FLOP)
// is tiny. Known limits of this simple design: pass 1 reads each k row
// with one lane (72 scattered bytes, not coalesced across the warp), and
// pass 2 is a dependent loop over j per lane. Staging the anc column and
// k tiles in shared memory (TMA) is a later PR's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 4;      // (n, h) items per block
constexpr int kMaxDhTiles = 4;  // dh <= 32 * kMaxDhTiles

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
beam_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ anc,
                      T* __restrict__ out, int heads, int s_len, int n, int dh,
                      int pos, float sqrt_dh) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + warp;  // = hyp * heads + h
  if (item >= n * heads) return;  // whole warps only; no block barrier below
  const int hyp = item / heads;
  const int h = item - hyp * heads;
  const int len = pos + 1;

  float* q_s = smem + static_cast<size_t>(warp) * (dh + 2 * len);
  float* p_s = q_s + dh;
  int* row_s = reinterpret_cast<int*>(p_s + len);

  const T* qv = q + static_cast<size_t>(item) * dh;
  for (int d = lane; d < dh; d += 32) q_s[d] = to_f32(qv[d]);
  __syncwarp();

  // Pass 1: scores, lanes over positions.
  float m = -INFINITY;
  for (int j = lane; j < len; j += 32) {
    const int r = anc[static_cast<size_t>(j) * n + hyp];
    const T* kr = k + ((static_cast<size_t>(h) * s_len + j) * n + r) * dh;
    float acc = 0.f;
    for (int d = 0; d < dh; ++d) acc = fmaf(q_s[d], to_f32(kr[d]), acc);
    const float s = acc / sqrt_dh;
    p_s[j] = s;
    row_s[j] = r;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  float l = 0.f;
  for (int j = lane; j < len; j += 32) {
    const float e = expf(p_s[j] - m);
    p_s[j] = e;
    l += e;
  }
  l = warp_sum(l);
  __syncwarp();

  // Pass 2: weighted sum of v rows, lanes over dh.
  float acc[kMaxDhTiles] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const float p = p_s[j];
    const T* vr = v + ((static_cast<size_t>(h) * s_len + j) * n + row_s[j]) * dh;
#pragma unroll
    for (int i = 0; i < kMaxDhTiles; ++i) {
      const int d = lane + 32 * i;
      if (d < dh) acc[i] = fmaf(p, to_f32(vr[d]), acc[i]);
    }
  }
  T* o = out + static_cast<size_t>(item) * dh;
#pragma unroll
  for (int i = 0; i < kMaxDhTiles; ++i) {
    const int d = lane + 32 * i;
    if (d < dh) store(o + d, acc[i] / l);
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, const int* anc,
            void* out, int heads, int s_len, int n, int dh, int pos,
            float sqrt_dh, size_t smem, cudaStream_t stream) {
  const int items = n * heads;
  const int blocks = (items + kWarps - 1) / kWarps;
  beam_attention_kernel<T><<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), anc, static_cast<T*>(out), heads, s_len, n,
      dh, pos, sqrt_dh);
}

}  // namespace

// Shared memory one launch needs, in bytes (the wrapper checks it
// against the 48 KB a block may take without opting in).
extern "C" int mamba_beam_attention_smem_bytes(int dh, int pos) {
  return kWarps * (dh + 2 * (pos + 1)) * 4;
}

// Plain C entry, bound with ctypes. is_bf16 selects the dtype of q, k, v
// and out. Attends positions 0..pos (pos < s_len). Returns the CUDA error
// of the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int mamba_beam_attention(const void* q, const void* k, const void* v,
                                    const void* anc, void* out, int heads,
                                    int s_len, int n, int dh, int pos,
                                    float sqrt_dh, int is_bf16, void* stream) {
  if (heads <= 0 || n <= 0 || dh <= 0 || dh > 32 * kMaxDhTiles || pos < 0 ||
      pos >= s_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(mamba_beam_attention_smem_bytes(dh, pos));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(anc);
  if (is_bf16) {
    launch<__nv_bfloat16>(q, k, v, a, out, heads, s_len, n, dh, pos, sqrt_dh, smem, s);
  } else {
    launch<float>(q, k, v, a, out, heads, s_len, n, dh, pos, sqrt_dh, smem, s);
  }
  return static_cast<int>(cudaGetLastError());
}
