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
// Bound. The work is a gather: each distinct K and V row (j, anc[j, n]),
// j <= pos, read once, ~4 FLOP per element read. At the S2S-Small decoder
// (H 4, dh 36, bf16), N 528 and pos 255 that is up to 77.9 MB (49.3 MB of
// distinct rows on a random table, fewer on a beam's, where hypotheses
// share ancestors): memory bounds it. The rows are scattered 72-byte
// pieces, so what the card pays is the number of 128-byte lines each load
// instruction touches in L1, and then the 32-byte sectors it fetches: a
// load in which 32 lanes read 32 different rows touches 32 lines.
//
// Design. One pass over memory with an online softmax (as FlashDecoding).
// A block takes `hyps` neighbouring hypotheses x `head_block` heads x
// `splits` position splits, one warp each (at most kMaxWarps). In a warp,
// `lanes_per_row` lanes (G, the largest power of two <= the row's
// `vec_bytes` chunks) read one row together, lane g the chunks g, g + G,
// ..., so a load instruction reads whole runs of G chunks of 32 / G rows
// (at dh 36 bf16: G 8, 64 contiguous bytes and then 8, of 4 rows). A lane
// issues the K and V loads of kUnroll positions at once (they depend only
// on the ancestor entries), takes each score by a shuffle sum over its G
// lanes, and keeps a running max, sum and accumulator of its chunks in
// fp32. The block stages the ancestor entries of its hypotheses, kAncTile
// positions at a time, with coalesced loads into shared memory: each is
// read from memory once for all heads. After the walk the lanes merge by
// shuffles, the splits through shared memory of fixed size (none grows
// with pos, so any pos < S is taken). The geometry is the wrapper's
// (kernels/beam_attention.py: row_layout, split_rule), which splits
// positions over more warps when N x H warps cannot fill the card. Rows
// past pos are never read, so a never-written buffer tail cannot leak
// in. pos is a host int passed by value: no device read, no sync. On the
// TPU the kernel renders a (J, R, N) validity plane and sweeps all rows;
// a gather is what suits this card. On an H100 SXM (700 W) at N 528, pos
// 255 this takes ~2.4x the time of the distinct 32-byte sectors (PERF.md).
// In dev builds one, two or four positions in flight per lane timed
// alike at two blocks per SM, so the loads' latency is not what remains;
// builds at one block per SM (four or eight in flight) were slower at N 528.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace {

constexpr int kMaxWarps = 16;     // warps per block
constexpr int kAncTile = 256;     // positions of ancestor entries staged at once
constexpr int kMaxDh = 128;
constexpr int kUnroll = 2;        // warp steps whose loads a lane issues together
constexpr float kLog2e = 1.4426950408889634f;

// Chunks of one row a lane walks at most: the wrapper gives a row
// lanes_per_row = the largest power of two <= its chunks (at most 32), so
// a lane walks 2 at most, or 4 where 2- or 4-byte loads make a row more
// than 64 chunks.
__host__ __device__ constexpr int chunks_per_lane(int vec_bytes) {
  return vec_bytes <= 4 ? 4 : 2;
}

template <int VB> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// One 32-bit word as 2 bf16 (low half first) or 1 float.
template <bool BF16>
__device__ __forceinline__ void unpack_word(unsigned w, float* o) {
  if constexpr (BF16) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    o[0] = __uint_as_float(w);
  }
}

template <bool BF16>
__device__ __forceinline__ void unpack(unsigned short x, float* o) {
  o[0] = __uint_as_float(static_cast<unsigned>(x) << 16);
}
template <bool BF16>
__device__ __forceinline__ void unpack(unsigned x, float* o) { unpack_word<BF16>(x, o); }
template <bool BF16>
__device__ __forceinline__ void unpack(uint2 x, float* o) {
  constexpr int w = BF16 ? 2 : 1;
  unpack_word<BF16>(x.x, o);
  unpack_word<BF16>(x.y, o + w);
}
template <bool BF16>
__device__ __forceinline__ void unpack(uint4 x, float* o) {
  constexpr int w = BF16 ? 2 : 1;
  unpack_word<BF16>(x.x, o);
  unpack_word<BF16>(x.y, o + w);
  unpack_word<BF16>(x.z, o + 2 * w);
  unpack_word<BF16>(x.w, o + 3 * w);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(unsigned short* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

template <bool BF16, int VB>
__global__ void __launch_bounds__(32 * kMaxWarps, 2)
beam_attention_kernel(const void* __restrict__ q, const void* __restrict__ k,
                      const void* __restrict__ v, const int* __restrict__ anc,
                      void* __restrict__ out, int heads, int s_len, int n, int dh,
                      int pos, float scale_log2, int hyps, int head_block,
                      int splits, int lanes_per_row) {
  using R = typename Raw<VB>::type;
  using T = typename std::conditional<BF16, unsigned short, float>::type;
  constexpr int kElem = BF16 ? 2 : 4;
  constexpr int kVe = VB / kElem;   // elements per chunk
  constexpr int kChunks = chunks_per_lane(VB);

  __shared__ int anc_s[kAncTile * kMaxWarps];
  __shared__ __align__(16) float q_s[kMaxWarps * kMaxDh];
  __shared__ float part_s[kMaxWarps * (kMaxDh + 2)];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pairs = hyps * head_block;
  const int pair = warp % pairs;
  const int split = warp / pairs;
  const int b = pair / head_block;
  const int hyp = blockIdx.x * hyps + b;
  const int h = blockIdx.y * head_block + pair % head_block;
  const bool live = hyp < n && h < heads;

  for (int i = threadIdx.x; i < pairs * dh; i += blockDim.x) {
    const int pr = i / dh, d = i - pr * dh;
    const int hy = blockIdx.x * hyps + pr / head_block;
    const int hh = blockIdx.y * head_block + pr % head_block;
    float x = 0.f;
    if (hy < n && hh < heads) {
      const size_t at = (static_cast<size_t>(hy) * heads + hh) * dh + d;
      x = BF16 ? __uint_as_float(static_cast<unsigned>(static_cast<const T*>(q)[at]) << 16)
               : static_cast<const float*>(q)[at];
    }
    q_s[pr * kMaxDh + d] = x;
  }

  const int G = lanes_per_row;
  const int g = lane & (G - 1);
  const int slot = lane / G;
  const int slots = 32 / G;                      // positions per warp step
  const int stride = splits * slots;             // positions per block step
  const int nch = dh / kVe;                      // chunks per row
  const int cpl = (nch + G - 1) / G;             // chunks a lane's group walks
  const size_t row_bytes = static_cast<size_t>(dh) * kElem;
  const float* qw = q_s + pair * kMaxDh;

  float m = -INFINITY, l = 0.f;
  float acc[kChunks * kVe];
#pragma unroll
  for (int i = 0; i < kChunks * kVe; ++i) acc[i] = 0.f;

  const int len = pos + 1;
  for (int t0 = 0; t0 < len; t0 += kAncTile) {
    const int tl = min(kAncTile, len - t0);
    __syncthreads();  // q staged; the previous tile consumed
    for (int i = threadIdx.x; i < tl * hyps; i += blockDim.x) {
      const int jj = i / hyps, hb = i - jj * hyps;
      const int hy = blockIdx.x * hyps + hb;
      anc_s[i] = hy < n ? anc[static_cast<size_t>(t0 + jj) * n + hy] : 0;
    }
    __syncthreads();
    if (!live) continue;
    // kUnroll warp steps at once: every K and V load of them in flight.
    for (int base = split * slots; base < tl; base += kUnroll * stride) {  // warp-uniform
      R kr[kUnroll][kChunks], vr[kUnroll][kChunks];
      bool valid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = base + u * stride + slot;
        valid[u] = jj < tl;
        if (valid[u]) {
          const int r = anc_s[jj * hyps + b];
          const size_t row = (static_cast<size_t>(h) * s_len + t0 + jj) * n + r;
          const char* kp = static_cast<const char*>(k) + row * row_bytes;
          const char* vp = static_cast<const char*>(v) + row * row_bytes;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int ch = g + c * G;
            if (c < cpl && ch < nch) {
              kr[u][c] = *reinterpret_cast<const R*>(kp + ch * VB);
              vr[u][c] = *reinterpret_cast<const R*>(vp + ch * VB);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float s = 0.f;
        if (valid[u]) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int ch = g + c * G;
            if (c < cpl && ch < nch) {
              float kf[kVe];
              unpack<BF16>(kr[u][c], kf);
#pragma unroll
              for (int e = 0; e < kVe; ++e) s = fmaf(qw[ch * kVe + e], kf[e], s);
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {  // the score over the row's lanes
          if (o < G) s += __shfl_xor_sync(0xffffffffu, s, o);
        }
        if (valid[u]) {
          s *= scale_log2;
          const float mn = fmaxf(m, s);
          const float c0 = exp2f(m - mn);  // 0 on a lane's first position (m = -inf)
          const float p = exp2f(s - mn);
          l = fmaf(l, c0, p);
          m = mn;
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int ch = g + c * G;
            if (c < cpl && ch < nch) {  // a chunk past the row keeps acc 0
              float vf[kVe];
              unpack<BF16>(vr[u][c], vf);
#pragma unroll
              for (int e = 0; e < kVe; ++e) {
                acc[c * kVe + e] = fmaf(acc[c * kVe + e], c0, p * vf[e]);
              }
            }
          }
        }
      }
    }
  }

  // Merge the warp's position slots (lanes with equal g): max, then the
  // rescaled sums. A lane, or a whole warp, that owns no position has
  // m = -inf and weighs 0.
  float mw = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= G) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  }
  const float c0 = m == -INFINITY ? 0.f : exp2f(m - mw);
  l *= c0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= G) l += __shfl_xor_sync(0xffffffffu, l, o);
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c < cpl) {  // uniform over the warp
#pragma unroll
      for (int e = 0; e < kVe; ++e) {
        float a = acc[c * kVe + e] * c0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          if (o >= G) a += __shfl_xor_sync(0xffffffffu, a, o);
        }
        acc[c * kVe + e] = a;
      }
    }
  }
  float* part = part_s + warp * (kMaxDh + 2);
  if (lane < G) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ch = g + c * G;
      if (c < cpl && ch < nch) {
#pragma unroll
        for (int e = 0; e < kVe; ++e) part[ch * kVe + e] = acc[c * kVe + e];
      }
    }
    if (lane == 0) {
      part[kMaxDh] = mw;
      part[kMaxDh + 1] = l;
    }
  }
  __syncthreads();

  // Split 0's warp of each (hypothesis, head) merges the splits.
  if (split != 0 || !live) return;
  float mx = -INFINITY;
  for (int p = 0; p < splits; ++p) {
    mx = fmaxf(mx, part_s[(p * pairs + pair) * (kMaxDh + 2) + kMaxDh]);
  }
  float wsum = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float* pp = part_s + (p * pairs + pair) * (kMaxDh + 2);
    wsum += pp[kMaxDh] == -INFINITY ? 0.f : pp[kMaxDh + 1] * exp2f(pp[kMaxDh] - mx);
  }
  const float inv = 1.f / wsum;
  T* o = static_cast<T*>(out) + (static_cast<size_t>(hyp) * heads + h) * dh;
  for (int d = lane; d < dh; d += 32) {
    float a = 0.f;
    for (int p = 0; p < splits; ++p) {
      const float* pp = part_s + (p * pairs + pair) * (kMaxDh + 2);
      if (pp[kMaxDh] != -INFINITY) a = fmaf(pp[d], exp2f(pp[kMaxDh] - mx), a);
    }
    store(o + d, a * inv);
  }
}

template <bool BF16, int VB>
void launch(const void* q, const void* k, const void* v, const int* anc, void* out,
            int heads, int s_len, int n, int dh, int pos, float scale_log2, int hyps,
            int head_block, int splits, int lanes_per_row, cudaStream_t stream) {
  const dim3 grid((n + hyps - 1) / hyps, (heads + head_block - 1) / head_block);
  const int threads = 32 * hyps * head_block * splits;
  beam_attention_kernel<BF16, VB><<<grid, threads, 0, stream>>>(
      q, k, v, anc, out, heads, s_len, n, dh, pos, scale_log2, hyps, head_block,
      splits, lanes_per_row);
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

}  // namespace

// Plain C entry, bound with ctypes. is_bf16 selects the dtype of q, k, v
// and out. Attends positions 0..pos (pos < s_len). The launch geometry is
// the wrapper's (kernels/beam_attention.py:launch_shape): `hyps`
// hypotheses x `head_block` heads x `splits` position splits per block,
// at most 16 warps; `lanes_per_row` (a power of two) lanes per position,
// each walking at most chunks_per_lane chunks of `vec_bytes` (2 (bf16
// only), 4, 8 or 16, dividing dh x the element size and the alignment of
// k and v). Returns the CUDA error of the launch (0 on
// success); the launch is asynchronous on `stream`.
extern "C" int mamba_beam_attention(const void* q, const void* k, const void* v,
                                    const void* anc, void* out, int heads,
                                    int s_len, int n, int dh, int pos,
                                    float sqrt_dh, int is_bf16, int hyps,
                                    int head_block, int splits, int lanes_per_row,
                                    int vec_bytes, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  const bool vec_ok = (vec_bytes == 2 && is_bf16) || vec_bytes == 4 || vec_bytes == 8 ||
                      vec_bytes == 16;
  if (heads <= 0 || n <= 0 || dh <= 0 || dh > kMaxDh || pos < 0 || pos >= s_len ||
      hyps <= 0 || head_block <= 0 || !pow2(splits) ||
      hyps * head_block * splits > kMaxWarps || !pow2(lanes_per_row) ||
      lanes_per_row > 32 || !vec_ok || (dh * elem) % vec_bytes != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nch = dh * elem / vec_bytes;
  if ((nch + lanes_per_row - 1) / lanes_per_row > chunks_per_lane(vec_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = kLog2e / sqrt_dh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(anc);
#define MAMBA_BA_LAUNCH(BF, VB)                                                    \
  launch<BF, VB>(q, k, v, a, out, heads, s_len, n, dh, pos, scale_log2, hyps,     \
                 head_block, splits, lanes_per_row, s)
  if (is_bf16) {
    switch (vec_bytes) {
      case 2: MAMBA_BA_LAUNCH(true, 2); break;
      case 4: MAMBA_BA_LAUNCH(true, 4); break;
      case 8: MAMBA_BA_LAUNCH(true, 8); break;
      default: MAMBA_BA_LAUNCH(true, 16); break;
    }
  } else {
    switch (vec_bytes) {
      case 4: MAMBA_BA_LAUNCH(false, 4); break;
      case 8: MAMBA_BA_LAUNCH(false, 8); break;
      default: MAMBA_BA_LAUNCH(false, 16); break;
    }
  }
#undef MAMBA_BA_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
