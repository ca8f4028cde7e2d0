// K1, the selective-scan forward for Hopper (sm_90a): the production
// instantiation (variant kBase) of selective_scan_fwd.cuh, where the
// design, its bound and the TPU kernel it replaces are described.

#include "selective_scan_fwd.cuh"

// Plain C entry, bound with ctypes. dt_bias, d_skip and h0 may be null
// (zeros); h_last and h_chunks may be null (not written). is_bf16 selects
// the dtype of u, delta, B, C, z and out (bfloat16 or float32). segments
// > 1 splits time into that many segments of seg_len steps (a multiple of
// 32) for small batches, with the scratch seg_h (B, segments - 1, D, N)
// and seg_dt (B, segments - 1, D) float32; segments 1 takes seg_len >= L
// and no scratch. Returns the CUDA error of the launch (0 on success);
// the launches are asynchronous on `stream`.
extern "C" int mamba_selective_scan_fwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* z, const void* A, const void* dt_bias, const void* d_skip,
    const void* h0, void* out, void* h_last, void* h_chunks, void* seg_h,
    void* seg_dt, int batch, int L, int D, int N, int is_bf16, int softplus_on,
    int seg_len, int segments, void* stream) {
  const scan_fwd::FwdArgs args{
      u, delta, Bm, Cm, z, static_cast<const float*>(A),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), out, static_cast<float*>(h_last),
      static_cast<float*>(h_chunks), static_cast<float*>(seg_h),
      static_cast<float*>(seg_dt), batch, L, D, N, softplus_on, seg_len, segments};
  return scan_fwd::launch<scan_fwd::kBase>(args, is_bf16,
                                           static_cast<cudaStream_t>(stream));
}
