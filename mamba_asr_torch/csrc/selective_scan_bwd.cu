// K2, the selective-scan adjoint for Hopper (sm_90a): the production
// instantiation (variant kBase) of selective_scan_bwd.cuh, where the
// design, its bound and the TPU kernel it replaces are described.

#include "selective_scan_bwd.cuh"

// Channels per block for d_state N: the dB/dC partials have
// ceil(D / this) channel tiles.
extern "C" int mamba_selective_scan_bwd_channels_per_block(int N) {
  return scan_bwd::channels_per_block(N);
}

// Plain C entry, bound with ctypes. dt_bias, d_skip, h0 and dh_last may be
// null (zeros); dh0 may be null (not written). h_chunks is the forward's
// training-form output (B, ceil(L / 32), D, N). is_bf16 selects the dtype
// of u, delta, B, C, z, dout, du, ddelta and dz (bfloat16 or float32).
// Returns the CUDA error of the launch (0 on success); the launch is
// asynchronous on `stream`.
extern "C" int mamba_selective_scan_bwd(
    const void* u, const void* delta, const void* Bm, const void* Cm,
    const void* z, const void* dout, const void* A, const void* dt_bias,
    const void* d_skip, const void* h0, const void* dh_last,
    const void* h_chunks, void* du, void* ddelta, void* dz, void* dB_part,
    void* dC_part, void* dA_part, void* dD_part, void* ddb_part, void* dh0,
    int batch, int L, int D, int N, int is_bf16, int softplus_on,
    void* stream) {
  const void* in[] = {u, delta, Bm, Cm, z, dout, A, dt_bias, d_skip, h0,
                      dh_last, h_chunks};
  void* out[] = {du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part,
                 dh0};
  return scan_bwd::launch<scan_bwd::kBase>(in, out, batch, L, D, N, is_bf16,
                                           softplus_on,
                                           static_cast<cudaStream_t>(stream));
}
