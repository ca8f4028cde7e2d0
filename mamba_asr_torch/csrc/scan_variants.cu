// P1, the scan-attribution variants for Hopper (sm_90a): every variant tag
// of K1 (selective_scan_fwd.cuh) and of K2 (selective_scan_bwd.cuh),
// instantiated from the same bodies as the kernels that ship, so that an
// ablation times those kernels with one piece of work removed.
//
// Replaces: the Pallas launches of scripts/exp_scan_variants.py:283
// (run_variant, the forward variants of make_kernel) and :601
// (run_bwd_variant, the adjoint variants of make_bwd_kernel). What each
// variant removes, and what it means on this card, is listed in the two
// headers. Bound: as K1 and K2 (operations: the SFU), less what the
// variant removes.

#include "selective_scan_bwd.cuh"
#include "selective_scan_fwd.cuh"

namespace {

using FwdLaunch = int (*)(const scan_fwd::FwdArgs&, int, cudaStream_t);
using BwdLaunch = int (*)(const void* const*, void* const*, int, int, int, int,
                          int, int, cudaStream_t);

// kFusedY is kBase by construction (selective_scan_fwd.cuh) and launches it.
const FwdLaunch kFwd[] = {
    scan_fwd::launch<scan_fwd::kBase>,     scan_fwd::launch<scan_fwd::kNoExp>,
    scan_fwd::launch<scan_fwd::kNoSoftplus>, scan_fwd::launch<scan_fwd::kNoScan>,
    scan_fwd::launch<scan_fwd::kNoDbu>,    scan_fwd::launch<scan_fwd::kNoY>,
    scan_fwd::launch<scan_fwd::kFastExp>,  scan_fwd::launch<scan_fwd::kBf16Scan>,
    scan_fwd::launch<scan_fwd::kNLoop>,    scan_fwd::launch<scan_fwd::kBase>,
};
static_assert(sizeof(kFwd) / sizeof(kFwd[0]) == scan_fwd::kNumVariants,
              "one launcher per forward variant");

const BwdLaunch kBwd[] = {
    scan_bwd::launch<scan_bwd::kBase>,       scan_bwd::launch<scan_bwd::kNLoop>,
    scan_bwd::launch<scan_bwd::kNoExp>,      scan_bwd::launch<scan_bwd::kNoSoftplus>,
    scan_bwd::launch<scan_bwd::kNoFwdScan>,  scan_bwd::launch<scan_bwd::kNoRevScan>,
    scan_bwd::launch<scan_bwd::kNoReduceN>,  scan_bwd::launch<scan_bwd::kNoReduceD>,
    scan_bwd::launch<scan_bwd::kNoGh>,
};
static_assert(sizeof(kBwd) / sizeof(kBwd[0]) == scan_bwd::kNumVariants,
              "one launcher per adjoint variant");

}  // namespace

extern "C" int mamba_scan_variant_fwd_count() { return scan_fwd::kNumVariants; }
extern "C" int mamba_scan_variant_bwd_count() { return scan_bwd::kNumVariants; }

// Forward variant `variant` (index into kernels/scan_variants.py:
// FWD_VARIANTS), arguments as mamba_selective_scan_fwd without the
// training form and the time segments (every variant walks each row's
// steps in one block).
extern "C" int mamba_scan_variant_fwd(
    int variant, const void* u, const void* delta, const void* Bm,
    const void* Cm, const void* z, const void* A, const void* dt_bias,
    const void* d_skip, const void* h0, void* out, void* h_last, int batch,
    int L, int D, int N, int is_bf16, int softplus_on, void* stream) {
  if (variant < 0 || variant >= scan_fwd::kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (L + scan_fwd::kTileT - 1) / scan_fwd::kTileT;
  const scan_fwd::FwdArgs args{
      u, delta, Bm, Cm, z, static_cast<const float*>(A),
      static_cast<const float*>(dt_bias), static_cast<const float*>(d_skip),
      static_cast<const float*>(h0), out, static_cast<float*>(h_last), nullptr,
      nullptr, nullptr, batch, L, D, N, softplus_on, tiles * scan_fwd::kTileT, 1};
  return kFwd[variant](args, is_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int mamba_scan_variant_bwd_channels_per_block(int N) {
  return scan_bwd::channels_per_block(N);
}

// Adjoint variant `variant` (index into BWD_VARIANTS), arguments as
// mamba_selective_scan_bwd.
extern "C" int mamba_scan_variant_bwd(
    int variant, const void* u, const void* delta, const void* Bm,
    const void* Cm, const void* z, const void* dout, const void* A,
    const void* dt_bias, const void* d_skip, const void* h0,
    const void* dh_last, const void* h_chunks, void* du, void* ddelta,
    void* dz, void* dB_part, void* dC_part, void* dA_part, void* dD_part,
    void* ddb_part, void* dh0, int batch, int L, int D, int N, int is_bf16,
    int softplus_on, void* stream) {
  if (variant < 0 || variant >= scan_bwd::kNumVariants) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* in[] = {u, delta, Bm, Cm, z, dout, A, dt_bias, d_skip, h0,
                      dh_last, h_chunks};
  void* out[] = {du, ddelta, dz, dB_part, dC_part, dA_part, dD_part, ddb_part,
                 dh0};
  return kBwd[variant](in, out, batch, L, D, N, is_bf16, softplus_on,
                       static_cast<cudaStream_t>(stream));
}
