"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | source | replaces |
| --- | --- | --- |
| selective-scan forward (K1; inference and training forms) | csrc/selective_scan_fwd.cuh, .cu | mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel |
| selective-scan adjoint (K2) | csrc/selective_scan_bwd.cuh, .cu | mamba_asr_tpu/ops/pallas/scan.py:_scan_bwd_kernel |
| CTC prefix DP (K3) | csrc/ctc_dp.cu | mamba_asr_tpu/ops/pallas/log_scan.py:_ctc_dp_kernel |
| ancestor-masked beam attention (K4) | csrc/beam_attention.cu | mamba_asr_tpu/ops/pallas/beam_attention.py:_beam_attn_kernel |
| scan-attribution variants of K1 and K2 (P1) | csrc/scan_variants.cu | scripts/exp_scan_variants.py:make_kernel, make_bwd_kernel |
| attainable-rate probe (P2) | csrc/peak_probe.cu | scripts/vpu_peak.py:main.kernel |
"""
