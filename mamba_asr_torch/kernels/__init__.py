"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | source | replaces |
| --- | --- | --- |
| selective-scan forward (K1; inference and training forms) | csrc/selective_scan_fwd.cu | mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel |
| selective-scan adjoint (K2) | csrc/selective_scan_bwd.cu | mamba_asr_tpu/ops/pallas/scan.py:_scan_bwd_kernel |
| CTC prefix DP (K3) | csrc/ctc_dp.cu | mamba_asr_tpu/ops/pallas/log_scan.py:_ctc_dp_kernel |
| ancestor-masked beam attention (K4) | csrc/beam_attention.cu | mamba_asr_tpu/ops/pallas/beam_attention.py:_beam_attn_kernel |
"""
