"""Hand-written Hopper kernels of the port, each beside its plain version.

| kernel | source | replaces |
| --- | --- | --- |
| selective-scan forward | csrc/selective_scan_fwd.cu | mamba_asr_tpu/ops/pallas/scan.py:_scan_kernel |
"""
