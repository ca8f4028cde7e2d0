"""Multi-process training (port of mamba_asr_tpu/parallel/, but for
tensor parallelism): `distributed` (the process group), `mesh` (the
(data, seq, pipe) grid of ranks), `collectives` (all over all_reduce and
all_gather), `sequence` (the sp conv and scan), `pipeline` (the GPipe
schedule) and `encoder_parallel` (the ConMamba stack with its time axis
sharded or its layers split into stages)."""
