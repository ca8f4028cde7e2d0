"""Multi-process training (port of mamba_asr_tpu/parallel/):
`distributed` (the process group), `mesh` (the (data, model, seq, pipe)
grid of ranks), `collectives` (all over all_reduce and all_gather),
`tensor` (the tensor-parallel placement and column-parallel products),
`sequence` (the sp conv and scan), `pipeline` (the GPipe schedule) and
`encoder_parallel` (the ConMamba stack with its time axis sharded or its
layers split into stages)."""
