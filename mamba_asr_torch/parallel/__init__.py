"""Multi-process training (port of mamba_asr_tpu/parallel/, but for
pipeline and tensor parallelism): `distributed` (the process group),
`mesh` (the (data, seq) grid of ranks), `collectives` (all over
all_reduce), `sequence` (the sp conv and scan) and `encoder_parallel`
(the ConMamba stack with its time axis sharded)."""
