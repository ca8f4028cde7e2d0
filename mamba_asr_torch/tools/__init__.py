"""Measurement entry points of the port: `python -m mamba_asr_torch.tools.<name>`."""
