"""utils of the PyTorch port (see mamba_asr_torch/__init__.py)."""
