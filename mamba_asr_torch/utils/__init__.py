"""utils of the PyTorch port (see mamba_asr_torch/__init__.py): the
device rule and the tracing utilities."""

from mamba_asr_torch.utils.profiling import StepTimer, profile_trace, rtfx

__all__ = ["StepTimer", "profile_trace", "rtfx"]
