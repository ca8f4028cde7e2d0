"""Global input normalisation, inference side (port of
mamba_asr_tpu/training/normalizer.py:apply_normalizer).

The statistics are the JAX package's Welford state (count, mean, m2);
updating them is training work and waits for the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class NormalizerState(NamedTuple):
    count: torch.Tensor  # scalar float32, frames seen
    mean: torch.Tensor   # (F,)
    m2: torch.Tensor     # (F,) sum of squared deviations

    @classmethod
    def from_arrays(cls, count, mean, m2, device=None) -> "NormalizerState":
        """From array-likes (e.g. the JAX NormalizerState's numpy values)."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return cls(f32(count), f32(mean), f32(m2))


def apply_normalizer(
    state: NormalizerState, feats: torch.Tensor, eps: float = 1e-10
) -> torch.Tensor:
    """(feats - mean) / std with std = sqrt(m2 / max(count - 1, 1)), the
    sample deviation (torch_export.export_normalizer_stats writes m2/count
    instead). Before any statistics exist (count 0), features pass
    through unchanged."""
    std = torch.sqrt(state.m2 / torch.clamp_min(state.count - 1.0, 1.0))
    std = torch.clamp_min(std, eps)
    out = (feats.float() - state.mean) / std
    return torch.where(state.count > 0, out, feats).to(feats.dtype)
