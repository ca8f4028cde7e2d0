"""Global input normalisation (port of mamba_asr_tpu/training/normalizer.py).

The statistics are the JAX package's Welford state (count, mean, m2):
`update_normalizer` merges a batch's masked statistics into it (the
trainer does so while epoch <= normalizer_update_epochs), and
`apply_normalizer` normalises with it. `batch_stats` and `merge_stats`
are its two halves: a multi-process step merges the ranks' batch
statistics in rank order before merging them into the state.
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


def init_normalizer(num_features: int, device=None) -> NormalizerState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return NormalizerState(zeros(), zeros(num_features), zeros(num_features))


def batch_stats(feats: torch.Tensor, frame_mask: torch.Tensor) -> NormalizerState:
    """(count, mean, m2) of the masked frames of feats (B, T, F); frame_mask
    (B, T) True for valid frames."""
    f = feats.float()
    m = frame_mask.float()[..., None]
    n_b = m.sum()
    mean_b = (f * m).sum((0, 1)) / torch.clamp_min(n_b, 1.0)
    m2_b = (((f - mean_b) ** 2) * m).sum((0, 1))
    return NormalizerState(n_b, mean_b, m2_b)


def merge_stats(a: NormalizerState, b: NormalizerState) -> NormalizerState:
    """Chan's parallel merge of two (count, mean, m2) statistics."""
    n_a, mean_a, m2_a = a
    n_b, mean_b, m2_b = b
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * n_b / torch.clamp_min(n, 1.0)
    m2 = m2_a + m2_b + delta**2 * n_a * n_b / torch.clamp_min(n, 1.0)
    return NormalizerState(n, mean, m2)


def update_normalizer(state: NormalizerState, feats: torch.Tensor,
                      frame_mask: torch.Tensor) -> NormalizerState:
    """Chan/Welford parallel merge of the masked batch statistics. feats
    (B, T, F); frame_mask (B, T) True for valid frames."""
    return merge_stats(state, batch_stats(feats, frame_mask))


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
