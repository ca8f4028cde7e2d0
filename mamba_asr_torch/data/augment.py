"""SpecAugment's time and frequency drops (port of
mamba_asr_tpu/data/augment.py:spec_augment).

Each example gets `num_drops` spans with starts uniform in [0, length)
and widths uniform in [1, max_width], set to `mask_value`, over time and
over mel bins (hparams/CTC/conmamba_small.yaml: 4 time drops of up to 20
frames, 4 frequency drops of up to 10 bins). The random integers come
from an explicit `torch.Generator` on the features' device; they are
not the JAX package's bits, so the tests hand both the same spans.

The time warps (bicubic and linear) and speed perturbation belong to the
S2S configurations and the data pipeline; they raise until then.
"""

from __future__ import annotations

import torch


def spans_mask(starts: torch.Tensor, widths: torch.Tensor, length: int) -> torch.Tensor:
    """(B, num_drops) starts and widths -> (B, length) bool, True inside
    any span."""
    pos = torch.arange(length, device=starts.device)[None, None, :]
    spans = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return spans.any(dim=1)


def drop_mask(generator: torch.Generator, length: int, num_drops: int,
              max_width: int, batch: int, device=None) -> torch.Tensor:
    """(B, length) bool mask of `num_drops` random spans per example."""
    starts = torch.randint(0, max(length, 1), (batch, num_drops),
                           generator=generator, device=device)
    widths = torch.randint(1, max_width + 1, (batch, num_drops),
                           generator=generator, device=device)
    return spans_mask(starts, widths, length)


def apply_drop_masks(feats: torch.Tensor, tmask: torch.Tensor, fmask: torch.Tensor,
                     mask_value: float = 0.0) -> torch.Tensor:
    """feats (B, T, F) with time rows tmask (B, T) and mel bins fmask
    (B, F) set to mask_value."""
    fill = torch.full_like(feats, mask_value)
    feats = torch.where(tmask[:, :, None], fill, feats)
    return torch.where(fmask[:, None, :], fill, feats)


def spec_augment(
    feats: torch.Tensor,
    generator: torch.Generator,
    num_time_drops: int = 4,
    time_drop_width: int = 20,
    num_freq_drops: int = 4,
    freq_drop_width: int = 10,
    time_warp_window: int = 5,
    apply_time_warp: bool = False,
    time_warp_mode: str = "bicubic",
    mask_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment on (B, T, F) log-mel features: time drops, then
    frequency drops. `generator` must live on feats' device."""
    del time_warp_window, time_warp_mode
    if apply_time_warp:
        raise NotImplementedError(
            "time warping comes with the S2S configurations (ROADMAP slice 2b)")
    b, t, f = feats.shape
    tmask = drop_mask(generator, t, num_time_drops, time_drop_width, b, feats.device)
    fmask = drop_mask(generator, f, num_freq_drops, freq_drop_width, b, feats.device)
    return apply_drop_masks(feats, tmask, fmask, mask_value)


def speed_perturb(*args, **kwargs):
    raise NotImplementedError(
        "speed perturbation comes with the data pipeline (ROADMAP slice 2b)")
