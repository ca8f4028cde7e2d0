"""Speed perturbation on the host and SpecAugment's time and frequency
drops on the device (port of mamba_asr_tpu/data/augment.py:
speed_perturb, sinc_resample_np, random_speed_perturb and spec_augment).

Speed perturbation resamples a waveform by 0.95, 1.0 or 1.05 (the
reference recipe's SpeedPerturb) through the port's C++ windowed-sinc or
linear resampler (`native/flac_decode.cpp`, the JAX package's code and
flags, so the same bits); `sinc_resample_np` is the plain numpy
restatement the tests hold it against.

Each example gets `num_drops` spans with starts uniform in [0, length)
and widths uniform in [1, max_width], set to `mask_value`, over time and
over mel bins (hparams/CTC/conmamba_small.yaml: 4 time drops of up to 20
frames, 4 frequency drops of up to 10 bins). The random integers come
from an explicit `torch.Generator` on the features' device; they are
not the JAX package's bits, so the tests hand both the same spans.

The time warps (bicubic and linear) belong to the S2S configurations;
they raise until then.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from mamba_asr_torch.native.build import flac_lib

SPEED_FACTORS = (0.95, 1.0, 1.05)
SINC_WIDTH = 6  # speechbrain Resample lowpass_filter_width default


def speed_perturb(wav: np.ndarray, factor: float, quality: str = "sinc") -> np.ndarray:
    """Resample a float32 waveform by `factor` on the host (factor > 1
    plays faster: a shorter output of round(len / factor) samples).
    quality "sinc" is a Kaldi-style windowed-sinc lowpass resample,
    "linear" plain interpolation."""
    if factor == 1.0 or len(wav) == 0:
        return wav
    if wav.dtype != np.float32:
        raise TypeError(f"speed_perturb takes float32 audio, got {wav.dtype}")
    if quality not in ("sinc", "linear"):
        raise ValueError(f"quality must be 'sinc' or 'linear', got {quality!r}")
    lib = flac_lib()
    n_out = int(round(len(wav) / factor))
    src = np.ascontiguousarray(wav)
    out = np.empty(n_out, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    if quality == "sinc":
        n = lib.sinc_resample(src.ctypes.data_as(fp), len(src), float(factor),
                              out.ctypes.data_as(fp), n_out, SINC_WIDTH)
    else:
        n = lib.linear_resample(src.ctypes.data_as(fp), len(src), float(factor),
                                out.ctypes.data_as(fp), n_out)
    return out[:n]


def sinc_resample_np(wav: np.ndarray, factor: float, width: int = SINC_WIDTH) -> np.ndarray:
    """The windowed-sinc resample in numpy, float64 (the plain version of
    the C++ `sinc_resample`)."""
    n_in = len(wav)
    n_out = int(round(n_in / factor))
    fc = 0.99 * 0.5 * min(1.0, 1.0 / factor)
    support = width / (2.0 * fc)
    half = int(np.ceil(support))
    t = np.arange(n_out, dtype=np.float64) * factor
    j = (np.floor(t).astype(np.int64) - half)[:, None] + np.arange(2 * half + 1)[None, :]
    x = j.astype(np.float64) - t[:, None]
    window = np.where(np.abs(x) < support, 0.5 * (1.0 + np.cos(np.pi * x / support)), 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(x == 0.0, 2.0 * fc, np.sin(2.0 * np.pi * fc * x) / (np.pi * x))
    valid = (j >= 0) & (j < n_in)
    samples = np.where(valid, wav[np.clip(j, 0, n_in - 1)], 0.0)
    return (s * window * samples * valid).sum(axis=1)


def random_speed_perturb(wav: np.ndarray, rng: np.random.Generator,
                         factors: Tuple[float, ...] = SPEED_FACTORS) -> np.ndarray:
    return speed_perturb(wav, factors[rng.integers(len(factors))])


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
