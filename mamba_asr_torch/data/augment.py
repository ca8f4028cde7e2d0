"""Speed perturbation on the host and SpecAugment's time warp and time
and frequency drops on the device (port of mamba_asr_tpu/data/
augment.py: speed_perturb, sinc_resample_np, random_speed_perturb,
_cubic_weights, _cubic_time_gather, time_warp_bicubic and
spec_augment).

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

The time warp (the S2S configurations' `apply_time_warp: true`) runs
before the drops, when T > 2 * window + 2. "bicubic" (the reference's
SpeechBrain Warping) draws one centre c ~ U[window, T - window) and one
target w = c + U[-window, window) + 1 per batch and resizes the time
segments [0, c) and [c, T) to [0, w) and [w, T) by Keys cubic
interpolation (a = -0.75, align_corners), each tap clamped to its own
segment; "linear" draws a centre and a target per example and maps
positions piecewise linearly. The draws stay device tensors: the
source-position map and the 4-tap gather are built from them, with no
host sync. `time_warp_bicubic` and `time_warp_linear` take the draws as
arguments, so the tests hand them the JAX package's.
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


def _cubic_weights(frac: torch.Tensor) -> torch.Tensor:
    """Keys cubic-convolution weights (a = -0.75, F.interpolate's bicubic)
    of the 4 taps at offsets -1, 0, 1, 2 around the sample point; frac in
    [0, 1). Returns (..., 4)."""
    a = -0.75
    d = torch.stack([frac + 1.0, frac, 1.0 - frac, 2.0 - frac], dim=-1)
    near = (a + 2.0) * d ** 3 - (a + 3.0) * d ** 2 + 1.0
    far = a * d ** 3 - 5.0 * a * d ** 2 + 8.0 * a * d - 4.0 * a
    return torch.where(d <= 1.0, near, far)


def _cubic_time_gather(feats: torch.Tensor, src: torch.Tensor, lo_bound: torch.Tensor,
                       hi_bound: torch.Tensor) -> torch.Tensor:
    """(B, T, F) features sampled at the fractional time positions src (T,)
    by 4-tap cubic interpolation, each tap clamped to [lo_bound, hi_bound]
    (T,) of its position's segment."""
    lo = torch.floor(src)
    w = _cubic_weights(src - lo)  # (T, 4)
    base = lo.long()
    out = 0.0
    for tap, off in enumerate((-1, 0, 1, 2)):
        idx = torch.minimum(torch.maximum(base + off, lo_bound), hi_bound)
        out = out + w[:, tap:tap + 1] * feats[:, idx]
    return out


def draw_time_warp(generator: torch.Generator, length: int, window: int, batch: int,
                   mode: str = "bicubic") -> Tuple[torch.Tensor, torch.Tensor]:
    """The warp's draws on the generator's device: bicubic, one (centre,
    target) pair of 0-d tensors per batch; linear, (B,) centres and
    targets."""
    dev = generator.device
    if mode == "bicubic":
        c = torch.randint(window, length - window, (), generator=generator, device=dev)
        shift = torch.randint(-window, window, (), generator=generator, device=dev)
        return c, c + shift + 1
    if mode == "linear":
        center = torch.randint(window + 1, length - window - 1, (batch,),
                               generator=generator, device=dev)
        shift = torch.randint(-window, window + 1, (batch,), generator=generator, device=dev)
        return center, center + shift
    raise ValueError(f"unknown time_warp_mode {mode!r}")


def time_warp_bicubic(feats: torch.Tensor, c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, F) with its time segments [0, c) and [c, T) resized to [0, w)
    and [w, T) by cubic interpolation, align_corners (the JAX package's
    segment maps, `augment.py:200-207`); c and w are 0-d tensors."""
    t = feats.shape[1]
    c, w = c.float(), w.float()
    pos = torch.arange(t, dtype=torch.float32, device=feats.device)
    left = pos * (c - 1.0) / torch.clamp_min(w - 1.0, 1.0)
    right = c + (pos - w) * (t - c - 1.0) / torch.clamp_min(t - w - 1.0, 1.0)
    in_left = pos < w
    src = torch.clamp(torch.where(in_left, left, right), 0.0, t - 1.0)
    ci = c.long()
    lo_bound = torch.where(in_left, torch.zeros_like(ci), ci)
    hi_bound = torch.where(in_left, ci - 1, torch.full_like(ci, t - 1))
    return _cubic_time_gather(feats, src, lo_bound, hi_bound)


def time_warp_linear(feats: torch.Tensor, center: torch.Tensor, target: torch.Tensor
                     ) -> torch.Tensor:
    """(B, T, F) with each example's source position `center` (B,) moved
    to `target` (B,), positions mapped piecewise linearly and sampled by
    linear interpolation."""
    t = feats.shape[1]
    center, target = center.float()[:, None], target.float()[:, None]
    pos = torch.arange(t, dtype=torch.float32, device=feats.device)[None, :]
    left = pos * (center / torch.clamp_min(target, 1.0))
    right = center + (pos - target) * ((t - 1 - center) / torch.clamp_min(t - 1 - target, 1.0))
    src = torch.clamp(torch.where(pos <= target, left, right), 0.0, t - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp_max(lo + 1, t - 1)
    w = (src - lo)[..., None]
    rows = torch.arange(feats.shape[0], device=feats.device)[:, None]
    return (1 - w) * feats[rows, lo] + w * feats[rows, hi]


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
    """SpecAugment on (B, T, F) log-mel features: the time warp (when
    asked and T > 2 * window + 2), time drops, then frequency drops.
    `generator` must live on feats' device."""
    b, t, f = feats.shape
    if apply_time_warp and t > 2 * time_warp_window + 2:
        a, z = draw_time_warp(generator, t, time_warp_window, b, time_warp_mode)
        warp = time_warp_bicubic if time_warp_mode == "bicubic" else time_warp_linear
        feats = warp(feats, a, z)
    tmask = drop_mask(generator, t, num_time_drops, time_drop_width, b, feats.device)
    fmask = drop_mask(generator, f, num_freq_drops, freq_drop_width, b, feats.device)
    return apply_drop_masks(feats, tmask, fmask, mask_value)
